"""R1CS constraint system (bellperson style) for the proof circuits.

Copied from crypto3_fil_proofs_tpu/zk/r1cs.py and cut to dict rows:
`LinearCombination`, `lc_one`/`lc_zero`, and `ConstraintSystem` with
`alloc`, `alloc_input`, `enforce`, `is_satisfied` and `finalize`. The
vectorized `BulkBlock`/`FieldBlock` runs wait for the circuits that
emit them.

Synthesis builds sparse linear combinations over python-int Fr
coefficients, and every allocation carries its value (proving-mode
synthesis). The Groth16 prover (zk/groth16.py) consumes the rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.bls12_381 import R

ONE = 0  # variable index of the constant 1


class LinearCombination:
    """Sparse sum of (variable, coefficient) terms over Fr."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict[int, int] | None = None):
        self.terms = dict(terms) if terms else {}

    @classmethod
    def from_var(cls, var: int, coeff: int = 1) -> "LinearCombination":
        return cls({var: coeff % R})

    @classmethod
    def constant(cls, value: int) -> "LinearCombination":
        return cls({ONE: value % R}) if value % R else cls()

    def accumulate(self, var: int, coeff: int) -> None:
        """In-place add of one term (use on fresh LCs only)."""
        c = (self.terms.get(var, 0) + coeff) % R
        if c:
            self.terms[var] = c
        elif var in self.terms:
            del self.terms[var]

    def add_term(self, var: int, coeff: int) -> "LinearCombination":
        out = LinearCombination(self.terms)
        out.accumulate(var, coeff)
        return out

    def __add__(self, other):
        if isinstance(other, int):
            return self.add_term(ONE, other)
        out = LinearCombination(self.terms)
        for v, c in other.terms.items():
            out.accumulate(v, c)
        return out

    def __sub__(self, other):
        if isinstance(other, int):
            return self.add_term(ONE, -other)
        return self + other.scale(R - 1)

    def scale(self, k: int) -> "LinearCombination":
        k %= R
        if k == 0:
            return LinearCombination()
        return LinearCombination({v: (c * k) % R for v, c in self.terms.items()})

    def evaluate(self, assignment: list[int]) -> int:
        return sum(c * assignment[v] for v, c in self.terms.items()) % R


def lc_zero() -> LinearCombination:
    return LinearCombination()


def lc_one() -> LinearCombination:
    return LinearCombination.from_var(ONE)


@dataclass
class ConstraintSystem:
    """Proving-mode constraint system: rows + full witness.

    Variable order follows Groth16: [one, public inputs..., auxiliary...]
    after `finalize()`; before it, variables are numbered in allocation
    order.
    """

    values: list[int] = field(default_factory=lambda: [1])
    is_input: list[bool] = field(default_factory=lambda: [True])
    constraints: list[tuple] = field(default_factory=list)
    names: list[str] = field(default_factory=list)

    def alloc(self, value: int, name: str = "aux") -> int:
        """Allocate an auxiliary (private) variable with a known value."""
        self.values.append(value % R)
        self.is_input.append(False)
        return len(self.values) - 1

    def alloc_input(self, value: int, name: str = "input") -> int:
        """Allocate a public-input variable."""
        self.values.append(value % R)
        self.is_input.append(True)
        return len(self.values) - 1

    def enforce(self, a: LinearCombination, b: LinearCombination,
                c: LinearCombination, name: str = "") -> None:
        """a * b = c; rows are stored as plain {var: coeff} dicts."""
        self.constraints.append((a.terms, b.terms, c.terms))
        self.names.append(name)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_inputs(self) -> int:
        return sum(self.is_input)

    @property
    def num_aux(self) -> int:
        return len(self.values) - self.num_inputs

    def is_satisfied(self) -> bool:
        return self.which_unsatisfied() is None

    def which_unsatisfied(self) -> str | None:
        values = self.values
        for i, (a, b, c) in enumerate(self.constraints):
            av = sum(co * values[v] for v, co in a.items())
            bv = sum(co * values[v] for v, co in b.items())
            cv = sum(co * values[v] for v, co in c.items())
            if (av * bv - cv) % R != 0:
                return self.names[i] or f"constraint {i}"
        return None

    def finalize(self):
        """Reindex variables to [one, inputs..., aux...] order.

        Returns (num_inputs, num_aux, rows, input_values, aux_values),
        rows being (a, b, c) dicts over the new indices.
        """
        new_index = [0] * len(self.values)
        inputs, aux = [], []
        for i, (value, is_in) in enumerate(zip(self.values, self.is_input)):
            if is_in:
                new_index[i] = len(inputs)
                inputs.append(value)
        n_in = len(inputs)
        for i, (value, is_in) in enumerate(zip(self.values, self.is_input)):
            if not is_in:
                new_index[i] = n_in + len(aux)
                aux.append(value)
        rows = [
            tuple({new_index[v]: co for v, co in terms.items()} for terms in row)
            for row in self.constraints
        ]
        return n_in, len(aux), rows, inputs, aux
