"""Field-element gadget (bellperson `num.rs` AllocatedNum semantics).

Copied from crypto3_fil_proofs_tpu/zk/gadgets/num.py and cut to what
builds circuits from field multiplications: `alloc`, `alloc_input`,
`inputize`, `lc`, `mul` and `square`, with the JAX package's variable
order.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, LinearCombination, lc_one


@dataclass
class AllocatedNum:
    var: int
    value: int

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int, name: str = "num"):
        return cls(cs.alloc(value % R, name), value % R)

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, value: int, name: str = "input"):
        return cls(cs.alloc_input(value % R, name), value % R)

    def inputize(self, cs: ConstraintSystem) -> None:
        """Expose this private value as a public input (one constraint)."""
        inp = cs.alloc_input(self.value, "inputized")
        cs.enforce(
            LinearCombination.from_var(inp),
            lc_one(),
            LinearCombination.from_var(self.var),
            "inputize",
        )

    def lc(self, coeff: int = 1) -> LinearCombination:
        return LinearCombination.from_var(self.var, coeff)

    def mul(self, cs, other: "AllocatedNum") -> "AllocatedNum":
        value = (self.value * other.value) % R
        out = AllocatedNum.alloc(cs, value, "mul")
        cs.enforce(self.lc(), other.lc(), out.lc(), "mul")
        return out

    def square(self, cs) -> "AllocatedNum":
        return self.mul(cs, self)
