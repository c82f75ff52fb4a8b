"""Boolean / bit gadgets (bellperson `boolean.rs` semantics).

Replaces the reference's consumed blueprint bit components (reference:
core/components/por.hpp uses packing/bit gadgets from crypto3-zk;
SURVEY.md §2.1 circuit gadget rows). AllocatedBit enforces b*(1-b)=0;
`Boolean` is a tri-state wrapper (constant / var / negated var) whose
operations fold constants so composite gadgets (SHA-256) stay small.

Copied from crypto3_fil_proofs_tpu/zk/gadgets/boolean.py with its imports rewritten.
"""
from __future__ import annotations


from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, LinearCombination, lc_one


_M1 = R - 1  # -1 mod R (prebuilt coeff for the raw-dict fast paths)


class AllocatedBit:
    __slots__ = ("var", "value")

    def __init__(self, var: int, value: int):
        self.var = var
        self.value = value

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int) -> "AllocatedBit":
        value = 1 if value else 0
        values = cs.values
        values.append(value)
        cs.is_input.append(False)
        var = len(values) - 1
        # b * (1 - b) = 0
        cs.enforce_raw({var: 1}, {0: 1, var: _M1}, {})
        return cls(var, value)

    @classmethod
    def alloc_unchecked(cls, cs: ConstraintSystem, value: int) -> "AllocatedBit":
        return cls(cs.alloc(int(bool(value)), "bit"), int(bool(value)))

    def lc(self) -> LinearCombination:
        return LinearCombination.from_var(self.var)

    @classmethod
    def xor(cls, cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = a.value ^ b.value
        var = cs.alloc(value, "xor")
        # 2a * b = a + b - c
        if a.var == b.var:  # rare degenerate case; keep exact semantics
            cs.enforce_raw({a.var: 2}, {b.var: 1}, {a.var: 2, var: _M1})
        else:
            cs.enforce_raw(
                {a.var: 2}, {b.var: 1}, {a.var: 1, b.var: 1, var: _M1}
            )
        return cls(var, value)

    @classmethod
    def and_(cls, cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = a.value & b.value
        var = cs.alloc(value, "and")
        cs.enforce_raw({a.var: 1}, {b.var: 1}, {var: 1})
        return cls(var, value)

    @classmethod
    def and_not(cls, cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        """a AND (NOT b)."""
        value = a.value & (1 - b.value)
        var = cs.alloc(value, "and_not")
        cs.enforce_raw({a.var: 1}, {0: 1, b.var: _M1}, {var: 1})
        return cls(var, value)

    @classmethod
    def nor(cls, cs, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        value = (1 - a.value) & (1 - b.value)
        var = cs.alloc(value, "nor")
        cs.enforce_raw({0: 1, a.var: _M1}, {0: 1, b.var: _M1}, {var: 1})
        return cls(var, value)


class Boolean:
    """Constant-folding boolean: constant, bit, or negated bit."""

    __slots__ = ("bit", "constant", "negated")

    def __init__(self, bit: AllocatedBit | None = None,
                 constant: bool | None = None, negated: bool = False):
        assert (bit is None) != (constant is None)
        self.bit = bit
        self.constant = constant
        self.negated = negated

    # -- constructors ------------------------------------------------------

    @classmethod
    def const(cls, value: bool) -> "Boolean":
        # the two constants are immutable in practice; share singletons
        return _TRUE if value else _FALSE

    @classmethod
    def from_bit(cls, bit: AllocatedBit) -> "Boolean":
        return cls(bit=bit)

    @classmethod
    def alloc(cls, cs, value) -> "Boolean":
        return cls(bit=AllocatedBit.alloc(cs, value))

    # -- views -------------------------------------------------------------

    @property
    def value(self) -> int:
        if self.constant is not None:
            return int(self.constant)
        v = self.bit.value
        return 1 - v if self.negated else v

    def lc(self, coeff: int = 1) -> LinearCombination:
        if self.constant is not None:
            return LinearCombination.constant(coeff if self.constant else 0)
        if self.negated:
            return LinearCombination.constant(coeff) - self.bit.lc().scale(coeff)
        return self.bit.lc().scale(coeff)

    def not_(self) -> "Boolean":
        if self.constant is not None:
            return Boolean.const(not self.constant)
        return Boolean(bit=self.bit, negated=not self.negated)

    # -- ops ---------------------------------------------------------------

    @classmethod
    def xor(cls, cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.constant is not None:
            return b if not a.constant else b.not_()
        if b.constant is not None:
            return a if not b.constant else a.not_()
        if a.negated == b.negated:
            return cls(bit=AllocatedBit.xor(cs, a.bit, b.bit))
        return cls(bit=AllocatedBit.xor(cs, a.bit, b.bit), negated=True)

    @classmethod
    def and_(cls, cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.constant is not None:
            return b if a.constant else cls.const(False)
        if b.constant is not None:
            return a if b.constant else cls.const(False)
        if not a.negated and not b.negated:
            return cls(bit=AllocatedBit.and_(cs, a.bit, b.bit))
        if not a.negated and b.negated:
            return cls(bit=AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.negated and not b.negated:
            return cls(bit=AllocatedBit.and_not(cs, b.bit, a.bit))
        return cls(bit=AllocatedBit.nor(cs, a.bit, b.bit))

    @classmethod
    def enforce_equal(cls, cs, a: "Boolean", b: "Boolean") -> None:
        cs.enforce(a.lc() - b.lc(), lc_one(), LinearCombination(),
                   "enforce equal")


def alloc_bits_bulk(cs: ConstraintSystem, vals) -> list[Boolean]:
    """Allocate many AllocatedBit booleans at once: one bulk_alloc plus
    a BulkBlock of b*(1-b)=0 rows (array-synthesis path; same
    constraint content as AllocatedBit.alloc per bit)."""
    import numpy as np

    from ..r1cs import _EMPTY_I64, _BulkBuilder

    vals = np.asarray(vals, dtype=np.int64)
    n = len(vals)
    if n == 0:
        return []
    base = cs.bulk_alloc(vals)
    ids = np.arange(base, base + n, dtype=np.int64)
    ones = np.ones(n, np.int64)
    b_cols = np.empty(2 * n, np.int64)
    b_cols[0::2] = 0
    b_cols[1::2] = ids
    b_coeffs = np.empty(2 * n, np.int64)
    b_coeffs[0::2] = 1
    b_coeffs[1::2] = -1
    builder = _BulkBuilder()
    builder.add_rows(
        n,
        ones, ids, ones,
        2 * ones, b_cols, b_coeffs,
        np.zeros(n, np.int64), _EMPTY_I64, _EMPTY_I64,
    )
    cs.add_bulk_block(builder.build("bits"))
    vlist = vals.tolist()
    return [
        Boolean(bit=AllocatedBit(base + i, vlist[i])) for i in range(n)
    ]


def accumulate_boolean(lc: LinearCombination, b: "Boolean", coeff: int) -> None:
    """In-place `lc += coeff * b` (hot path for packing loops)."""
    if b.constant is not None:
        if b.constant:
            lc.accumulate(0, coeff)
        return
    if b.negated:
        lc.accumulate(0, coeff)
        lc.accumulate(b.bit.var, -coeff)
    else:
        lc.accumulate(b.bit.var, coeff)


def pack_bits_lc(bits: list["Boolean"]) -> tuple[LinearCombination, int]:
    """(sum 2^i b_i as one LC, value) — linear-time packing."""
    lc = LinearCombination()
    coeff, value = 1, 0
    for b in bits:
        accumulate_boolean(lc, b, coeff)
        value += b.value * coeff
        coeff = (coeff * 2) % R
    return lc, value % R


def field_into_boolean_vec_le(cs, value: int, bits: int = 255) -> list[Boolean]:
    """Allocate the little-endian bit decomposition of an Fr element,
    with the packing constraint sum(b_i 2^i) == value."""
    value %= R
    out_bits = []
    lc = LinearCombination()
    coeff = 1
    for i in range(bits):
        b = AllocatedBit.alloc(cs, (value >> i) & 1)
        out_bits.append(Boolean.from_bit(b))
        lc = lc + b.lc().scale(coeff)
        coeff = (coeff * 2) % R
    cs.enforce(lc - LinearCombination.constant(value), lc_one(),
               LinearCombination(), "packing")
    return out_bits


def u8_vec_into_boolean_vec_le(cs, data: bytes) -> list[Boolean]:
    """Bytes -> bits, little-endian within each byte (bellperson
    `u8_vec_into_boolean_vec_le` order, used for replica_id bits)."""
    out = []
    for byte in data:
        for i in range(8):
            out.append(Boolean.from_bit(AllocatedBit.alloc(cs, (byte >> i) & 1)))
    return out


_TRUE = Boolean(constant=True)
_FALSE = Boolean(constant=False)
