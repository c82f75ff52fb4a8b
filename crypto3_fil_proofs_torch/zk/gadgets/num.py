"""Field-element gadget (bellperson `num.rs` AllocatedNum semantics).

Used by every circuit layer: Merkle roots, Poseidon states, column
values (reference consumed-blueprint equivalents; e.g.
stacked/circuit/column.hpp:41-100 AllocatedColumn holds AllocatedNums).

Copied from crypto3_fil_proofs_tpu/zk/gadgets/num.py with its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .boolean import AllocatedBit, Boolean


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

    def add(self, cs, other: "AllocatedNum") -> "AllocatedNum":
        value = (self.value + other.value) % R
        out = AllocatedNum.alloc(cs, value, "add")
        cs.enforce(self.lc() + other.lc(), lc_one(), out.lc(), "add")
        return out

    @classmethod
    def equals(cls, cs, a: "AllocatedNum", b: "AllocatedNum") -> None:
        cs.enforce(a.lc() - b.lc(), lc_one(), LinearCombination(), "equals")

    def to_bits_le(self, cs, bits: int = 255) -> list[Boolean]:
        """LE bit decomposition with packing constraint (bulk-allocated
        bits; same constraint content as the per-bit path)."""
        from .boolean import alloc_bits_bulk, pack_bits_lc

        v = self.value
        out = alloc_bits_bulk(cs, [(v >> i) & 1 for i in range(bits)])
        lc, _ = pack_bits_lc(out)
        lc.accumulate(self.var, R - 1)
        cs.enforce(lc, lc_one(), LinearCombination(), "unpacking")
        return out

    @classmethod
    def from_bits_le(cls, cs, bits: list[Boolean]) -> "AllocatedNum":
        """Pack LE bits into a num (one constraint)."""
        from .boolean import pack_bits_lc

        lc, value = pack_bits_lc(bits)
        out = cls.alloc(cs, value, "packed")
        lc.accumulate(out.var, R - 1)
        cs.enforce(lc, lc_one(), LinearCombination(), "packing")
        return out


def pick(cs, condition: Boolean, a: AllocatedNum, b: AllocatedNum) -> AllocatedNum:
    """condition ? a : b  (one constraint)."""
    value = a.value if condition.value else b.value
    out = AllocatedNum.alloc(cs, value, "pick")
    # (a - b) * cond = out - b
    cs.enforce(a.lc() - b.lc(), condition.lc(), out.lc() - b.lc(), "pick")
    return out
