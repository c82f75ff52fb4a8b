"""32-bit word gadget for the in-circuit SHA-256 (bellperson uint32.rs).

(reference: the stacked circuit's labeling/encoding proofs hash with
SHA-256 in-circuit via the consumed blueprint sha256 component —
stacked/circuit/create_label.hpp is an empty stub in the reference,
semantics per rust-fil-proofs create_label_circuit.)

Copied from crypto3_fil_proofs_tpu/zk/gadgets/uint32.py with its imports rewritten.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...ops.bls12_381 import R
from ..r1cs import ConstraintSystem, LinearCombination, lc_one
from .boolean import AllocatedBit, Boolean


@dataclass
class UInt32:
    bits: list  # 32 Booleans, little-endian (bits[0] = LSB)
    value: int

    @classmethod
    def constant(cls, value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        return cls([Boolean.const((value >> i) & 1) for i in range(32)], value)

    @classmethod
    def alloc(cls, cs, value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        bits = [Boolean.alloc(cs, (value >> i) & 1) for i in range(32)]
        return cls(bits, value)

    @classmethod
    def from_bits_be(cls, bits: list) -> "UInt32":
        """32 Booleans, big-endian (bits[0] = MSB)."""
        assert len(bits) == 32
        le = list(reversed(bits))
        value = sum(b.value << i for i, b in enumerate(le))
        return cls(le, value)

    def into_bits_be(self) -> list:
        return list(reversed(self.bits))

    def xor(self, cs, other: "UInt32") -> "UInt32":
        bits = [Boolean.xor(cs, a, b) for a, b in zip(self.bits, other.bits)]
        return UInt32(bits, self.value ^ other.value)

    def rotr(self, n: int) -> "UInt32":
        n %= 32
        bits = [self.bits[(i + n) % 32] for i in range(32)]
        value = ((self.value >> n) | (self.value << (32 - n))) & 0xFFFFFFFF
        return UInt32(bits, value)

    def shr(self, n: int) -> "UInt32":
        bits = [
            self.bits[i + n] if i + n < 32 else Boolean.const(False)
            for i in range(32)
        ]
        return UInt32(bits, self.value >> n)

    @classmethod
    def addmany(cls, cs, operands: list["UInt32"]) -> "UInt32":
        """Sum mod 2^32. One packing constraint over sum-width bits."""
        assert len(operands) >= 2
        total = sum(op.value for op in operands)
        # result width from the STATIC bound (constants count at their
        # value, variables at 2^32-1), never the witness value — the
        # circuit structure must be identical for blank-CRS synthesis
        # and witness synthesis (bellperson uint32.rs max_value
        # semantics; a witness-sized width made witness circuits
        # incompatible with the cached Groth16 CRS)
        bound = 0
        for op in operands:
            if all(b.constant is not None for b in op.bits):
                bound += op.value
            else:
                bound += 0xFFFFFFFF
        n_bits = max(bound.bit_length(), 32)
        result_bits = [
            AllocatedBit.alloc(cs, (total >> i) & 1) for i in range(n_bits)
        ]
        # raw-dict accumulation (hot path: 3 addmanys per SHA round)
        terms: dict[int, int] = {}
        get = terms.get
        for op in operands:
            coeff = 1
            for b in op.bits:
                if b.constant is not None:
                    if b.constant:
                        terms[0] = (get(0, 0) + coeff) % R
                elif b.negated:
                    terms[0] = (get(0, 0) + coeff) % R
                    v = b.bit.var
                    terms[v] = (get(v, 0) - coeff) % R
                else:
                    v = b.bit.var
                    terms[v] = (get(v, 0) + coeff) % R
                coeff = coeff * 2 % R
        coeff = 1
        for b in result_bits:
            terms[b.var] = (get(b.var, 0) - coeff) % R
            coeff = coeff * 2 % R
        cs.enforce_raw(
            {v: c for v, c in terms.items() if c}, {0: 1}, {}
        )
        return cls(
            [Boolean.from_bit(b) for b in result_bits[:32]],
            total & 0xFFFFFFFF,
        )

    @classmethod
    def sha256_maj(cls, cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        """(a & b) ^ (a & c) ^ (b & c) == (b & c) ^ (a & (b ^ c))."""
        bits = []
        for x, y, z in zip(a.bits, b.bits, c.bits):
            t1 = Boolean.xor(cs, y, z)
            t2 = Boolean.and_(cs, x, t1)
            t3 = Boolean.and_(cs, y, z)
            bits.append(Boolean.xor(cs, t2, t3))
        value = (a.value & b.value) ^ (a.value & c.value) ^ (b.value & c.value)
        return cls(bits, value)

    @classmethod
    def sha256_ch(cls, cs, e: "UInt32", f: "UInt32", g: "UInt32") -> "UInt32":
        """(e & f) ^ (~e & g)."""
        bits = []
        for x, y, z in zip(e.bits, f.bits, g.bits):
            t1 = Boolean.and_(cs, x, y)
            t2 = Boolean.and_(cs, x.not_(), z)
            bits.append(Boolean.xor(cs, t1, t2))
        value = (e.value & f.value) ^ ((~e.value & 0xFFFFFFFF) & g.value)
        return cls(bits, value)
