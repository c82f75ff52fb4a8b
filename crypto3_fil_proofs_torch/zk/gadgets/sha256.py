"""In-circuit SHA-256 (bellperson sha256.rs semantics).

Needed for the stacked circuit's labeling / encoding-key proofs and
binary tree_d path hashing (reference: stacked/circuit/create_label.hpp
is a stub; semantics follow rust-fil-proofs; vanilla counterpart is
hashlib SHA-256 with the &0x3F Fr trim — ops/tree_hash.Sha256Backend).

Bit convention: circuit inputs/outputs are Boolean lists in *byte
order, MSB-first within each byte* (matching how bytes feed hashlib).
Helpers convert to/from the little-endian-within-byte order used for
replica-id packing.

Copied from crypto3_fil_proofs_tpu/zk/gadgets/sha256.py with its imports rewritten.
"""
from __future__ import annotations

from .boolean import Boolean
from .uint32 import UInt32

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]


def sha256_compress(cs, block_bits: list, state: list) -> list:
    """One compression round: 512 input bits (BE), 8-word state."""
    assert len(block_bits) == 512
    w = [UInt32.from_bits_be(block_bits[i * 32 : (i + 1) * 32]) for i in range(16)]
    for i in range(16, 64):
        s0_src = w[i - 15]
        s0 = s0_src.rotr(7).xor(cs, s0_src.rotr(18)).xor(cs, s0_src.shr(3))
        s1_src = w[i - 2]
        s1 = s1_src.rotr(17).xor(cs, s1_src.rotr(19)).xor(cs, s1_src.shr(10))
        w.append(UInt32.addmany(cs, [w[i - 16], s0, w[i - 7], s1]))

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        big_s1 = e.rotr(6).xor(cs, e.rotr(11)).xor(cs, e.rotr(25))
        ch = UInt32.sha256_ch(cs, e, f, g)
        t1 = UInt32.addmany(
            cs, [h, big_s1, ch, UInt32.constant(ROUND_CONSTANTS[i]), w[i]]
        )
        big_s0 = a.rotr(2).xor(cs, a.rotr(13)).xor(cs, a.rotr(22))
        maj = UInt32.sha256_maj(cs, a, b, c)
        t2 = UInt32.addmany(cs, [big_s0, maj])
        h, g, f = g, f, e
        e = UInt32.addmany(cs, [d, t1])
        d, c, b = c, b, a
        a = UInt32.addmany(cs, [t1, t2])

    return [
        UInt32.addmany(cs, [s, v])
        for s, v in zip(state, [a, b, c, d, e, f, g, h])
    ]


def sha256_block_no_padding(cs, block_bits: list) -> list:
    """Hash exactly one 512-bit block with the IV, no padding appended
    (rust-fil-proofs uses this for 64-byte two-child node hashing).
    Dispatches to the array-synthesis emitter; `_scalar` variant below
    is the per-bit reference."""
    from .sha256_vec import sha256_block_no_padding_vec

    return sha256_block_no_padding_vec(cs, block_bits)


def sha256_block_no_padding_scalar(cs, block_bits: list) -> list:
    state = [UInt32.constant(v) for v in IV]
    state = sha256_compress(cs, block_bits, state)
    out = []
    for word in state:
        out.extend(word.into_bits_be())
    return out


def sha256(cs, data_bits: list) -> list:
    """Full SHA-256 with standard padding. data_bits in BE byte order,
    length must be a multiple of 8.

    Dispatches to the array-synthesis emitter (sha256_vec.py: numpy CSR
    BulkBlocks, ~10-30x the per-bit python path; same per-bit constraint
    content). `sha256_scalar` keeps the per-bit reference path for
    parity tests."""
    from .sha256_vec import sha256_vec

    return sha256_vec(cs, data_bits)


def sha256_scalar(cs, data_bits: list) -> list:
    """Per-bit reference path (bellperson sha256.rs port)."""
    length = len(data_bits)
    assert length % 8 == 0
    bits = list(data_bits)
    bits.append(Boolean.const(True))
    while (len(bits) + 64) % 512 != 0:
        bits.append(Boolean.const(False))
    for i in range(63, -1, -1):
        bits.append(Boolean.const((length >> i) & 1))
    state = [UInt32.constant(v) for v in IV]
    for off in range(0, len(bits), 512):
        state = sha256_compress(cs, bits[off : off + 512], state)
    out = []
    for word in state:
        out.extend(word.into_bits_be())
    return out


# ---------------------------------------------------------------------------
# Bit-order helpers
# ---------------------------------------------------------------------------


def bytes_to_bits_be(cs, data: bytes) -> list:
    """Bytes -> constant Booleans, MSB-first within each byte."""
    out = []
    for byte in data:
        for i in range(7, -1, -1):
            out.append(Boolean.const((byte >> i) & 1))
    return out


def le_bits_to_be(bits_le: list) -> list:
    """Reorder bits from LE-within-byte to BE-within-byte (same bytes)."""
    assert len(bits_le) % 8 == 0
    out = []
    for i in range(0, len(bits_le), 8):
        out.extend(reversed(bits_le[i : i + 8]))
    return out


def be_bits_to_le(bits_be: list) -> list:
    return le_bits_to_be(bits_be)  # involution


def digest_bits_to_fr_le_bits(bits_be: list) -> list:
    """SHA digest (BE byte order) -> 254 LE bits of the Fr value with the
    reference's &0x3F trim on the last byte (create_label.hpp:77,118)."""
    le = be_bits_to_le(bits_be)  # LE within byte, byte order preserved
    # value bit k = le[k] (byte j bit i -> k = 8j + i); trim bits 254, 255
    return le[:254]


def digest_bits_value(bits_be: list) -> int:
    """Digest bits -> integer (LE byte interpretation, &0x3F trim)."""
    le = be_bits_to_le(bits_be)
    return sum(b.value << i for i, b in enumerate(le[:254]))
