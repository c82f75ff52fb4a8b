"""Feistel network pseudo-random permutation.

Copied from crypto3_fil_proofs_tpu/core/feistel.py (reference
core/crypto/feistel.hpp:33-181: 3-round Feistel with a Blake2b-128 round
function over (right_u64_be || key_u64_be), output masked to the
half-width; `permute` cycle-walks until the result lands in
[0, num_elements)). The stacked graph's expander parents run the same
permutation in the native engine (native/label.c
`expander_parents_range`), which is given `precompute`'s widths; this
module's `permute` is its host version.

The reference's `decode` body indexes keys[3..1] (an off-by-one that
would break encode/decode inversion); this uses the reversed key order
keys[2..0].
"""
from __future__ import annotations

import hashlib

FEISTEL_ROUNDS = 3


def precompute(num_elements: int) -> tuple[int, int, int]:
    """(left_mask, right_mask, half_bits) for the smallest even bit-width
    covering num_elements (reference: feistel.hpp:45-58)."""
    next_pow4 = 4
    log4 = 1
    while next_pow4 < num_elements:
        next_pow4 *= 4
        log4 += 1
    left_mask = ((1 << log4) - 1) << log4
    right_mask = (1 << log4) - 1
    return left_mask, right_mask, log4


def _round_fn(right: int, key: int, right_mask: int) -> int:
    data = (right & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big") + (
        key & 0xFFFFFFFFFFFFFFFF
    ).to_bytes(8, "big")
    h = hashlib.blake2b(data, digest_size=16).digest()
    return int.from_bytes(h[:8], "big") & right_mask


def encode(index: int, keys, precomputed) -> int:
    left_mask, right_mask, half_bits = precomputed
    left = (index & left_mask) >> half_bits
    right = index & right_mask
    for key in keys[:FEISTEL_ROUNDS]:
        left, right = right, left ^ _round_fn(right, key, right_mask)
    return (left << half_bits) | right


def decode(index: int, keys, precomputed) -> int:
    left_mask, right_mask, half_bits = precomputed
    left = (index & left_mask) >> half_bits
    right = index & right_mask
    for key in reversed(keys[:FEISTEL_ROUNDS]):
        left, right = right ^ _round_fn(left, key, right_mask), left
    return (left << half_bits) | right


def permute(num_elements: int, index: int, keys, precomputed) -> int:
    u = encode(index, keys, precomputed)
    while u >= num_elements:
        u = encode(u, keys, precomputed)
    return u


def invert_permute(num_elements: int, index: int, keys, precomputed) -> int:
    u = decode(index, keys, precomputed)
    while u >= num_elements:
        u = decode(u, keys, precomputed)
    return u
