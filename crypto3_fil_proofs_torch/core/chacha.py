"""ChaCha8 stream RNG — drives DRG bucket-sampled parent selection.

Replaces the consumed `crypto3::random::chacha`
(reference: libs/storage/.../core/drgraph.hpp:32,148 seeds a ChaCha RNG
with drg_seed||node to sample parent buckets).

Semantics follow the rand_chacha crate's ChaCha8Rng: 32-byte seed as the
key, zero nonce, 64-bit block counter, 8 rounds, output words consumed
little-endian in stream order. next_u64 = lo_u32 | hi_u32 << 32.

Copied from crypto3_fil_proofs_tpu/core/chacha.py.
"""
from __future__ import annotations

import numpy as np

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl32(x, n):
    return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))).astype(np.uint32)


def _quarter_round(state, a, b, c, d):
    state[a] = (state[a] + state[b]).astype(np.uint32)
    state[d] = _rotl32(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]).astype(np.uint32)
    state[b] = _rotl32(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]).astype(np.uint32)
    state[d] = _rotl32(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]).astype(np.uint32)
    state[b] = _rotl32(state[b] ^ state[c], 7)


def chacha_block(key_words: np.ndarray, counter: int, rounds: int = 8) -> np.ndarray:
    """One 16-word ChaCha block (uint32[16])."""
    state = np.zeros(16, dtype=np.uint32)
    state[0:4] = _CONSTANTS
    state[4:12] = key_words
    state[12] = counter & 0xFFFFFFFF
    state[13] = (counter >> 32) & 0xFFFFFFFF
    # words 14, 15: zero nonce
    working = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            # column rounds
            _quarter_round(working, 0, 4, 8, 12)
            _quarter_round(working, 1, 5, 9, 13)
            _quarter_round(working, 2, 6, 10, 14)
            _quarter_round(working, 3, 7, 11, 15)
            # diagonal rounds
            _quarter_round(working, 0, 5, 10, 15)
            _quarter_round(working, 1, 6, 11, 12)
            _quarter_round(working, 2, 7, 8, 13)
            _quarter_round(working, 3, 4, 9, 14)
        return (working + state).astype(np.uint32)


def chacha8_stream_words(keys: np.ndarray, n_words: int) -> np.ndarray:
    """Vectorized ChaCha8 streams: (N, 8) uint32 keys -> (N, n_words) uint32.

    Each row is an independent ChaCha8Rng keyed by that row, zero nonce,
    counter starting at 0. Used to sample DRG parents for a whole layer of
    nodes at once (each node has its own seed).
    """
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    blocks = -(-n_words // 16)
    out = np.empty((n, blocks * 16), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for blk in range(blocks):
            state = np.zeros((16, n), dtype=np.uint32)
            state[0:4] = _CONSTANTS[:, None]
            state[4:12] = keys.T
            state[12] = blk
            working = state.copy()
            for _ in range(4):  # 8 rounds = 4 double rounds
                _quarter_round(working, 0, 4, 8, 12)
                _quarter_round(working, 1, 5, 9, 13)
                _quarter_round(working, 2, 6, 10, 14)
                _quarter_round(working, 3, 7, 11, 15)
                _quarter_round(working, 0, 5, 10, 15)
                _quarter_round(working, 1, 6, 11, 12)
                _quarter_round(working, 2, 7, 8, 13)
                _quarter_round(working, 3, 4, 9, 14)
            out[:, blk * 16 : (blk + 1) * 16] = (working + state).T
    return out[:, :n_words]


class ChaCha8Rng:
    """Word-stream RNG over ChaCha8 blocks."""

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self._key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        self._counter = 0
        self._buf: list[int] = []

    def _refill(self):
        block = chacha_block(self._key, self._counter)
        self._counter += 1
        self._buf.extend(int(w) for w in block)

    def next_u32(self) -> int:
        if not self._buf:
            self._refill()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)
