"""Vectorized host Fr arithmetic on [N, 16] uint64 arrays of 16-bit limbs.

Copied from crypto3_fil_proofs_tpu/ops/fr_vec.py (the CIOS recurrence
of the plain field layer, ops/field.py): batched Montgomery
multiplication for template-tiled gadget emission (zk/gadgets/*_vec.py)
and FieldBlock row evaluation, where per-element python-int math was
the 14k-constraints/s bottleneck of the PoSt circuits.

Everything stays in numpy uint64: 16-bit limbs keep every CIOS column
< 2^22 before normalization, so no Python bigints appear on the hot
path. Conversions to/from python ints batch through bytes.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .field import FR, LIMB_BITS, LIMB_MASK

N_LIMBS = FR.n16  # 16
_MASK = np.uint64(LIMB_MASK)
_SHIFT = np.uint64(LIMB_BITS)
_N0INV = np.uint64(FR.n0inv16)
_P = np.asarray(FR.p16, dtype=np.uint64)  # [16]
_P_INT = FR.modulus
_FOLD256 = None  # (2^256 mod p) limbs, lazily built
_R2 = None
_ONE = None


def to_v(values) -> np.ndarray:
    """list[int] (plain, < R) -> [N, 16] uint64 16-bit limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return (
        np.frombuffer(raw, dtype="<u2").astype(np.uint64).reshape(-1, N_LIMBS)
    )


def from_v(v: np.ndarray) -> list[int]:
    raw = np.ascontiguousarray(v.astype("<u2")).view(np.uint8).tobytes()
    return [
        int.from_bytes(raw[i : i + 32], "little")
        for i in range(0, len(raw), 32)
    ]


def _ge_p(x: np.ndarray) -> np.ndarray:
    """x >= p lexicographically, x [N, 16] canonical limbs."""
    res = np.ones(len(x), dtype=bool)
    decided = np.zeros(len(x), dtype=bool)
    for j in range(N_LIMBS - 1, -1, -1):
        gt = (~decided) & (x[:, j] > _P[j])
        lt = (~decided) & (x[:, j] < _P[j])
        res[lt] = False
        decided |= gt | lt
    return res


def _sub_p_masked(x: np.ndarray, mask: np.ndarray) -> None:
    """x[mask] -= p in place (mod 2^256; caller guarantees no net
    underflow, i.e. masked rows are >= p possibly via an implicit
    17th limb)."""
    borrow = np.zeros(len(x), dtype=np.uint64)
    for j in range(N_LIMBS):
        s = _P[j] + borrow
        d = (x[:, j] - s) & _MASK
        borrow = (x[:, j] < s).astype(np.uint64)
        x[:, j] = np.where(mask, d, x[:, j])


def _carry_normalize(wide: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, 16] u64 columns of arbitrary magnitude -> (canonical 16-bit
    limbs, overflow) where value = limbs + overflow * 2^256."""
    n = wide.shape[0]
    out = np.empty((n, N_LIMBS), dtype=np.uint64)
    carry = np.zeros(n, dtype=np.uint64)
    for j in range(N_LIMBS):
        v = wide[:, j] + carry
        out[:, j] = v & _MASK
        carry = v >> _SHIFT
    return out, carry


def _reduce_canonical(limbs: np.ndarray, overflow: np.ndarray) -> np.ndarray:
    """Full reduction mod p of limbs + overflow * 2^256 (overflow any
    u64 magnitude): fold the overflow through (2^256 mod p), then a
    conditional-subtract loop (executes <= a few times)."""
    global _FOLD256
    if _FOLD256 is None:
        _FOLD256 = to_v([(1 << 256) % _P_INT])[0]
    out = limbs
    while overflow.any():
        wide = out.astype(np.uint64) + overflow[:, None] * _FOLD256[None, :]
        out, overflow = _carry_normalize(wide)
    ge = _ge_p(out)
    while ge.any():
        _sub_p_masked(out, ge)
        ge = _ge_p(out)
    return out


# rows per pass of the CIOS loop: its ~200 array passes stay in the
# cache (16384 rows x 17 limbs x 8 B = 2.2 MB a temporary) where whole-
# array passes over a 512 MiB PoSt circuit's millions of terms stream
# from memory; the passes release the interpreter's lock, so the chunks
# run on every core (2^20 products on 8 cores: 0.9 s, against 13.9 s in
# one pass and 4.2 s in chunks on one thread); the pool is bounded by
# torch's intra-op thread count, so a caller that sets it (each test
# process sets 1) does not start a pool of every core
_ROWS = 16384


def mont_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """CIOS Montgomery product of [N, 16] u64 limb arrays (broadcasts
    [1, 16] against [N, 16]). Result canonical (< p)."""
    a, b = np.broadcast_arrays(a, b)
    n = a.shape[0]
    if n <= _ROWS:
        return _mont_mul_rows(a, b)
    out = np.empty((n, N_LIMBS), dtype=np.uint64)

    def chunk(lo: int) -> None:
        out[lo : lo + _ROWS] = _mont_mul_rows(a[lo : lo + _ROWS], b[lo : lo + _ROWS])

    workers = min(torch.get_num_threads(), -(-n // _ROWS))
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(chunk, range(0, n, _ROWS)))  # raises a chunk's exception
    return out


def _mont_mul_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = a.shape[0]
    t = np.zeros((n, N_LIMBS + 1), dtype=np.uint64)
    for i in range(N_LIMBS):
        bi = b[:, i : i + 1]
        prod = a * bi  # [N, 16] each < 2^32
        t0 = t[:, 0] + (prod[:, 0] & _MASK)
        m = (t0 * _N0INV) & _MASK
        q = m[:, None] * _P[None, :]
        lo = (prod & _MASK) + (q & _MASK)
        hi = (prod >> _SHIFT) + (q >> _SHIFT)
        t[:, :N_LIMBS] += lo
        t[:, 1 : N_LIMBS + 1] += hi
        carry = t[:, 0] >> _SHIFT
        t[:, :-1] = t[:, 1:]
        t[:, -1] = 0
        t[:, 0] += carry
    out, overflow = _carry_normalize(t[:, :N_LIMBS])
    # CIOS bound: value < 2p, so overflow (the 17th limb, 0 or 1) or
    # out >= p means exactly one subtraction of p lands in [0, p)
    ge = overflow.astype(bool) | _ge_p(out)
    _sub_p_masked(out, ge)
    return out


def _tables():
    global _R2, _ONE
    if _R2 is None:
        _R2 = to_v([FR.mont_r2])
        _ONE = to_v([1])
    return _R2, _ONE


def to_mont(a: np.ndarray) -> np.ndarray:
    r2, _ = _tables()
    return mont_mul(a, r2)


def from_mont(a: np.ndarray) -> np.ndarray:
    _, one = _tables()
    return mont_mul(a, one)


def mul_mod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain-form modular product: to_mont one side, CIOS the other."""
    return mont_mul(to_mont(a), b)


def add_mod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.broadcast_arrays(a, b)
    out, overflow = _carry_normalize(a.astype(np.uint64) + b)
    return _reduce_canonical(out, overflow)


def sum_mod_csr(terms: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Segment (CSR row) sums mod p of canonical [M, 16] limb terms.

    Per-limb u64 cumsums are exact for M < 2^48 rows; each row total is
    carry-normalized and the 2^256 residue folded back through
    (2^256 mod p)."""
    csum = np.zeros((len(terms) + 1, N_LIMBS), dtype=np.uint64)
    np.cumsum(terms, axis=0, out=csum[1:])
    seg = csum[indptr[1:]] - csum[indptr[:-1]]  # exact: sums are monotone
    out, overflow = _carry_normalize(seg)
    return _reduce_canonical(out, overflow)
