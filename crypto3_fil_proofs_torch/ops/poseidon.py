"""Poseidon hash over BLS12-381 Fr, host reference.

Copied from the JAX package's host module, cut to what the port's
protocols need: the constants of the protocol arities read from the
package's `poseidon_constants.npz` (Grain LFSR round constants, Cauchy
MDS, neptune round numbers; reference core/hasher/types.hpp:34-42), the
plain permutation, the sparse partial-round schedule that the device
kernel runs, `poseidon_hash`, `hash2`, `hash_md` (the arity-36
Merkle-Damgard fold of Election PoSt) and `column_hash`.

Merkle-tree domain tag = 2^arity - 1 in the first state element; the
digest is state[1] after one permutation. This module is the host
golden for the batched permutation (ops/poseidon_torch.py) and the
CUDA kernel (csrc/poseidon.cu).
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from .field import R

ALPHA = 5
POSEIDON_MD_ARITY = 36  # reference core/hasher/types.hpp:34-42


class PoseidonConstants:
    def __init__(self, arity: int, r_f: int, r_p: int, round_constants, mds):
        self.arity = arity
        self.t = arity + 1
        self.r_f, self.r_p = r_f, r_p
        self.round_constants = round_constants
        self.mds = mds
        # Merkle-tree domain tag (neptune HashType::MerkleTree)
        self.domain_tag = (1 << arity) - 1


_CONSTANTS_PATH = os.path.join(os.path.dirname(__file__), "poseidon_constants.npz")


@lru_cache(maxsize=None)
def poseidon_constants(arity: int) -> PoseidonConstants:
    """Constants for a protocol arity (2, 4, 8, 11 or 36), loaded from
    the package file."""
    key = f"a{arity}"
    with np.load(_CONSTANTS_PATH) as data:
        if f"{key}_rc" not in data:
            raise ValueError(f"no Poseidon constants for arity {arity}")
        r_f, r_p = (int(v) for v in data[f"{key}_rounds"])
        rc = [int.from_bytes(row.tobytes(), "little") for row in data[f"{key}_rc"]]
        mds_flat = [
            int.from_bytes(row.tobytes(), "little") for row in data[f"{key}_mds"]
        ]
    t = arity + 1
    mds = [mds_flat[i * t : (i + 1) * t] for i in range(t)]
    return PoseidonConstants(arity, r_f, r_p, rc, mds)


def permutation(state: list[int], consts: PoseidonConstants) -> list[int]:
    t, mds, rc = consts.t, consts.mds, consts.round_constants
    half_f = consts.r_f // 2
    s = [x % R for x in state]
    c = 0

    def mix(vec):
        return [sum(mds[i][j] * vec[j] for j in range(t)) % R for i in range(t)]

    for _ in range(half_f):
        s = [(x + rc[c + i]) % R for i, x in enumerate(s)]
        c += t
        s = [pow(x, ALPHA, R) for x in s]
        s = mix(s)
    for _ in range(consts.r_p):
        s = [(x + rc[c + i]) % R for i, x in enumerate(s)]
        c += t
        s[0] = pow(s[0], ALPHA, R)
        s = mix(s)
    for _ in range(half_f):
        s = [(x + rc[c + i]) % R for i, x in enumerate(s)]
        c += t
        s = [pow(x, ALPHA, R) for x in s]
        s = mix(s)
    return s


def _mat_inv_mod(m: list[list[int]]) -> list[list[int]]:
    """Inverse of a matrix mod R by Gauss-Jordan (t <= 37, exact ints)."""
    n = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % R != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], R - 2, R)
        a[col] = [(x * inv) % R for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % R for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_mul(a, b):
    n, k, m = len(a), len(b), len(b[0])
    return [
        [sum(a[i][x] * b[x][j] for x in range(k)) % R for j in range(m)]
        for i in range(n)
    ]


def _mat_vec(a, v):
    return [sum(a[i][j] * v[j] for j in range(len(v))) % R for i in range(len(a))]


@lru_cache(maxsize=None)
def optimized_partial_schedule(arity: int):
    """Sparse-MDS factorization of the partial-round chain (the standard
    Poseidon appendix-B optimization, as used by neptune for the GPU
    tree builders the reference consumes — stacked/vanilla/proof.hpp
    column/tree hashing). The P partial rounds x -> M.S(x + c_k) are
    rewritten as P sparse rounds x -> E_k.S(x + c'_k) followed by ONE
    dense mix D: each E_k has 2t-1 non-trivial entries
    ([[m00, v], [w_hat, I]]), so the per-round mix drops from t^2 to
    2t-1 field muls. Returns (c_prime[P][t], m00[P], v[P][t-1],
    w_hat[P][t-1], d_last[t][t]) as python ints mod R.

    Derivation: M = M'.M'' with M' = [[1,0],[0,Mhat]] and
    M'' = [[M00, v],[Mhat^-1 w, I]]; S commutes with M'-shaped maps
    after transforming the constants by Mhat^-1, so the dense residue
    M' is pushed left through the whole chain, re-decomposing
    N_k = M.D_{k-1} at each step. The batched permutation that runs
    this schedule is held against the plain `permutation` in
    tests/test_torch_poseidon.py."""
    consts = poseidon_constants(arity)
    t, mds, rc = consts.t, consts.mds, consts.round_constants
    half_f, P = consts.r_f // 2, consts.r_p
    # D_k = [[1, 0], [0, A^k]] with A = Mhat (the lower-right block of
    # M), since N_k = M.D_k has lower-right block A^(k+1): so round k's
    # constants are A^-k c, v = M[0][1:] A^k and w_hat = A^-(k+1) M[1:][0],
    # and one inversion of A serves every round
    a = [row[1:] for row in mds[1:]]
    a_inv = _mat_inv_mod(a)
    c_prime, m00s, vs, w_hats = [], [], [], []
    v = mds[0][1:]
    w_hat = [row[0] for row in mds[1:]]
    for k in range(P):
        c = rc[(half_f + k) * t : (half_f + k + 1) * t]
        rest = c[1:]
        for _ in range(k):
            rest = _mat_vec(a_inv, rest)
        c_prime.append([c[0]] + rest)
        m00s.append(mds[0][0])
        vs.append(v)
        w_hat = _mat_vec(a_inv, w_hat)
        w_hats.append(w_hat)
        v = [sum(v[x] * a[x][j] for x in range(t - 1)) % R for j in range(t - 1)]
    a_pow, base, e = [[int(i == j) for j in range(t - 1)] for i in range(t - 1)], a, P
    while e:
        if e & 1:
            a_pow = _mat_mul(a_pow, base)
        base = _mat_mul(base, base)
        e >>= 1
    d = [[1] + [0] * (t - 1)] + [[0] + row for row in a_pow]
    return c_prime, m00s, vs, w_hats, d


def poseidon_hash(preimage: list[int], arity: int | None = None) -> int:
    """Hash `arity` field elements to one (Merkle-tree domain tag)."""
    if arity is None:
        arity = len(preimage)
    if len(preimage) != arity:
        raise ValueError(f"preimage length {len(preimage)} != arity {arity}")
    consts = poseidon_constants(arity)
    state = [consts.domain_tag] + [x % R for x in preimage]
    return permutation(state, consts)[1]


def hash2(a: int, b: int) -> int:
    """Poseidon-2 of two elements; used for comm_r = H(comm_c, comm_r_last)
    (reference: .../stacked/vanilla/proof.hpp:943-945)."""
    return poseidon_hash([a, b], 2)


def hash_md(elements: list[int]) -> int:
    """Merkle-Damgard style fold with the MD-arity constants.

    Mirrors rust-fil-proofs PoseidonFunction::hash_md (consumed by the
    reference's election PoSt partial_ticket,
    post/election/vanilla.hpp `hash_md` over PoseidonMDArity): the
    accumulator and the next 35 elements, zero-padded, hash to the next
    accumulator; one element passes through unhashed.
    """
    arity = POSEIDON_MD_ARITY
    if len(elements) == 1:
        return elements[0] % R
    acc = elements[0] % R
    for chunk_start in range(1, len(elements), arity - 1):
        chunk = elements[chunk_start : chunk_start + arity - 1]
        preimage = [acc] + [x % R for x in chunk]
        preimage += [0] * (arity - len(preimage))
        acc = poseidon_hash(preimage, arity)
    return acc


def column_hash(rows: list[int]) -> int:
    """Hash a column of per-layer labels (reference:
    .../stacked/vanilla/hash.hpp:37-52 — Poseidon over `layers` elements
    with arity = layer count, e.g. 2 for test sizes, 11 for 32GiB)."""
    return poseidon_hash(rows, len(rows))
