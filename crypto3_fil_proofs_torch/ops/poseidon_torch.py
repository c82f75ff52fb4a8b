"""Batched Poseidon over BLS12-381 Fr on tensors.

Counterpart of crypto3_fil_proofs_tpu/ops/poseidon_jax.py (batched
permutation, `hash_level_mont`, `bytes_to_mont` / `mont_to_bytes`) and
of the constant staging of ops/pallas/poseidon.py (`_staged` :315).

- `staged(arity, device)`: the constants in Montgomery form as the
  kernel runs them: rc with the partial-round rows replaced by c', the
  dense MDS, the sparse rows [m00, v..., w_hat...], d_last and the
  domain tag.
- `hash_mont_plain`: the plain batched permutation on int64 16-bit
  limbs, the plain version of kernel K2 (csrc/poseidon.cu).
- `witness_plain`: the same permutation recording x^2, x^4 and x^5 of
  every S-box, then the digest, in plain form: the plain version of
  kernel K7 (csrc/poseidon_witness.cu), the circuits' witness replay.
- `hash_level`, `bytes_to_mont`, `mont_to_bytes`: whole Merkle levels,
  through the kernel wrappers, so a CUDA tensor runs K1 and K2 and a CPU
  tensor their plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import field as F
from .cuda import field as k1
from .poseidon import optimized_partial_schedule, poseidon_constants

FR = F.FR
L = FR.n32  # 8 limbs of 32 bits


@dataclass(frozen=True)
class Staged:
    """Montgomery constants of one arity, int32 [..., 8] limb tensors."""

    arity: int
    r_f: int
    r_p: int
    rc: torch.Tensor  # [r_f + r_p, t, 8]; partial rows hold c'
    mds: torch.Tensor  # [t, t, 8]
    sp: torch.Tensor  # [r_p, 2t - 1, 8]: m00, v_0..v_{t-2}, w_0..w_{t-2}
    dl: torch.Tensor  # [t, t, 8]
    tag: torch.Tensor  # [8]

    @property
    def t(self) -> int:
        return self.arity + 1

    def flat(self) -> torch.Tensor:
        """One buffer [rc | mds | sp | dl | tag], the kernel's layout."""
        return torch.cat(
            [x.reshape(-1) for x in (self.rc, self.mds, self.sp, self.dl, self.tag)]
        )

    def to(self, device) -> "Staged":
        return Staged(
            self.arity, self.r_f, self.r_p,
            *(x.to(device) for x in (self.rc, self.mds, self.sp, self.dl, self.tag)),
        )


def _mont(values) -> torch.Tensor:
    return F.ints_to_limbs32([(v * FR.mont_r) % FR.modulus for v in values])


@lru_cache(maxsize=None)
def _staged_cpu(arity: int) -> Staged:
    c = poseidon_constants(arity)
    t, rounds, half = c.t, c.r_f + c.r_p, c.r_f // 2
    c_prime, m00s, vs, w_hats, d_last = optimized_partial_schedule(arity)
    rc = list(c.round_constants)
    rc[half * t : (half + c.r_p) * t] = [x for row in c_prime for x in row]
    sp = [
        x for k in range(c.r_p) for x in ([m00s[k]] + list(vs[k]) + list(w_hats[k]))
    ]
    return Staged(
        arity=arity,
        r_f=c.r_f,
        r_p=c.r_p,
        rc=_mont(rc).reshape(rounds, t, L),
        mds=_mont([v for row in c.mds for v in row]).reshape(t, t, L),
        sp=_mont(sp).reshape(c.r_p, 2 * t - 1, L),
        dl=_mont([v for row in d_last for v in row]).reshape(t, t, L),
        tag=_mont([c.domain_tag])[0],
    )


@lru_cache(maxsize=None)
def _staged_on(arity: int, device: str) -> Staged:
    return _staged_cpu(arity).to(device)


def staged(arity: int, device="cpu") -> Staged:
    return _staged_on(arity, str(torch.device(device)))


def from_jax_staged(rc, mds, sp, dl, tag) -> Staged:
    """The numpy arrays of the JAX package's `_staged(arity)`
    (ops/pallas/poseidon.py:315, [..., 16] u32 of 16-bit limbs) as the
    port's staged constants."""
    t = np.asarray(rc).shape[1]
    r_p = np.asarray(sp).shape[0]
    rounds = np.asarray(rc).shape[0]
    return Staged(
        arity=t - 1,
        r_f=rounds - r_p,
        r_p=r_p,
        rc=F.from_jax_limbs(rc),
        mds=F.from_jax_limbs(mds),
        sp=F.from_jax_limbs(sp),
        dl=F.from_jax_limbs(dl),
        tag=F.from_jax_limbs(tag),
    )


# ---------------------------------------------------------------------------
# Plain permutation (int64 16-bit limbs; the plain version of K2)
# ---------------------------------------------------------------------------


def _sbox(x: torch.Tensor, record: list | None = None) -> torch.Tensor:
    """x^5 of x [B, n, 16]; where `record` is a list, [B, n, 3, 16] of
    (x^2, x^4, x^5) is appended to it."""
    x2 = F.mont_mul(x, x)
    x4 = F.mont_mul(x2, x2)
    x5 = F.mont_mul(x4, x)
    if record is not None:
        record.append(torch.stack([x2, x4, x5], dim=2))
    return x5


def _mix(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """s [B, t, n] -> M s with M [t, t, n]."""
    return F.mod_sum(F.mont_mul(m.unsqueeze(0), s.unsqueeze(1)), dim=2)


def permute_plain(s: torch.Tensor, st: Staged, record: list | None = None) -> torch.Tensor:
    """The sparse-schedule permutation of states s [B, t, 16] (int64
    16-bit Montgomery limbs); equals the host `permutation`. Where
    `record` is a list, each round appends its S-boxes' (x^2, x^4, x^5),
    [B, t or 1, 3, 16], in the order of the circuit's allocations."""
    rc, mds, sp, dl = (F.to_limbs16(x.to(s.device)) for x in (st.rc, st.mds, st.sp, st.dl))
    t, half = st.t, st.r_f // 2

    def full(s, r):
        return _mix(_sbox(F.add(s, rc[r]), record), mds)

    for r in range(half):
        s = full(s, r)
    for k in range(st.r_p):
        s = F.add(s, rc[half + k])
        x0 = _sbox(s[:, :1], record)
        # one product call: [x0, s_1..] by [m00, v..] and x0 by w_hat
        prods = F.mont_mul(torch.cat([x0, s[:, 1:], x0.expand(-1, t - 1, -1)], dim=1), sp[k].unsqueeze(0))
        out0 = F.mod_sum(prods[:, :t], dim=1)
        rest = F.add(prods[:, t:], s[:, 1:])
        s = torch.cat([out0.unsqueeze(1), rest], dim=1)
    s = _mix(s, dl)
    for r in range(half + st.r_p, st.r_f + st.r_p):
        s = full(s, r)
    return s


def hash_mont_plain(pre: torch.Tensor, arity: int) -> torch.Tensor:
    """Plain version of K2: preimages int32 [B, arity, 8] Montgomery ->
    digests [B, 8] (domain tag in state[0], digest = state[1])."""
    st = staged(arity, pre.device)
    tag = st.tag.expand(pre.shape[0], 1, L)
    states = F.to_limbs16(torch.cat([tag, pre], dim=1))
    return F.to_limbs32(permute_plain(states, st)[:, 1])


def witness_len(arity: int) -> int:
    """Values per instance of the witness replay: (x^2, x^4, x^5) of every
    S-box, R_F t full-round and R_P partial-round ones, then the digest."""
    st = staged(arity)
    return 3 * (st.r_f * st.t + st.r_p) + 1


def witness_plain(pre: torch.Tensor, arity: int) -> torch.Tensor:
    """Plain version of K7: preimages int32 [B, arity, 8] Montgomery ->
    int32 [B, n_int, 8] in plain form: every S-box's x^2, x^4, x^5 in the
    Poseidon gadget's allocation order, then the digest (state[1])."""
    st = staged(arity, pre.device)
    tag = st.tag.expand(pre.shape[0], 1, L)
    states = F.to_limbs16(torch.cat([tag, pre], dim=1))
    record = []
    digest = permute_plain(states, st, record)[:, 1:2]
    values = torch.cat([r.flatten(1, 2) for r in record] + [digest], dim=1)
    return F.to_limbs32(F.from_mont(values))


# ---------------------------------------------------------------------------
# Levels: through the kernel wrappers
# ---------------------------------------------------------------------------


def hash_level(nodes: torch.Tensor, arity: int) -> torch.Tensor:
    """[N, 8] Montgomery nodes -> [N / arity, 8] parents."""
    from .cuda.poseidon import poseidon_hash

    n = nodes.shape[0]
    if n % arity:
        raise ValueError(f"{n} nodes do not split into groups of {arity}")
    return poseidon_hash(nodes.reshape(n // arity, arity, L), arity)


def bytes_to_mont(nodes_u8: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 canonical LE elements -> [N, 8] Montgomery."""
    return k1.to_mont(F.bytes_to_limbs32(nodes_u8))


def mont_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[N, 8] Montgomery -> (N, 32) uint8 canonical LE elements."""
    return F.limbs32_to_bytes(k1.from_mont(x))
