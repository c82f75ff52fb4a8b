"""Fixed-base batch scalar multiplication and batch normalisation: the
device work of Groth16 setup.

Counterpart of crypto3_fil_proofs_tpu/zk/groth16.py `_window_table`
(:147) and the fixed-base batches (:174-320: `_fixed_base_g1_run`,
`_fixed_base_g2_run`, `batch_fixed_base_g{1,2}_staged`), and of the
batch normalisation they stage through (ops/g1_jax.py:234
`normalize_batch`, ops/g2_jax.py:236).

- `window_table`: [d * 16^k * G for k < 64, d < 16] on the host, in the
  working form (affine int32, Montgomery; d = 0 is infinity, staged as
  0, 0 and never added).
- `fixed_base`: [s_i * G] for int32 [N, 8] canonical scalars, in chunks.
  A chunk runs 64 steps: gather table row k at each lane's digit d_k
  (torch indexing), then one K4 (G1) or K5 (G2) `madd_nodbl` launch with
  valid = d_k != 0. The doubling path is never needed: after step k the
  accumulator is a G with a < 16^k, the point added is b G with
  16^k <= b <= 15 * 16^k, and a + b <= s < r, so a != +-b mod r. Every
  chunk checks that no lane raised `same`.
- `normalize`: Jacobian -> (affine, valid) in the key's staging
  (infinity as 0, 0). On a CUDA tensor every Fq product (the prefix and
  suffix scans of the batch inverse, Z^-2, Z^-3, and for G2 the
  Karatsuba products and the norm of Fq2) is a K1 `fq_montmul` launch;
  one host inversion per chunk. On a CPU tensor it is the plain
  `Curve.normalize`.

`plain=True` runs the plain point formulas and `Curve.normalize` on any
device: the plain version the smoke run holds the kernels against.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from . import field as F
from .bls12_381 import G1_GEN, G1_INF, G2_GEN_X, G2_GEN_Y, G2_INF, g1_add, g1_from_affine, g2_add, g2_from_affine
from .cuda import field as k1
from .cuda import g1 as k4
from .cuda import g2 as k5
from .g1_torch import G1, Curve
from .g2_torch import G2

FQ = F.FQ
WINDOWS = 64  # 4-bit windows of a 256-bit scalar
CHUNK = {"g1": 1 << 21, "g2": 1 << 20}  # lanes per chunk


@lru_cache(maxsize=None)
def _host_table(name: str) -> list:
    """[d * 16^k * G for k < 64, d < 16] as host points, row-major."""
    if name == "g1":
        gen, add, inf = g1_from_affine(G1_GEN), g1_add, G1_INF
    else:
        gen, add, inf = g2_from_affine((G2_GEN_X, G2_GEN_Y)), g2_add, G2_INF
    flat, p = [], gen
    for _ in range(WINDOWS):
        cur = inf
        flat.append(inf)
        for _ in range(15):
            cur = add(cur, p)
            flat.append(cur)
        for _ in range(4):
            p = add(p, p)
    return flat


@lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
    curve = G1 if name == "g1" else G2
    aff, _ = curve.points_to_device(_host_table(name))
    return aff.reshape((WINDOWS, 16, 2) + curve.coord).to(device)


def window_table(curve: Curve, device) -> torch.Tensor:
    """The window table int32 [64, 16, 2, *coord] on `device`."""
    return _table(curve.name, str(torch.device(device)))


def digit(scalars: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th 4-bit digit of int32 [N, 8] scalars (bits 4k .. 4k + 3)."""
    return ((scalars[:, k // 8] >> (4 * (k % 8))) & 0xF).long()


def _run_chunk(curve: Curve, table: torch.Tensor, scalars: torch.Tensor, plain: bool) -> torch.Tensor:
    n = scalars.shape[0]
    madd = curve.madd_nodbl_plain if plain else (k4.madd_nodbl if curve is G1 else k5.madd_nodbl)
    acc = curve.infinity(n, scalars.device)
    met = torch.zeros(n, dtype=torch.bool, device=scalars.device)
    for k in range(WINDOWS):
        d = digit(scalars, k)
        acc, same = madd(acc, table[k][d].contiguous(), d != 0)
        met |= same
    if bool(met.any()):
        raise AssertionError("fixed-base: a lane met P == +-Q, which a canonical scalar never gives")
    return acc


def fixed_base(curve: Curve, scalars: torch.Tensor, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[s_i * G] for int32 [N, 8] canonical scalars, on their device, as
    (affine int32 [N, 2, *coord] Montgomery, valid [N] bool)."""
    table = window_table(curve, scalars.device)
    chunk = CHUNK[curve.name]
    n = scalars.shape[0]
    aff = torch.empty((n, 2) + curve.coord, dtype=torch.int32, device=scalars.device)
    valid = torch.empty(n, dtype=torch.bool, device=scalars.device)
    for lo in range(0, n, chunk):
        acc = _run_chunk(curve, table, scalars[lo : lo + chunk], plain)
        aff[lo : lo + chunk], valid[lo : lo + chunk] = curve.normalize(acc) if plain else normalize(curve, acc)
    return aff, valid


def host_points(curve: Curve, aff: torch.Tensor, valid: torch.Tensor) -> list:
    """Host Jacobian points (Z = 1, infinity as the host's) of a staged
    batch."""
    pts = curve.points_from_device(curve.lift(aff))
    return [p if ok else curve.host_inf for p, ok in zip(pts, valid.tolist())]


# ---------------------------------------------------------------------------
# Normalisation with the Fq products on K1
# ---------------------------------------------------------------------------


class Fq32:
    """Fq in the working form, int32 [..., 12]: products on K1, the rest
    elementwise torch ops."""

    @staticmethod
    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return k1.montmul(a.reshape(-1, FQ.n32), b.reshape(-1, FQ.n32), FQ).reshape(a.shape)

    @staticmethod
    def add(a, b):
        return F.to_limbs32(F.add(F.to_limbs16(a), F.to_limbs16(b), FQ))

    @staticmethod
    def sub(a, b):
        return F.to_limbs32(F.sub(F.to_limbs16(a), F.to_limbs16(b), FQ))

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def sel(cond, a, b):
        return torch.where(cond[..., None], a, b)

    @staticmethod
    def one_like(a):
        return G1.one.to(a.device).expand(a.shape)

    @staticmethod
    def inv_pieces(a):
        return a, None

    @staticmethod
    def scale(c, n_inv):
        return n_inv


class Fq2_32:
    """Fq2 in the working form, int32 [..., 2, 12]: Karatsuba over one
    K1 launch of three Fq products."""

    @staticmethod
    def mul(a, b):
        a0, a1, b0, b1 = torch.broadcast_tensors(a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :])
        t0, t1, t2 = Fq32.mul(torch.stack([a0, a1, Fq32.add(a0, a1)]), torch.stack([b0, b1, Fq32.add(b0, b1)]))
        return torch.stack([Fq32.sub(t0, t1), Fq32.sub(t2, Fq32.add(t0, t1))], dim=-2)

    add = staticmethod(Fq32.add)
    sub = staticmethod(Fq32.sub)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def sel(cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    @staticmethod
    def one_like(a):
        return G2.one.to(a.device).expand(a.shape)

    @staticmethod
    def inv_pieces(a):
        """(n, c) with a^-1 = c * n^-1: n = a0^2 + a1^2 in Fq, c = conj(a)."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        sq = Fq32.mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
        conj = torch.stack([a0, Fq32.sub(torch.zeros_like(a1), a1)], dim=-2)
        return Fq32.add(sq[0], sq[1]), conj

    @staticmethod
    def scale(c, n_inv):
        return Fq32.mul(c, n_inv.unsqueeze(-2))


def batch_inverse(d: torch.Tensor) -> torch.Tensor:
    """Inverses of nonzero Fq elements int32 [N, 12] (Montgomery):
    inclusive prefix and suffix products by log-depth scans, one host
    inversion of the total (ops/g1_torch.py `batch_inverse` in the
    working form)."""
    n = d.shape[0]
    one = Fq32.one_like(d[:1])
    pre, suf, k = d, d, 1
    while k < n:
        pre = torch.cat([pre[:k], Fq32.mul(pre[k:], pre[:-k])])
        suf = torch.cat([Fq32.mul(suf[:-k], suf[k:]), suf[-k:]])
        k *= 2
    total = F.limbs32_to_ints(pre[-1:])[0]  # T R mod p
    inv_total = F.ints_to_limbs32([pow(total, -1, FQ.modulus) * FQ.mont_r * FQ.mont_r % FQ.modulus], FQ)
    before = torch.cat([one, pre[:-1]])
    after = torch.cat([suf[1:], one])
    return Fq32.mul(Fq32.mul(before, after), inv_total.to(d.device))


def normalize(curve: Curve, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Jacobian [N, 3, *coord] -> (affine [N, 2, *coord], valid [N]),
    infinity as 0, 0. CPU tensors run the plain `Curve.normalize`."""
    if p.device.type == "cpu":
        return curve.normalize(p)
    if not p.is_cuda:
        raise ValueError(f"normalize: unsupported device {p.device}")
    return normalize_k1(curve, p)


def normalize_k1(curve: Curve, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of `normalize` over the K1 wrapper (which runs its plain
    version on CPU tensors)."""
    f = Fq32 if curve is G1 else Fq2_32
    if p.shape[0] == 0:
        return p[:, :2].clone(), torch.zeros(0, dtype=torch.bool, device=p.device)
    X, Y, Z = p[:, 0], p[:, 1], p[:, 2]
    valid = ~f.is_zero(Z)
    z = f.sel(valid, Z, f.one_like(Z))
    norm, conj = f.inv_pieces(z)
    zinv = f.scale(conj, batch_inverse(norm))
    zinv2 = f.mul(zinv, zinv)
    x, y = f.mul(X, zinv2), f.mul(Y, f.mul(zinv2, zinv))
    zero = torch.zeros_like(x)
    return torch.stack([f.sel(valid, x, zero), f.sel(valid, y, zero)], dim=1), valid
