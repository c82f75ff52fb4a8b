"""BLS12-381 G2 in Jacobian coordinates over Fq2 on tensors: the plain
versions of kernel K5.

Counterpart of crypto3_fil_proofs_tpu/ops/g2_jax.py and of the kernel
bodies of ops/pallas/g2.py. The formulas and edge semantics are those of
ops/g1_torch.py, over Fq2 = Fq[u] / (u^2 + 1): an element is int64
[..., 2, 24] (c0, c1) on the plain path and int32 [..., 2, 12] in the
working form, so a point is [N, 2, 2, 12] (affine) or [N, 3, 2, 12]
(Jacobian).
"""
from __future__ import annotations

import torch

from . import bls12_381 as B
from . import field as F
from .g1_torch import Curve, FqOps


class Fq2Ops:
    """Plain Fq2 on int64 [..., 2, 24]."""

    @staticmethod
    def mul(a, b):
        """Karatsuba: three Fq products, taken in one batched call."""
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        a0, a1, b0, b1 = torch.broadcast_tensors(a0, a1, b0, b1)
        t0, t1, t2 = FqOps.mul(
            torch.stack([a0, a1, FqOps.add(a0, a1)]), torch.stack([b0, b1, FqOps.add(b0, b1)])
        )
        return torch.stack([FqOps.sub(t0, t1), FqOps.sub(t2, FqOps.add(t0, t1))], dim=-2)

    @staticmethod
    def add(a, b):
        return FqOps.add(a, b)

    @staticmethod
    def sub(a, b):
        return FqOps.sub(a, b)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def sel(cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    @staticmethod
    def one_like(a):
        c0 = FqOps.one_like(a[..., 0, :])
        return torch.stack([c0, torch.zeros_like(c0)], dim=-2)

    @staticmethod
    def inv_pieces(a):
        """(n, c) with a^-1 = c * n^-1: n = a0^2 + a1^2 in Fq, c = conj(a)."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        sq = FqOps.mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
        conj = torch.stack([a0, FqOps.sub(torch.zeros_like(a1), a1)], dim=-2)
        return FqOps.add(sq[0], sq[1]), conj

    @staticmethod
    def scale(c, n_inv):
        return FqOps.mul(c, n_inv.unsqueeze(-2))


G2 = Curve(
    name="g2",
    f=Fq2Ops,
    coord=(2, F.FQ.n32),
    host_add=B.g2_add,
    host_double=B.g2_double,
    host_inf=B.G2_INF,
    encode=lambda c: [c[0], c[1]],
    decode=lambda vs: (vs[0], vs[1]),
)
