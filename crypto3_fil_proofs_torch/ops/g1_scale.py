"""One scalar times many G1 points: the query rescaling of the phase-2
ceremony.

Counterpart of crypto3_fil_proofs_tpu/cli/phase2.py `_batch_scale_g1_query`
(:84-98), which decodes every point of a staged query and runs a host
`g1_mul((x, y, 1), k)` on each. Here the points stay in the working form
(affine int32 [N, 2, 12], Montgomery, ops/g1_torch.py) and the scalar's
bits are taken from the top, on every lane at once:

- the accumulator starts at each valid lane's point (Z = 1) and at
  infinity on the others;
- for each lower bit: one doubling of every lane (K4 `dbl`), and where
  the bit is set one mixed add of the lane's point (K4 `g1_madd`, whose
  doubling path takes the lanes where the accumulator meets the point;
  a lane at infinity lifts the point, P == -P gives infinity, and an
  invalid lane keeps its infinity);
- the result is normalised with its Fq products on K1 (ops/fixed_base.py
  `normalize_k1`): affine, and infinity staged as (0, 0) with valid = 0,
  as `_stage_g1` stages the host's (1, 1, 0).

k = 0 mod r gives every lane infinity, as `g1_mul` does. The lanes run in
chunks of `CHUNK` on the device (the accumulator is 144 bytes a lane);
the result lies where the input lies.

`plain=True` (and any call with device="cpu") runs the plain version:
the same bit loop over ops/g1_torch.py `double` and `madd_nodbl` with the
doubling of the P == Q lanes, in int64 16-bit limbs, then
`Curve.normalize`. Nothing on the CUDA path calls it; tests and the smoke
run hold the kernels against it.
"""
from __future__ import annotations

import torch

from ..api.seal import check_device
from . import field as F
from .bls12_381 import R
from .cuda import g1 as k4
from .fixed_base import normalize_k1
from .g1_torch import G1, FqOps, double, madd_nodbl

CHUNK = 1 << 22  # lanes per device pass


def _ladder_k4(q: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    acc = torch.where(valid[:, None, None], G1.lift(q), G1.infinity(q.shape[0], q.device))
    for i in range(k.bit_length() - 2, -1, -1):
        acc = k4.dbl(acc, valid)
        if (k >> i) & 1:
            acc = k4.madd(acc, q, valid)
    return acc


@torch.inference_mode()  # the loop's many small ops, without autograd's bookkeeping
def _ladder_plain(q: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    f, sel = FqOps, FqOps.sel
    x2, y2 = F.to_limbs16(q[:, 0]), F.to_limbs16(q[:, 1])
    inf = G1.infinity(q.shape[0], q.device)
    X, Y, Z = (sel(valid, c, F.to_limbs16(inf[:, j])) for j, c in enumerate((x2, y2, f.one_like(x2))))
    for i in range(k.bit_length() - 2, -1, -1):
        X, Y, Z = double(f, X, Y, Z)
        if (k >> i) & 1:
            X, Y, Z, same = madd_nodbl(f, X, Y, Z, x2, y2, valid)
            if bool(same.any()):
                dX, dY, dZ = double(f, X, Y, Z)
                X, Y, Z = sel(same, dX, X), sel(same, dY, Y), sel(same, dZ, Z)
    return torch.stack([F.to_limbs32(c) for c in (X, Y, Z)], dim=1)


def scale_g1(px: torch.Tensor, py: torch.Tensor, valid: torch.Tensor, k: int, device="cuda",
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[k * P_i] for a staged G1 query (px, py int32 [N, 12] Montgomery,
    valid bool [N]), as (affine int32 [N, 2, 12], valid [N]) in the
    query's staging, on the device of px; the work runs on `device`."""
    dev = check_device(device)
    plain = plain or dev.type == "cpu"
    n = px.shape[0]
    out = torch.zeros((n, 2, F.FQ.n32), dtype=torch.int32, device=px.device)
    out_valid = torch.zeros(n, dtype=torch.bool, device=px.device)
    k %= R
    if k == 0:
        return out, out_valid
    for lo in range(0, n, CHUNK):
        q = torch.stack([px[lo : lo + CHUNK], py[lo : lo + CHUNK]], dim=1).to(dev)
        ok = valid[lo : lo + CHUNK].to(dev)
        if plain:
            aff, v = G1.normalize(_ladder_plain(q, ok, k))
        else:
            aff, v = normalize_k1(G1, _ladder_k4(q, ok, k))
        out[lo : lo + CHUNK], out_valid[lo : lo + CHUNK] = aff.to(px.device), v.to(px.device)
    return out, out_valid
