"""Kernel K5 wrapper: G2 point operations over lanes (csrc/g2.cu).

Replaces crypto3_fil_proofs_tpu/ops/pallas/g2.py `madd_nodbl_soa`
(:486), `dbl_soa` (:511) and `add_soa` (:533). The entry points are
those of ops/cuda/g1.py over G2 points, int32 [N, 2|3, 2, 12]: on CPU
tensors they run the plain versions (ops/g2_torch.py), on CUDA tensors
they launch the kernels (two threads per lane, csrc/curve_pair.cuh) or
raise.
"""
from __future__ import annotations

from ..g2_torch import G2
from .g1 import PointKernels

K5 = PointKernels(G2, "g2")
launches = K5.launches
madd_nodbl = K5.madd_nodbl
dbl = K5.dbl
add = K5.add
