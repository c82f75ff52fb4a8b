"""Kernel K2 wrapper: the Poseidon permutation as a batched Merkle hash.

Replaces crypto3_fil_proofs_tpu/ops/pallas/poseidon.py `permute_soa`
(:594) / `permute_soa_mxu` (:548) behind `hash_level_packed` (:653); the
kernel is csrc/poseidon.cu. Preimages are int32 [B, arity, 8] Montgomery
elements; digests come back as [B, 8].

On CPU tensors the wrapper runs the plain version
(ops/poseidon_torch.py `hash_mont_plain`); on CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import poseidon_torch as PT
from . import build

# arities the kernel is instantiated for (state widths 3, 9, 12)
ARITIES = (2, 8, 11)

# launches per arity, counted where the kernel is launched
launches = {a: 0 for a in ARITIES}


def poseidon_hash(pre: torch.Tensor, arity: int) -> torch.Tensor:
    if pre.device.type == "cpu":
        return PT.hash_mont_plain(pre, arity)
    if not pre.is_cuda:
        raise ValueError(f"poseidon_hash: unsupported device {pre.device}")
    if arity not in ARITIES:
        raise ValueError(f"the Poseidon kernel is built for arities {ARITIES}, not {arity}")
    if pre.dtype != torch.int32 or pre.dim() != 3 or pre.shape[1:] != (arity, PT.L):
        raise ValueError(f"preimages must be int32 [B, {arity}, {PT.L}], got {pre.dtype} {tuple(pre.shape)}")
    pre = pre.contiguous()
    out = torch.empty((pre.shape[0], PT.L), dtype=torch.int32, device=pre.device)
    if pre.shape[0] == 0:
        return out
    consts = _consts(arity, str(pre.device))
    st = PT.staged(arity)
    err = _kernel()(
        pre.data_ptr(), out.data_ptr(), consts.data_ptr(), pre.shape[0],
        st.t, st.r_f, st.r_p, torch.cuda.current_stream(pre.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"poseidon_hash (arity {arity}) launch failed: cudaError {err}")
    build.count(launches, arity)
    return out


@lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/poseidon.cu, built at first use."""
    fn = build.load("poseidon").poseidon_hash
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _consts(arity: int, device: str) -> torch.Tensor:
    return PT.staged(arity, device).flat().contiguous()
