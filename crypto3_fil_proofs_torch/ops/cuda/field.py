"""Kernel K1 wrapper: elementwise Montgomery product over Fr and Fq,
and the elementwise Fr subtraction of the Groth16 h pipeline.

Replaces crypto3_fil_proofs_tpu/ops/pallas/field.py `fr_montmul_soa` /
`fq_montmul_soa` (:95-128) and, on the h path, ops/pallas/ntt.py
`fr_mul_soa` (:424, K3m) and `_sub_soa` (:667); the kernels are
csrc/field.cu. Elements are in the port's working form, int32 [N, 8]
(Fr) or [N, 12] (Fq).

On CPU tensors the wrapper runs the plain version (ops/field.py); on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import field as F
from . import build

# launches of each kernel, counted where the kernel is launched
launches = {"fr_montmul": 0, "fq_montmul": 0, "fr_sub": 0}


@lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point `name` of csrc/field.cu, built at first use."""
    fn = getattr(build.load("field"), name)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def montmul(a: torch.Tensor, b: torch.Tensor, field: F.Field = F.FR, out: torch.Tensor | None = None) -> torch.Tensor:
    """a * b * R^-1 mod p. a: int32 [N, n32]; b: int32 [N, n32], or one
    element [n32] that every row of a is multiplied by. Into `out` where
    given (contiguous, of a's shape; a itself for a product in place)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        r = F.mont_mul32(a, b, field)
        return r if out is None else out.copy_(r)
    n32 = field.n32
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("montmul: a and b must lie on one CUDA device")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("montmul takes int32 limb tensors")
    if a.dim() != 2 or a.shape[1] != n32:
        raise ValueError(f"a must be [N, {n32}], got {tuple(a.shape)}")
    broadcast = b.dim() == 1
    if broadcast:
        if b.shape[0] != n32:
            raise ValueError(f"b must be [{n32}] or [N, {n32}], got {tuple(b.shape)}")
    elif b.shape != a.shape:
        raise ValueError(f"b must be [{n32}] or {tuple(a.shape)}, got {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    if out is None:
        out = torch.empty_like(a)
    elif out.shape != a.shape or out.dtype != a.dtype or out.device != a.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous int32 {tuple(a.shape)} on {a.device}")
    if a.shape[0] == 0:
        return out
    name = "fr_montmul" if field is F.FR else "fq_montmul"
    err = _kernel(name)(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], int(broadcast),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    build.count(launches, name)
    return out


@lru_cache(maxsize=None)
def _sub_kernel():
    fn = build.load("field").fr_sub
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod r, elementwise over int32 [N, 8] Fr elements."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return F.sub32(a, b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("sub: a and b must lie on one CUDA device")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("sub takes int32 limb tensors")
    if a.dim() != 2 or a.shape[1] != F.FR.n32 or b.shape != a.shape:
        raise ValueError(f"a and b must both be [N, {F.FR.n32}], got {tuple(a.shape)}, {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    err = _sub_kernel()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fr_sub launch failed: cudaError {err}")
    build.count(launches, "fr_sub")
    return out


@lru_cache(maxsize=None)
def _const(value: int, field: F.Field, device: str) -> torch.Tensor:
    return F.ints_to_limbs32([value], field)[0].to(device)


def to_mont(x: torch.Tensor, field: F.Field = F.FR) -> torch.Tensor:
    """Canonical -> Montgomery form (x * R^2 * R^-1)."""
    return montmul(x, _const(field.mont_r2, field, str(x.device)), field)


def from_mont(x: torch.Tensor, field: F.Field = F.FR) -> torch.Tensor:
    """Montgomery -> canonical form (x * 1 * R^-1)."""
    return montmul(x, _const(1, field, str(x.device)), field)
