"""Kernel K3 wrapper: the Fr NTT on the card, and the Groth16 h pipeline.

Replaces crypto3_fil_proofs_tpu/ops/pallas/ntt.py (the stage kernels at
:264, :290 and :315, and `h_pipeline` :637); the kernel is csrc/ntt.cu.
Vectors are int32 [n, 8] Fr elements in Montgomery form; `transform`
also takes a batch, int32 [batch, n, 8]: rows of at most 2^12 elements
go to K3b (csrc/ntt_rows.cu, each row whole in one block's shared
memory, one launch for the batch), longer rows to K3's passes, one
launch a pass for all rows.

`transform` runs the plain version (ops/ntt.py `transform_plain`) on a
CPU tensor and launches the kernel, or raises, for a CUDA tensor. The
elementwise products and the subtraction around it go through K1
(ops/cuda/field.py), so every function here runs on either device.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import field as F
from .. import ntt as N
from . import build
from . import field as k1

# launches of the pass kernel (K3) and of the row kernel (K3b), counted
# where each is launched
launches = {"ntt": 0, "ntt_rows": 0}

# stages one pass keeps in shared memory (2^10 elements, 32 KB)
MAX_PASS_STAGES = 10

# K3b: rows of at most 2^12 elements (128 KB of shared memory)
ROWS_MAX_LOG_N = 12


@lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ntt").ntt_pass
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _rows_kernel():
    fn = build.load("ntt_rows").ntt_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def passes(log_n: int) -> list[tuple[int, int]]:
    """(first stage, stage count) of each pass: as few passes as the
    shared-memory limit allows, their lengths as even as possible."""
    k = -(-log_n // MAX_PASS_STAGES)
    out, s0 = [], 0
    for i in range(k):
        cnt = (log_n - s0) // (k - i)
        out.append((s0, cnt))
        s0 += cnt
    return out


# rows of one batched launch (the grid's y dimension)
MAX_BATCH = 65535


def transform(x: torch.Tensor, log_n: int, inverse: bool = False) -> torch.Tensor:
    """Unscaled transform (ops/ntt.py `transform_plain`) of int32 [n, 8],
    or of each row of int32 [batch, n, 8]."""
    if x.device.type == "cpu":
        return N.transform_plain(x, log_n, inverse)
    if not x.is_cuda:
        raise ValueError(f"transform: unsupported device {x.device}")
    n = 1 << log_n
    if x.dtype != torch.int32 or x.dim() not in (2, 3) or x.shape[-2:] != (n, F.FR.n32):
        raise ValueError(f"expected int32 [{n}, {F.FR.n32}] or [batch, {n}, {F.FR.n32}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.dim() == 3 and log_n > ROWS_MAX_LOG_N and x.shape[0] > MAX_BATCH:
        raise ValueError(f"a batch of at most {MAX_BATCH} transforms, not {x.shape[0]}")
    if log_n < 1 or x.numel() == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.dim() == 3 and log_n <= ROWS_MAX_LOG_N:
        run_rows(x, out, log_n, inverse)
        return out
    src = x
    for s0, cnt in passes(log_n):
        run_pass(src, out, log_n, s0, cnt, inverse)
        src = out
    return out


def run_pass(src: torch.Tensor, out: torch.Tensor, log_n: int, s0: int, cnt: int, inverse: bool) -> None:
    """One launch: DIT stages s0 + 1 .. s0 + cnt of a transform of
    2^log_n elements (of each row of a batch [batch, 2^log_n, 8]) from
    src into out, through the bit reversal when s0 == 0 (src and out
    distinct then; the same buffer otherwise)."""
    tw = N.table(log_n, "tw_inv" if inverse else "tw_fwd", str(out.device))
    batch = out.shape[0] if out.dim() == 3 else 1
    err = _kernel()(
        src.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, s0, cnt, int(s0 == 0), batch,
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ntt_pass launch failed: cudaError {err}")
    build.count(launches, "ntt")


def run_rows(src: torch.Tensor, out: torch.Tensor, log_n: int, inverse: bool) -> None:
    """One launch of K3b: every row of src [batch, 2^log_n, 8] (log_n <=
    12, contiguous) transformed into the same row of out (distinct)."""
    tw = N.table(log_n, "tw_inv" if inverse else "tw_fwd", str(out.device))
    err = _rows_kernel()(
        src.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, out.shape[0],
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ntt_rows launch failed: cudaError {err}")
    build.count(launches, "ntt_rows")


def ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return transform(x, log_n, False)


def intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return k1.montmul(transform(x, log_n, True), N.table(log_n, "n_inv_mont", str(x.device)))


def coset_ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return transform(k1.montmul(x, N.table(log_n, "coset_fwd", str(x.device))), log_n, False)


def coset_intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return k1.montmul(intt(x, log_n), N.table(log_n, "coset_inv", str(x.device)))


def h_from_evals(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, log_n: int) -> torch.Tensor:
    """Coefficients of h = (A B - C) / Z from the evaluations of A, B and
    C on the domain <w> of size n = 2^log_n (int32 [n, 8] Montgomery in
    and out). Each of A, B, C is interpolated and evaluated on the coset
    g<w>, where Z is the constant g^n - 1; the quotient is interpolated
    back from the coset. Seven transforms; the 1/n, coset and 1/Z scales
    ride on two precomputed vectors (ops/ntt.py `Domain`)."""
    dev = str(a.device)
    scale_in = N.table(log_n, "h_in_scale", dev)
    cos = [transform(k1.montmul(transform(v, log_n, True), scale_in), log_n, False) for v in (a, b, c)]
    num = k1.sub(k1.montmul(cos[0], cos[1]), cos[2])
    del cos
    return k1.montmul(transform(num, log_n, True), N.table(log_n, "h_out_scale", dev))
