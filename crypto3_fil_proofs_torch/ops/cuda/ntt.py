"""Kernel K3 wrapper: the Fr NTT on the card, and the Groth16 h pipeline.

Replaces crypto3_fil_proofs_tpu/ops/pallas/ntt.py (the stage kernels at
:264, :290 and :315, and `h_pipeline` :637); the kernel is csrc/ntt.cu
(its block in csrc/ntt_pass.cuh). Vectors are int32 [n, 8] Fr elements
in Montgomery form; `transform` also takes a batch, int32 [batch, n, 8]:
rows of at most 2^12 elements go to K3b (csrc/ntt_rows.cu, each row
whole in one block's shared memory, one launch for the batch), longer
rows to K3's passes, one launch a pass for all rows: one call into
csrc/ntt.cu (`ntt_transform`) launches every pass of a transform, each
of more than one wave behind the kernel before it (PDL).

`transform` runs the plain version (ops/ntt.py `transform_plain`) on a
CPU tensor and launches the kernel, or raises, for a CUDA tensor. The
elementwise products and the subtraction around it go through K1
(ops/cuda/field.py), so every function here runs on either device.
"""
from __future__ import annotations

import ctypes
import itertools
from functools import lru_cache

import torch

from .. import field as F
from .. import ntt as N
from . import build
from . import field as k1

# launches of the pass kernel (K3) and of the row kernel (K3b), counted
# where each is launched
launches = {"ntt": 0, "ntt_rows": 0}

# K3's tiles: 2^TILE_LOG elements (32 KB; 128 threads in radix-8 trips,
# four blocks an SM) of at least 2^MIN_COLS_LOG adjacent columns (runs of
# 128 bytes)
TILE_LOG = 10
MIN_COLS_LOG = 2
# K3's trips: radix 8 where a launch's radix-8 butterflies give each SM
# FILL_WARPS warps (all that its 122 registers a thread let it hold), else
# radix 4 (80 registers: 24 warps an SM)
FILL_WARPS = 16

# K3's passes of more than one wave of blocks are launched behind the
# kernel before them (programmatic dependent launch: a pass's blocks are
# scheduled while a K3 pass before it drains, and wait for the kernel
# before them to finish)
PDL = True

# K3b: rows of at most 2^12 elements (128 KB of shared memory)
ROWS_MAX_LOG_N = 12


@lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ntt").ntt_pass
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _transform_kernel():
    fn = build.load("ntt").ntt_transform
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def radix_log(elems: int, device: torch.device) -> int:
    """log2 of the trip radix (8 or 4) of a pass over `elems` elements in
    all (the batch's rows together) on `device`."""
    return 3 if elems >> 3 >= FILL_WARPS * 32 * _sm_count(device) else 2


@lru_cache(maxsize=None)
def _rows_kernel():
    fn = build.load("ntt_rows").ntt_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def passes(log_n: int, tile_log: int | None = None, min_cols_log: int | None = None,
           radix: int = 3) -> list[tuple[int, int, int]]:
    """(first stage, stage count, log2 of the columns a tile holds) of each
    pass: one pass of one column up to 2^tile_log elements; above, as few
    passes as tiles of 2^min_cols_log columns allow, each tile filled to
    2^tile_log elements with as many columns as the pass has (a later
    pass's columns are the 2^s0 low indices). Trips of radix 2^radix run
    one butterfly a thread, at most 512 threads a block: tile_log <= 9 +
    radix. The stage counts take the fewest trips, then the evenest, the
    longer passes first."""
    tile_log = min(TILE_LOG if tile_log is None else tile_log, 9 + radix)
    min_cols_log = MIN_COLS_LOG if min_cols_log is None else min_cols_log
    if log_n <= tile_log:
        return [(0, log_n, 0)]
    out, s0 = [], 0
    for cnt in _split(log_n, tile_log - min_cols_log, radix):
        out.append((s0, cnt, min(tile_log - cnt, log_n - cnt, s0 or log_n)))
        s0 += cnt
    return out


@lru_cache(maxsize=None)
def _split(log_n: int, most: int, radix: int) -> tuple[int, ...]:
    """Stage counts of the fewest passes of at most `most` stages: the
    fewest radix-2^radix trips, then the smallest longest pass, in falling
    order."""
    k = -(-log_n // most)
    best = None
    for cut in itertools.combinations(range(1, log_n), k - 1):
        cnts = tuple(sorted((b - a for a, b in zip((0, *cut), (*cut, log_n))), reverse=True))
        if cnts[0] <= most:
            key = (sum(-(-c // radix) for c in cnts), cnts[0], cnts)
            best = key if best is None or key < best else best
    return best[2]


def plan(log_n: int, batch: int, device) -> list[tuple[int, int, int]]:
    """The passes `transform` runs on `batch` rows of 2^log_n on a card:
    `passes` at the trip radix `radix_log` picks for them."""
    return passes(log_n, radix=radix_log(batch << log_n, torch.device(device)))


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
    batch = out.shape[0] if out.dim() == 3 else 1
    r = radix_log(batch << log_n, out.device)
    tw = N.table(log_n, "tw_stages_inv" if inverse else "tw_stages_fwd", str(out.device))
    npasses, flat = _plan_args(log_n, r, TILE_LOG, MIN_COLS_LOG)
    err = _transform_kernel()(x.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, npasses, flat, r, batch,
                              int(PDL), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntt_transform launch failed: cudaError {err}")
    for _ in range(npasses):
        build.count(launches, "ntt")
    return out


@lru_cache(maxsize=None)
def _plan_args(log_n: int, r: int, tile_log: int, min_cols_log: int):
    """`passes` as ntt_transform takes them: their count and (s0, cnt,
    log_c) of each in one C int array."""
    plan = passes(log_n, tile_log, min_cols_log, r)
    return len(plan), (ctypes.c_int * (3 * len(plan)))(*(v for p in plan for v in p))


def run_pass(src: torch.Tensor, out: torch.Tensor, log_n: int, s0: int, cnt: int, log_c: int,
             inverse: bool) -> None:
    """One launch: DIT stages s0 + 1 .. s0 + cnt of a transform of
    2^log_n elements (of each row of a batch [batch, 2^log_n, 8]) from
    src into out, in tiles of 2^log_c columns, through the bit reversal
    when s0 == 0 (src and out distinct then; the same buffer otherwise)."""
    batch = out.shape[0] if out.dim() == 3 else 1
    tw = N.table(log_n, "tw_stages_inv" if inverse else "tw_stages_fwd", str(out.device))
    err = _kernel()(src.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, s0, cnt, log_c,
                    radix_log(batch << log_n, out.device), batch, torch.cuda.current_stream(out.device).cuda_stream)
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
    and out). A, B, C are interpolated and evaluated on the coset g<w>,
    where Z is the constant g^n - 1, as one batch [3, n, 8] (one launch a
    pass for the three); the quotient is interpolated back from the coset.
    The 1/n, coset and 1/Z scales ride on two precomputed vectors
    (ops/ntt.py `Domain`), the first applied in place."""
    dev = str(a.device)
    scale_in = N.table(log_n, "h_in_scale", dev)
    cos = transform(torch.stack((a, b, c)), log_n, True)
    for v in cos:
        k1.montmul(v, scale_in, out=v)
    cos = transform(cos, log_n, False)
    num = k1.sub(k1.montmul(cos[0], cos[1]), cos[2])
    del cos
    return k1.montmul(transform(num, log_n, True), N.table(log_n, "h_out_scale", dev))
