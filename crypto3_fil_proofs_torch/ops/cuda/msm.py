"""Kernel K6 wrapper: the bucket stages of the Pippenger MSM (csrc/msm.cu).

Replaces the bucket accumulation and aggregation of
crypto3_fil_proofs_tpu/ops/pallas/msm.py (`_bucket_accumulate_soa`
:206, `_aggregate_soa` :367, `_aggregate_split` :438); the aggregation
runs in levels (`agg_level`, driven by ops/msm.py `aggregate`). Points are in
the working form of ops/g1_torch.py; the schedule tensors (sorted point
order, chunk starts and lengths, chunk pointers of each bucket) are
int32 and built by ops/msm.py `schedule`.

On CPU tensors each stage runs its plain version (ops/msm.py); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import msm as M
from ..g1_torch import G1, Curve
from ..g2_torch import G2
from . import build

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int


class BucketKernels:
    """The bucket stages of one group."""

    def __init__(self, curve: Curve):
        self.curve = curve
        self.prefix = f"msm_{curve.name}"
        self.launches = {f"{self.prefix}_{op}": 0 for op in ("bucket_acc", "bucket_reduce", "agg_level")}
        self._fns: dict = {}

    def _fn(self, op: str, argtypes):
        fn = self._fns.get(op)
        if fn is None:
            fn = getattr(build.load("msm"), f"{self.prefix}_{op}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[op] = fn
        return fn

    def _launch(self, op: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.prefix}_{op} launch failed: cudaError {err}")
        build.count(self.launches, f"{self.prefix}_{op}")

    @staticmethod
    def _cuda(*ts: torch.Tensor) -> torch.device | None:
        if all(t.device.type == "cpu" for t in ts):
            return None
        dev = ts[0].device
        if not all(t.is_cuda and t.device == dev for t in ts):
            raise ValueError("operands must all lie on the CPU or on one CUDA device")
        for t in ts:
            if not t.is_contiguous():
                raise ValueError("operands must be contiguous")
        return dev

    def _points(self, t: torch.Tensor, coords: int) -> None:
        shape = (coords,) + self.curve.coord
        if t.dtype != torch.int32 or tuple(t.shape[1:]) != shape:
            raise ValueError(f"points must be int32 [N, {', '.join(map(str, shape))}], got "
                             f"{t.dtype} {tuple(t.shape)}")

    @staticmethod
    def _index(*ts: torch.Tensor) -> None:
        for t in ts:
            if t.dtype != torch.int32 or t.dim() != 1:
                raise ValueError("schedule tensors must be int32 [n]")

    def bucket_acc(self, pts, order, start, length) -> torch.Tensor:
        """Sum of the affine points pts[order[start[i] : start[i] + length[i]]]
        for each chunk i, as Jacobian [C, 3, ...]."""
        dev = self._cuda(pts, order, start, length)
        if dev is None:
            return M.bucket_acc_plain(self.curve, pts, order, start, length)
        self._points(pts, 2)
        self._index(order, start, length)
        out = torch.empty((start.shape[0], 3) + self.curve.coord, dtype=torch.int32, device=dev)
        if start.shape[0]:
            self._launch("bucket_acc", self._fn("bucket_acc", [_P, _P, _P, _P, _P, _N, _P])(
                pts.data_ptr(), order.data_ptr(), start.data_ptr(), length.data_ptr(),
                out.data_ptr(), start.shape[0], torch.cuda.current_stream(dev).cuda_stream))
        return out

    def bucket_reduce(self, chunks, ptr) -> torch.Tensor:
        """Bucket b = the sum of chunks[ptr[b] : ptr[b + 1]]."""
        dev = self._cuda(chunks, ptr)
        if dev is None:
            return M.bucket_reduce_plain(self.curve, chunks, ptr)
        self._points(chunks, 3)
        self._index(ptr)
        out = torch.empty((ptr.shape[0] - 1, 3) + self.curve.coord, dtype=torch.int32, device=dev)
        if out.shape[0]:
            self._launch("bucket_reduce", self._fn("bucket_reduce", [_P, _P, _P, _N, _P])(
                chunks.data_ptr(), ptr.data_ptr(), out.data_ptr(), out.shape[0],
                torch.cuda.current_stream(dev).cuda_stream))
        return out

    def agg_level(self, s, t, group: int, want_s: bool):
        """One aggregation level over groups of `group` consecutive
        entries of s (and t, or no t): (t', s') with t'_g = sum_j j s_j +
        sum_j t_j and s'_g = group * sum_j s_j (None unless want_s)."""
        ts = (s,) if t is None else (s, t)
        dev = self._cuda(*ts)
        if dev is None:
            return M.agg_level_plain(self.curve, s, t, group, want_s)
        for x in ts:
            self._points(x, 3)
        if group < 1 or group & (group - 1) or s.shape[0] % group or (t is not None and t.shape != s.shape):
            raise ValueError("the group must be a power of two dividing the entries of s (and t)")
        n = s.shape[0] // group
        t_out = torch.empty((n, 3) + self.curve.coord, dtype=torch.int32, device=dev)
        s_out = torch.empty_like(t_out) if want_s else None
        if n:
            self._launch("agg_level", self._fn("agg_level", [_P, _P, _I, _I, _P, _P, _N, _P])(
                s.data_ptr(), None if t is None else t.data_ptr(), group, group.bit_length() - 1,
                t_out.data_ptr(), None if s_out is None else s_out.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream))
        return t_out, s_out


K6_G1 = BucketKernels(G1)
K6_G2 = BucketKernels(G2)
