"""Kernel K4 wrapper: G1 point operations over lanes (csrc/g1.cu), and
the wrapper class that K5 (ops/cuda/g2.py) instantiates for G2.

Replaces crypto3_fil_proofs_tpu/ops/pallas/g1.py `madd_nodbl_soa`
(:533), `dbl_soa` (:559), `add_soa` (:580) and `madd_soa` (:506, G1
only, off every path). Points are in the working
form of ops/g1_torch.py: affine int32 [N, 2, *coord], Jacobian int32
[N, 3, *coord], Montgomery; masks are bool [N].

On CPU tensors each entry point runs its plain version (the `Curve`
methods of ops/g1_torch.py); on CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..g1_torch import G1, Curve
from . import build

_P = ctypes.c_void_p
_N = ctypes.c_longlong


class PointKernels:
    """The entry points of one group's kernel library."""

    def __init__(self, curve: Curve, lib: str):
        self.curve = curve
        self.lib = lib
        # madd (with its doubling path) is built for G1 only, as on the TPU
        self.ops = ("madd_nodbl", "dbl", "add") + (("madd",) if curve.name == "g1" else ())
        self.launches = {f"{curve.name}_{op}": 0 for op in self.ops}
        self._fns: dict = {}

    def _fn(self, op: str, argtypes):
        fn = self._fns.get(op)
        if fn is None:
            fn = getattr(build.load(self.lib), f"{self.curve.name}_{op}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[op] = fn
        return fn

    def _check(self, what: str, t: torch.Tensor, coords: int, dev) -> None:
        shape = (coords,) + self.curve.coord
        if t.dtype != torch.int32 or t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{what} must be int32 [N, {', '.join(map(str, shape))}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{what} lies on {t.device}, not {dev}")

    @staticmethod
    def _device(*ts: torch.Tensor):
        if all(t.device.type == "cpu" for t in ts):
            return None
        dev = ts[0].device
        if not all(t.is_cuda and t.device == dev for t in ts):
            raise ValueError("operands must all lie on the CPU or on one CUDA device")
        return dev

    def _launch(self, op: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.curve.name}_{op} launch failed: cudaError {err}")
        build.count(self.launches, f"{self.curve.name}_{op}")

    def madd_nodbl(self, acc: torch.Tensor, q: torch.Tensor, valid: torch.Tensor):
        """acc + affine q where valid; (sum, same) with same flagging the
        P == Q lanes, which keep acc for the caller to double."""
        dev = self._device(acc, q, valid)
        if dev is None:
            return self.curve.madd_nodbl_plain(acc, q, valid)
        self._check("acc", acc, 3, dev)
        self._check("q", q, 2, dev)
        n = acc.shape[0]
        if q.shape[0] != n or valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError("q and valid [N] bool must match acc's N lanes")
        acc, q, valid = acc.contiguous(), q.contiguous(), valid.contiguous()
        out = torch.empty_like(acc)
        same = torch.empty_like(valid)
        if n:
            self._launch("madd_nodbl", self._fn("madd_nodbl", [_P, _P, _P, _P, _P, _N, _P])(
                acc.data_ptr(), q.data_ptr(), valid.data_ptr(), out.data_ptr(), same.data_ptr(),
                n, torch.cuda.current_stream(dev).cuda_stream))
        return out, same

    def madd(self, acc: torch.Tensor, q: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """acc + affine q where valid, doubling where P == Q."""
        dev = self._device(acc, q, valid)
        if dev is None:
            return self.curve.madd_plain(acc, q, valid)
        if "madd" not in self.ops:
            raise ValueError(f"no madd kernel for {self.curve.name}")
        self._check("acc", acc, 3, dev)
        self._check("q", q, 2, dev)
        n = acc.shape[0]
        if q.shape[0] != n or valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError("q and valid [N] bool must match acc's N lanes")
        acc, q, valid = acc.contiguous(), q.contiguous(), valid.contiguous()
        out = torch.empty_like(acc)
        if n:
            self._launch("madd", self._fn("madd", [_P, _P, _P, _P, _N, _P])(
                acc.data_ptr(), q.data_ptr(), valid.data_ptr(), out.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream))
        return out

    def dbl(self, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """2P where mask, P elsewhere."""
        dev = self._device(p, mask)
        if dev is None:
            return self.curve.dbl_plain(p, mask)
        self._check("p", p, 3, dev)
        n = p.shape[0]
        if mask.shape != (n,) or mask.dtype != torch.bool:
            raise ValueError("mask must be bool [N]")
        p, mask = p.contiguous(), mask.contiguous()
        out = torch.empty_like(p)
        if n:
            self._launch("dbl", self._fn("dbl", [_P, _P, _P, _N, _P])(
                p.data_ptr(), mask.data_ptr(), out.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream))
        return out

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """P + Q over Jacobian lanes (doubling where P == Q)."""
        dev = self._device(p, q)
        if dev is None:
            return self.curve.add_plain(p, q)
        self._check("p", p, 3, dev)
        self._check("q", q, 3, dev)
        if q.shape[0] != p.shape[0]:
            raise ValueError("p and q must have the same number of lanes")
        p, q = p.contiguous(), q.contiguous()
        out = torch.empty_like(p)
        if p.shape[0]:
            self._launch("add", self._fn("add", [_P, _P, _P, _N, _P])(
                p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[0],
                torch.cuda.current_stream(dev).cuda_stream))
        return out


K4 = PointKernels(G1, "g1")
launches = K4.launches
madd_nodbl = K4.madd_nodbl
madd = K4.madd
dbl = K4.dbl
add = K4.add
