"""Kernel K2 wrapper: the Poseidon permutation as a batched Merkle hash;
kernel K7 wrapper: the circuits' Poseidon witness replay.

K2 replaces crypto3_fil_proofs_tpu/ops/pallas/poseidon.py `permute_soa`
(:594) / `permute_soa_mxu` (:548) behind `hash_level_packed` (:653); the
kernel is csrc/poseidon.cu. Preimages are int32 [B, arity, 8] Montgomery
elements; digests come back as [B, 8].

K7 replaces the XLA replay of crypto3_fil_proofs_tpu/zk/gadgets/tiled.py
`_poseidon_witness_jax_fn` (:659-790); the kernel is
csrc/poseidon_witness.cu. From the same preimages it gives every S-box's
x^2, x^4, x^5 and the digest, int32 [B, n_int, 8] in plain form, written
by the kernel in that layout: a group of t lanes per instance below a
batch size per width (`witness_switch`), one thread per instance from
there on.

On CPU tensors the wrappers run the plain versions
(ops/poseidon_torch.py `hash_mont_plain`, `witness_plain`); on CUDA
tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import poseidon_torch as PT
from . import build

# arities the kernel is instantiated for (state widths 3, 9, 12)
ARITIES = (2, 8, 11)

# K2's launches per arity and K7's, counted where the kernels are launched
launches = {**{a: 0 for a in ARITIES}, "poseidon_witness": 0}


def _check(pre: torch.Tensor, arity: int, what: str) -> None:
    if not pre.is_cuda:
        raise ValueError(f"{what}: unsupported device {pre.device}")
    if arity not in ARITIES:
        raise ValueError(f"the Poseidon kernels are built for arities {ARITIES}, not {arity}")
    if pre.dtype != torch.int32 or pre.dim() != 3 or pre.shape[1:] != (arity, PT.L):
        raise ValueError(f"preimages must be int32 [B, {arity}, {PT.L}], got {pre.dtype} {tuple(pre.shape)}")


def _launch(lib: str, entry: str, pre: torch.Tensor, out: torch.Tensor, arity: int) -> None:
    """One launch on pre's card (current for the launch) and its current stream."""
    st = PT.staged(arity)
    with torch.cuda.device(pre.device):
        err = _kernel(lib, entry)(
            pre.data_ptr(), out.data_ptr(), _consts(arity, str(pre.device)).data_ptr(), pre.shape[0],
            st.t, st.r_f, st.r_p, torch.cuda.current_stream(pre.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} (arity {arity}) launch failed: cudaError {err}")


def poseidon_hash(pre: torch.Tensor, arity: int) -> torch.Tensor:
    if pre.device.type == "cpu":
        return PT.hash_mont_plain(pre, arity)
    _check(pre, arity, "poseidon_hash")
    pre = pre.contiguous()
    out = torch.empty((pre.shape[0], PT.L), dtype=torch.int32, device=pre.device)
    if pre.shape[0] == 0:
        return out
    _launch("poseidon", "poseidon_hash", pre, out, arity)
    build.count(launches, arity)
    return out


def witness(pre: torch.Tensor, arity: int) -> torch.Tensor:
    """K7: preimages int32 [B, arity, 8] Montgomery -> int32 [B, n_int, 8]
    plain: x^2, x^4, x^5 of every S-box in the gadget's allocation order,
    then the digest."""
    if pre.device.type == "cpu":
        return PT.witness_plain(pre, arity)
    _check(pre, arity, "witness")
    pre = pre.contiguous()
    out = torch.empty((pre.shape[0], PT.witness_len(arity), PT.L), dtype=torch.int32, device=pre.device)
    if pre.shape[0] == 0:
        return out
    _launch("poseidon_witness", "poseidon_witness", pre, out, arity)
    build.count(launches, "poseidon_witness")
    return out


# K7's C entry points in one layout whatever the batch size, for timing
# the two against each other (uncounted, as the kernel-alone timings are)
WITNESS_LAYOUTS = {"one_thread": "poseidon_witness_one_thread", "group": "poseidon_witness_group"}


def witness_switch(arity: int) -> int:
    """The batch size from which K7 runs one thread per instance at
    `arity` (the lane groups below it), as the kernel's launcher has it."""
    fn = build.load("poseidon_witness").poseidon_witness_one_thread_from
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(PT.staged(arity).t))


@lru_cache(maxsize=None)
def _kernel(lib: str, entry: str):
    """The C entry point `entry` of csrc/`lib`.cu, built at first use."""
    fn = getattr(build.load(lib), entry)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _consts(arity: int, device: str) -> torch.Tensor:
    return PT.staged(arity, device).flat().contiguous()
