"""ctypes bindings + on-demand build for the native C engine.

Builds native/label.c into a shared object under the repository's
`build/` directory on first use (rebuilt when the source is newer) and
binds SDR labeling, batched SHA-256 and the Feistel expander parents.
There is no pure-Python fallback: a missing compiler is an error.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native", "label.c")
_SO = os.path.join(BUILD_DIR, "native", "_label.so")

_lib = None
_lock = threading.Lock()  # threads of one process share the build's temporary file


def _build() -> None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["cc", "-O3", "-shared", "-fPIC", "-march=native", "-pthread", _SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{proc.stderr}")
    # atomic publish: concurrent builders each write their own file
    os.replace(tmp, _SO)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    with _lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
    global _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.label_layer.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        u32p, ctypes.c_uint32, ctypes.c_uint32,
        u32p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.label_layer.restype = None
    lib.sha256_many.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.sha256_many.restype = None
    lib.label_engine_init.argtypes = [ctypes.c_int]
    lib.label_engine_init.restype = None
    lib.expander_parents_range.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64, u32p,
    ]
    lib.expander_parents_range.restype = None
    lib.label_engine_init(1)  # SHA-NI when compiled in
    _lib = lib
    return lib


def label_layer_native(
    out: np.ndarray,
    prev: np.ndarray | None,
    replica_id: bytes,
    layer: int,
    base_tbl: np.ndarray,
    exp_tbl: np.ndarray | None,
) -> None:
    """Label one layer in place.

    Row-strided uint32 parent views (column slices of the mmapped
    [nodes, DEGREE] ParentCache table) are passed by pointer + stride,
    with no copy (reference cache.hpp CacheData)."""
    lib = get_lib()
    nodes = out.shape[0]

    def view(arr):
        # zero-copy when the element stride is already 4-byte u32 rows
        if arr.dtype == np.uint32 and arr.strides[1] == 4:
            return arr
        return np.ascontiguousarray(arr, dtype=np.uint32)

    base = view(base_tbl)
    bp = ctypes.cast(base.ctypes.data, ctypes.POINTER(ctypes.c_uint32))
    if exp_tbl is not None and prev is not None:
        exp = view(exp_tbl)
        ep = ctypes.cast(exp.ctypes.data, ctypes.POINTER(ctypes.c_uint32))
        exp_deg, exp_stride = exp.shape[1], exp.strides[0] // 4
        prev_ptr = prev.ctypes.data_as(ctypes.c_char_p)
    else:
        ep = None
        exp_deg, exp_stride = 0, 0
        prev_ptr = None
    lib.label_layer(
        replica_id, layer, nodes,
        bp, base.shape[1], base.strides[0] // 4,
        ep, exp_deg, exp_stride,
        prev_ptr, out.ctypes.data_as(ctypes.c_char_p),
    )


def sha256_many_native(msgs: np.ndarray, trim_fr: bool = True) -> np.ndarray:
    """Batched SHA-256 of (N, L) uint8 messages -> (N, 32)."""
    lib = get_lib()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, msg_len = msgs.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib.sha256_many(
        msgs.ctypes.data_as(ctypes.c_char_p), n, msg_len,
        out.ctypes.data_as(ctypes.c_char_p), 1 if trim_fr else 0,
    )
    return out


def expander_parents_native(
    nodes: int, exp_degree: int, keys: list[int], half_bits: int,
    start: int = 0, end: int | None = None,
) -> np.ndarray:
    """[(end-start), exp_degree] uint32 Feistel expander parent rows for
    the node window [start, end) (reference parent-cache payload,
    stacked/vanilla/cache.hpp; bit-exact vs core/feistel.permute)."""
    lib = get_lib()
    if end is None:
        end = nodes
    out = np.empty((end - start, exp_degree), dtype=np.uint32)
    karr = (ctypes.c_uint64 * 3)(*[k & 0xFFFFFFFFFFFFFFFF for k in keys[:3]])
    lib.expander_parents_range(
        nodes, exp_degree, karr, half_bits, os.cpu_count() or 1, start, end,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out
