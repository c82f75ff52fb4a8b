"""Groth16 parameter disk cache (v28 naming, reference parity).

Copied from crypto3_fil_proofs_tpu/core/parameter_cache.py, which
re-implements reference core/parameter_cache.hpp:50-223: parameters and
verifying keys cached under `FIL_PROOFS_PARAMETER_CACHE` (default
/var/tmp/filecoin-proof-parameters) as `v28-<id>.params` / `.vk` /
`.meta`, keyed by the circuit's cache identifier. Our storage format is
npz (numpy limb arrays for the device-ready query tables + compressed
curve points) instead of the reference's crypto3-marshalling blobs —
the naming/layout contract on disk is preserved.

The npz layout is the JAX package's (`_save_pk` :50 / `_load_pk` :82),
written uncompressed (np.load reads both), so either package loads a
`.params` or `.vk` file that the other wrote.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..zk import groth16
from .measure import measure_op
from .settings import settings

VERSION = 28
SRS_MAX_PROOFS_TO_AGGREGATE = 65535  # reference parameter_cache.hpp


def parameter_cache_dir() -> str:
    d = settings().parameter_cache
    os.makedirs(d, exist_ok=True)
    return d


def cache_identifier(prefix: str) -> str:
    """v28-<sha256(prefix)[:32]> (reference cache_identifier semantics)."""
    h = hashlib.sha256(prefix.encode()).hexdigest()[:32]
    return f"v{VERSION}-{h}"


def params_path(prefix: str) -> str:
    return os.path.join(parameter_cache_dir(), cache_identifier(prefix) + ".params")


def vk_path(prefix: str) -> str:
    return os.path.join(parameter_cache_dir(), cache_identifier(prefix) + ".vk")


def meta_path(prefix: str) -> str:
    return os.path.join(parameter_cache_dir(), cache_identifier(prefix) + ".meta")


def _save_pk(path: str, pk: groth16.ProvingKey) -> None:
    tmp = path + ".tmp.npz"
    pk.save(tmp)
    os.replace(tmp, path)


def _load_pk(path: str) -> groth16.ProvingKey:
    return groth16.ProvingKey.load(path)


def _save_vk(path: str, vk: groth16.VerifyingKey) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **vk.to_npz_dict())
    os.replace(tmp, path)


def _load_vk(path: str) -> groth16.VerifyingKey:
    with np.load(path) as d:
        return groth16.VerifyingKey.from_npz_dict(d)


def get_groth_params(
    prefix: str, blank_circuit_fn, seed: bytes | None = None, device="cuda"
) -> groth16.ProvingKey:
    """Load cached params for the circuit identity or generate+cache
    (reference cacheable_parameters::get_groth_params); a key made here
    keeps its queries on `device`. Spans (core/measure.py):
    setup_blank_circuit, setup_save, and those of `groth16.setup`."""
    path = params_path(prefix)
    if os.path.exists(path):
        return _load_pk(path)
    with measure_op("setup_blank_circuit"):
        cs = blank_circuit_fn()
    pk = groth16.setup(cs, seed=seed or prefix.encode(), device=device)
    with measure_op("setup_save"):
        _save_pk(path, pk)
        _save_vk(vk_path(prefix), pk.vk)
    with open(meta_path(prefix), "w") as f:
        json.dump(
            {
                "prefix": prefix,
                "version": VERSION,
                "num_constraints": cs.num_constraints,
                "num_inputs": cs.num_inputs,
            },
            f,
        )
    return pk


def get_verifying_key(
    prefix: str, blank_circuit_fn, seed: bytes | None = None
) -> groth16.VerifyingKey:
    path = vk_path(prefix)
    if os.path.exists(path):
        return _load_vk(path)
    return get_groth_params(prefix, blank_circuit_fn, seed=seed).vk
