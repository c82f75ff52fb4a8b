"""In-memory Groth16 parameter/verifying-key caches.

Copied from crypto3_fil_proofs_tpu/caches.py (the PoRep part), which
re-implements reference libs/filecoin caches.hpp:38-160: process-level
maps keyed by circuit identity (STACKED[size] / WINNING_POST[size] /
WINDOW_POST[size]) in front of the disk parameter cache; the port has
the STACKED maps so far.
"""
from __future__ import annotations

from .core.compound import CompoundProof
from .core.parameter_cache import get_verifying_key as _disk_vk

_PARAM_CACHE: dict[str, object] = {}
_VK_CACHE: dict[str, object] = {}


def _key(kind: str, sector_size: int, extra: str = "") -> str:
    return f"{kind}[{sector_size}]{extra}"


def get_stacked_params(config, pub_params, compound: CompoundProof, device="cuda"):
    """The proving key, from this process's cache, the disk cache, or a
    setup on `device`."""
    key = _key("STACKED", config.sector_size)
    if key not in _PARAM_CACHE:
        _PARAM_CACHE[key] = compound.get_params(pub_params, device=device)
    return _PARAM_CACHE[key]


def get_stacked_verifying_key(config, pub_params, compound: CompoundProof):
    key = _key("STACKED-VK", config.sector_size)
    if key not in _VK_CACHE:
        prefix = compound.adapter.cache_prefix(pub_params)
        _VK_CACHE[key] = _disk_vk(
            prefix, lambda: compound.adapter.blank_circuit(pub_params)
        )
    return _VK_CACHE[key]


def clear_caches() -> None:
    _PARAM_CACHE.clear()
    _VK_CACHE.clear()
