"""Tunables backed by FIL_PROOFS_* environment variables.

Mirrors the reference `configuration` struct
(reference: core/configuration.hpp:34-66), cut to what the port reads:
the column and tree batch sizes of the GPU builders (configuration.hpp:
50-56; the names are rust-fil-proofs' `max_gpu_*_batch_size`), the
LevelCache rows to discard (configuration.hpp:57-59), the multicore-SDR
producer count (configuration.hpp:60-65; `seal_many` takes its labeling
workers from it), and the parameter- and
parent-cache directories. There is no switch to a host hashing path: the
device of the tensors decides where Poseidon runs. A `config.ini` (or the
file `FIL_PROOFS_CONFIG` names) seeds the FIL_PROOFS_* variables the
environment does not set, as in the JAX package (core/settings.py:86).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class Settings:
    # columns hashed per device call in PC2 (reference GPU column batch)
    max_gpu_column_batch_size: int = field(
        default_factory=lambda: _env_int("FIL_PROOFS_MAX_GPU_COLUMN_BATCH_SIZE", 400_000)
    )
    # nodes encoded per host chunk in PC2 (reference GPU tree batch)
    max_gpu_tree_batch_size: int = field(
        default_factory=lambda: _env_int("FIL_PROOFS_MAX_GPU_TREE_BATCH_SIZE", 700_000)
    )
    # Merkle cache shape (configuration.hpp:57-59)
    rows_to_discard: int = field(
        default_factory=lambda: _env_int("FIL_PROOFS_ROWS_TO_DISCARD", 2)
    )
    # SDR labeling (configuration.hpp:60-65): the labeling workers of
    # `seal_many`
    multicore_sdr_producers: int = field(
        default_factory=lambda: _env_int("FIL_PROOFS_MULTICORE_SDR_PRODUCERS", 3)
    )
    parameter_cache: str = field(
        default_factory=lambda: _env_str(
            "FIL_PROOFS_PARAMETER_CACHE", "/var/tmp/filecoin-proof-parameters"
        )
    )
    parent_cache: str = field(
        default_factory=lambda: _env_str(
            "FIL_PROOFS_PARENT_CACHE", "/var/tmp/filecoin-parents"
        )
    )


def _load_config_ini() -> None:
    """Seed missing FIL_PROOFS_* env vars from ./config.ini
    (reference: core/configuration.hpp reads config.ini)."""
    import configparser

    path = os.environ.get("FIL_PROOFS_CONFIG", "config.ini")
    if not os.path.exists(path):
        return
    cp = configparser.ConfigParser()
    try:
        cp.read(path)
    except configparser.Error:
        return
    for section in cp.sections():
        for key, value in cp.items(section):
            env = f"FIL_PROOFS_{key.upper()}"
            os.environ.setdefault(env, value)


def settings() -> Settings:
    """Read the environment afresh, so a caller that changes it sees the
    change on its next call; config.ini fills what it leaves unset."""
    _load_config_ini()
    return Settings()
