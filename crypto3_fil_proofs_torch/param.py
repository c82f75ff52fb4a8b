"""Parameter-file utilities shared by the param CLIs.

Copied from crypto3_fil_proofs_tpu/param.py, which re-implements
reference libs/filecoin param.hpp:38-167 + src/param.cpp:
Blake2b-512 digests of cached parameter files (hex[:32]), parameter-map
(parameters.json manifest) IO, filename/extension helpers.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

from .core.parameter_cache import parameter_cache_dir


@dataclass
class ParameterData:
    cid: str
    digest: str
    sector_size: int


def get_digest_for_file_within_cache(filename: str) -> str:
    """Blake2b-512 hex digest truncated to 32 chars
    (reference param.hpp get_digest_for_file_within_cache)."""
    path = os.path.join(parameter_cache_dir(), filename)
    h = hashlib.blake2b()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:32]


def add_extension(filename: str, ext: str) -> str:
    return f"{filename}.{ext}"


def parameter_id(filename: str) -> str:
    """Strip the extension (reference param.hpp parameter_id)."""
    return filename.rsplit(".", 1)[0]


def has_extension(filename: str, ext: str) -> bool:
    return filename.endswith("." + ext)


def read_parameter_map(path: str) -> dict[str, ParameterData]:
    with open(path) as f:
        raw = json.load(f)
    return {
        name: ParameterData(
            cid=v.get("cid", ""),
            digest=v.get("digest", ""),
            sector_size=v.get("sector_size", 0),
        )
        for name, v in raw.items()
    }


def write_parameter_map(path: str, params: dict[str, ParameterData]) -> None:
    with open(path, "w") as f:
        json.dump(
            {
                name: {
                    "cid": p.cid,
                    "digest": p.digest,
                    "sector_size": p.sector_size,
                }
                for name, p in sorted(params.items())
            },
            f,
            indent=2,
            sort_keys=True,
        )


def cached_parameter_files(extensions=("params", "vk", "meta")) -> list[str]:
    d = parameter_cache_dir()
    out = []
    for name in sorted(os.listdir(d)):
        if any(has_extension(name, e) for e in extensions):
            out.append(name)
    return out
