"""API helpers (reference api/utilities.hpp:34-50), copied from
crypto3_fil_proofs_tpu/api/utilities.py."""
from __future__ import annotations

from ..ops.bls12_381 import R


def as_safe_commitment(comm: bytes) -> int:
    """32 LE bytes -> Fr, raising on non-canonical values
    (reference as_safe_commitment)."""
    if len(comm) != 32:
        raise ValueError("commitment must be 32 bytes")
    v = int.from_bytes(comm, "little")
    if v >= R:
        raise ValueError("commitment is not a valid field element")
    return v


def commitment_from_fr(v: int) -> bytes:
    return (v % R).to_bytes(32, "little")
