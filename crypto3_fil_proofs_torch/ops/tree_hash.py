"""Batched tree-hash backends shared by the Merkle engine.

Counterpart of crypto3_fil_proofs_tpu/ops/tree_hash.py. The Merkle
engine hashes whole levels at a time (reference: per-node
`process_layer` loops and GPU batch builders, core/merkle/merkle.hpp:
205-250, stacked/vanilla/proof.hpp:385-581).

- "poseidon": tensors. On a CUDA tensor every level runs kernels K1
  (Montgomery conversion) and K2 (the permutation); on a CPU tensor
  their plain versions. There is no host fallback for a CUDA tensor.
- "sha256": host numpy through the native C engine (tree_d, pieces).
- "pedersen": the legacy Jubjub hasher (ops/pedersen.py), host Python
  integers, loaded at its first use.
"""
from __future__ import annotations

import hashlib
from typing import Iterator

import numpy as np
import torch

from .native import sha256_many_native
from .poseidon import poseidon_hash
from .poseidon_torch import bytes_to_mont, hash_level, mont_to_bytes

NODE_SIZE = 32


def host_bytes(nodes) -> np.ndarray:
    """(N, 32) uint8 nodes from a numpy array, memmap or tensor."""
    if isinstance(nodes, torch.Tensor):
        return nodes.cpu().numpy()
    return np.asarray(nodes)


def _tensor(nodes, device) -> torch.Tensor:
    """(N, 32) uint8 nodes as a tensor on `device` (default: where a
    tensor already lies)."""
    if not isinstance(nodes, torch.Tensor):
        # a private copy: memmaps are read-only and may be views of files
        nodes = torch.from_numpy(np.array(nodes, dtype=np.uint8))
    if device is None:
        return nodes
    return nodes.to(device)


def _is_mont(nodes) -> bool:
    """Poseidon nodes come as (N, 32) uint8 canonical LE bytes (numpy
    array, memmap or tensor) or as an int32 [N, 8] tensor already in
    Montgomery form (the column hashes of tree_c)."""
    return isinstance(nodes, torch.Tensor) and nodes.dtype == torch.int32


class PoseidonBackend:
    """Poseidon level hashing on the tensor's device."""

    name = "poseidon"

    def leaf_bytes(self, leaves) -> np.ndarray:
        """The leaf level as the store holds it: (N, 32) canonical LE
        bytes on the host."""
        if _is_mont(leaves):
            return mont_to_bytes(leaves).cpu().numpy()
        return host_bytes(leaves)

    def tree_levels(self, leaves, arity: int, device=None) -> Iterator[np.ndarray]:
        """Yield each level above the leaves as (n, 32) canonical LE
        bytes on the host. Between levels the nodes stay on the device in
        Montgomery form; leaves already in that form are not converted."""
        level = leaves if _is_mont(leaves) else bytes_to_mont(_tensor(leaves, device))
        while level.shape[0] > 1:
            level = hash_level(level, arity)
            yield mont_to_bytes(level).cpu().numpy()

    def hash_level(self, nodes: torch.Tensor, arity: int) -> torch.Tensor:
        """(N, 32) uint8 tensor -> (N / arity, 32) parents, same device."""
        return mont_to_bytes(hash_level(bytes_to_mont(nodes), arity))

    def hash_single(self, children: list[bytes]) -> bytes:
        ints = [int.from_bytes(c, "little") for c in children]
        return poseidon_hash(ints, len(ints)).to_bytes(32, "little")


class Sha256Backend:
    """Binary SHA-256 tree hashing with Fr trim (tree_d / piece trees).

    Matches rust-fil-proofs Sha256 hasher node semantics: digest of the
    concatenated children, last byte masked &0x3F so the node is a valid
    Fr element (reference label/commit trimming, create_label.hpp:77).
    """

    name = "sha256"

    def leaf_bytes(self, leaves) -> np.ndarray:
        return host_bytes(leaves)

    def tree_levels(self, leaves, arity: int, device=None) -> Iterator[np.ndarray]:
        level = host_bytes(leaves)
        while level.shape[0] > 1:
            msgs = np.ascontiguousarray(level, dtype=np.uint8).reshape(-1, arity * NODE_SIZE)
            level = sha256_many_native(msgs, trim_fr=True)
            yield level

    def hash_single(self, children: list[bytes]) -> bytes:
        d = bytearray(hashlib.sha256(b"".join(children)).digest())
        d[31] &= 0x3F
        return bytes(d)


_BACKENDS = {"poseidon": PoseidonBackend(), "sha256": Sha256Backend()}


def get_backend(name: str):
    """The tree-hash backend of a hasher name ("poseidon", "sha256" or
    "pedersen")."""
    if name == "pedersen" and name not in _BACKENDS:
        # lazy, so the generator derivation never taxes the hot paths
        from .pedersen import PedersenBackend

        _BACKENDS[name] = PedersenBackend()
    return _BACKENDS[name]
