"""Merkle stores: backing storage for tree node arrays.

Re-implements the behavior of reference core/merkle/storage/*:
- StoreConfig (utilities.hpp:205-261)
- VecStore (vec.hpp), DiskStore (disk.hpp, `sc-02-data-<id>.dat` naming)
- tree math helpers (utilities.hpp:44-151)

Copied from the JAX package, cut to what building a tree and reading
its proofs need; the file layout is the JAX package's, byte for byte.

Node data is uniformly an (N, 32) uint8 array; DiskStore memory-maps the
file (the reference mmaps via boost::interprocess).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

NODE_SIZE = 32


# ---------------------------------------------------------------------------
# Tree math (reference: core/merkle/storage/utilities.hpp:44-151)
# ---------------------------------------------------------------------------


def get_merkle_tree_row_count(leafs: int, arity: int) -> int:
    """Number of levels, leaves and root included."""
    rows, n = 1, leafs
    while n > 1:
        if n % arity:
            raise ValueError(f"{n} leaves are not a power of arity {arity}")
        n //= arity
        rows += 1
    return rows


def get_merkle_tree_len(leafs: int, arity: int) -> int:
    """Total node count of a linear-layout tree."""
    total, n = leafs, leafs
    while n > 1:
        n //= arity
        total += n
    return total


@dataclass
class StoreConfig:
    """On-disk identity of a tree store
    (reference: storage/utilities.hpp:205-261)."""

    path: str
    id: str
    size: int = 0  # total node count (linear layout)
    rows_to_discard: int = 0

    def data_path(self) -> str:
        return os.path.join(self.path, f"sc-02-data-{self.id}.dat")


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------


class Store:
    """Abstract node store (reference: utilities.hpp:264-278)."""

    def read_at(self, index: int) -> bytes:
        raise NotImplementedError

    def read_range(self, start: int, end: int) -> np.ndarray:
        raise NotImplementedError

    def write_range(self, start: int, values: np.ndarray) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass


class VecStore(Store):
    """In-memory store (reference: storage/vec.hpp:37-101)."""

    def __init__(self, size: int):
        self._data = np.zeros((size, NODE_SIZE), dtype=np.uint8)

    def read_at(self, index: int) -> bytes:
        return self._data[index].tobytes()

    def read_range(self, start: int, end: int) -> np.ndarray:
        return self._data[start:end].copy()

    def write_range(self, start: int, values: np.ndarray) -> None:
        self._data[start : start + values.shape[0]] = values


class DiskStore(Store):
    """File-backed store, memory-mapped (reference: storage/disk.hpp).

    create=False reopens a store that an earlier phase wrote, and raises
    FileNotFoundError where its file is missing."""

    def __init__(self, config: StoreConfig, size: int | None = None, create: bool = True):
        self.config = config
        self.path = config.data_path()
        n = size if size is not None else config.size
        if not create and not os.path.exists(self.path):
            raise FileNotFoundError(self.path)
        if not os.path.exists(self.path):
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "wb") as f:
                f.truncate(n * NODE_SIZE)
        file_nodes = os.path.getsize(self.path) // NODE_SIZE
        if n == 0:
            n = file_nodes
        if file_nodes < n:
            with open(self.path, "r+b") as f:
                f.truncate(n * NODE_SIZE)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r+", shape=(n, NODE_SIZE))

    def read_at(self, index: int) -> bytes:
        return self._mm[index].tobytes()

    def read_range(self, start: int, end: int) -> np.ndarray:
        return np.asarray(self._mm[start:end])

    def write_range(self, start: int, values: np.ndarray) -> None:
        self._mm[start : start + values.shape[0]] = values

    def sync(self) -> None:
        self._mm.flush()
