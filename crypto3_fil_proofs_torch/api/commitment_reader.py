"""Incremental piece-commitment hasher.

Copied from crypto3_fil_proofs_tpu/api/commitment_reader.py, which
re-implements reference libs/filecoin commitment_reader.hpp:37-99:
consumes a (padded) stream, hashing 64-byte pairs up a binary SHA-254
tree as data arrives (`try_hash`), producing comm_p at `finish`.
"""
from __future__ import annotations

from ..ops.tree_hash import get_backend

NODE_SIZE = 32


class CommitmentReader:
    def __init__(self):
        self._buffer = b""
        self._levels: list[list[bytes]] = [[]]
        self._backend = get_backend("sha256")
        self._bytes_consumed = 0

    def consume(self, data: bytes) -> None:
        self._bytes_consumed += len(data)
        self._buffer += data
        while len(self._buffer) >= 2 * NODE_SIZE:
            pair, self._buffer = (
                self._buffer[: 2 * NODE_SIZE],
                self._buffer[2 * NODE_SIZE :],
            )
            self._push(
                0,
                self._backend.hash_single(
                    [pair[:NODE_SIZE], pair[NODE_SIZE:]]
                ),
            )

    def _push(self, level: int, node: bytes) -> None:
        """try_hash: fold complete pairs upward (reference :try_hash)."""
        while len(self._levels) <= level:
            self._levels.append([])
        self._levels[level].append(node)
        if len(self._levels[level]) == 2:
            a, b = self._levels[level]
            self._levels[level] = []
            self._push(level + 1, self._backend.hash_single([a, b]))

    @property
    def bytes_consumed(self) -> int:
        return self._bytes_consumed

    def finish(self) -> bytes:
        """comm_p; the consumed stream must be a whole power-of-two
        number of nodes (reference :finish)."""
        if self._buffer:
            raise ValueError("incomplete trailing node data")
        pending = [lvl for lvl in self._levels if lvl]
        if sum(len(lvl) for lvl in pending) == 1:
            return pending[0][0]
        if not pending and self._bytes_consumed == 0:
            raise ValueError("no data consumed")
        raise ValueError("stream length was not a power-of-two node count")
