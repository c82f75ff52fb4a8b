"""Depth-robust graph with bucket-sampled parents.

Re-implements the behavior of reference core/drgraph.hpp:44-218
(BucketGraph): per-node ChaCha8 RNG seeded with drg_seed||node_le32,
BASE_DEGREE-1 parents sampled from log-distance buckets over the
metagraph, plus the immediate predecessor; nodes 0 and 1 reference node 0.

TPU-first design: parents for a whole layer are generated as one
vectorized numpy computation (chacha8_stream_words) instead of the
reference's per-node loop, so the parent table feeds the labeling
pipeline and parent cache as a single array.

Copied from crypto3_fil_proofs_tpu/core/drgraph.py.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .chacha import chacha8_stream_words
from .domain_seed import derive_drg_seed

NODE_SIZE = 32

BASE_DEGREE = 6


class BucketGraph:
    def __init__(self, nodes: int, base_degree: int = BASE_DEGREE, porep_id: bytes = bytes(32)):
        m_prime = base_degree - 1
        if nodes * m_prime > 1 << 54:
            raise ValueError("metagraph too large for exact f64 math")
        self.nodes = nodes
        self.base_degree = base_degree
        self.porep_id = porep_id
        self.seed = derive_drg_seed(porep_id)  # 28 bytes

    def size(self) -> int:
        return self.nodes

    def degree(self) -> int:
        return self.base_degree

    def sector_size(self) -> int:
        return self.nodes * NODE_SIZE

    def identifier(self) -> str:
        return (
            f"drgraph-bucket-{self.nodes}-{self.base_degree}-"
            f"{self.seed.hex()}"
        )

    def parents(self, node: int) -> np.ndarray:
        return self.parents_batch(np.array([node], dtype=np.uint64))[0]

    def parents_batch(self, node_ids: np.ndarray) -> np.ndarray:
        """(K,) node ids -> (K, degree) uint32 parent table (vectorized)."""
        node_ids = np.asarray(node_ids, dtype=np.uint64)
        k = len(node_ids)
        m = self.base_degree
        m_prime = m - 1
        out = np.zeros((k, m), dtype=np.uint32)

        small = node_ids <= 1  # nodes 0 and 1 reference node 0
        big_ids = node_ids[~small]
        if len(big_ids) == 0:
            return out

        # per-node seeds: 28-byte drg seed + node as LE u32
        seed_words = np.frombuffer(self.seed, dtype="<u4").astype(np.uint32)
        keys = np.empty((len(big_ids), 8), dtype=np.uint32)
        keys[:, :7] = seed_words
        keys[:, 7] = big_ids.astype(np.uint32)

        # 2 u64 draws per parent = 4 u32 words
        words = chacha8_stream_words(keys, 4 * m_prime)
        w = words.astype(np.uint64)
        r1 = w[:, 0::4] | (w[:, 1::4] << np.uint64(32))  # bucket draws
        r2 = w[:, 2::4] | (w[:, 3::4] << np.uint64(32))  # distance draws

        metagraph_node = big_ids * np.uint64(m_prime)  # (K',)
        n_buckets = np.ceil(np.log2(metagraph_node.astype(np.float64))).astype(np.uint64)

        bucket_index = (r1 % n_buckets[:, None]) + np.uint64(1)
        largest = np.minimum(
            metagraph_node[:, None], np.uint64(1) << bucket_index
        )
        smallest = np.maximum(np.uint64(2), largest >> np.uint64(1))
        n_distances = largest - smallest + np.uint64(1)
        distance = smallest + (r2 % n_distances)
        metagraph_parent = metagraph_node[:, None] - distance
        mapped = metagraph_parent // np.uint64(m_prime)
        parents = np.where(
            mapped == big_ids[:, None], big_ids[:, None] - np.uint64(1), mapped
        ).astype(np.uint32)

        out_big = np.empty((len(big_ids), m), dtype=np.uint32)
        out_big[:, :m_prime] = parents
        out_big[:, m_prime] = (big_ids - np.uint64(1)).astype(np.uint32)
        out[~small] = out_big
        return out

    def parents_all(self) -> np.ndarray:
        """(nodes, degree) uint32 full parent table."""
        return self.parents_batch(np.arange(self.nodes, dtype=np.uint64))

    @staticmethod
    def create_key(replica_id: bytes, node: int, parents: np.ndarray, parents_data: bytes) -> bytes:
        """DRG encoding key: SHA-256(id || parent labels), trimmed to Fr
        (reference: core/drgraph.hpp:189-206)."""
        h = hashlib.sha256()
        h.update(replica_id)
        if node != int(parents[0]):
            for p in parents:
                off = int(p) * NODE_SIZE
                h.update(parents_data[off : off + NODE_SIZE])
        d = bytearray(h.digest())
        d[31] &= 0x3F
        return bytes(d)
