"""Stacked-DRG graph: DRG base parents + Feistel expander parents.

The reference declares `StackedBucketGraph` but never ported its body
(reference: porep/stacked/vanilla/graph.hpp — EXP_DEGREE=8, DEGREE=14;
SURVEY.md §2.5 marks the implementation missing, semantics per
rust-fil-proofs stacked/vanilla/graph.rs). Behavior implemented here:

- base parents: BucketGraph with BASE_DEGREE=6
- expander parents: for i in 0..EXP_DEGREE, the Feistel permutation of
  node*EXP_DEGREE+i over the domain nodes*EXP_DEGREE, divided by
  EXP_DEGREE; keys are the four LE u64 words of
  SHA-256("Filecoin_Feistel" || porep_id)
- full parent list = base(6) || expander(8)

Copied from crypto3_fil_proofs_tpu/models/porep/stacked/vanilla/graph.py.
"""
from __future__ import annotations

import numpy as np

from crypto3_fil_proofs_torch.core import feistel
from crypto3_fil_proofs_torch.core.domain_seed import (
    FEISTEL_DST,
    derive_porep_domain_seed,
)
from crypto3_fil_proofs_torch.core.drgraph import BASE_DEGREE, BucketGraph
from crypto3_fil_proofs_torch.ops.native import expander_parents_native

EXP_DEGREE = 8
DEGREE = BASE_DEGREE + EXP_DEGREE  # 14


class StackedBucketGraph:
    def __init__(
        self,
        nodes: int,
        base_degree: int = BASE_DEGREE,
        expansion_degree: int = EXP_DEGREE,
        porep_id: bytes = bytes(32),
    ):
        self.nodes = nodes
        self.base_graph = BucketGraph(nodes, base_degree, porep_id)
        self.expansion_degree = expansion_degree
        self.porep_id = porep_id
        raw = derive_porep_domain_seed(FEISTEL_DST, porep_id)
        self.feistel_keys = [
            int.from_bytes(raw[i : i + 8], "little") for i in range(0, 32, 8)
        ]
        self.feistel_precomputed = feistel.precompute(nodes * expansion_degree)

    def size(self) -> int:
        return self.nodes

    def degree(self) -> int:
        return self.base_graph.base_degree + self.expansion_degree

    def base_degree(self) -> int:
        return self.base_graph.base_degree

    def sector_size(self) -> int:
        return self.nodes * 32

    def identifier(self) -> str:
        return (
            f"stacked-graph-{self.nodes}-{self.base_graph.base_degree}-"
            f"{self.expansion_degree}-{self.porep_id.hex()}"
        )

    def expanded_parents(self, node: int) -> np.ndarray:
        """(EXP_DEGREE,) uint32 expander parents of `node` (the native
        Feistel engine over the one-node window)."""
        return expander_parents_native(
            self.nodes,
            self.expansion_degree,
            self.feistel_keys,
            self.feistel_precomputed[2],
            start=node,
            end=node + 1,
        )[0]

    def base_parents(self, node: int) -> np.ndarray:
        """(BASE_DEGREE,) uint32 DRG parents of `node`."""
        return self.base_graph.parents_batch(np.asarray([node], dtype=np.uint64))[0]

    # node window per generation step: bounds the DRG bucket-sampling
    # temporaries (~10 vectorized u64 arrays per window) and the
    # expander output to ~1 GB — the one-shot parents_all peaked 13 GB
    # at the 512MiB class and would need >100 GB at 32GiB (r5 RSS probe)
    PARENTS_CHUNK = 1 << 21

    def parents_into(self, out: np.ndarray) -> None:
        """Fill a [nodes, DEGREE] uint32 array or memmap window-wise
        (the parent-cache generation path, reference cache.hpp payload).

        The expander half goes through the native Blake2b Feistel kernel
        (~50x the per-node python permute, which took ~20 min for the
        512MiB table)."""
        m = self.base_graph.base_degree
        for lo in range(0, self.nodes, self.PARENTS_CHUNK):
            hi = min(lo + self.PARENTS_CHUNK, self.nodes)
            out[lo:hi, :m] = self.base_graph.parents_batch(
                np.arange(lo, hi, dtype=np.uint64)
            )
            exp = expander_parents_native(
                self.nodes,
                self.expansion_degree,
                self.feistel_keys,
                self.feistel_precomputed[2],
                start=lo,
                end=hi,
            )
            out[lo:hi, m:] = exp
