"""StackedDrg: SDR labeling, the column tree and the vanilla proofs.

Counterpart of crypto3_fil_proofs_tpu/models/porep/stacked/vanilla/
proof.py (reference porep/stacked/vanilla/proof.hpp): `setup`,
`generate_labels_streamed` (:105), `_generate_tree_c` (:211), and
`prove_all_partitions` (:294) / `verify_all_partitions` (:364), copied
as they are; the proofs read the stored trees and labels on the host.

Labeling is the one inherently sequential loop (node n needs n - 1), so
it stays on the host in the native C engine, with the parent table
precomputed as one array (ParentCache). The column hashes and trees run
where the caller's `device` says: kernels K1 and K2 on a GPU.
"""
from __future__ import annotations

import numpy as np
import torch

from crypto3_fil_proofs_torch.core.merkle import StoreConfig, create_tree
from crypto3_fil_proofs_torch.core.settings import settings
from crypto3_fil_proofs_torch.ops.native import label_layer_native
from crypto3_fil_proofs_torch.ops.poseidon_torch import L, bytes_to_mont, hash_level

from .cache import ParentCache
from .graph import StackedBucketGraph
from .params import (
    NODE_SIZE,
    ColumnProof,
    EncodingProof,
    LabelingProof,
    Labels,
    PrivateInputs,
    Proof,
    PublicInputs,
    PublicParams,
    ReplicaColumnProof,
    SetupParams,
    repeat_parents,
)

BASE = 6  # base parents hashed per node


class StackedDrg:
    @staticmethod
    def setup(sp: SetupParams) -> PublicParams:
        graph = StackedBucketGraph(
            sp.nodes,
            base_degree=sp.degree,
            expansion_degree=sp.expansion_degree,
            porep_id=sp.porep_id,
        )
        return PublicParams(graph=graph, layer_challenges=sp.layer_challenges)

    @staticmethod
    def generate_labels_streamed(
        graph: StackedBucketGraph,
        layers: int,
        replica_id: bytes,
        layer_paths: list[str],
        parent_cache: ParentCache,
    ) -> Labels:
        """Memory-scaled SDR labeling: a 2-layer ping-pong working set
        with each finished layer persisted to its file and handed back as
        a read-only memmap; peak RAM is ~2 sectors regardless of layer
        count (reference proof.hpp:311-313 ping-pong buffer + :339-354
        per-layer DiskStore persist)."""
        nodes = graph.size()
        if len(layer_paths) != layers:
            raise ValueError(f"{len(layer_paths)} layer paths for {layers} layers")
        parents_tbl = parent_cache.table()
        # u32 views straight into the (possibly mmapped) parent table: the
        # labeling engine takes row strides, so no copy is made
        base_tbl = parents_tbl[:, :BASE]
        exp_tbl = parents_tbl[:, BASE:]

        ping = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
        pong = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
        memmaps: list[np.ndarray] = []
        prev: np.ndarray | None = None
        for layer in range(1, layers + 1):
            cur = ping if layer % 2 else pong
            label_layer_native(
                cur, prev, replica_id, layer, base_tbl,
                exp_tbl if layer > 1 else None,
            )
            cur.tofile(layer_paths[layer - 1])
            memmaps.append(
                np.memmap(
                    layer_paths[layer - 1], dtype=np.uint8, mode="r",
                    shape=(nodes, NODE_SIZE),
                )
            )
            prev = cur
        return Labels(memmaps)

    @staticmethod
    def _generate_tree_c(
        labels: Labels, shape, configs: list[StoreConfig] | None, device
    ):
        """Column-hash leaves, then a compound Poseidon tree
        (reference: proof.hpp:380-646).

        Columns are assembled from the (mmapped) layer files in bounded
        batches (reference GPU column batch cap, configuration.hpp:
        50-56) and hashed on `device`; the column hashes, the tree's
        leaves, stay there in Montgomery form. The tree converts them
        once, to write its leaf level."""
        layers = labels.layers
        nodes = labels.layers_data[0].shape[0]
        col_batch = settings().max_gpu_column_batch_size
        leaves = torch.empty((nodes, L), dtype=torch.int32, device=device)
        for lo in range(0, nodes, col_batch):
            hi = min(lo + col_batch, nodes)
            cols = np.stack(
                [mm[lo:hi] for mm in labels.layers_data], axis=1
            ).reshape((hi - lo) * layers, NODE_SIZE)
            leaves[lo:hi] = hash_level(bytes_to_mont(torch.from_numpy(cols).to(device)), layers)
        return create_tree(leaves, shape[0], shape[1], shape[2], "poseidon", configs, device)

    # -- proving (reference: proof.hpp:63-266 prove_layers) ---------------

    @staticmethod
    def prove_all_partitions(
        pp: PublicParams,
        pub_inputs: PublicInputs,
        priv_inputs: PrivateInputs,
        partitions: int,
    ) -> list[list[Proof]]:
        graph = pp.graph
        layers = pp.layers
        t_aux = priv_inputs.t_aux
        labels = t_aux.labels
        result = []
        for k in range(partitions):
            challenges = pub_inputs.challenges(
                pp.layer_challenges, graph.size(), k
            )
            proofs_k = []
            for challenge in challenges:
                if not 1 < challenge < graph.size():
                    raise ValueError(f"challenge {challenge} out of range")
                comm_d_proof = t_aux.tree_d.gen_proof(challenge)

                base_parents = [int(p) for p in graph.base_parents(challenge)]
                exp_parents = [int(p) for p in graph.expanded_parents(challenge)]

                def column_proof(node: int) -> ColumnProof:
                    col = labels.column(node)
                    incl = t_aux.tree_c.gen_proof(node)
                    return ColumnProof(column=col, inclusion_proof=incl)

                rcp = ReplicaColumnProof(
                    c_x=column_proof(challenge),
                    drg_parents=[column_proof(p) for p in base_parents],
                    exp_parents=[column_proof(p) for p in exp_parents],
                )

                comm_r_last_proof = t_aux.tree_r_last.gen_proof(challenge)

                labeling_proofs = []
                encoding_proof = None
                for layer in range(1, layers + 1):
                    if layer == 1:
                        parents_data = [labels.label(1, p) for p in base_parents]
                    else:
                        parents_data = [
                            labels.label(layer, p) for p in base_parents
                        ] + [labels.label(layer - 1, p) for p in exp_parents]
                    full = repeat_parents(parents_data)
                    lp = LabelingProof(layer_index=layer, node=challenge, parents=full)
                    expected = rcp.c_x.get_node_at_layer(layer)
                    if not lp.verify(pub_inputs.replica_id, expected):
                        raise AssertionError(f"invalid labeling proof generated at layer {layer}")
                    labeling_proofs.append(lp)
                    if layer == layers:
                        encoding_proof = EncodingProof(
                            layer_index=layer, node=challenge, parents=full
                        )

                proofs_k.append(
                    Proof(
                        comm_d_proof=comm_d_proof,
                        replica_column_proofs=rcp,
                        comm_r_last_proof=comm_r_last_proof,
                        labeling_proofs=labeling_proofs,
                        encoding_proof=encoding_proof,
                    )
                )
            result.append(proofs_k)
        return result

    @staticmethod
    def verify_all_partitions(
        pp: PublicParams, pub_inputs: PublicInputs, partition_proofs: list[list[Proof]]
    ) -> bool:
        graph = pp.graph
        for k, proofs in enumerate(partition_proofs):
            challenges = pub_inputs.challenges(pp.layer_challenges, graph.size(), k)
            if len(challenges) != len(proofs):
                return False
            for challenge, proof in zip(challenges, proofs):
                if not proof.verify(pp, pub_inputs, challenge, graph):
                    return False
        return True
