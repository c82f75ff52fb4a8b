"""StackedDrg: SDR labeling, the column tree and the vanilla proofs.

Counterpart of crypto3_fil_proofs_tpu/models/porep/stacked/vanilla/
proof.py (reference porep/stacked/vanilla/proof.hpp): `setup`, the
in-memory `generate_labels` (:74) and `transform_and_replicate_layers`
(:156) that the multi-sector pipeline runs (parallel/pipeline.py),
`generate_labels_streamed` (:105), `_generate_tree_c` (:211), the
unseal's `generate_last_layer_key` (:234) and
`extract_and_invert_transform_layers` (:266), and `prove_all_partitions`
(:294) / `verify_all_partitions` (:364), copied as they are; the proofs
read the stored trees and labels on the host, and the unseal's labeling
and decode run on the host too.

Labeling is the one inherently sequential loop (node n needs n - 1), so
it stays on the host in the native C engine, with the parent table
precomputed as one array (ParentCache). The column hashes and trees run
where the caller's `device` says: kernels K1 and K2 on a GPU.
"""
from __future__ import annotations

import numpy as np
import torch

from crypto3_fil_proofs_torch.core.merkle import MerkleTree, StoreConfig, create_tree
from crypto3_fil_proofs_torch.core.measure import measure_op
from crypto3_fil_proofs_torch.core.settings import settings
from crypto3_fil_proofs_torch.ops.fr_numpy import fr_add_bytes, fr_sub_bytes
from crypto3_fil_proofs_torch.ops.native import label_layer_native
from crypto3_fil_proofs_torch.ops.poseidon import hash2
from crypto3_fil_proofs_torch.ops.poseidon_torch import L, bytes_to_mont, hash_level

from .cache import ParentCache
from .graph import StackedBucketGraph
from .params import (
    NODE_SIZE,
    ColumnProof,
    EncodingProof,
    LabelingProof,
    Labels,
    PersistentAux,
    PrivateInputs,
    Proof,
    PublicInputs,
    PublicParams,
    ReplicaColumnProof,
    SetupParams,
    Tau,
    TemporaryAux,
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
    def generate_labels(
        graph: StackedBucketGraph,
        layers: int,
        replica_id: bytes,
        parent_cache: ParentCache | None = None,
    ) -> Labels:
        """Sequential SDR labeling of every layer, each held in memory
        (reference proof.hpp:297-360). Without a parent cache the table
        is made in memory."""
        nodes = graph.size()
        if parent_cache is not None:
            parents_tbl = parent_cache.table()
        else:
            parents_tbl = np.empty((nodes, graph.degree()), dtype="<u4")
            graph.parents_into(parents_tbl)
        base_tbl = parents_tbl[:, :BASE]
        exp_tbl = parents_tbl[:, BASE:]
        layer_arrays: list[np.ndarray] = []
        prev: np.ndarray | None = None
        for layer in range(1, layers + 1):
            cur = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
            label_layer_native(
                cur, prev, replica_id, layer, base_tbl, exp_tbl if layer > 1 else None
            )
            layer_arrays.append(cur)
            prev = cur
        return Labels(layer_arrays)

    @staticmethod
    def transform_and_replicate_layers(
        pp: PublicParams,
        replica_id: bytes,
        data_leaves: np.ndarray,
        shape: tuple[int, int, int] = (8, 0, 0),
        configs: dict | None = None,
        parent_cache: ParentCache | None = None,
        device="cuda",
    ):
        """Phase 1 and 2 of replication in memory: labels, tree_d,
        tree_c, the encoding, tree_r_last and comm_r. Returns (tau,
        p_aux, t_aux, replica_leaves). `configs` may carry StoreConfigs
        for 'tree-d' / 'tree-c' / 'tree-r-last' to keep the trees on
        disk; the Poseidon trees are hashed on `device`."""
        if data_leaves.shape != (pp.graph.size(), NODE_SIZE):
            raise ValueError(f"data leaves {data_leaves.shape} for a graph of {pp.graph.size()} nodes")
        labels = StackedDrg.generate_labels(pp.graph, pp.layers, replica_id, parent_cache)
        return StackedDrg.replicate_labeled(data_leaves, labels, shape, configs, device)

    @staticmethod
    def replicate_labeled(data_leaves: np.ndarray, labels: Labels, shape, configs: dict | None, device):
        """The phase-2 half of `transform_and_replicate_layers`, from the
        labels: tree_d (binary SHA-256, host), then `encode_and_build`
        into a new replica array."""
        if data_leaves.shape != labels.layers_data[0].shape:
            raise ValueError(f"data leaves {data_leaves.shape} for labels of {labels.layers_data[0].shape}")
        configs = configs or {}
        tree_d = MerkleTree.build(data_leaves, 2, "sha256", configs.get("tree-d"))
        replica = np.empty_like(labels.layers_data[0])
        tree_c, tree_r_last, comm_r = StackedDrg.encode_and_build(
            labels, data_leaves, replica, shape, configs.get("tree-c"), configs.get("tree-r-last"), device
        )
        return (
            Tau(comm_d=tree_d.root(), comm_r=comm_r),
            PersistentAux(comm_c=tree_c.root(), comm_r_last=tree_r_last.root()),
            TemporaryAux(labels=labels, tree_d=tree_d, tree_c=tree_c, tree_r_last=tree_r_last),
            replica,
        )

    @staticmethod
    def encode_and_build(labels: Labels, data, replica, shape, tree_c_configs, tree_r_configs, device):
        """The phase-2 step of PC2 and `replicate_labeled`: tree_c (column
        hashes and the Poseidon tree on `device`), the encoding (replica
        = data + key layer, in host chunks, into `replica`, which may be
        `data` itself, a memmap flushed at the end), tree_r_last on
        `device`, and comm_r = H(comm_c, comm_r_last). Returns (tree_c,
        tree_r_last, comm_r). Spans: tree_c, encode, tree_r_last."""
        with measure_op("tree_c"):
            tree_c = StackedDrg._generate_tree_c(labels, shape, tree_c_configs, device)
        key_layer = labels.layer(labels.layers)
        chunk = settings().max_gpu_tree_batch_size
        with measure_op("encode"):
            for lo in range(0, replica.shape[0], chunk):
                hi = lo + chunk
                replica[lo:hi] = fr_add_bytes(np.asarray(data[lo:hi]), np.asarray(key_layer[lo:hi]))
            if isinstance(replica, np.memmap):
                replica.flush()
        with measure_op("tree_r_last"):
            tree_r_last = create_tree(replica, shape[0], shape[1], shape[2], "poseidon", tree_r_configs, device)
        comm_r = hash2(
            int.from_bytes(tree_c.root(), "little"), int.from_bytes(tree_r_last.root(), "little")
        ).to_bytes(32, "little")
        return tree_c, tree_r_last, comm_r

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

    @staticmethod
    def generate_last_layer_key(
        pp: PublicParams, replica_id: bytes, parent_cache: ParentCache
    ) -> np.ndarray:
        """SDR key regeneration for decode: the 2-layer ping-pong of
        generate_labels_streamed WITHOUT persisting intermediate layers
        — decode only needs layer `layers`, so peak RAM is ~2 sectors
        regardless of layer count (reference proof.hpp:268-295 uses the
        same bounded-buffer discipline as labeling)."""
        graph, layers = pp.graph, pp.layers
        nodes = graph.size()
        parents_tbl = parent_cache.table()
        base_tbl = parents_tbl[:, :BASE]
        exp_tbl = parents_tbl[:, BASE:]
        ping = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
        pong = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
        prev: np.ndarray | None = None
        for layer in range(1, layers + 1):
            cur = pong if prev is ping else ping
            label_layer_native(
                cur, prev, replica_id, layer, base_tbl,
                exp_tbl if layer > 1 else None,
            )
            prev = cur
        return prev

    @staticmethod
    def extract_and_invert_transform_layers(
        pp: PublicParams,
        replica_id: bytes,
        replica_leaves: np.ndarray,
        parent_cache: ParentCache,
        out: np.ndarray | None = None,
    ) -> np.ndarray:
        """Unseal: regenerate the key layer (2-layer ping-pong), decode
        chunk-wise (reference: proof.hpp:268-295). `replica_leaves` may
        be a read-only memmap; `out` (optional) receives the decoded
        leaves in place, and may be the key's own buffer. Spans
        (core/measure.py): unseal_key, unseal_decode."""
        with measure_op("unseal_key"):
            key = StackedDrg.generate_last_layer_key(pp, replica_id, parent_cache)
        nodes = key.shape[0]
        if out is None:
            out = np.empty((nodes, NODE_SIZE), dtype=np.uint8)
        chunk = 1 << 22
        with measure_op("unseal_decode"):
            for lo in range(0, nodes, chunk):
                hi = min(lo + chunk, nodes)
                out[lo:hi] = fr_sub_bytes(np.asarray(replica_leaves[lo:hi]), key[lo:hi])
        return out

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
