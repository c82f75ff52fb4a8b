"""Stacked SDR data model: params, proofs, columns, labeling/encoding.

Copied from crypto3_fil_proofs_tpu/models/porep/stacked/vanilla/params.py,
which re-implements reference porep/stacked/vanilla/params.hpp (530 LoC data
model), challenges.hpp, column.hpp/column_proof.hpp, labelling_proof.hpp,
encoding_proof.hpp, and the naive verification processing
(detail/processing/naive/params.hpp).

Labeling message layout (used consistently by labeling, proofs, and the
in-circuit SHA-256 gadget): SHA-256 over
    replica_id(32) || pad32(BE32(layer) || BE64(node)) || label(p_0)..label(p_36)
with parent labels cycled to TOTAL_PARENTS=37 slots
(reference: create_label.hpp:41-122 + proof.hpp:233-237 "repeat parents";
layer 1 uses the 6 base parents of the current layer, layers 2+ the 6
base parents of the current layer then the 8 expander parents of the
previous layer). The digest's last byte is masked &0x3F to land in Fr.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass

import numpy as np

from crypto3_fil_proofs_torch.core.merkle import MerkleProof
from crypto3_fil_proofs_torch.ops.field import R
from crypto3_fil_proofs_torch.ops.poseidon import column_hash, hash2

TOTAL_PARENTS = 37
NODE_SIZE = 32


# ---------------------------------------------------------------------------
# Challenges (reference: stacked/vanilla/challenges.hpp:44-96)
# ---------------------------------------------------------------------------


@dataclass
class LayerChallenges:
    layers: int
    max_count: int

    def challenges_count_all(self) -> int:
        return self.max_count

    def derive(self, leaves: int, replica_id: bytes, seed: bytes, k: int) -> list[int]:
        """challenge_i = LE(SHA-256(replica_id || seed || LE32(k*count+i)))
        mod (leaves-1) + 1."""
        assert leaves > 2, "too few leaves"
        out = []
        for i in range(self.max_count):
            j = self.max_count * k + i
            h = hashlib.sha256(
                replica_id + seed + j.to_bytes(4, "little")
            ).digest()
            big = int.from_bytes(h, "little")
            out.append(big % (leaves - 1) + 1)
        return out


# ---------------------------------------------------------------------------
# Setup / public params (reference: params.hpp:60-110)
# ---------------------------------------------------------------------------


@dataclass
class SetupParams:
    nodes: int
    degree: int
    expansion_degree: int
    porep_id: bytes
    layer_challenges: LayerChallenges


@dataclass
class PublicParams:
    graph: "object"  # StackedBucketGraph
    layer_challenges: LayerChallenges

    @property
    def layers(self) -> int:
        return self.layer_challenges.layers

    def sector_size(self) -> int:
        return self.graph.sector_size()

    def identifier(self) -> str:
        return (
            f"layered_drgporep::PublicParams{{ graph: {self.graph.identifier()},"
            f" challenges: {self.layer_challenges.layers}-{self.layer_challenges.max_count} }}"
        )


@dataclass
class Tau:
    comm_d: bytes
    comm_r: bytes


@dataclass
class PersistentAux:
    comm_c: bytes
    comm_r_last: bytes


@dataclass
class PublicInputs:
    replica_id: bytes  # 32-byte LE Fr
    seed: bytes
    tau: Tau | None
    k: int | None = None

    def challenges(self, layer_challenges: LayerChallenges, leaves: int, k: int | None = None) -> list[int]:
        k = k if k is not None else (self.k or 0)
        return layer_challenges.derive(leaves, self.replica_id, self.seed, k)


# ---------------------------------------------------------------------------
# Columns (reference: column.hpp:40-66, column_proof.hpp:36-74)
# ---------------------------------------------------------------------------


@dataclass
class Column:
    index: int
    rows: list[bytes]  # label per layer, 32-byte LE each

    def hash(self) -> bytes:
        ints = [int.from_bytes(r, "little") for r in self.rows]
        return column_hash(ints).to_bytes(32, "little")

    def get_node_at_layer(self, layer: int) -> bytes:
        """1-indexed layer."""
        return self.rows[layer - 1]


@dataclass
class ColumnProof:
    column: Column
    inclusion_proof: MerkleProof

    def root(self) -> bytes:
        return self.inclusion_proof.root

    def get_node_at_layer(self, layer: int) -> bytes:
        return self.column.get_node_at_layer(layer)

    def verify(self, challenge: int, expected_root: bytes) -> bool:
        if self.inclusion_proof.root != expected_root:
            return False
        if not self.inclusion_proof.validate_data(self.column.hash()):
            return False
        return self.inclusion_proof.proves_challenge(self.column.index)


# ---------------------------------------------------------------------------
# Labeling / encoding proofs
# (reference: labelling_proof.hpp, encoding_proof.hpp,
#  detail/processing/naive/labelling_proof.hpp)
# ---------------------------------------------------------------------------


def label_message(replica_id: bytes, layer_index: int, node: int, parents_labels: list[bytes]) -> bytes:
    buf = bytearray(32)
    buf[0:4] = layer_index.to_bytes(4, "big")
    buf[4:12] = node.to_bytes(8, "big")
    return replica_id + bytes(buf) + b"".join(parents_labels)


def create_label_from_parents(replica_id: bytes, layer_index: int, node: int, parents_labels: list[bytes]) -> bytes:
    """SHA-256 of the labeling message, masked to Fr."""
    d = bytearray(hashlib.sha256(label_message(replica_id, layer_index, node, parents_labels)).digest())
    d[31] &= 0x3F
    return bytes(d)


def repeat_parents(parents_labels: list[bytes]) -> list[bytes]:
    """Cycle the available parent labels into TOTAL_PARENTS slots
    (reference: proof.hpp:233-237)."""
    n = len(parents_labels)
    return [parents_labels[i % n] for i in range(TOTAL_PARENTS)]


@dataclass
class LabelingProof:
    layer_index: int  # 1-based
    node: int
    parents: list[bytes]  # TOTAL_PARENTS labels

    def create_label(self, replica_id: bytes) -> bytes:
        return create_label_from_parents(replica_id, self.layer_index, self.node, self.parents)

    def verify(self, replica_id: bytes, expected_label: bytes) -> bool:
        return self.create_label(replica_id) == expected_label


@dataclass
class EncodingProof:
    layer_index: int
    node: int
    parents: list[bytes]

    def verify(self, replica_id: bytes, exp_encoded_node: bytes, decoded_node: bytes) -> bool:
        key = create_label_from_parents(replica_id, self.layer_index, self.node, self.parents)
        encoded = encode_node(key, decoded_node)
        return encoded == exp_encoded_node


def encode_node(key: bytes, data: bytes) -> bytes:
    """Sloth-0 encode: data + key in Fr (reference: core/components/encode
    semantics; replica node = data + labeling key)."""
    v = (int.from_bytes(data, "little") + int.from_bytes(key, "little")) % R
    return v.to_bytes(32, "little")


def decode_node(key: bytes, encoded: bytes) -> bytes:
    v = (int.from_bytes(encoded, "little") - int.from_bytes(key, "little")) % R
    return v.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Proof bundle (reference: params.hpp:460-490)
# ---------------------------------------------------------------------------


@dataclass
class ReplicaColumnProof:
    c_x: ColumnProof
    drg_parents: list[ColumnProof]
    exp_parents: list[ColumnProof]


@dataclass
class Proof:
    comm_d_proof: MerkleProof
    replica_column_proofs: ReplicaColumnProof
    comm_r_last_proof: MerkleProof
    labeling_proofs: list[LabelingProof]
    encoding_proof: EncodingProof

    def comm_c(self) -> bytes:
        return self.replica_column_proofs.c_x.root()

    def comm_r_last(self) -> bytes:
        return self.comm_r_last_proof.root

    def verify(
        self,
        pub_params: PublicParams,
        pub_inputs: PublicInputs,
        challenge: int,
        graph,
    ) -> bool:
        """Vanilla per-challenge verification
        (reference: detail/processing/naive/params.hpp:70-160)."""
        replica_id = pub_inputs.replica_id
        if challenge >= graph.size() or challenge <= 1:
            return False
        # comm_d inclusion
        if not self.comm_d_proof.validate():
            return False
        if not self.comm_d_proof.proves_challenge(challenge):
            return False
        # comm_r binding
        if pub_inputs.tau is not None:
            expect = hash2(
                int.from_bytes(self.comm_c(), "little"),
                int.from_bytes(self.comm_r_last(), "little"),
            ).to_bytes(32, "little")
            if expect != pub_inputs.tau.comm_r:
                return False
        # replica column proofs against comm_c
        comm_c = self.comm_c()
        rcp = self.replica_column_proofs
        if not rcp.c_x.verify(challenge, comm_c):
            return False
        base_parents = graph.base_parents(challenge)
        exp_parents = graph.expanded_parents(challenge)
        if len(rcp.drg_parents) != len(base_parents):
            return False
        for proof, parent in zip(rcp.drg_parents, base_parents):
            if not proof.verify(int(parent), comm_c):
                return False
        if len(rcp.exp_parents) != len(exp_parents):
            return False
        for proof, parent in zip(rcp.exp_parents, exp_parents):
            if not proof.verify(int(parent), comm_c):
                return False
        # comm_r_last inclusion of the encoded node
        if not self.comm_r_last_proof.validate():
            return False
        if not self.comm_r_last_proof.proves_challenge(challenge):
            return False
        # labeling proofs per layer
        layers = pub_params.layers
        if len(self.labeling_proofs) != layers:
            return False
        for layer, lp in enumerate(self.labeling_proofs, start=1):
            if lp.layer_index != layer or lp.node != challenge:
                return False
            expected = rcp.c_x.get_node_at_layer(layer)
            if not lp.verify(replica_id, expected):
                return False
        # encoding proof: encode(key_last_layer, data_leaf) == replica leaf
        if not self.encoding_proof.verify(
            replica_id, self.comm_r_last_proof.leaf, self.comm_d_proof.leaf
        ):
            return False
        return True


def proofs_digest(partition_proofs: list[list[Proof]]) -> str:
    """SHA-256 (hex) of the vanilla proofs of every partition in a
    canonical form: JSON of their fields, bytes as hex. Equal proofs give
    equal digests, whichever package's classes hold them."""
    text = json.dumps([[asdict(p) for p in part] for part in partition_proofs],
                      default=bytes.hex, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Replica id (reference: params.hpp:508-524)
# ---------------------------------------------------------------------------


def generate_replica_id(
    prover_id: bytes, sector_id: int, ticket: bytes, comm_d: bytes, porep_seed: bytes
) -> bytes:
    """SHA-256(prover_id || BE64(sector_id) || ticket || comm_d || porep_id),
    masked to Fr."""
    h = hashlib.sha256(
        prover_id + sector_id.to_bytes(8, "big") + ticket + comm_d + porep_seed
    ).digest()
    d = bytearray(h)
    d[31] &= 0x3F
    return bytes(d)


# ---------------------------------------------------------------------------
# Aux state (reference: params.hpp:103-270, 353-448)
# ---------------------------------------------------------------------------


@dataclass
class Labels:
    """Per-layer label arrays: list of (nodes, 32) uint8 (memory or memmap)."""

    layers_data: list[np.ndarray]

    def layer(self, layer: int) -> np.ndarray:
        """1-indexed."""
        return self.layers_data[layer - 1]

    def label(self, layer: int, node: int) -> bytes:
        return self.layers_data[layer - 1][node].tobytes()

    def column(self, node: int) -> Column:
        return Column(
            index=node,
            rows=[ld[node].tobytes() for ld in self.layers_data],
        )

    @property
    def layers(self) -> int:
        return len(self.layers_data)


@dataclass
class TemporaryAux:
    """Tree/label handles kept between seal phases."""

    labels: Labels
    tree_d: "object"  # MerkleTree (binary sha256)
    tree_c: "object"  # CompoundMerkleTree | MerkleTree (poseidon)
    tree_r_last: "object"  # CompoundMerkleTree | MerkleTree (poseidon, LC)


@dataclass
class PrivateInputs:
    p_aux: PersistentAux
    t_aux: TemporaryAux
