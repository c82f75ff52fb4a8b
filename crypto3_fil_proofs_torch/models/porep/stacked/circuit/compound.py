"""StackedCompound: vanilla SDR <-> circuit <-> Groth16 adapter.

(reference: porep/stacked/circuit/proof.hpp:177-337 StackedCompound —
cache_prefix `stacked-proof-of-replication-<tree>-<hasher>` :177-180,
blank_circuit with challenges_count_all empty proofs :300-317.)

Copied from crypto3_fil_proofs_tpu/models/porep/stacked/circuit/compound.py with its imports rewritten.
"""
from __future__ import annotations

from crypto3_fil_proofs_torch.core.merkle.tree import MerkleProof, ProofLevel

from ..vanilla.params import (
    TOTAL_PARENTS,
    Column,
    ColumnProof,
    EncodingProof,
    LabelingProof,
    Proof,
    PublicInputs,
    PublicParams,
    ReplicaColumnProof,
    Tau,
)
from . import proof as circ

_Z32 = b"\0" * 32


def blank_merkle_proof(
    leafs: int, base_arity: int, sub_arity: int, top_arity: int
) -> MerkleProof:
    """Zero-valued proof with the exact path shape of the tree
    (reference blank-circuit MerkleProof shape, builders.hpp tree math)."""
    base_leafs = leafs
    for a in (sub_arity, top_arity):
        if a:
            base_leafs //= a
    levels = []
    n = base_leafs
    while n > 1:
        levels.append(ProofLevel(siblings=[_Z32] * (base_arity - 1), index=0))
        n //= base_arity
    if sub_arity:
        levels.append(ProofLevel(siblings=[_Z32] * (sub_arity - 1), index=0))
    if top_arity:
        levels.append(ProofLevel(siblings=[_Z32] * (top_arity - 1), index=0))
    return MerkleProof(leaf=_Z32, root=_Z32, path=levels)


def blank_proof(pub_params: PublicParams, shape) -> Proof:
    layers = pub_params.layers
    graph = pub_params.graph
    leafs = graph.size()
    base, sub, top = shape

    def blank_column_proof():
        return ColumnProof(
            column=Column(index=0, rows=[_Z32] * layers),
            inclusion_proof=blank_merkle_proof(leafs, base, sub, top),
        )

    return Proof(
        comm_d_proof=blank_merkle_proof(leafs, 2, 0, 0),
        replica_column_proofs=ReplicaColumnProof(
            c_x=blank_column_proof(),
            drg_parents=[blank_column_proof() for _ in range(graph.base_degree())],
            exp_parents=[
                blank_column_proof() for _ in range(graph.expansion_degree)
            ],
        ),
        comm_r_last_proof=blank_merkle_proof(leafs, base, sub, top),
        labeling_proofs=[
            LabelingProof(layer_index=layer, node=0, parents=[_Z32] * TOTAL_PARENTS)
            for layer in range(1, layers + 1)
        ],
        encoding_proof=EncodingProof(
            layer_index=layers, node=0, parents=[_Z32] * TOTAL_PARENTS
        ),
    )


class StackedCompound:
    def __init__(self, shape=(8, 0, 0)):
        self.shape = shape

    def cache_prefix(self, pub_params: PublicParams) -> str:
        base, sub, top = self.shape
        return (
            f"stacked-proof-of-replication-poseidon-{base}-{sub}-{top}-"
            f"{pub_params.identifier()}"
        )

    def circuit_from_vanilla(self, pub_params, pub_inputs, partition_proofs, k, device="cuda"):
        comm_c = partition_proofs[0].comm_c()
        comm_r_last = partition_proofs[0].comm_r_last()
        return circ.circuit_from_vanilla(
            pub_params, pub_inputs, partition_proofs, comm_c, comm_r_last, device=device
        )

    def blank_circuit(self, pub_params: PublicParams):
        count = pub_params.layer_challenges.challenges_count_all()
        proofs = [blank_proof(pub_params, self.shape) for _ in range(count)]
        blank_inputs = PublicInputs(
            replica_id=_Z32,
            seed=_Z32,
            tau=Tau(comm_d=_Z32, comm_r=_Z32),
            k=0,
        )
        return circ.circuit_from_vanilla(
            pub_params, blank_inputs, proofs, _Z32, _Z32, blank=True
        )

    def generate_public_inputs(self, pub_params, pub_inputs, k):
        return circ.generate_public_inputs(pub_params, pub_inputs, k)
