"""FallbackPoStCompound: vanilla PoSt <-> circuit <-> Groth16 adapter.

Copied from crypto3_fil_proofs_tpu/models/post/fallback/compound.py with
its imports rewritten. It fills the reference's empty
post/fallback/compound.hpp stub (rust impl: per-sector PoR public
inputs; padding sectors). The cache prefix is the JAX package's to the
character (the election compound's `proof-of-spacetime-*` naming,
reference post/election/compound.hpp:40-56): setup's seed derives from
it, so the port's key equals the JAX package's.
"""
from __future__ import annotations

from crypto3_fil_proofs_torch.core.merkle.tree import MerkleProof, ProofLevel

from . import circuit as circ
from .vanilla import NODE_SIZE, Proof, PublicInputs, PublicParams, PublicSector, SectorProof

_Z32 = b"\0" * 32


def blank_partition_proof(pub_params: PublicParams, shape) -> Proof:
    base, sub, top = shape
    leafs = pub_params.sector_size // NODE_SIZE

    def blank_inclusion():
        base_leafs = leafs
        for a in (sub, top):
            if a:
                base_leafs //= a
        levels = []
        n = base_leafs
        while n > 1:
            levels.append(ProofLevel(siblings=[_Z32] * (base - 1), index=0))
            n //= base
        if sub:
            levels.append(ProofLevel(siblings=[_Z32] * (sub - 1), index=0))
        if top:
            levels.append(ProofLevel(siblings=[_Z32] * (top - 1), index=0))
        return MerkleProof(leaf=_Z32, root=_Z32, path=levels)

    return Proof(
        sectors=[
            SectorProof(
                inclusion_proofs=[blank_inclusion() for _ in range(pub_params.challenge_count)],
                comm_c=_Z32,
                comm_r_last=_Z32,
            )
            for _ in range(pub_params.sector_count)
        ]
    )


class FallbackPoStCompound:
    def __init__(self, shape=(8, 0, 0)):
        self.shape = shape

    def cache_prefix(self, pub_params: PublicParams) -> str:
        base, sub, top = self.shape
        return (
            f"proof-of-spacetime-fallback-poseidon-{base}-{sub}-{top}-"
            f"{pub_params.sector_size}-{pub_params.challenge_count}-"
            f"{pub_params.sector_count}"
        )

    def circuit_from_vanilla(self, pub_params, pub_inputs, partition_proof, k, device="cuda"):
        return circ.circuit_from_vanilla(pub_params, pub_inputs, partition_proof, k, device=device)

    def blank_circuit(self, pub_params: PublicParams):
        blank_inputs = PublicInputs(
            randomness=_Z32,
            prover_id=_Z32,
            sectors=[PublicSector(id=0, comm_r=_Z32) for _ in range(pub_params.sector_count)],
            k=0,
        )
        return circ.circuit_from_vanilla(
            pub_params, blank_inputs,
            blank_partition_proof(pub_params, self.shape), 0, blank=True,
        )

    def generate_public_inputs(self, pub_params, pub_inputs, k):
        return circ.generate_public_inputs(pub_params, pub_inputs, k)
