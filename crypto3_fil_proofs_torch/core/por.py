"""PoR: single Merkle-inclusion proof scheme (reference core/por.hpp:36-122).

Copied from crypto3_fil_proofs_tpu/core/por.py.

The challenge is reduced mod the leaf count; public commitment equality
is enforced when the tree root is public (private=False).
"""
from __future__ import annotations

from dataclasses import dataclass

from .merkle import MerkleProof


@dataclass
class PoRSetupParams:
    leaves: int
    private: bool = False


@dataclass
class PoRPublicParams:
    leaves: int
    private: bool


@dataclass
class PoRPublicInputs:
    challenge: int
    commitment: bytes | None = None  # root, when public


@dataclass
class PoRPrivateInputs:
    leaf: bytes
    tree: "object"


@dataclass
class DataProof:
    proof: MerkleProof
    data: bytes


class PoR:
    @staticmethod
    def setup(sp: PoRSetupParams) -> PoRPublicParams:
        return PoRPublicParams(sp.leaves, sp.private)

    @staticmethod
    def prove(
        pp: PoRPublicParams, pub: PoRPublicInputs, priv: PoRPrivateInputs
    ) -> DataProof:
        challenge = pub.challenge % pp.leaves
        proof = priv.tree.gen_proof(challenge)
        return DataProof(proof=proof, data=proof.leaf)

    @staticmethod
    def verify(
        pp: PoRPublicParams, pub: PoRPublicInputs, proof: DataProof
    ) -> bool:
        challenge = pub.challenge % pp.leaves
        if not pp.private and pub.commitment is not None:
            if proof.proof.root != pub.commitment:
                return False
        if not proof.proof.validate():
            return False
        return proof.proof.proves_challenge(challenge)
