"""Election PoSt (candidate-based, legacy) — vanilla.

Re-implements reference post/election/vanilla.hpp (375 LoC):
candidate generation with partial tickets
(`generate_candidates`/`generate_candidate` :227-307 — partial_ticket =
Poseidon-MD(randomness || prover_id || sector_id || challenged leaves),
ticket = SHA-256(partial_ticket)), and prove/verify of the challenged
leaves' inclusion.

Copied from crypto3_fil_proofs_tpu/models/post/election/vanilla.py with
its imports rewritten. Host work: `tree.leaf` and `tree.gen_proof` read
nodes from the tree's store (a sealed sector's tree_r_last files are
not read whole).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from crypto3_fil_proofs_torch.core.merkle import MerkleProof
from crypto3_fil_proofs_torch.ops.bls12_381 import R
from crypto3_fil_proofs_torch.ops.poseidon import hash2, hash_md

NODE_SIZE = 32


@dataclass
class SetupParams:
    sector_size: int
    challenge_count: int
    challenged_nodes: int


@dataclass
class PublicParams:
    sector_size: int
    challenge_count: int
    challenged_nodes: int


@dataclass
class Candidate:
    sector_id: int
    partial_ticket: bytes
    ticket: bytes
    sector_challenge_index: int


@dataclass
class PublicInputs:
    randomness: bytes
    sector_id: int
    prover_id: bytes
    comm_r: bytes
    partial_ticket: bytes
    sector_challenge_index: int


@dataclass
class PrivateInputs:
    tree: "object"
    comm_c: bytes
    comm_r_last: bytes


@dataclass
class Proof:
    inclusion_proofs: list[MerkleProof]
    ticket: bytes
    comm_c: bytes

    def comm_r_last(self) -> bytes:
        return self.inclusion_proofs[0].root


def generate_sector_challenges(
    randomness: bytes, challenge_count: int, sector_set: list[int]
) -> list[int]:
    """Challenged sector per index n (reference :derive over sector set)."""
    out = []
    for n in range(challenge_count):
        h = hashlib.sha256(randomness + n.to_bytes(8, "little")).digest()
        out.append(sector_set[int.from_bytes(h[:8], "little") % len(sector_set)])
    return out


def generate_leaf_challenge(
    pub_params: PublicParams, randomness: bytes, sector_challenge_index: int, leaf_index: int
) -> int:
    leaves = pub_params.sector_size // NODE_SIZE
    h = hashlib.sha256(
        randomness
        + sector_challenge_index.to_bytes(8, "little")
        + leaf_index.to_bytes(8, "little")
    ).digest()
    return int.from_bytes(h[:8], "little") % leaves


def generate_candidate(
    pub_params: PublicParams,
    tree,
    prover_id: bytes,
    sector_id: int,
    randomness: bytes,
    sector_challenge_index: int,
) -> Candidate:
    """partial_ticket = Poseidon-MD over [randomness, prover_id,
    sector_id, challenged leaf values]; ticket = SHA-256(partial)."""
    fields = [
        int.from_bytes(randomness, "little") % R,
        int.from_bytes(prover_id, "little") % R,
        sector_id % R,
    ]
    for n in range(pub_params.challenge_count):
        leaf = generate_leaf_challenge(
            pub_params, randomness, sector_challenge_index, n
        )
        for d in range(pub_params.challenged_nodes):
            idx = (leaf + d) % (pub_params.sector_size // NODE_SIZE)
            fields.append(int.from_bytes(tree.leaf(idx), "little") % R)
    partial = hash_md(fields).to_bytes(32, "little")
    ticket = hashlib.sha256(partial).digest()
    return Candidate(
        sector_id=sector_id,
        partial_ticket=partial,
        ticket=ticket,
        sector_challenge_index=sector_challenge_index,
    )


def generate_candidates(
    pub_params: PublicParams,
    challenged_sectors: list[int],
    trees: dict,
    prover_id: bytes,
    randomness: bytes,
) -> list[Candidate]:
    return [
        generate_candidate(
            pub_params, trees[sector_id], prover_id, sector_id, randomness, idx
        )
        for idx, sector_id in enumerate(challenged_sectors)
    ]


class ElectionPoSt:
    @staticmethod
    def setup(sp: SetupParams) -> PublicParams:
        return PublicParams(sp.sector_size, sp.challenge_count, sp.challenged_nodes)

    @staticmethod
    def prove(pp: PublicParams, pub: PublicInputs, priv: PrivateInputs) -> Proof:
        leaves = pp.sector_size // NODE_SIZE
        proofs = []
        for n in range(pp.challenge_count):
            leaf = generate_leaf_challenge(pp, pub.randomness, pub.sector_challenge_index, n)
            for d in range(pp.challenged_nodes):
                proofs.append(priv.tree.gen_proof((leaf + d) % leaves))
        candidate = generate_candidate(
            pp, priv.tree, pub.prover_id, pub.sector_id, pub.randomness,
            pub.sector_challenge_index,
        )
        return Proof(
            inclusion_proofs=proofs, ticket=candidate.ticket, comm_c=priv.comm_c
        )

    @staticmethod
    def verify(pp: PublicParams, pub: PublicInputs, proof: Proof) -> bool:
        leaves = pp.sector_size // NODE_SIZE
        comm_r_last = proof.comm_r_last()
        expect = hash2(
            int.from_bytes(proof.comm_c, "little"),
            int.from_bytes(comm_r_last, "little"),
        ).to_bytes(32, "little")
        if expect != pub.comm_r:
            return False
        i = 0
        fields = [
            int.from_bytes(pub.randomness, "little") % R,
            int.from_bytes(pub.prover_id, "little") % R,
            pub.sector_id % R,
        ]
        for n in range(pp.challenge_count):
            leaf = generate_leaf_challenge(pp, pub.randomness, pub.sector_challenge_index, n)
            for d in range(pp.challenged_nodes):
                incl = proof.inclusion_proofs[i]
                i += 1
                if incl.root != comm_r_last:
                    return False
                if not incl.validate():
                    return False
                if not incl.proves_challenge((leaf + d) % leaves):
                    return False
                fields.append(int.from_bytes(incl.leaf, "little") % R)
        partial = hash_md(fields).to_bytes(32, "little")
        return partial == pub.partial_ticket
