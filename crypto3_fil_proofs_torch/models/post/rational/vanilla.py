"""Rational PoSt (deterministic challenge set over sector faults) — vanilla.

Re-implements reference post/rational/vanilla.hpp (256 LoC):
`derive_challenges` hashes seed||n over the non-faulty sector space,
per-challenge Merkle inclusion proofs against the challenged sector's
comm_r_last, comm_r binding via H2(comm_c, comm_r_last).

Copied from crypto3_fil_proofs_tpu/models/post/rational/vanilla.py with
its imports rewritten. Host work.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from crypto3_fil_proofs_torch.core.merkle import MerkleProof
from crypto3_fil_proofs_torch.ops.poseidon import hash2

NODE_SIZE = 32


@dataclass
class SetupParams:
    sector_size: int
    challenges_count: int


@dataclass
class PublicParams:
    sector_size: int
    challenges_count: int


@dataclass
class Challenge:
    sector: int
    leaf: int


@dataclass
class PublicInputs:
    challenges: list[Challenge]
    faults: set[int]
    comm_rs: dict[int, bytes]  # sector -> comm_r


@dataclass
class PrivateInputs:
    trees: dict[int, "object"]
    comm_c: dict[int, bytes]
    comm_r_last: dict[int, bytes]


@dataclass
class Proof:
    inclusion_proofs: list[MerkleProof]
    comm_cs: list[bytes]


def derive_challenges(
    challenge_count: int, sector_size: int, sectors: list[int], seed: bytes, faults: set[int]
) -> list[Challenge]:
    """Deterministic challenges over the non-faulty ordered sector set
    (reference rational/vanilla.hpp derive_challenges)."""
    good = [s for s in sorted(sectors) if s not in faults]
    assert good, "no non-faulty sectors"
    leaves = sector_size // NODE_SIZE
    out = []
    for n in range(challenge_count):
        h = hashlib.sha256(seed + n.to_bytes(8, "little")).digest()
        big = int.from_bytes(h[:8], "little")
        sector = good[big % len(good)]
        leaf = int.from_bytes(h[8:16], "little") % leaves
        out.append(Challenge(sector=sector, leaf=leaf))
    return out


class RationalPoSt:
    @staticmethod
    def setup(sp: SetupParams) -> PublicParams:
        return PublicParams(sp.sector_size, sp.challenges_count)

    @staticmethod
    def prove(pp: PublicParams, pub: PublicInputs, priv: PrivateInputs) -> Proof:
        proofs, comm_cs = [], []
        for ch in pub.challenges:
            tree = priv.trees[ch.sector]
            proofs.append(tree.gen_proof(ch.leaf))
            comm_cs.append(priv.comm_c[ch.sector])
        return Proof(inclusion_proofs=proofs, comm_cs=comm_cs)

    @staticmethod
    def verify(pp: PublicParams, pub: PublicInputs, proof: Proof) -> bool:
        if len(proof.inclusion_proofs) != len(pub.challenges):
            return False
        for ch, incl, comm_c in zip(
            pub.challenges, proof.inclusion_proofs, proof.comm_cs
        ):
            if ch.sector in pub.faults:
                return False
            comm_r = pub.comm_rs.get(ch.sector)
            if comm_r is None:
                return False
            expect = hash2(
                int.from_bytes(comm_c, "little"),
                int.from_bytes(incl.root, "little"),
            ).to_bytes(32, "little")
            if expect != comm_r:
                return False
            if not incl.validate():
                return False
            if not incl.proves_challenge(ch.leaf):
                return False
        return True
