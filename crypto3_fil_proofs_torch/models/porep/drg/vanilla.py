"""DRG PoRep — the simple single-layer PoRep (vanilla prover/verifier).

Re-implements reference porep/drg/vanilla.hpp:42-437: sequential encode
along node order (`replicate` :292-346), per-challenge proofs = replica
node inclusion + all parent inclusions + data node inclusion
(`prove` :162-210), verify recomputes key = SHA(id || parent replica
data) and decodes (`verify` :212-290); extract via key re-derivation.

Copied from crypto3_fil_proofs_tpu/models/porep/drg/vanilla.py with its
imports rewritten. Host work, as there: the trees are the port's SHA-256
`MerkleTree`s (the native C engine hashes their levels).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from crypto3_fil_proofs_torch.core.drgraph import BucketGraph
from crypto3_fil_proofs_torch.core.merkle.tree import MerkleProof, MerkleTree
from crypto3_fil_proofs_torch.ops.bls12_381 import R

NODE_SIZE = 32


@dataclass
class SetupParams:
    drg: "DrgParams"
    private: bool = True
    challenges_count: int = 2


@dataclass
class DrgParams:
    nodes: int
    degree: int
    expansion_degree: int  # always 0 for plain DRG
    seed: bytes  # porep_id


@dataclass
class PublicParams:
    graph: BucketGraph
    private: bool
    challenges_count: int


@dataclass
class Tau:
    comm_d: bytes
    comm_r: bytes


@dataclass
class ProverAux:
    tree_d: MerkleTree
    tree_r: MerkleTree


@dataclass
class PublicInputs:
    replica_id: bytes
    challenges: list[int]
    tau: Tau | None


@dataclass
class PrivateInputs:
    tree_d: MerkleTree
    tree_r: MerkleTree


@dataclass
class DataProof:
    proof: MerkleProof
    data: bytes  # the 32-byte node


@dataclass
class Proof:
    data_root: bytes
    replica_root: bytes
    replica_nodes: list[DataProof]
    replica_parents: list[list[tuple[int, DataProof]]]
    nodes: list[DataProof]  # data nodes at the challenges


def _fr_add(a: bytes, b: bytes) -> bytes:
    return (
        (int.from_bytes(a, "little") + int.from_bytes(b, "little")) % R
    ).to_bytes(32, "little")


def _fr_sub(a: bytes, b: bytes) -> bytes:
    return (
        (int.from_bytes(a, "little") - int.from_bytes(b, "little")) % R
    ).to_bytes(32, "little")


class DrgPoRep:
    @staticmethod
    def setup(sp: SetupParams) -> PublicParams:
        graph = BucketGraph(sp.drg.nodes, sp.drg.degree, sp.drg.seed)
        return PublicParams(graph, sp.private, sp.challenges_count)

    # -- replication (reference vanilla.hpp:292-346) -----------------------

    @staticmethod
    def replicate(
        pp: PublicParams, replica_id: bytes, data: np.ndarray
    ) -> tuple[Tau, ProverAux, np.ndarray]:
        """data: (nodes, 32) uint8. Returns (tau, aux, replica array)."""
        graph = pp.graph
        nodes = graph.size()
        assert data.shape == (nodes, NODE_SIZE)
        tree_d = MerkleTree.build(data, 2, "sha256")

        replica = data.copy()
        buf = replica.tobytes()  # parents always have lower index, but
        # the reference encodes against already-encoded parents in place
        out = bytearray(buf)
        for node in range(nodes):
            parents = graph.parents(node)
            key = DrgPoRep._create_key(replica_id, node, parents, bytes(out))
            off = node * NODE_SIZE
            enc = _fr_add(bytes(out[off : off + NODE_SIZE]), key)
            out[off : off + NODE_SIZE] = enc
        replica = np.frombuffer(bytes(out), dtype=np.uint8).reshape(nodes, NODE_SIZE)
        tree_r = MerkleTree.build(replica, 2, "sha256")
        tau = Tau(comm_d=tree_d.root(), comm_r=tree_r.root())
        return tau, ProverAux(tree_d, tree_r), replica

    # SHA-256(replica_id || parents' encoded nodes), trimmed to Fr; node 0
    # (its own first parent) hashes the id alone
    _create_key = staticmethod(BucketGraph.create_key)

    # -- extraction (reference vanilla.hpp extract/extract_all) ------------

    @staticmethod
    def extract_all(pp: PublicParams, replica_id: bytes, replica: np.ndarray) -> np.ndarray:
        nodes = pp.graph.size()
        data = bytes(replica.tobytes())
        out = bytearray(data)
        # decode in REVERSE order so parents are still encoded when used
        for node in range(nodes - 1, -1, -1):
            parents = pp.graph.parents(node)
            key = DrgPoRep._create_key(replica_id, node, parents, bytes(out))
            off = node * NODE_SIZE
            out[off : off + NODE_SIZE] = _fr_sub(
                bytes(out[off : off + NODE_SIZE]), key
            )
        return np.frombuffer(bytes(out), dtype=np.uint8).reshape(nodes, NODE_SIZE)

    # -- prove / verify (reference vanilla.hpp:162-290) --------------------

    @staticmethod
    def prove(pp: PublicParams, pub: PublicInputs, priv: PrivateInputs) -> Proof:
        graph = pp.graph
        replica_nodes, replica_parents, data_nodes = [], [], []
        for challenge_raw in pub.challenges:
            challenge = challenge_raw % graph.size()
            assert challenge != 0, "cannot prove the first node"
            tree_d, tree_r = priv.tree_d, priv.tree_r
            rp = tree_r.gen_proof(challenge)
            replica_nodes.append(DataProof(rp, rp.leaf))
            parents = graph.parents(challenge)
            parent_proofs = []
            for p in parents:
                pproof = tree_r.gen_proof(int(p))
                parent_proofs.append((int(p), DataProof(pproof, pproof.leaf)))
            replica_parents.append(parent_proofs)
            dp = tree_d.gen_proof(challenge)
            data_nodes.append(DataProof(dp, dp.leaf))
        return Proof(
            data_root=priv.tree_d.root(),
            replica_root=priv.tree_r.root(),
            replica_nodes=replica_nodes,
            replica_parents=replica_parents,
            nodes=data_nodes,
        )

    @staticmethod
    def verify(pp: PublicParams, pub: PublicInputs, proof: Proof) -> bool:
        graph = pp.graph
        if pub.tau is not None:
            if proof.data_root != pub.tau.comm_d:
                return False
            if proof.replica_root != pub.tau.comm_r:
                return False
        for i, challenge_raw in enumerate(pub.challenges):
            challenge = challenge_raw % graph.size()
            if challenge == 0:
                return False
            rn = proof.replica_nodes[i]
            if not rn.proof.validate() or rn.proof.root != proof.replica_root:
                return False
            if not rn.proof.proves_challenge(challenge):
                return False
            expected_parents = [int(p) for p in graph.parents(challenge)]
            got_parents = [p for p, _ in proof.replica_parents[i]]
            if expected_parents != got_parents:
                return False
            for p, dp in proof.replica_parents[i]:
                if not dp.proof.validate() or dp.proof.root != proof.replica_root:
                    return False
                if not dp.proof.proves_challenge(p):
                    return False
            # recompute the key from parent replica data and decode
            h = hashlib.sha256()
            h.update(pub.replica_id)
            if challenge != expected_parents[0]:
                for _, dp in proof.replica_parents[i]:
                    h.update(dp.data)
            d = bytearray(h.digest())
            d[31] &= 0x3F
            key = bytes(d)
            decoded = _fr_sub(rn.data, key)
            dn = proof.nodes[i]
            if dn.data != decoded:
                return False
            if not dn.proof.validate() or dn.proof.root != proof.data_root:
                return False
            if not dn.proof.proves_challenge(challenge):
                return False
        return True
