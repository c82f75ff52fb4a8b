"""DRG PoRep circuit + compound public inputs.

Re-implements reference porep/drg/circuit.hpp:44-249 (per-challenge
replica/parents/data inclusion + key derivation + encoding check) and
compound.hpp:41-224 (public inputs: replica_id + per-challenge PoR
inputs over replica/parents vs comm_r and data vs comm_d).

Copied from crypto3_fil_proofs_tpu/models/porep/drg/circuit.py with its
imports rewritten. The circuit is scalar (dict) rows: about 2 M
constraints for 8 nodes, degree 6 and one challenge, a 2^21 domain.
"""
from __future__ import annotations

from crypto3_fil_proofs_torch.ops.bls12_381 import R
from crypto3_fil_proofs_torch.zk.gadgets.boolean import Boolean, pack_bits_lc
from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
from crypto3_fil_proofs_torch.zk.gadgets.por import (
    pack_position_bits_into_inputs,
    packed_position_input_values,
    por_circuit,
)
from crypto3_fil_proofs_torch.zk.gadgets.sha256 import le_bits_to_be, sha256
from crypto3_fil_proofs_torch.zk.r1cs import (
    ConstraintSystem,
    LinearCombination,
    lc_one,
)

from .vanilla import Proof, PublicInputs, PublicParams

_LE = lambda b: int.from_bytes(b, "little")


def _num_to_be_bits(cs, num: AllocatedNum) -> list:
    # replica/parent values are full canonical Fr (< R < 2^255): encoded
    # nodes are data+key mod R, so bit 254 may be set — decompose 255
    # bits (unlike &0x3F-masked labels, which fit 254).
    bits = num.to_bits_le(cs, 255) + [Boolean.const(False)]
    return le_bits_to_be(bits)


def synthesize(
    cs: ConstraintSystem,
    pub_params: PublicParams,
    pub_inputs: PublicInputs,
    proof: Proof,
) -> None:
    replica_id_num = AllocatedNum.alloc_input(
        cs, _LE(pub_inputs.replica_id), "replica_id"
    )
    comm_r_num = AllocatedNum.alloc_input(cs, _LE(proof.replica_root), "comm_r")
    comm_d_num = AllocatedNum.alloc_input(cs, _LE(proof.data_root), "comm_d")
    replica_id_bits = _num_to_be_bits(cs, replica_id_num)

    for i in range(len(pub_inputs.challenges)):
        rn = proof.replica_nodes[i]
        # replica node inclusion vs comm_r
        leaf_r = AllocatedNum.alloc(cs, _LE(rn.data), "replica_leaf")
        bits = por_circuit(
            cs, leaf_r, rn.proof.as_options(), comm_r_num, hasher="sha256"
        )
        pack_position_bits_into_inputs(cs, bits)
        # parents inclusion + collect their values for the key
        parent_nums = []
        for p, dp in proof.replica_parents[i]:
            pn = AllocatedNum.alloc(cs, _LE(dp.data), "parent")
            pbits = por_circuit(
                cs, pn, dp.proof.as_options(), comm_r_num, hasher="sha256"
            )
            pack_position_bits_into_inputs(cs, pbits)
            parent_nums.append(pn)
        # key = SHA-256(replica_id || parent values), Fr trim
        msg = list(replica_id_bits)
        for pn in parent_nums:
            msg.extend(_num_to_be_bits(cs, pn))
        digest_be = sha256(cs, msg)
        key_lc, key_val = pack_bits_lc(le_bits_to_be(digest_be)[:254])
        # data node: decoded = replica - key; inclusion vs comm_d
        dn = proof.nodes[i]
        leaf_d = AllocatedNum.alloc(cs, _LE(dn.data), "data_leaf")
        cs.enforce(
            leaf_d.lc() + key_lc - leaf_r.lc(),
            lc_one(),
            LinearCombination(),
            "decode",
        )
        dbits = por_circuit(
            cs, leaf_d, dn.proof.as_options(), comm_d_num, hasher="sha256"
        )
        pack_position_bits_into_inputs(cs, dbits)


def circuit_from_vanilla(pub_params, pub_inputs, proof) -> ConstraintSystem:
    cs = ConstraintSystem()
    synthesize(cs, pub_params, pub_inputs, proof)
    return cs


class DrgPoRepCompound:
    """Compound adapter: DRG vanilla <-> circuit <-> Groth16
    (reference porep/drg/compound.hpp:41-224 — cache identity,
    blank circuit for setup, public-input generation). Plugs into
    core/compound.CompoundProof; DRG proves a single partition."""

    def cache_prefix(self, pub_params: PublicParams) -> str:
        g = pub_params.graph
        return (
            f"drg-proof-of-replication-sha256-{g.size()}-{g.degree()}-"
            f"{pub_params.challenges_count}"
        )

    def circuit_from_vanilla(self, pub_params, pub_inputs, partition_proofs, k=0, device="cuda"):
        # scalar gadgets: no witness replay runs on `device`
        assert k == 0, "DRG PoRep is single-partition"
        return circuit_from_vanilla(pub_params, pub_inputs, partition_proofs)

    def blank_circuit(self, pub_params: PublicParams) -> ConstraintSystem:
        from ..stacked.circuit.compound import blank_merkle_proof
        from .vanilla import DataProof, Proof as VanillaProof, Tau

        g = pub_params.graph
        leaves = g.size()
        z32 = b"\0" * 32

        def blank_dp():
            return DataProof(
                proof=blank_merkle_proof(leaves, 2, 0, 0), data=z32
            )

        count = pub_params.challenges_count
        proof = VanillaProof(
            data_root=z32,
            replica_root=z32,
            replica_nodes=[blank_dp() for _ in range(count)],
            replica_parents=[
                [(0, blank_dp()) for _ in range(g.degree())]
                for _ in range(count)
            ],
            nodes=[blank_dp() for _ in range(count)],
        )
        blank_inputs = PublicInputs(
            replica_id=z32,
            challenges=[1] * count,
            tau=Tau(comm_d=z32, comm_r=z32),
        )
        return circuit_from_vanilla(pub_params, blank_inputs, proof)

    def generate_public_inputs(self, pub_params, pub_inputs, k=0):
        return generate_public_inputs(pub_params, pub_inputs)


def generate_public_inputs(
    pub_params: PublicParams, pub_inputs: PublicInputs, proof_meta=None
) -> list[int]:
    """replica_id, comm_r, comm_d, then per challenge: replica PoR bits,
    parent PoR bits (graph order), data PoR bits."""
    graph = pub_params.graph
    leaves = graph.size()
    n_bits = (leaves - 1).bit_length()
    assert pub_inputs.tau is not None
    inputs = [
        _LE(pub_inputs.replica_id),
        _LE(pub_inputs.tau.comm_r),
        _LE(pub_inputs.tau.comm_d),
    ]
    for challenge_raw in pub_inputs.challenges:
        challenge = challenge_raw % leaves
        inputs.extend(packed_position_input_values(challenge, n_bits))
        for parent in graph.parents(challenge):
            inputs.extend(packed_position_input_values(int(parent), n_bits))
        inputs.extend(packed_position_input_values(challenge, n_bits))
    return inputs
