"""Election PoSt circuit + compound public inputs.

Re-implements reference post/election/circuit.hpp:35-135 (comm_r = H2
check, per-challenge PoR, partial_ticket Poseidon-MD in-circuit,
inputize the ticket) and the compound skeleton
(post/election/compound.hpp:40-56, cache_prefix
`proof-of-spacetime-election-<tree>`).

Copied from crypto3_fil_proofs_tpu/models/post/election/circuit.py with
its imports rewritten.
"""
from __future__ import annotations

from crypto3_fil_proofs_torch.ops.bls12_381 import R
from crypto3_fil_proofs_torch.ops.poseidon import POSEIDON_MD_ARITY
from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
from crypto3_fil_proofs_torch.zk.gadgets.poseidon import (
    hash2_circuit,
    poseidon_hash_circuit,
)
from crypto3_fil_proofs_torch.zk.gadgets.por import (
    pack_position_bits_into_inputs,
    packed_position_input_values,
    por_circuit,
)
from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem

from .vanilla import (
    NODE_SIZE,
    Proof,
    PublicInputs,
    PublicParams,
    generate_leaf_challenge,
)

_LE = lambda b: int.from_bytes(b, "little")


def hash_md_circuit(cs, elements: list[AllocatedNum]) -> AllocatedNum:
    """In-circuit Poseidon-MD fold (mirrors ops/poseidon.hash_md)."""
    arity = POSEIDON_MD_ARITY
    assert len(elements) >= 1
    if len(elements) == 1:
        return elements[0]
    zero = AllocatedNum.alloc(cs, 0, "md_zero")
    # constrain the zero padding element
    from crypto3_fil_proofs_torch.zk.r1cs import LinearCombination, lc_one

    cs.enforce(zero.lc(), lc_one(), LinearCombination(), "md_zero")
    acc = elements[0]
    for start in range(1, len(elements), arity - 1):
        chunk = elements[start : start + arity - 1]
        preimage = [acc] + chunk
        preimage += [zero] * (arity - len(preimage))
        acc = poseidon_hash_circuit(cs, preimage, arity)
    return acc


def synthesize(
    cs: ConstraintSystem,
    pub_params: PublicParams,
    pub_inputs: PublicInputs,
    proof: Proof,
) -> None:
    comm_r_num = AllocatedNum.alloc_input(cs, _LE(pub_inputs.comm_r), "comm_r")
    comm_c_num = AllocatedNum.alloc(cs, _LE(proof.comm_c), "comm_c")
    comm_r_last = proof.comm_r_last()
    comm_r_last_num = AllocatedNum.alloc(cs, _LE(comm_r_last), "comm_r_last")
    AllocatedNum.equals(
        cs, hash2_circuit(cs, comm_c_num, comm_r_last_num), comm_r_num
    )

    leaf_nums = []
    for incl in proof.inclusion_proofs:
        leaf = AllocatedNum.alloc(cs, _LE(incl.leaf), "leaf")
        bits = por_circuit(
            cs, leaf, incl.as_options(), comm_r_last_num, hasher="poseidon"
        )
        pack_position_bits_into_inputs(cs, bits)
        leaf_nums.append(leaf)

    fields = [
        AllocatedNum.alloc_input(
            cs, _LE(pub_inputs.randomness) % R, "randomness"
        ),
        AllocatedNum.alloc_input(cs, _LE(pub_inputs.prover_id) % R, "prover_id"),
        AllocatedNum.alloc_input(cs, pub_inputs.sector_id % R, "sector_id"),
    ]
    partial = hash_md_circuit(cs, fields + leaf_nums)
    partial.inputize(cs)


def circuit_from_vanilla(pub_params, pub_inputs, proof) -> ConstraintSystem:
    cs = ConstraintSystem()
    synthesize(cs, pub_params, pub_inputs, proof)
    return cs


def generate_public_inputs(
    pub_params: PublicParams, pub_inputs: PublicInputs
) -> list[int]:
    """comm_r, per-challenge packed leaf bits (in synthesis order:
    interleaved with the randomness/prover/sector/partial inputs)."""
    leaves = pub_params.sector_size // NODE_SIZE
    n_bits = (leaves - 1).bit_length()
    inputs = [_LE(pub_inputs.comm_r)]
    for n in range(pub_params.challenge_count):
        leaf = generate_leaf_challenge(
            pub_params, pub_inputs.randomness, pub_inputs.sector_challenge_index, n
        )
        for d in range(pub_params.challenged_nodes):
            inputs.extend(
                packed_position_input_values((leaf + d) % leaves, n_bits)
            )
    inputs.append(_LE(pub_inputs.randomness) % R)
    inputs.append(_LE(pub_inputs.prover_id) % R)
    inputs.append(pub_inputs.sector_id % R)
    inputs.append(_LE(pub_inputs.partial_ticket) % R)
    return inputs


class ElectionPoStCompound:
    def __init__(self, shape=(8, 0, 0)):
        self.shape = shape

    def cache_prefix(self, pub_params: PublicParams) -> str:
        base, sub, top = self.shape
        return (
            f"proof-of-spacetime-election-poseidon-{base}-{sub}-{top}-"
            f"{pub_params.sector_size}-{pub_params.challenge_count}-"
            f"{pub_params.challenged_nodes}"
        )

    def circuit_from_vanilla(self, pub_params, pub_inputs, proof, k=0, device="cuda"):
        # scalar gadgets: no witness replay runs on `device`
        return circuit_from_vanilla(pub_params, pub_inputs, proof)

    def generate_public_inputs(self, pub_params, pub_inputs, k=0):
        return generate_public_inputs(pub_params, pub_inputs)

    def blank_circuit(self, pub_params: PublicParams):
        from crypto3_fil_proofs_torch.core.merkle.tree import MerkleProof, ProofLevel

        from .vanilla import Proof as VProof

        _Z32 = b"\0" * 32
        base, sub, top = self.shape
        leafs = pub_params.sector_size // NODE_SIZE

        def blank_incl():
            levels = []
            n = leafs
            for a in (sub, top):
                if a:
                    n //= a
            while n > 1:
                levels.append(ProofLevel([_Z32] * (base - 1), 0))
                n //= base
            if sub:
                levels.append(ProofLevel([_Z32] * (sub - 1), 0))
            if top:
                levels.append(ProofLevel([_Z32] * (top - 1), 0))
            return MerkleProof(leaf=_Z32, root=_Z32, path=levels)

        blank_proof = VProof(
            inclusion_proofs=[
                blank_incl()
                for _ in range(
                    pub_params.challenge_count * pub_params.challenged_nodes
                )
            ],
            ticket=_Z32,
            comm_c=_Z32,
        )
        blank_inputs = PublicInputs(
            randomness=_Z32,
            sector_id=0,
            prover_id=_Z32,
            comm_r=_Z32,
            partial_ticket=_Z32,
            sector_challenge_index=0,
        )
        return circuit_from_vanilla(pub_params, blank_inputs, blank_proof)
