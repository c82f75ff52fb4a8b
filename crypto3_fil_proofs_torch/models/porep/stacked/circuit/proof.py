"""Stacked SDR PoRep circuit (R1CS synthesis) + public-input generation.

Re-implements the reference's StackedCircuit / StackedCompound
(reference: porep/stacked/circuit/proof.hpp:42-337 — top circuit with
public replica_id/comm_d/comm_r, private comm_c/comm_r_last tied by
comm_r == H2(comm_c, comm_r_last); per-challenge sub-circuits from
circuit/params.hpp:42-276; create_label circuit per rust-fil-proofs
since circuit/create_label.hpp is an empty stub).

Public-input order (must match generate_public_inputs exactly):
  [replica_id, comm_d, comm_r] then per challenge:
    comm_d PoR packed path bits,
    6 DRG parent column PoR packed bits (tree_c),
    8 expander parent column PoR packed bits (layers >= 2 only),
    challenge value (u64 as Fr),
    comm_r_last PoR packed bits,
    c_x column PoR packed bits.
(reference order per SURVEY §2.5 circuit row: comm_d PoR inputs, DRG+exp
parent PoR inputs, u64 challenge, comm_r_last PoR, c_x PoR.)

Copied from crypto3_fil_proofs_tpu/models/porep/stacked/circuit/proof.py with its imports rewritten.
"""
from __future__ import annotations

from crypto3_fil_proofs_torch.ops.bls12_381 import R
from crypto3_fil_proofs_torch.zk.gadgets.boolean import Boolean
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
from crypto3_fil_proofs_torch.zk.gadgets.sha256 import le_bits_to_be, sha256
from crypto3_fil_proofs_torch.zk.r1cs import (
    ConstraintSystem,
    LinearCombination,
    lc_one,
)

from ..vanilla.params import (
    TOTAL_PARENTS,
    PublicInputs,
    PublicParams,
    Proof,
)

_LE = lambda b: int.from_bytes(b, "little")


def _num_to_256_le_bits(cs, num: AllocatedNum) -> list:
    """A label/Fr num as 256 LE bits (bits 254/255 constant zero —
    labels are &0x3F-masked, reference create_label.hpp:77)."""
    bits = num.to_bits_le(cs, 254)
    return bits + [Boolean.const(False), Boolean.const(False)]


def _be64_bits(node_bits_le: list) -> list:
    """LE node bits (padded to 64) -> BE64 byte-stream bits."""
    padded = list(node_bits_le) + [Boolean.const(False)] * (64 - len(node_bits_le))
    out = []
    for k in range(8):  # byte k = (node >> 8*(7-k)) & 0xff, MSB-first
        base = 8 * (7 - k)
        for i in range(7, -1, -1):
            out.append(padded[base + i])
    return out


def _labeling_digest(
    cs, replica_id_bits_be, layer: int, node_bits_le, parent_bits_be: list
) -> tuple[LinearCombination, int]:
    """SHA-256 label circuit; returns (254-bit packed LC, value).

    Message: replica_id(32B) || BE32(layer) BE64(node) 20x00 || 37 parent
    labels (vanilla params.label_message layout).
    """
    msg = list(replica_id_bits_be)
    for i in range(31, -1, -1):  # BE32(layer)
        msg.append(Boolean.const((layer >> i) & 1))
    msg.extend(_be64_bits(node_bits_le))
    msg.extend([Boolean.const(False)] * (20 * 8))  # zero padding to 32 B
    assert len(parent_bits_be) == TOTAL_PARENTS
    for pb in parent_bits_be:
        msg.extend(pb)
    digest_be = sha256(cs, msg)
    le = le_bits_to_be(digest_be)  # involution -> LE-within-byte order
    from crypto3_fil_proofs_torch.zk.gadgets.boolean import pack_bits_lc

    return pack_bits_lc(le[:254])  # &0x3F trim


def _column_por(cs, column_rows: list[bytes], path_options, comm_c: AllocatedNum):
    """Allocate a column, hash it (Poseidon arity=layers), prove
    inclusion in tree_c; returns (column nums, packed-input count)."""
    col_nums = [AllocatedNum.alloc(cs, _LE(row), "col") for row in column_rows]
    col_hash = poseidon_hash_circuit(cs, col_nums, len(col_nums))
    bits = por_circuit(cs, col_hash, path_options, comm_c, hasher="poseidon")
    pack_position_bits_into_inputs(cs, bits)
    return col_nums


def synthesize(
    cs: ConstraintSystem,
    pub_params: PublicParams,
    replica_id: bytes,
    comm_d: bytes,
    comm_r: bytes,
    comm_c: bytes,
    comm_r_last: bytes,
    vanilla_proofs: list[Proof],
) -> None:
    """Build the full partition circuit from vanilla proofs (witness)."""
    layers = pub_params.layers

    replica_id_num = AllocatedNum.alloc_input(cs, _LE(replica_id), "replica_id")
    comm_d_num = AllocatedNum.alloc_input(cs, _LE(comm_d), "comm_d")
    comm_r_num = AllocatedNum.alloc_input(cs, _LE(comm_r), "comm_r")
    comm_r_last_num = AllocatedNum.alloc(cs, _LE(comm_r_last), "comm_r_last")
    comm_c_num = AllocatedNum.alloc(cs, _LE(comm_c), "comm_c")

    # comm_r == H2(comm_c, comm_r_last)  (reference proof.hpp:143-160)
    hashed = hash2_circuit(cs, comm_c_num, comm_r_last_num)
    AllocatedNum.equals(cs, hashed, comm_r_num)

    replica_id_bits_le = _num_to_256_le_bits(cs, replica_id_num)
    replica_id_bits_be = le_bits_to_be(replica_id_bits_le)

    for proof in vanilla_proofs:
        with cs.namespace("challenge"):
            _synthesize_challenge(
                cs,
                layers,
                replica_id_bits_be,
                proof,
                comm_d_num,
                comm_r_last_num,
                comm_c_num,
            )


def _synthesize_challenge(
    cs, layers, replica_id_bits_be, proof: Proof, comm_d_num, comm_r_last_num,
    comm_c_num,
):
    # 1. comm_d inclusion of the data leaf (binary SHA-256 tree)
    leaf_d = AllocatedNum.alloc(cs, _LE(proof.comm_d_proof.leaf), "data_leaf")
    d_bits = por_circuit(
        cs, leaf_d, proof.comm_d_proof.as_options(), comm_d_num, hasher="sha256"
    )
    pack_position_bits_into_inputs(cs, d_bits)

    # 2. parent column proofs against comm_c
    rcp = proof.replica_column_proofs
    drg_cols = [
        _column_por(
            cs, cp.column.rows, cp.inclusion_proof.as_options(), comm_c_num
        )
        for cp in rcp.drg_parents
    ]
    exp_cols = [
        _column_por(
            cs, cp.column.rows, cp.inclusion_proof.as_options(), comm_c_num
        )
        for cp in rcp.exp_parents
    ]

    # 3. challenge value as u64 public input (tied to comm_d path bits)
    challenge_num = AllocatedNum.from_bits_le(cs, d_bits)
    challenge_num.inputize(cs)

    # 4. comm_r_last inclusion of the replica leaf
    leaf_r = AllocatedNum.alloc(cs, _LE(proof.comm_r_last_proof.leaf), "replica_leaf")
    r_bits = por_circuit(
        cs,
        leaf_r,
        proof.comm_r_last_proof.as_options(),
        comm_r_last_num,
        hasher="poseidon",
    )
    pack_position_bits_into_inputs(cs, r_bits)

    # 5. c_x column against comm_c
    cx_cols = _column_por(
        cs,
        rcp.c_x.column.rows,
        rcp.c_x.inclusion_proof.as_options(),
        comm_c_num,
    )

    # 6. labeling circuits per layer; parent label bits reused across
    #    layers (drg parents: current layer; exp parents: previous layer)
    drg_bits = [
        [None] * layers for _ in drg_cols
    ]  # drg_bits[p][l-1] = BE bits of drg parent p's label at layer l
    exp_bits = [[None] * layers for _ in exp_cols]

    def drg_label_bits(p, layer):
        if drg_bits[p][layer - 1] is None:
            drg_bits[p][layer - 1] = le_bits_to_be(
                _num_to_256_le_bits(cs, drg_cols[p][layer - 1])
            )
        return drg_bits[p][layer - 1]

    def exp_label_bits(p, layer):
        if exp_bits[p][layer - 1] is None:
            exp_bits[p][layer - 1] = le_bits_to_be(
                _num_to_256_le_bits(cs, exp_cols[p][layer - 1])
            )
        return exp_bits[p][layer - 1]

    key_lc = key_val = None
    for layer in range(1, layers + 1):
        if layer == 1:
            parents = [drg_label_bits(p, 1) for p in range(len(drg_cols))]
        else:
            parents = [drg_label_bits(p, layer) for p in range(len(drg_cols))] + [
                exp_label_bits(p, layer - 1) for p in range(len(exp_cols))
            ]
        full = [parents[i % len(parents)] for i in range(TOTAL_PARENTS)]
        label_lc, label_val = _labeling_digest(
            cs, replica_id_bits_be, layer, d_bits, full
        )
        expected = cx_cols[layer - 1]
        cs.enforce(
            label_lc - expected.lc(), lc_one(), LinearCombination(), "label"
        )
        if layer == layers:
            key_lc, key_val = label_lc, label_val

    # 7. encoding: leaf_r == leaf_d + key (sloth-0 encode,
    #    vanilla params.encode_node)
    cs.enforce(
        leaf_d.lc() + key_lc - leaf_r.lc(), lc_one(), LinearCombination(),
        "encoding",
    )


# ---------------------------------------------------------------------------
# Compound: public inputs + blank/witness circuit construction
# (reference: stacked/circuit/proof.hpp:177-337 StackedCompound)
# ---------------------------------------------------------------------------


def circuit_from_vanilla(
    pub_params: PublicParams,
    pub_inputs: PublicInputs,
    vanilla_proofs: list[Proof],
    comm_c: bytes,
    comm_r_last: bytes,
    blank: bool = False,
    device="cuda",
) -> ConstraintSystem:
    """Partition circuit, its Poseidon witness replayed on `device`
    (kernel K7 on a card). Default path is the challenge-batched emitter
    (circuit/batched.py — op-major across the partition's challenges,
    ~K-fold less python overhead; VERDICT r4 item 6);
    FIL_PROOFS_SDR_SYNTH=scalar keeps the per-challenge scalar path as
    the parity oracle (identical constraint content and public inputs,
    different variable order)."""
    import os

    cs = ConstraintSystem()
    mode = os.environ.get("FIL_PROOFS_SDR_SYNTH", "batched")
    synth = synthesize
    if mode != "scalar" and vanilla_proofs:
        from .batched import synthesize_batched

        synthesize_batched(
            cs,
            pub_params,
            pub_inputs.replica_id,
            pub_inputs.tau.comm_d,
            pub_inputs.tau.comm_r,
            comm_c,
            comm_r_last,
            vanilla_proofs,
            blank=blank,
            device=device,
        )
        return cs
    synth(
        cs,
        pub_params,
        pub_inputs.replica_id,
        pub_inputs.tau.comm_d,
        pub_inputs.tau.comm_r,
        comm_c,
        comm_r_last,
        vanilla_proofs,
    )
    return cs


def generate_public_inputs(
    pub_params: PublicParams, pub_inputs: PublicInputs, k: int
) -> list[int]:
    """Fr public-input vector for partition k (verifier side; order must
    match synthesize — see module docstring)."""
    graph = pub_params.graph
    layers = pub_params.layers
    leaves = graph.size()
    challenges = pub_inputs.challenges(pub_params.layer_challenges, leaves, k)

    tree_d_bits = (leaves - 1).bit_length()  # binary tree height
    oct_bits = tree_d_bits  # oct tree: 3 bits x height -> same bit count

    inputs = [
        _LE(pub_inputs.replica_id),
        _LE(pub_inputs.tau.comm_d),
        _LE(pub_inputs.tau.comm_r),
    ]
    for challenge in challenges:
        inputs.extend(packed_position_input_values(challenge, tree_d_bits))
        for parent in graph.base_parents(challenge):
            inputs.extend(packed_position_input_values(int(parent), oct_bits))
        for parent in graph.expanded_parents(challenge):
            inputs.extend(packed_position_input_values(int(parent), oct_bits))
        inputs.append(challenge)
        inputs.extend(packed_position_input_values(challenge, oct_bits))
        inputs.extend(packed_position_input_values(challenge, oct_bits))
    return inputs
