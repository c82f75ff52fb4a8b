"""Fallback PoSt circuit + compound public inputs.

Copied from crypto3_fil_proofs_tpu/models/post/fallback/circuit.py with
its imports rewritten, which re-implements the reference's fallback
circuit skeleton (reference: post/fallback/circuit.hpp:39-92 — Sector
sub-circuit: comm_r public, comm_c/comm_r_last private tied by
comm_r == H2(comm_c, comm_r_last), per-challenge PoR against
comm_r_last; post/fallback/compound.hpp is a stub, semantics per
rust-fil-proofs fallback compound). Host work: the gadgets emit their
rows as numpy blocks, and the Poseidon witness is replayed on the
partition's device (zk/gadgets/tiled.py `poseidon_witness_v`: kernel K7
on a card).

Public-input order per partition (must match generate_public_inputs):
  per sector (sector_count, padded by duplicating the last):
    comm_r,
    then per challenge: packed PoR path bits (the leaf challenge).
"""
from __future__ import annotations

from functools import cache

import numpy as np

from crypto3_fil_proofs_torch.ops import fr_vec as fv
from crypto3_fil_proofs_torch.zk.gadgets import tiled
from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
from crypto3_fil_proofs_torch.zk.gadgets.poseidon import hash2_circuit
from crypto3_fil_proofs_torch.zk.gadgets.por import packed_position_input_values
from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem

from .vanilla import (
    NODE_SIZE,
    Proof,
    PublicInputs,
    PublicParams,
    generate_leaf_challenge,
)


def _le(b: bytes) -> int:
    return int.from_bytes(b, "little")


@cache
def _header_template() -> tiled.CircuitTemplate:
    """Template: comm_c/comm_r_last allocs + comm_r == H2 tie (one per
    sector; reference circuit.hpp Sector prelude)."""

    def build(cs, ext):
        comm_r = AllocatedNum(ext[0], 0)
        comm_c = AllocatedNum.alloc(cs, 0, "comm_c")
        comm_r_last = AllocatedNum.alloc(cs, 0, "comm_r_last")
        hashed = hash2_circuit(cs, comm_c, comm_r_last)
        AllocatedNum.equals(cs, hashed, comm_r)

    return tiled.CircuitTemplate(build, 1, label="post_sector_header")


def circuit_from_vanilla(
    pub_params: PublicParams,
    pub_inputs: PublicInputs,
    partition_proof: Proof,
    k: int,
    blank: bool = False,
    device="cuda",
) -> ConstraintSystem:
    """Partition circuit: sector_count sector sub-circuits (reference
    FallbackPoStCircuit), padding sectors duplicated like the vanilla
    prover.

    Emission is template-tiled (zk/gadgets/tiled.py): all sector headers
    go out as one batch and all sector x challenge PoR instances as
    FieldBlock runs. Public-input ORDER is the scalar layout (per
    sector: comm_r, then per challenge the packed path bits), as
    generate_public_inputs gives it. `blank=True` skips witness
    computation (CRS/counting paths never read aux values); otherwise
    the Poseidon witness is replayed on `device`."""
    per_chunk = pub_params.sector_count
    pub_chunk = pub_inputs.sectors[k * per_chunk : (k + 1) * per_chunk]
    # padding: vanilla duplicates the last sector proof AND its comm_r
    comm_rs = [s.comm_r for s in pub_chunk]
    while len(comm_rs) < per_chunk:
        comm_rs.append(comm_rs[-1])
    sectors = partition_proof.sectors
    S = len(sectors)
    if len(comm_rs) != S:
        raise ValueError(f"{len(comm_rs)} public sectors for {S} sector proofs")
    C = pub_params.challenge_count
    opts0 = sectors[0].inclusion_proofs[0].as_options()
    arities = tuple(len(s) + 1 for s, _ in opts0)
    level_bits = [(len(s)).bit_length() for s, _ in opts0]
    total_bits = sum(level_bits)
    n_packs = -(-total_bits // 254)

    cs = ConstraintSystem()
    # public inputs first, in the scalar order
    comm_r_vars = np.empty(S, np.int64)
    packed_vars = np.empty((S * C, n_packs), np.int64)
    for i in range(S):
        comm_r_vars[i] = cs.alloc_input(_le(comm_rs[i]), "comm_r")
        for n in range(C):
            incl = sectors[i].inclusion_proofs[n]
            challenge = 0
            shift = 0
            for (sibs, idx), nb in zip(incl.as_options(), level_bits):
                challenge |= idx << shift
                shift += nb
            vals = packed_position_input_values(challenge, total_bits)
            assert len(vals) == n_packs
            for j, v in enumerate(vals):
                packed_vars[i * C + n, j] = cs.alloc_input(v, "packed_bits")

    # sector headers: comm_c / comm_r_last / H2 tie, one batch
    htpl = _header_template()
    if blank:
        h_values = None
    else:
        comm_c_v = tiled.bytes_rows_to_v([sp.comm_c for sp in sectors])
        crl_v = tiled.bytes_rows_to_v([sp.inclusion_proofs[0].root for sp in sectors])
        pre = np.stack([comm_c_v, crl_v], axis=1)
        pos_wit = tiled.poseidon_witness_v(pre, 2, device)
        h_wit = np.concatenate([comm_c_v[:, None], crl_v[:, None], pos_wit], axis=1)
        assert h_wit.shape[1] == htpl.n_int
        h_values = fv.from_v(h_wit.reshape(-1, 16))
    h_bases = htpl.instantiate(cs, comm_r_vars[:, None], h_values)
    comm_r_last_vars = h_bases + 1  # second internal alloc of the header

    # PoR instances: sector-major, challenge-minor (the input order)
    root_vars = np.repeat(comm_r_last_vars, C)
    if blank:
        leaf_v = None
        levels = None
    else:
        incls = [sectors[i].inclusion_proofs[n] for i in range(S) for n in range(C)]
        leaf_v = tiled.bytes_rows_to_v([p.leaf for p in incls])
        levels = []
        for lvl in range(len(arities)):
            sibs = tiled.bytes_rows_to_v(
                [s for p in incls for s in p.as_options()[lvl][0]]
            ).reshape(len(incls), arities[lvl] - 1, 16)
            idx = np.asarray([p.as_options()[lvl][1] for p in incls], np.int64)
            levels.append((sibs, idx))
    tiled.por_circuit_batch(cs, root_vars, packed_vars, arities, leaf_v, levels, device)
    return cs


def generate_public_inputs(
    pub_params: PublicParams, pub_inputs: PublicInputs, k: int
) -> list[int]:
    """Verifier-side Fr input vector for partition k (reference compound
    semantics: per-sector comm_r + per-challenge packed leaf bits;
    padded sectors repeat the last real sector)."""
    per_chunk = pub_params.sector_count
    pub_chunk = pub_inputs.sectors[k * per_chunk : (k + 1) * per_chunk]
    sectors = list(pub_chunk)
    while len(sectors) < per_chunk:
        sectors.append(sectors[-1])
    leaves = pub_params.sector_size // NODE_SIZE
    leaf_bits = (leaves - 1).bit_length()
    # the padded duplicate of sector i repeats sector i's challenge
    # indices, so recompute with the ORIGINAL chunk position
    inputs: list[int] = []
    for i, sector in enumerate(sectors):
        real_i = min(i, len(pub_chunk) - 1)
        inputs.append(_le(sector.comm_r))
        for n in range(pub_params.challenge_count):
            challenge_index = (k * per_chunk + real_i) * pub_params.challenge_count + n
            leaf = generate_leaf_challenge(
                pub_params, pub_inputs.randomness, sector.id, challenge_index
            )
            inputs.extend(packed_position_input_values(leaf, leaf_bits))
    return inputs
