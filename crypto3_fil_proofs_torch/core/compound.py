"""Compound proof plumbing: vanilla scheme <-> circuit <-> Groth16.

Copied from crypto3_fil_proofs_tpu/core/compound.py, which re-implements the reference's compound_proof / multi_proof layer
(reference: core/proof/compound_proof.hpp:40-205 — setup, per-partition
circuit proofs, generate_public_inputs dispatch, Groth16 prove/verify;
core/proof/multi_proof.hpp:38-58 — one 192-byte Groth16 proof per
partition + shared verifying key).

A protocol plugs in a `CircuitAdapter`: the stacked PoRep adapter lives
next to its circuit (models/porep/stacked/circuit). `prove` hands the
partitions to `groth16.prove_many`, which proves partition k on card k
mod the card count (every card of the machine for `device="cuda"`, the
one card that `device="cuda:1"` names, the CPU for `device="cpu"`) with
randomness + bytes([k]), as the JAX package's `prove` does
(core/compound.py:93), so the bytes are the serial loop's and the JAX
package's. Each partition is synthesized and checked where
`prove_many` asks for it: on one device just before its proof, so only
one partition's circuit is held at a time. Its Poseidon witness is
replayed on the device that proves it (kernel K7 on a card).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from ..zk import groth16
from .measure import measure_op

SINGLE_PARTITION_PROOF_LEN = 192  # reference constants.hpp:93


@dataclass
class MultiProof:
    """Groth16 proof per partition (reference multi_proof.hpp)."""

    circuit_proofs: list[groth16.Proof]

    def to_bytes(self) -> bytes:
        return b"".join(p.to_bytes() for p in self.circuit_proofs)

    @classmethod
    def from_bytes(cls, data: bytes, partitions: int) -> "MultiProof":
        if len(data) != partitions * SINGLE_PARTITION_PROOF_LEN:
            raise ValueError("multi-proof length mismatch")
        return cls(
            [
                groth16.Proof.from_bytes(
                    data[i * SINGLE_PARTITION_PROOF_LEN : (i + 1) * SINGLE_PARTITION_PROOF_LEN]
                )
                for i in range(partitions)
            ]
        )

    def __len__(self) -> int:
        return len(self.circuit_proofs)


class CompoundProof:
    """Generic compound prove/verify over a circuit adapter.

    Adapter interface (mirrors the reference compound_proof hooks):
    - circuit_from_vanilla(pub_params, pub_inputs, partition_proofs, k, device) -> cs
      (`device`: where the circuit replays its Poseidon witness)
    - blank_circuit(pub_params) -> cs
    - generate_public_inputs(pub_params, pub_inputs, k) -> list[int]
    - cache_prefix(pub_params) -> str   (Groth16 parameter identity)
    """

    def __init__(self, adapter):
        self.adapter = adapter

    def get_params(self, pub_params, seed: bytes | None = None, device="cuda"):
        """Groth16 CRS for this circuit identity (disk-cached; made on
        `device` where the cache has none)."""
        from .parameter_cache import get_groth_params

        return get_groth_params(
            self.adapter.cache_prefix(pub_params),
            lambda: self.adapter.blank_circuit(pub_params),
            seed=seed,
            device=device,
        )

    def prove(
        self,
        pub_params,
        pub_inputs,
        vanilla_partition_proofs: list,
        pk: groth16.ProvingKey,
        randomness: bytes = b"fil-tpu-prove",
        device="cuda",
    ) -> MultiProof:
        """Spans (core/measure.py): commit_synthesis, commit_check, and
        the prover's."""
        circuits = [
            partial(self._checked_circuit, pub_params, pub_inputs, p, k)
            for k, p in enumerate(vanilla_partition_proofs)
        ]
        # partition-parallel Groth16: one device per partition group; the
        # bytes of the serial loop
        return MultiProof(groth16.prove_many(pk, circuits, randomness=randomness, device=device))

    def _checked_circuit(self, pub_params, pub_inputs, partition_proofs, k: int, device):
        """Partition k's circuit, synthesized (its witness replayed on
        `device`, the one that proves it) and checked."""
        with measure_op("commit_synthesis"):
            cs = self.adapter.circuit_from_vanilla(pub_params, pub_inputs, partition_proofs, k, device=device)
        with measure_op("commit_check"):
            bad = cs.which_unsatisfied()
            if bad is not None:
                raise AssertionError(f"partition {k} circuit unsatisfied: {bad}")
            expected = self.adapter.generate_public_inputs(pub_params, pub_inputs, k)
            got = [v for v, i in zip(cs.values, cs.is_input) if i][1:]
            if got != expected:
                raise AssertionError(f"partition {k} public-input mismatch")
        return cs

    def verify(
        self,
        pub_params,
        pub_inputs,
        multi_proof: MultiProof,
        vk: groth16.VerifyingKey,
    ) -> bool:
        for k, proof in enumerate(multi_proof.circuit_proofs):
            inputs = self.adapter.generate_public_inputs(pub_params, pub_inputs, k)
            if not groth16.verify(vk, proof, inputs):
                return False
        return True
