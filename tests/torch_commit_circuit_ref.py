"""The stacked circuit of a C1, summarised by SHA-256 digests, and the
frozen JAX digest of the registered 2 KiB circuit (two challenges).

`circuit_summary(cs)` takes a circuit of either package: its counts, its
public inputs, and SHA-256 digests of the assignment and of every
segment's arrays. `summary_digest` folds a summary into one SHA-256.
Neither needs JAX, so the smoke run on the card (chip_smoke.py phase 13)
holds the port's circuit of the same C1 against the golden.

Run as a script, it seals the 2 KiB sector of
tests/golden/torch_precommit_2k.json with the JAX package
(crypto3_fil_proofs_tpu), runs its C1 with seed 07 x 32, synthesizes its
registered stacked circuit (LayerChallenges(layers=2, max_count=2): one
partition of two challenges, as `StackedCompound.circuit_from_vanilla`
does in C2) with FIL_PROOFS_WITNESS_BACKEND=numpy, and writes
tests/golden/torch_commit_2k_circuit.json:
    python tests/torch_commit_circuit_ref.py
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_commit_2k_circuit.json")
SEED = bytes([7] * 32)
BLOCK_ARRAYS = ("a_indptr", "a_cols", "a_coeffs", "a_idx", "b_indptr", "b_cols", "b_coeffs", "b_idx",
                "c_indptr", "c_cols", "c_coeffs", "c_idx")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def digest_ints(values) -> str:
    return _digest(b"".join(int(v).to_bytes(32, "little") for v in values))


def circuit_summary(cs) -> dict:
    """A finalized circuit of either package: counts, the inputs, and
    SHA-256 digests of the assignment and of every segment's arrays."""
    n_in, n_aux, fin, inputs, aux = cs.finalize()
    segments = []
    for kind, seg, base in fin.segments():
        if kind == "d":
            segments.append(("d", base, len(seg), _digest(repr(seg).encode())))
            continue
        arrays = {}
        for name in BLOCK_ARRAYS:
            if hasattr(seg, name):
                a = np.ascontiguousarray(getattr(seg, name))
                arrays[name] = (str(a.dtype), a.shape, _digest(a.tobytes()))
        if hasattr(seg, "pool"):
            arrays["pool"] = digest_ints(seg.pool)
        segments.append((type(seg).__name__, base, seg.n, arrays))
    return {"n_in": n_in, "n_aux": n_aux, "constraints": len(fin), "inputs": inputs,
            "aux": digest_ints(aux), "segments": segments}


def summary_digest(summary: dict) -> dict:
    """The counts, and SHA-256 digests of the inputs, the assignment and
    the segments (their JSON form, in order)."""
    return {
        "constraints": summary["constraints"], "n_in": summary["n_in"], "n_aux": summary["n_aux"],
        "segments": len(summary["segments"]),
        "inputs_digest": digest_ints(summary["inputs"]),
        "aux_digest": summary["aux"],
        "segments_digest": _digest(json.dumps(summary["segments"]).encode()),
    }


def jax_reference() -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FIL_PROOFS_WITNESS_BACKEND"] = "numpy"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from crypto3_fil_proofs_tpu.api import mod as jax_mod
    from crypto3_fil_proofs_tpu.api import seal as jax_seal
    from crypto3_fil_proofs_tpu.constants import SECTOR_SHAPES
    from crypto3_fil_proofs_tpu.core.fr32 import to_unpadded_bytes
    from crypto3_fil_proofs_tpu.models.porep.stacked.circuit.compound import StackedCompound
    from crypto3_fil_proofs_tpu.models.porep.stacked.vanilla.params import PublicInputs, Tau
    from crypto3_fil_proofs_tpu.parameters import public_params
    from crypto3_fil_proofs_tpu.types import PoRepConfig

    with open(os.path.join(HERE, "golden", "torch_precommit_2k.json")) as f:
        g = json.load(f)
    size = g["sector_size"]
    prover_id, ticket, sector_id = bytes.fromhex(g["prover_id"]), bytes.fromhex(g["ticket"]), g["sector_id"]
    config = PoRepConfig.for_sector_size(size, bytes.fromhex(g["porep_id"]))
    root = tempfile.mkdtemp(prefix="commit-2k-circuit-")
    os.environ["FIL_PROOFS_PARENT_CACHE"] = os.path.join(root, "parents")
    staged, sealed, cache = (os.path.join(root, n) for n in ("staged", "sealed", "cache"))
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(size)))
    info, _ = jax_mod.add_piece(piece, staged, len(piece), [])
    p1 = jax_seal.seal_pre_commit_phase1(config, cache, staged, sealed, prover_id, sector_id, ticket, [info])
    p2 = jax_seal.seal_pre_commit_phase2(config, p1, cache, sealed)
    c1 = jax_seal.seal_commit_phase1(config, cache, sealed, prover_id, sector_id, ticket, SEED, p2, [info])
    pp = public_params(config)
    pub = PublicInputs(replica_id=c1.replica_id, seed=SEED, tau=Tau(comm_d=c1.comm_d, comm_r=c1.comm_r), k=None)
    compound = StackedCompound(shape=SECTOR_SHAPES[size])
    if len(c1.vanilla_proofs) != 1 or len(c1.vanilla_proofs[0]) != 2:
        raise RuntimeError("the registered 2 KiB C1 is not one partition of two challenges")
    cs = compound.circuit_from_vanilla(pp, pub, c1.vanilla_proofs[0], 0)
    return {
        "description": (
            "The JAX package's (crypto3_fil_proofs_tpu) registered stacked circuit of the 2 KiB sector of "
            "tests/golden/torch_precommit_2k.json after its C1 with seed 07 x 32 (one partition of two "
            "challenges), synthesized with FIL_PROOFS_WITNESS_BACKEND=numpy: the counts and the SHA-256 "
            "digests of tests/torch_commit_circuit_ref.py `summary_digest(circuit_summary(cs))`, and the "
            "digest of generate_public_inputs. Written by tests/torch_commit_circuit_ref.py."
        ),
        "sector_size": size,
        "seed": SEED.hex(),
        "comm_r": c1.comm_r.hex(),
        "challenges": len(c1.vanilla_proofs[0]),
        "circuit": summary_digest(circuit_summary(cs)),
        "public_digest": digest_ints(compound.generate_public_inputs(pp, pub, 0)),
    }


if __name__ == "__main__":
    import sys
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    t0 = time.time()
    ref = jax_reference()
    with open(GOLDEN, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN} in {time.time() - t0:.1f} s")
