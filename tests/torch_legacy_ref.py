"""Frozen JAX-package references for the port's Election PoSt: writes
tests/golden/torch_election_2k.json.

The JAX package (crypto3_fil_proofs_tpu) seals the 2 KiB sector of
tests/golden/torch_precommit_2k.json (the same piece, prover, ticket,
sector and PoRep id, as tests/torch_post_ref.py does) and proves it with
Election PoSt (2 challenges x 1 node, shape (8, 0, 0)) over its stored
tree_r_last, with a private parameter cache (FIL_PROOFS_PARAMETER_CACHE),
so the key is made by `setup` seeded with its cache prefix. Recorded:
- the candidate (partial ticket and ticket) of sector challenge index 0
  under `randomness`, and the circuit's public inputs;
- the key's SHA-256 in the parameter-cache layout
  (tests/test_torch_setup.py `arrays_digest`), the verifying key file
  (`.vk`, npz bytes) and the proof bytes under the Groth16 randomness
  `proof_randomness`;
- the blank circuits' constraint, input and variable counts at 2 KiB
  (2 x 1) and over 512 MiB (40 x 1, the shipped election PoSt's
  POST_CHALLENGE_COUNT and POST_CHALLENGED_NODES);
- its own run time, in `description`.

This runs the JAX package's Groth16 setup and prove, so it is not part
of the tests; the tests and chip_smoke.py read the file it writes. The
circuit is below the JAX package's `zk.groth16.HOST_FALLBACK_N`, so its
fixed-base batches and MSMs take the package's host path.
Run from the repository root (a few minutes on a CPU):
    JAX_PLATFORMS=cpu python tests/torch_legacy_ref.py
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the repository root, for the packages
sys.path.insert(0, HERE)
GOLDEN = os.path.join(HERE, "golden", "torch_election_2k.json")
PRECOMMIT = os.path.join(HERE, "golden", "torch_precommit_2k.json")
RANDOMNESS = bytes([44] * 31 + [0])
PROOF_RANDOMNESS = b"election-2k-fixed"
CHALLENGES = 2  # x 1 node at 2 KiB
# (sector size, challenge count, challenged nodes) of each blank circuit counted
BLANK_CONFIGS = ((2048, 2, 1), (512 << 20, 40, 1))

from torch_post_ref import key_files  # noqa: E402


def main() -> None:
    t_start = time.time()
    work = tempfile.mkdtemp(prefix="torch_legacy_ref_")
    os.environ["FIL_PROOFS_PARAMETER_CACHE"] = os.path.join(work, "params")
    os.environ["FIL_PROOFS_PARENT_CACHE"] = os.path.join(work, "parents")

    from crypto3_fil_proofs_tpu.api import mod, post, seal
    from crypto3_fil_proofs_tpu.core.compound import CompoundProof
    from crypto3_fil_proofs_tpu.core.fr32 import to_unpadded_bytes
    from crypto3_fil_proofs_tpu.models.post.election import circuit as ecirc
    from crypto3_fil_proofs_tpu.models.post.election import vanilla as election
    from crypto3_fil_proofs_tpu.types import PoRepConfig, PoStConfig, PoStType, PrivateReplicaInfo

    with open(PRECOMMIT) as f:
        g = json.load(f)
    size = g["sector_size"]
    prover_id, ticket, porep_id = (bytes.fromhex(g[k]) for k in ("prover_id", "ticket", "porep_id"))
    sector_id = g["sector_id"]

    staged, sealed, cache = (os.path.join(work, n) for n in ("staged", "sealed", "cache"))
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(size)))
    config = PoRepConfig.for_sector_size(size, porep_id)
    info, _ = mod.add_piece(piece, staged, len(piece), [])
    p1 = seal.seal_pre_commit_phase1(config, cache, staged, sealed, prover_id, sector_id, ticket, [info])
    p2 = seal.seal_pre_commit_phase2(config, p1, cache, sealed)
    if p2.comm_r.hex() != g["comm_r"]:
        raise AssertionError("the JAX package's 2 KiB comm_r moved from tests/golden/torch_precommit_2k.json")
    replica = PrivateReplicaInfo(replica_path=sealed, comm_r=p2.comm_r, cache_dir=cache)
    post_cfg = PoStConfig(sector_size=size, challenge_count=CHALLENGES, sector_count=1, typ=PoStType.WINNING)
    tree = post._replica_tree(post_cfg, replica)
    comm_c, comm_r_last = post._load_p_aux(replica)

    t0 = time.time()
    pp = election.ElectionPoSt.setup(election.SetupParams(size, CHALLENGES, 1))
    cand = election.generate_candidate(pp, tree, prover_id, sector_id, RANDOMNESS, 0)
    pub = election.PublicInputs(randomness=RANDOMNESS, sector_id=sector_id, prover_id=prover_id,
                                comm_r=p2.comm_r, partial_ticket=cand.partial_ticket, sector_challenge_index=0)
    priv = election.PrivateInputs(tree=tree, comm_c=comm_c, comm_r_last=comm_r_last)
    vanilla = election.ElectionPoSt.prove(pp, pub, priv)
    if not election.ElectionPoSt.verify(pp, pub, vanilla):
        raise AssertionError("the JAX package's 2 KiB election vanilla proof does not verify")
    compound = CompoundProof(ecirc.ElectionPoStCompound(shape=(8, 0, 0)))
    pk = compound.get_params(pp)
    multi = compound.prove(pp, pub, [vanilla], pk, randomness=PROOF_RANDOMNESS)
    proof = multi.to_bytes()
    if not compound.verify(pp, pub, multi, pk.vk):
        raise AssertionError("the JAX package's 2 KiB election proof does not verify")
    prove_s = time.time() - t0
    prefix = compound.adapter.cache_prefix(pp)

    blanks = []
    for sz, cc, cn in BLANK_CONFIGS:
        cs = compound.adapter.blank_circuit(election.PublicParams(sz, cc, cn))
        blanks.append({"sector_size": sz, "challenge_count": cc, "challenged_nodes": cn,
                       "constraints": cs.num_constraints, "inputs": cs.num_inputs, "variables": len(cs.values)})
    total = time.time() - t_start
    out = {
        "sector_size": size, "sector_id": sector_id, "prover_id": prover_id.hex(), "comm_r": p2.comm_r.hex(),
        "randomness": RANDOMNESS.hex(), "proof_randomness": PROOF_RANDOMNESS.hex(),
        "challenge_count": CHALLENGES, "challenged_nodes": 1, "sector_challenge_index": 0,
        "partial_ticket": cand.partial_ticket.hex(), "ticket": cand.ticket.hex(),
        "public_inputs": [str(v) for v in ecirc.generate_public_inputs(pp, pub)],
        "cache_prefix": prefix, **key_files(prefix), "proof": proof.hex(),
        "blank_counts": blanks,
        "description": (
            "Election PoSt of the JAX package (crypto3_fil_proofs_tpu) over the 2 KiB sector of "
            "tests/golden/torch_precommit_2k.json, sealed by the JAX package: the candidate of sector challenge "
            "index 0 under `randomness`, the public inputs, the key digest (parameter-cache layout, "
            "tests/test_torch_setup.py arrays_digest; setup seeded by the cache prefix), the verifying-key file "
            "and the proof bytes under `proof_randomness`; the blank circuits' counts. Written by "
            f"tests/torch_legacy_ref.py on a CPU in {total:.0f} s (setup and prove {prove_s:.0f} s)."
        ),
    }
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1)
    shutil.rmtree(work)
    print(f"wrote {GOLDEN} in {total:.0f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
