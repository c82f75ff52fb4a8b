"""Seal commit in the port (C1, the stacked circuit, verify_seal) against
the JAX package on the CPU, bit for bit.

- C1 at 2 KiB: from the same staged piece, each package's pre-commit and
  C1; the vanilla proofs are equal field by field, both verify, a
  tampered label is rejected, a lost tree store raises, and their digest
  is the frozen tests/golden/torch_commit_2k.json, which the GPU smoke
  run (chip_smoke.py) checks the port's C1 against.
- The stacked circuit at 2 KiB with LayerChallenges(layers=2,
  max_count=1), as tests/test_stacked_circuit.py builds it: the port's
  `circuit_from_vanilla` equals the JAX package's (constraint count,
  inputs, the whole assignment, every segment's arrays, by SHA-256 of
  their bytes), the port's is satisfied, the blank circuits have the
  same structure and `generate_public_inputs` agrees. The JAX side runs
  with FIL_PROOFS_WITNESS_BACKEND=numpy, so it compiles no XLA, and is
  computed once per pytest run (`shared_reference`).
- verify_seal accepts the committed tests/golden/seal2k proof with its
  verifying key in a private parameter cache, and rejects a flipped bit
  and an all-zero comm_r.

The tolerance is exact equality throughout.
"""
import copy
import dataclasses
import json
import os
import shutil

import pytest
import torch

from crypto3_fil_proofs_tpu.api import mod as jax_mod
from crypto3_fil_proofs_tpu.api import seal as jax_seal
from crypto3_fil_proofs_tpu.models.porep.stacked.circuit import proof as jax_circ
from crypto3_fil_proofs_tpu.models.porep.stacked.circuit.compound import StackedCompound as JaxStackedCompound
from crypto3_fil_proofs_tpu.models.porep.stacked.vanilla import params as jax_params
from crypto3_fil_proofs_tpu.models.porep.stacked.vanilla.proof import StackedDrg as JaxStackedDrg
from crypto3_fil_proofs_tpu.parameters import public_params as jax_public_params
from crypto3_fil_proofs_tpu.types import PoRepConfig as JaxPoRepConfig
from crypto3_fil_proofs_torch import caches
from crypto3_fil_proofs_torch.api import mod as api_mod
from crypto3_fil_proofs_torch.api import seal as api_seal
from crypto3_fil_proofs_torch.constants import SECTOR_SHAPES
from crypto3_fil_proofs_torch.core.fr32 import to_unpadded_bytes
from crypto3_fil_proofs_torch.core.parameter_cache import vk_path
from crypto3_fil_proofs_torch.models.porep.stacked.circuit import proof as circ
from crypto3_fil_proofs_torch.models.porep.stacked.circuit.compound import StackedCompound
from crypto3_fil_proofs_torch.models.porep.stacked.vanilla import params
from crypto3_fil_proofs_torch.models.porep.stacked.vanilla.proof import StackedDrg
from crypto3_fil_proofs_torch.parameters import public_params
from crypto3_fil_proofs_torch.types import PoRepConfig
from test_torch_setup import shared_reference
from torch_commit_circuit_ref import circuit_summary

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "golden", "torch_precommit_2k.json")) as _f:
    G = json.load(_f)
GOLDEN = os.path.join(HERE, "golden", "torch_commit_2k.json")
SEAL2K = os.path.join(HERE, "golden", "seal2k")
SIZE = G["sector_size"]
PROVER_ID = bytes.fromhex(G["prover_id"])
TICKET = bytes.fromhex(G["ticket"])
SECTOR_ID = G["sector_id"]
POREP_ID = bytes.fromhex(G["porep_id"])
SEED = bytes([7] * 32)


def _seal_and_commit(mod, seal, config, root, **kw):
    """add_piece, PC1, PC2 and C1 of one package into root/."""
    os.makedirs(root)
    staged, sealed, cache = (os.path.join(root, n) for n in ("staged", "sealed", "cache"))
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(SIZE)))
    info, _ = mod.add_piece(piece, staged, len(piece), [])
    p1 = seal.seal_pre_commit_phase1(config, cache, staged, sealed, PROVER_ID, SECTOR_ID, TICKET, [info], **kw)
    p2 = seal.seal_pre_commit_phase2(config, p1, cache, sealed, **kw)
    c1 = seal.seal_commit_phase1(config, cache, sealed, PROVER_ID, SECTOR_ID, TICKET, SEED, p2, [info])
    return {"info": info, "p2": p2, "c1": c1, "cache": cache, "sealed": sealed}


def _port_run(root):
    saved = os.environ.get("FIL_PROOFS_PARENT_CACHE")
    os.environ["FIL_PROOFS_PARENT_CACHE"] = os.path.join(root, "parents")
    try:
        return _seal_and_commit(
            api_mod, api_seal, PoRepConfig.for_sector_size(SIZE, POREP_ID), os.path.join(root, "port"),
            device="cpu",
        )
    finally:
        if saved is None:
            del os.environ["FIL_PROOFS_PARENT_CACHE"]
        else:
            os.environ["FIL_PROOFS_PARENT_CACHE"] = saved


def _jax_run(root):
    return _seal_and_commit(jax_mod, jax_seal, JaxPoRepConfig.for_sector_size(SIZE, POREP_ID), os.path.join(root, "jax"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 2 KiB seal and C1, once per run (`shared_reference`):
    the tests only read them."""
    return shared_reference(tmp_path_factory, "commit_2k_runs",
                            lambda shared: (_port_run(str(shared / "commit2k")), _jax_run(str(shared / "commit2k"))))


# ---------------------------------------------------------------------------
# C1
# ---------------------------------------------------------------------------


def test_commit_phase1_matches_jax(runs):
    port, ref = runs
    mine, theirs = port["c1"], ref["c1"]
    assert (mine.comm_r, mine.comm_d, mine.replica_id, mine.seed, mine.ticket) == (
        theirs.comm_r, theirs.comm_d, theirs.replica_id, theirs.seed, theirs.ticket)
    assert mine.comm_r.hex() == G["comm_r"]
    as_dicts = lambda parts: [[dataclasses.asdict(p) for p in part] for part in parts]
    assert as_dicts(mine.vanilla_proofs) == as_dicts(theirs.vanilla_proofs)


def test_commit_phase1_verifies_and_rejects_tampered_label(runs):
    port, ref = runs
    config = PoRepConfig.for_sector_size(SIZE, POREP_ID)
    pp = public_params(config)
    c1 = port["c1"]
    pub = params.PublicInputs(
        replica_id=c1.replica_id, seed=SEED, tau=params.Tau(comm_d=c1.comm_d, comm_r=c1.comm_r), k=None)
    assert StackedDrg.verify_all_partitions(pp, pub, c1.vanilla_proofs)
    jc1 = ref["c1"]
    jpub = jax_params.PublicInputs(
        replica_id=jc1.replica_id, seed=SEED, tau=jax_params.Tau(comm_d=jc1.comm_d, comm_r=jc1.comm_r), k=None)
    jax_conf = JaxPoRepConfig.for_sector_size(SIZE, POREP_ID)
    assert JaxStackedDrg.verify_all_partitions(jax_public_params(jax_conf), jpub, jc1.vanilla_proofs)

    tampered = copy.deepcopy(c1.vanilla_proofs)
    col = tampered[0][0].replica_column_proofs.c_x.column
    first = bytearray(col.rows[0])
    first[0] ^= 1
    col.rows[0] = bytes(first)
    assert not StackedDrg.verify_all_partitions(pp, pub, tampered)


def test_commit_phase1_raises_on_a_lost_tree(runs, tmp_path):
    port, _ = runs
    cache = str(tmp_path / "cache")
    shutil.copytree(port["cache"], cache)
    lost = [n for n in os.listdir(cache) if "tree-r-last" in n]
    assert lost
    os.remove(os.path.join(cache, lost[0]))
    config = PoRepConfig.for_sector_size(SIZE, POREP_ID)
    with pytest.raises(FileNotFoundError):
        api_seal.seal_commit_phase1(
            config, cache, port["sealed"], PROVER_ID, SECTOR_ID, TICKET, SEED, port["p2"], [port["info"]])


def test_commit_2k_golden(runs):
    """The frozen digest: the JAX package still produces it, and the
    port reproduces it."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["seed"] == SEED.hex() and golden["comm_r"] == G["comm_r"]
    port, ref = runs
    assert params.proofs_digest(ref["c1"].vanilla_proofs) == golden["vanilla_digest"]
    assert params.proofs_digest(port["c1"].vanilla_proofs) == golden["vanilla_digest"]


# ---------------------------------------------------------------------------
# The stacked circuit (one challenge)
# ---------------------------------------------------------------------------


def _one_challenge(pkg_params, setup):
    """Public params of the 2 KiB sector with one challenge."""
    sp = pkg_params.SetupParams(
        nodes=SIZE // 32, degree=6, expansion_degree=8, porep_id=POREP_ID,
        layer_challenges=pkg_params.LayerChallenges(layers=2, max_count=1),
    )
    return setup(sp)


def _pub(pkg_params, c1):
    return pkg_params.PublicInputs(
        replica_id=c1.replica_id, seed=SEED, tau=pkg_params.Tau(comm_d=c1.comm_d, comm_r=c1.comm_r), k=None)


def _jax_circuits(shared) -> dict:
    saved = os.environ.get("FIL_PROOFS_WITNESS_BACKEND")
    os.environ["FIL_PROOFS_WITNESS_BACKEND"] = "numpy"
    try:
        c1 = _jax_run(str(shared / "jax_circuit"))["c1"]
        pp = _one_challenge(jax_params, JaxStackedDrg.setup)
        pub = _pub(jax_params, c1)
        proofs = c1.vanilla_proofs[0][:1]
        cs = jax_circ.circuit_from_vanilla(pp, pub, proofs, proofs[0].comm_c(), proofs[0].comm_r_last())
        blank = JaxStackedCompound(shape=SECTOR_SHAPES[SIZE]).blank_circuit(pp)
        return {"circuit": circuit_summary(cs), "blank": circuit_summary(blank),
                "public": jax_circ.generate_public_inputs(pp, pub, 0)}
    finally:
        if saved is None:
            del os.environ["FIL_PROOFS_WITNESS_BACKEND"]
        else:
            os.environ["FIL_PROOFS_WITNESS_BACKEND"] = saved


@pytest.fixture(scope="module")
def jax_circuits(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_stacked_circuit_2k", _jax_circuits)


@pytest.fixture(scope="module")
def port_circuit(runs):
    port, _ = runs
    pp = _one_challenge(params, StackedDrg.setup)
    pub = _pub(params, port["c1"])
    proofs = port["c1"].vanilla_proofs[0][:1]
    cs = circ.circuit_from_vanilla(pp, pub, proofs, proofs[0].comm_c(), proofs[0].comm_r_last(), device="cpu")
    return pp, pub, cs


def test_stacked_circuit_equals_jax(jax_circuits, port_circuit):
    """Equal to the JAX package's, and satisfied (one test, so that one
    worker synthesizes the port's circuit)."""
    pp, pub, cs = port_circuit
    assert cs.which_unsatisfied() is None
    want = jax_circuits["circuit"]
    got = circuit_summary(cs)
    assert got["constraints"] == want["constraints"] and got["n_in"] == want["n_in"]
    assert got["inputs"] == want["inputs"]
    assert got["aux"] == want["aux"] and got["n_aux"] == want["n_aux"]
    assert len(got["segments"]) == len(want["segments"])
    for mine, theirs in zip(got["segments"], want["segments"]):
        assert mine == theirs
    assert circ.generate_public_inputs(pp, pub, 0) == jax_circuits["public"] == want["inputs"][1:]


def test_blank_circuit_equals_jax(jax_circuits):
    pp = _one_challenge(params, StackedDrg.setup)
    got = circuit_summary(StackedCompound(shape=SECTOR_SHAPES[SIZE]).blank_circuit(pp))
    assert got == jax_circuits["blank"]


# ---------------------------------------------------------------------------
# verify_seal on the committed 2 KiB proof
# ---------------------------------------------------------------------------


@pytest.fixture()
def seal2k(tmp_path, monkeypatch):
    with open(os.path.join(SEAL2K, "inputs.json")) as f:
        inputs = json.load(f)
    with open(os.path.join(SEAL2K, "proof.bin"), "rb") as f:
        proof = f.read()
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp_path))
    caches.clear_caches()
    config = PoRepConfig.for_sector_size(inputs["sector_size"], bytes.fromhex(inputs["porep_id"]))
    prefix = StackedCompound(shape=SECTOR_SHAPES[inputs["sector_size"]]).cache_prefix(public_params(config))
    shutil.copy(os.path.join(SEAL2K, "vk.npz"), vk_path(prefix))
    args = {
        "comm_r": bytes.fromhex(inputs["comm_r"]),
        "comm_d": bytes.fromhex(inputs["comm_d"]),
        "prover_id": bytes.fromhex(inputs["prover_id"]),
        "sector_id": inputs["sector_id"],
        "ticket": bytes.fromhex(inputs["ticket"]),
        "seed": bytes.fromhex(inputs["seed"]),
        "proof_bytes": proof,
    }
    yield config, args
    caches.clear_caches()


def test_verify_seal_accepts_committed_proof(seal2k):
    config, args = seal2k
    assert api_seal.verify_seal(config, **args)
    assert api_seal.verify_batch_seal(config, [args])


def test_verify_seal_rejects_tampered(seal2k):
    config, args = seal2k
    flipped = bytearray(args["proof_bytes"])
    flipped[100] ^= 1
    assert not api_seal.verify_seal(config, **{**args, "proof_bytes": bytes(flipped)})
    assert not api_seal.verify_seal(config, **{**args, "comm_r": bytes(32)})


def test_commit_phase2_raises_without_cuda(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = runs
    config = PoRepConfig.for_sector_size(SIZE, POREP_ID)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api_seal.seal_commit_phase2(config, port["c1"], PROVER_ID, SECTOR_ID)
