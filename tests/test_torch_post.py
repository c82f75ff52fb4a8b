"""Fallback PoSt (Winning and Window) and the LevelCache trees in the port
against the JAX package on the CPU, bit for bit.

- The sector and leaf challenges on 1,000 seeded inputs, and
  generate_winning_post_sector_challenge against the frozen
  tests/golden/torch_post.json.
- Seeded fake sectors (tree_r_last store files and p_aux, as
  tests/test_api_post.py and tests/test_api_post_4k.py build them) of
  2 KiB, shape (8,0,0), and 4 KiB, shape (8,2,0), built by each
  package: the store files are equal, and the vanilla proofs of the
  Winning config (2 challenges, 1 sector) and of the registered Window
  config (10 x 2) over three sectors (two partitions, the second padded
  by duplication) are equal field by field and verify in both packages;
  a wrong comm_r, a short partition and a missing challenge are
  rejected.
- The circuits of the padded Window partition and of the (8,2,0) shape
  equal the JAX package's (SHA-256 of every segment's arrays, the
  assignment and the inputs; the JAX side with
  FIL_PROOFS_WITNESS_BACKEND=numpy, once per run through
  `shared_reference`), their inputs are `generate_public_inputs`, and
  the padded one is satisfied; `generate_public_inputs` of every
  partition and the blank circuits equal the JAX package's, and the
  blank counts are the golden's.
- LevelCache trees (`compact` then `create_lc_tree` over the replica
  file) with rows_to_discard 1 and 2: their proofs equal the full
  store's and the JAX package's LevelCache proofs.
- The port's verify_winning_post / verify_window_post accept the JAX
  package's frozen 2 KiB proofs under its frozen verifying keys, and
  reject a wrong randomness, a flipped bit, a short proof and another
  sector id.

The port's Groth16 setup and prove of the 2 KiB configs take minutes on
the CPU; tests/test_torch_cuda.py holds them against the golden on the
card. The tolerance is exact equality throughout.
"""
import copy
import dataclasses
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.api import post as jax_post
from crypto3_fil_proofs_tpu.core.merkle import builders as jax_builders
from crypto3_fil_proofs_tpu.core.merkle import storage as jax_storage
from crypto3_fil_proofs_tpu.models.post.fallback import circuit as jax_circuit
from crypto3_fil_proofs_tpu.models.post.fallback import vanilla as jax_vanilla
from crypto3_fil_proofs_tpu.models.post.fallback.compound import FallbackPoStCompound as JaxCompound
from crypto3_fil_proofs_tpu.ops.poseidon import hash2 as jax_hash2
from crypto3_fil_proofs_tpu.types import PoStConfig as JaxPoStConfig
from crypto3_fil_proofs_tpu.types import PoStType as JaxPoStType
from crypto3_fil_proofs_torch import caches
from crypto3_fil_proofs_torch.api import post as api_post
from crypto3_fil_proofs_torch.constants import NODE_SIZE, SECTOR_SHAPES
from crypto3_fil_proofs_torch.core import cache_key
from crypto3_fil_proofs_torch.core.merkle import (
    MerkleTree,
    StoreConfig,
    compact,
    create_lc_tree,
    create_tree,
    get_base_tree_count,
    split_config,
    split_config_and_replica,
)
from crypto3_fil_proofs_torch.core.parameter_cache import vk_path
from crypto3_fil_proofs_torch.core.utilities import default_rows_to_discard
from crypto3_fil_proofs_torch.models.post.fallback import circuit
from crypto3_fil_proofs_torch.models.post.fallback import vanilla
from crypto3_fil_proofs_torch.models.post.fallback.compound import FallbackPoStCompound
from crypto3_fil_proofs_torch.ops.poseidon import hash2
from crypto3_fil_proofs_torch.parameters import window_post_public_params, winning_post_public_params
from crypto3_fil_proofs_torch.types import PoStConfig, PoStType, PrivateReplicaInfo, PublicReplicaInfo
from test_torch_commit import circuit_summary
from test_torch_setup import shared_reference

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "golden", "torch_post.json")) as _f:
    GOLDEN = json.load(_f)
RANDOMNESS = bytes([44] * 31 + [0])
PROVER_ID = bytes([66] * 31 + [0])
SECTOR_IDS = (1, 2, 8)  # three sectors: two Window partitions, the second padded


def _configs(size: int, typ_cls, cfg_cls) -> dict:
    return {
        "winning": cfg_cls(sector_size=size, challenge_count=2, sector_count=1, typ=typ_cls.WINNING),
        "window": cfg_cls.window(size),
    }


def _leaves(size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 64, size=(size // NODE_SIZE, 32), dtype=np.uint8)


def _port_sector(root: str, size: int, seed: int):
    """A sector cache dir with tree-r-last store files + p_aux (as PC2
    leaves them), built by the port on the CPU."""
    os.makedirs(root)
    shape = SECTOR_SHAPES[size]
    cfgs = split_config(StoreConfig(root, cache_key.COMM_R_LAST_TREE), get_base_tree_count(shape[1], shape[2]))
    tree = create_tree(_leaves(size, seed), *shape, "poseidon", cfgs, "cpu")
    comm_c = bytes([seed % 64] * 32)
    with open(os.path.join(root, cache_key.PAUX), "wb") as f:
        f.write(comm_c + tree.root())
    return hash2(int.from_bytes(comm_c, "little"), int.from_bytes(tree.root(), "little")).to_bytes(32, "little")


def _jax_sector(root: str, size: int, seed: int):
    os.makedirs(root)
    shape = SECTOR_SHAPES[size]
    cfgs = jax_builders.split_config(
        jax_storage.StoreConfig(root, cache_key.COMM_R_LAST_TREE), get_base_tree_count(shape[1], shape[2]))
    tree = jax_builders.create_tree(_leaves(size, seed), *shape, "poseidon", cfgs)
    comm_c = bytes([seed % 64] * 32)
    with open(os.path.join(root, cache_key.PAUX), "wb") as f:
        f.write(comm_c + tree.root())
    return jax_hash2(int.from_bytes(comm_c, "little"), int.from_bytes(tree.root(), "little")).to_bytes(32, "little")


def _jax_vanilla(cfg, replicas):
    """The JAX package's _post_prove up to its vanilla proofs."""
    params_fn = jax_post.winning_post_public_params if cfg.typ == JaxPoStType.WINNING \
        else jax_post.window_post_public_params
    pp = params_fn(cfg)
    partitions = jax_post.get_partitions_for_window_post(len(replicas), cfg)
    pub_sectors, priv_sectors = [], []
    for sid, rep in sorted(replicas.items()):
        comm_c, comm_r_last = jax_post._load_p_aux(rep)
        pub_sectors.append(jax_vanilla.PublicSector(id=sid, comm_r=rep.comm_r))
        priv_sectors.append(jax_vanilla.PrivateSector(
            tree=jax_post._replica_tree(cfg, rep), comm_c=comm_c, comm_r_last=comm_r_last))
    pub = jax_vanilla.PublicInputs(randomness=RANDOMNESS, prover_id=PROVER_ID, sectors=pub_sectors, k=None)
    proofs = jax_vanilla.FallbackPoSt.prove_all_partitions(
        pp, pub, jax_vanilla.PrivateInputs(sectors=priv_sectors), partitions)
    assert jax_vanilla.FallbackPoSt.verify_all_partitions(pp, pub, proofs)
    return pp, pub, proofs


def _port_params(cfg):
    return (winning_post_public_params if cfg.typ == PoStType.WINNING else window_post_public_params)(cfg)


def _port_vanilla(cfg, replicas):
    pp = _port_params(cfg)
    partitions = api_post.get_partitions_for_window_post(len(replicas), cfg)
    pub, proofs = api_post.vanilla_proofs(cfg, pp, RANDOMNESS, PROVER_ID, replicas, partitions)
    return pp, pub, proofs


def _replicas(info_cls, sectors: dict, ids) -> dict:
    return {sid: info_cls(replica_path="", comm_r=sectors[sid][1], cache_dir=sectors[sid][0]) for sid in ids}


CASES = {  # name: (sector size, config, sector ids)
    "2k-winning": (2048, "winning", (SECTOR_IDS[0],)),
    "2k-window": (2048, "window", SECTOR_IDS),
    "4k-winning": (4096, "winning", (SECTOR_IDS[0],)),
    "4k-window": (4096, "window", (SECTOR_IDS[0],)),
}
# the circuits held against the JAX package's, one partition each (a
# circuit's witness replay costs seconds in each package): the padded
# second Window partition, and the compound (8,2,0) shape
CIRCUITS = {"2k-window": 1, "4k-winning": 0}


def _build(root, size, builder):
    return {sid: (os.path.join(root, str(sid)), builder(os.path.join(root, str(sid)), size, sid * 11 + size))
            for sid in SECTOR_IDS}


def _jax_circuits(shared) -> dict:
    """The JAX package's circuit summaries of CIRCUITS, and every case's
    public inputs (every partition) and blank circuit, with the numpy
    witness replay."""
    saved = os.environ.get("FIL_PROOFS_WITNESS_BACKEND")
    os.environ["FIL_PROOFS_WITNESS_BACKEND"] = "numpy"
    try:
        out = {}
        sectors = {size: _build(str(shared / f"jax_post_{size}"), size, _jax_sector) for size in (2048, 4096)}
        for name, (size, kind, ids) in CASES.items():
            cfg = _configs(size, JaxPoStType, JaxPoStConfig)[kind]
            pp, pub, proofs = _jax_vanilla(cfg, _replicas(jax_post.PrivateReplicaInfo, sectors[size], ids))
            out[name] = {
                "public": [jax_circuit.generate_public_inputs(pp, pub, k) for k in range(len(proofs))],
                "blank": circuit_summary(JaxCompound(SECTOR_SHAPES[size]).blank_circuit(pp)),
            }
            if name in CIRCUITS:
                k = CIRCUITS[name]
                out[name]["circuit"] = circuit_summary(jax_circuit.circuit_from_vanilla(pp, pub, proofs[k], k))
        return out
    finally:
        if saved is None:
            del os.environ["FIL_PROOFS_WITNESS_BACKEND"]
        else:
            os.environ["FIL_PROOFS_WITNESS_BACKEND"] = saved


@pytest.fixture(scope="module")
def jax_circuits(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_post_circuits", _jax_circuits)


def _sectors(shared) -> dict:
    root = shared / "post"
    return {size: (_build(str(root / f"port{size}"), size, _port_sector),
                   _build(str(root / f"jax{size}"), size, _jax_sector)) for size in (2048, 4096)}


@pytest.fixture(scope="module")
def sectors(tmp_path_factory):
    """{size: (port sectors, JAX sectors)}, each {id: (cache dir, comm_r)},
    built once per run (`shared_reference`): the tests only read them."""
    return shared_reference(tmp_path_factory, "post_sectors", _sectors)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, sectors, tmp_path_factory):
    """A case's vanilla proofs in both packages, once per run
    (`shared_reference`): the tests only read them."""
    size, kind, ids = CASES[request.param]
    port_sectors, jax_sectors = sectors[size]
    cfg = _configs(size, PoStType, PoStConfig)[kind]
    jcfg = _configs(size, JaxPoStType, JaxPoStConfig)[kind]

    def vanilla(_shared):
        return (_port_vanilla(cfg, _replicas(PrivateReplicaInfo, port_sectors, ids)),
                _jax_vanilla(jcfg, _replicas(jax_post.PrivateReplicaInfo, jax_sectors, ids)))

    mine, theirs = shared_reference(tmp_path_factory, f"post_vanilla_{request.param}", vanilla)
    return request.param, cfg, mine, theirs


# ---------------------------------------------------------------------------
# challenges
# ---------------------------------------------------------------------------


def test_challenges_equal_jax():
    rng = random.Random(1000)
    for _ in range(1000):
        rnd, pid = rng.randbytes(32), rng.randbytes(32)
        n, set_len, sid = rng.randrange(1 << 20), rng.randrange(1, 1 << 45), rng.randrange(1 << 63)
        assert vanilla.generate_sector_challenge(rnd, n, set_len, pid) == \
            jax_vanilla.generate_sector_challenge(rnd, n, set_len, pid)
        size = rng.choice([2048, 512 << 20, 32 << 30])
        pp, jpp = vanilla.PublicParams(size, 66, 1), jax_vanilla.PublicParams(size, 66, 1)
        assert vanilla.generate_leaf_challenge(pp, rnd, sid, n) == jax_vanilla.generate_leaf_challenge(jpp, rnd, sid, n)


def test_winning_sector_challenges_equal_golden():
    g = GOLDEN["sector_challenges"]
    pid, rnd = bytes.fromhex(g["prover_id"]), bytes.fromhex(GOLDEN["randomness"])
    cfg = PoStConfig.winning(512 << 20)
    for n, want in g["winning_512MiB"].items():
        assert api_post.generate_winning_post_sector_challenge(cfg, rnd, int(n), pid) == want
    for n, want in g["draws_66"].items():
        assert vanilla.generate_sector_challenges(rnd, 66, int(n), pid) == want


# ---------------------------------------------------------------------------
# vanilla proofs
# ---------------------------------------------------------------------------


def test_fake_sector_stores_equal_jax(sectors):
    for size, (port_sectors, jax_sectors) in sectors.items():
        for sid in SECTOR_IDS:
            mine, theirs = port_sectors[sid], jax_sectors[sid]
            assert mine[1] == theirs[1]
            names = sorted(os.listdir(theirs[0]))
            assert sorted(os.listdir(mine[0])) == names
            for name in names:
                with open(os.path.join(mine[0], name), "rb") as a, open(os.path.join(theirs[0], name), "rb") as b:
                    assert a.read() == b.read(), (size, sid, name)


def test_vanilla_proofs_equal_jax(case):
    name, cfg, (pp, pub, proofs), (jpp, jpub, jproofs) = case
    assert dataclasses.asdict(pp) == dataclasses.asdict(jpp)
    assert [dataclasses.asdict(p) for p in proofs] == [dataclasses.asdict(p) for p in jproofs]
    assert vanilla.FallbackPoSt.verify_all_partitions(pp, pub, proofs)
    if name == "2k-window":
        assert len(proofs) == 2 and proofs[1].sectors[1] is proofs[1].sectors[0]  # padded by duplication


def test_vanilla_rejects_wrong_comm_r_and_short_partition(case):
    _, cfg, (pp, pub, proofs), _ = case
    bad = copy.deepcopy(pub)
    bad.sectors[0].comm_r = bytes(32)
    assert not vanilla.FallbackPoSt.verify_all_partitions(pp, bad, proofs)
    short = copy.deepcopy(proofs)
    short[0].sectors.pop()
    assert not vanilla.FallbackPoSt.verify_all_partitions(pp, pub, short)
    fewer = copy.deepcopy(proofs)
    fewer[0].sectors[0].inclusion_proofs.pop()
    assert not vanilla.FallbackPoSt.verify_all_partitions(pp, pub, fewer)
    assert not vanilla.FallbackPoSt.verify_all_partitions(pp, pub, proofs[:-1] if len(proofs) > 1 else [])
    with pytest.raises(ValueError):
        vanilla.FallbackPoSt.prove_all_partitions(pp, pub, vanilla.PrivateInputs(sectors=[]), 1)


def test_satisfies_requirements():
    pp = vanilla.PublicParams(2048, 10, 2)
    assert vanilla.FallbackPoSt.satisfies_requirements(pp, vanilla.ChallengeRequirements(40), 2)
    assert not vanilla.FallbackPoSt.satisfies_requirements(pp, vanilla.ChallengeRequirements(41), 2)


# ---------------------------------------------------------------------------
# circuits
# ---------------------------------------------------------------------------


def test_public_inputs_equal_jax(case, jax_circuits):
    """generate_public_inputs of every partition (the padded Window
    partition repeats the real sector's challenges)."""
    name, _, (pp, pub, proofs), _ = case
    want = jax_circuits[name]["public"]
    assert [circuit.generate_public_inputs(pp, pub, k) for k in range(len(proofs))] == want


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_equals_jax(name, sectors, jax_circuits):
    """The circuit equals the JAX package's, its inputs are
    generate_public_inputs', and (the padded Window partition) it is
    satisfied."""
    size, kind, ids = CASES[name]
    cfg = _configs(size, PoStType, PoStConfig)[kind]
    pp, pub, proofs = _port_vanilla(cfg, _replicas(PrivateReplicaInfo, sectors[size][0], ids))
    k = CIRCUITS[name]
    cs = circuit.circuit_from_vanilla(pp, pub, proofs[k], k, device="cpu")
    got = circuit_summary(cs)
    assert got == jax_circuits[name]["circuit"]
    assert got["inputs"][1:] == circuit.generate_public_inputs(pp, pub, k) == jax_circuits[name]["public"][k]
    if kind == "window":
        assert cs.which_unsatisfied() is None


@pytest.mark.parametrize("arity", [2, 8, 11])
def test_poseidon_witness_replay_equals_jax(arity):
    """The port's replay on the CPU (the plain version of kernel K7)
    against the JAX package's numpy replay, with 0 and r - 1 among the
    inputs, at K = 1 and an odd K (the JAX package's XLA replay is held
    equal to its numpy one by tests/test_tiled.py)."""
    from crypto3_fil_proofs_tpu.zk.gadgets import tiled as jax_tiled
    from crypto3_fil_proofs_torch.ops import fr_vec as fv
    from crypto3_fil_proofs_torch.ops.bls12_381 import R
    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    rng = random.Random(arity)
    values = [0, R - 1] + [rng.randrange(R) for _ in range(4 * arity - 4)] + [R - 1, 0]
    pre = fv.to_v(values).reshape(4, arity, 16)
    want = jax_tiled._poseidon_witness_numpy(pre, arity)  # one replay, instance by instance
    for lo, hi in ((0, 1), (1, 4)):  # K = 1 and K = 3
        got = tiled.poseidon_witness_v(pre[lo:hi], arity, device="cpu")
        assert got.dtype == np.uint64 and got.shape == (hi - lo, tiled.poseidon_template(arity).n_int, 16)
        assert np.array_equal(got, want[lo:hi])


def test_poseidon_witness_replay_cuda_raises_without_a_card(monkeypatch):
    """A "cuda" replay (the default) where there is no card raises; it is
    not run on the CPU instead."""
    from crypto3_fil_proofs_torch.ops import fr_vec as fv
    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pre = fv.to_v(list(range(16))).reshape(2, 8, 16)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tiled.poseidon_witness_v(pre, 8, device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tiled.poseidon_witness_v(pre, 8)


def test_blank_circuits_equal_jax(case, jax_circuits):
    name, cfg, (pp, _, _), _ = case
    blank = FallbackPoStCompound(SECTOR_SHAPES[cfg.sector_size]).blank_circuit(pp)
    assert circuit_summary(blank) == jax_circuits[name]["blank"]


def test_blank_circuit_counts_equal_golden():
    for g in GOLDEN["blank_counts"]:
        pp = vanilla.PublicParams(g["sector_size"], g["challenge_count"], g["sector_count"])
        cs = FallbackPoStCompound(SECTOR_SHAPES[g["sector_size"]]).blank_circuit(pp)
        assert (cs.num_constraints, cs.num_inputs, len(cs.values)) == (
            g["constraints"], g["inputs"], g["variables"]), g


def test_cache_prefix_equals_jax():
    for size in (2048, 4096, 512 << 20, 32 << 30):
        for cfg in (PoStConfig.winning(size), PoStConfig.window(size)):
            pp = vanilla.PublicParams(cfg.sector_size, cfg.challenge_count, cfg.sector_count)
            jpp = jax_vanilla.PublicParams(cfg.sector_size, cfg.challenge_count, cfg.sector_count)
            assert FallbackPoStCompound(SECTOR_SHAPES[size]).cache_prefix(pp) == \
                JaxCompound(SECTOR_SHAPES[size]).cache_prefix(jpp)


# ---------------------------------------------------------------------------
# LevelCache trees
# ---------------------------------------------------------------------------


def _lc_pair(root, leaves: np.ndarray, shape, rtd: int):
    """A full tree built by the port, a compacted copy reopened as a
    LevelCache tree by each package."""
    count = get_base_tree_count(shape[1], shape[2])
    replica = os.path.join(root, "replica")
    leaves.tofile(replica)
    full = create_tree(leaves, *shape, "poseidon",
                       split_config(StoreConfig(os.path.join(root, "full"), "tree-r-last"), count), "cpu")
    trees = {}
    for pkg in ("port", "jax"):
        shutil.copytree(os.path.join(root, "full"), os.path.join(root, pkg))
        if pkg == "port":
            cfgs, rep = split_config_and_replica(
                StoreConfig(os.path.join(root, pkg), "tree-r-last", rows_to_discard=rtd), replica, leaves.shape[0],
                count)
            for cfg in cfgs:
                compact(cfg, leaves.shape[0] // count, shape[0])
            trees[pkg] = create_lc_tree(leaves.shape[0], *shape, cfgs, rep, "poseidon", "cpu")
        else:
            cfgs, rep = jax_builders.split_config_and_replica(
                jax_storage.StoreConfig(os.path.join(root, pkg), "tree-r-last", rows_to_discard=rtd), replica,
                leaves.shape[0], count)
            for cfg in cfgs:
                jax_builders.compact(cfg, leaves.shape[0] // count, shape[0])
            trees[pkg] = jax_builders.create_lc_tree(leaves.shape[0], *shape, cfgs, rep, "poseidon")
    for name in os.listdir(os.path.join(root, "jax")):
        with open(os.path.join(root, "jax", name), "rb") as a, open(os.path.join(root, "port", name), "rb") as b:
            assert a.read() == b.read(), name  # compact wrote the same cached rows
    return full, trees["port"], trees["jax"]


def test_tree_math_and_small_modules_equal_jax(monkeypatch):
    from crypto3_fil_proofs_tpu.core import partitions as jax_partitions
    from crypto3_fil_proofs_tpu.core import sector as jax_sector
    from crypto3_fil_proofs_tpu.core import utilities as jax_utilities
    from crypto3_fil_proofs_tpu.core.settings import reset_settings
    from crypto3_fil_proofs_torch.core import partitions, sector, utilities
    from crypto3_fil_proofs_torch.core.merkle import storage

    for leafs, arity in ((1, 8), (8, 8), (64, 8), (4096, 8), (1 << 24, 8), (2, 2), (1 << 10, 2), (256, 4)):
        n = storage.get_merkle_tree_len(leafs, arity)
        assert storage.get_merkle_tree_leafs(n, arity) == jax_storage.get_merkle_tree_leafs(n, arity) == leafs
        rows = utilities.merkle_row_count(leafs, arity)
        assert rows == jax_utilities.merkle_row_count(leafs, arity)
        assert storage.get_merkle_proof_lemma_len(rows, arity) == jax_storage.get_merkle_proof_lemma_len(rows, arity)
        for rtd in range(4):
            assert storage.get_merkle_tree_cache_size(leafs, arity, rtd) == \
                jax_storage.get_merkle_tree_cache_size(leafs, arity, rtd)
        for env in ("2", "5"):
            monkeypatch.setenv("FIL_PROOFS_ROWS_TO_DISCARD", env)
            reset_settings()
            assert utilities.default_rows_to_discard(leafs, arity) == \
                jax_utilities.default_rows_to_discard(leafs, arity)
    reset_settings()
    cfg = StoreConfig("/d", "tree-r-last", 7, 2)
    jcfg = jax_storage.StoreConfig("/d", "tree-r-last", 7, 2)
    assert dataclasses.asdict(StoreConfig.from_config(cfg, "x")) == \
        dataclasses.asdict(jax_storage.StoreConfig.from_config(jcfg, "x"))
    assert dataclasses.asdict(split_config_and_replica(cfg, "/r", 64, 2)[1]) == \
        dataclasses.asdict(jax_builders.split_config_and_replica(jcfg, "/r", 64, 2)[1])
    assert sector.ordered_sector_set([5, 1, 5, 3]) == jax_sector.ordered_sector_set([5, 1, 5, 3]) == [1, 3, 5]
    for total, per in ((0, 2), (1, 2), (2, 2), (3, 2), (2349, 2349), (2350, 2349)):
        assert partitions.partition_count(total, per) == jax_partitions.partition_count(total, per)
        assert api_post.get_partitions_for_window_post(total, PoStConfig(2048, 10, per, PoStType.WINDOW)) == \
            jax_post.get_partitions_for_window_post(total, JaxPoStConfig(2048, 10, per, JaxPoStType.WINDOW))


@pytest.mark.parametrize("leafs,shape", [(4096, (8, 0, 0)), (128, (8, 2, 0))], ids=["8-0-0-rtd2", "8-2-0-rtd1"])
def test_level_cache_proofs_equal_full_store_and_jax(tmp_path, leafs, shape):
    base_leafs = leafs // get_base_tree_count(shape[1], shape[2])
    rtd = default_rows_to_discard(base_leafs, shape[0])
    assert rtd == {4096: 2, 64: 1}[base_leafs]
    full, lc, jax_lc = _lc_pair(str(tmp_path), _leaves(leafs * NODE_SIZE, leafs), shape, rtd)
    assert lc.root() == full.root() == jax_lc.root()
    base = lc if isinstance(lc, MerkleTree) else lc.base_trees[0]
    assert base.store.rows_to_discard == rtd and base.device == "cpu"
    rng = random.Random(leafs)
    for challenge in [0, leafs - 1] + [rng.randrange(leafs) for _ in range(2)]:
        got = lc.gen_proof(challenge)
        assert got == full.gen_proof(challenge)
        assert dataclasses.asdict(got) == dataclasses.asdict(jax_lc.gen_proof(challenge))
        assert got.validate() and got.proves_challenge(challenge)
    with pytest.raises(IndexError):
        base.store.read_range(base_leafs, base_leafs + 1)  # the discarded rows are gone


# ---------------------------------------------------------------------------
# verification of the JAX package's frozen proofs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["winning", "window"])
def test_verify_accepts_jax_golden_proof(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp_path))
    caches.clear_caches()
    g = GOLDEN[kind]
    cfg = _configs(GOLDEN["sector_size"], PoStType, PoStConfig)[kind]
    prefix = FallbackPoStCompound(SECTOR_SHAPES[cfg.sector_size]).cache_prefix(_port_params(cfg))
    assert prefix == g["cache_prefix"]
    with open(vk_path(prefix), "wb") as f:
        f.write(bytes.fromhex(g["vk_npz"]))
    verify = api_post.verify_winning_post if kind == "winning" else api_post.verify_window_post
    with open(os.path.join(HERE, "golden", "torch_precommit_2k.json")) as f:
        pre = json.load(f)
    pid, rnd, proof = bytes.fromhex(pre["prover_id"]), bytes.fromhex(GOLDEN["randomness"]), bytes.fromhex(g["proof"])
    pub = {pre["sector_id"]: PublicReplicaInfo(comm_r=bytes.fromhex(GOLDEN["comm_r"]))}
    try:
        assert verify(cfg, rnd, pub, pid, proof)
        assert not verify(cfg, bytes(32), pub, pid, proof)
        flipped = bytearray(proof)
        flipped[0] ^= 1
        assert not verify(cfg, rnd, pub, pid, bytes(flipped))
        assert not verify(cfg, rnd, pub, pid, proof[:-1])
        other = {pre["sector_id"] + 1: pub[pre["sector_id"]]}  # another sector's challenges
        assert not verify(cfg, rnd, other, pid, proof)
    finally:
        caches.clear_caches()
