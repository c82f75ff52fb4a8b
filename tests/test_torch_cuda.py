"""Kernels K1-K7 on the card against their plain versions (K7, the
Poseidon witness replay, also through zk/gadgets/tiled.py
`poseidon_witness_v` against its CPU replay), the 2 KiB
pre-commit on CUDA against the frozen JAX commitments, the cubic
Groth16 proof on CUDA against the frozen JAX proof bytes, setup's
fixed-base batches and normalisation against their plain versions, and
setup and prove of tests/test_torch_setup.py's block circuit on CUDA
against the frozen JAX key digest and proof
(tests/golden/torch_setup_blocks.json), the 2 KiB Winning (2 x 1) and
Window (10 x 2) PoSt of the sector of tests/golden/torch_precommit_2k.json
on CUDA against the frozen JAX key digests and proof bytes
(tests/golden/torch_post.json), LevelCache proofs whose discarded
rows are rebuilt on CUDA against the full store's, the phase-2 query
rescaling (ops/g1_scale.py) against its plain version, and the 2 KiB
`paramcache --only-post` Window key against the frozen JAX key digest,
and the 2 KiB Election PoSt (2 x 1) against the frozen JAX candidate,
key digest, verifying key and proof bytes
(tests/golden/torch_election_2k.json); K3b, the batched rows, and
K3's batched pass (rows of 2^13) against the plain transform, and an
8-shard mesh on the card (the sharded tree, NTT and MSMs against the
single-device functions and the frozen JAX golden
tests/golden/torch_sharded.json).

Marked `cuda`: they need an NVIDIA GPU with nvcc and skip without one.
They import nothing of JAX; where JAX is not installed, skip
tests/conftest.py (which imports it):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
Inputs are made with numpy from a seed; the tolerance is exact equality.
"""
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
from crypto3_fil_proofs_torch.ops.cuda import field as k1
from crypto3_fil_proofs_torch.ops.cuda import poseidon as k2
from crypto3_fil_proofs_torch.ops.poseidon import poseidon_hash

pytestmark = pytest.mark.cuda

SEED = 0x5EED


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _elements(field, n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, field.nbytes), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "little") % field.modulus for r in raw]
    vals[:3] = [0, 1, field.modulus - 1]
    return vals


@pytest.mark.parametrize("field", [F.FR, F.FQ], ids=["fr", "fq"])
def test_k1_matches_plain(dev, field):
    n = 4096
    a = F.ints_to_limbs32(_elements(field, n, SEED), field).to(dev)
    b = F.ints_to_limbs32(_elements(field, n, SEED + 1)[::-1], field).to(dev)
    assert torch.equal(k1.montmul(a, b, field), F.mont_mul32(a, b, field))
    assert torch.equal(k1.montmul(a, b[7], field), F.mont_mul32(a, b[7], field))
    assert torch.equal(k1.from_mont(k1.to_mont(a, field), field), a)


@pytest.mark.parametrize("arity", k2.ARITIES)
def test_k2_matches_plain_and_host(dev, arity):
    n = 256
    pre = F.ints_to_limbs32(_elements(F.FR, n * arity, SEED + arity)).to(dev)
    pre = pre.reshape(n, arity, PT.L)
    got = k2.poseidon_hash(pre, arity)
    assert torch.equal(got, PT.hash_mont_plain(pre, arity))
    values = F.limbs32_to_ints(k1.from_mont(pre[:4].reshape(-1, PT.L)))
    digests = F.limbs32_to_ints(k1.from_mont(got[:4]))
    for i in range(4):
        assert digests[i] == poseidon_hash(values[i * arity : (i + 1) * arity], arity)


@pytest.mark.parametrize("n", [1, 33, 4_500, "switch"])
@pytest.mark.parametrize("arity", k2.ARITIES)
def test_k7_witness_matches_plain(dev, arity, n):
    """K7 == witness_plain on an edge batch (0, 1, p - 1 first): one
    instance, a warp and one more, enough for blocks wider than a warp,
    and ("switch") the batch sizes just below the switch from the lane
    groups to one thread per instance and at it, and a batch whose last
    warp holds one group and idle ones; each launch is counted. Through
    poseidon_witness_v, the numpy layout of the card's replay == the
    CPU's."""
    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    switch = k2.witness_switch(arity)
    sizes = [switch - 1, switch, 5 * (32 // (arity + 1)) + 1] if n == "switch" else [n]
    for n in sizes:
        vals = _elements(F.FR, max(3, n * arity), SEED + 7 * arity)[: n * arity]
        pre = k1.to_mont(F.ints_to_limbs32(vals).to(dev)).reshape(n, arity, PT.L)
        before = k2.launches["poseidon_witness"]
        got = k2.witness(pre, arity)
        assert k2.launches["poseidon_witness"] == before + 1
        assert got.shape == (n, PT.witness_len(arity), PT.L)
        assert torch.equal(got, PT.witness_plain(pre, arity))
    if n == 33:
        pre_v = F.ints_to_limbs32(vals).numpy().view("<u2").astype(np.uint64).reshape(n, arity, 16)
        assert np.array_equal(tiled.poseidon_witness_v(pre_v, arity, device=dev),
                              tiled.poseidon_witness_v(pre_v, arity, device="cpu"))


def test_precommit_2k_cuda_matches_golden(dev, tmp_path, monkeypatch):
    from crypto3_fil_proofs_torch.api import mod as api_mod
    from crypto3_fil_proofs_torch.api import seal as api_seal
    from crypto3_fil_proofs_torch.core.fr32 import to_unpadded_bytes
    from crypto3_fil_proofs_torch.types import PoRepConfig

    monkeypatch.setenv("FIL_PROOFS_PARENT_CACHE", str(tmp_path / "parents"))
    with open(os.path.join(os.path.dirname(__file__), "golden", "torch_precommit_2k.json")) as f:
        g = json.load(f)
    size = g["sector_size"]
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(size)))
    config = PoRepConfig.for_sector_size(size, bytes.fromhex(g["porep_id"]))
    staged, sealed, cache = (str(tmp_path / n) for n in ("staged", "sealed", "cache"))
    info, _ = api_mod.add_piece(piece, staged, len(piece), [])
    args = (bytes.fromhex(g["prover_id"]), g["sector_id"], bytes.fromhex(g["ticket"]), [info])
    p1 = api_seal.seal_pre_commit_phase1(config, cache, staged, sealed, *args)
    before = dict(k2.launches)
    p2 = api_seal.seal_pre_commit_phase2(config, p1, cache, sealed)
    assert k2.launches[2] > before[2] and k2.launches[8] > before[8]
    assert (p2.comm_d.hex(), p2.comm_r.hex()) == (g["comm_d"], g["comm_r"])


# ---------------------------------------------------------------------------
# Groth16 slice: K1's fr_sub, K3 (NTT), K4/K5 (point ops), K6 (MSM)
# ---------------------------------------------------------------------------


def _fr(n, seed):
    return F.ints_to_limbs32(_elements(F.FR, n, seed)[:n])


@pytest.mark.parametrize("log_n", [1, 3, 10, 11, 13])
def test_k3_transforms_match_plain(dev, log_n):
    from crypto3_fil_proofs_torch.ops import ntt as N
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    x = _fr(1 << log_n, SEED + log_n)
    xd = x.to(dev)
    for inverse in (False, True):
        assert torch.equal(k3.transform(xd, log_n, inverse).cpu(), N.transform_plain(x, log_n, inverse))
    assert torch.equal(k3.coset_intt(k3.coset_ntt(xd, log_n), log_n).cpu(), x)
    assert torch.equal(k3.intt(xd, log_n).cpu(), N.intt(x, log_n))


def test_k1_sub_and_h_pipeline_match_plain(dev):
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    a, b, c = (_fr(1 << 12, SEED + k) for k in range(3))
    assert torch.equal(k1.sub(a.to(dev), b.to(dev)).cpu(), F.sub32(a, b))
    got = k3.h_from_evals(a.to(dev), b.to(dev), c.to(dev), 12)
    assert torch.equal(got.cpu(), k3.h_from_evals(a, b, c, 12))


def _edge_batch(curve, n, seed):
    """acc (Jacobian, Z != 1), q (affine), valid; lane 0 acc at infinity,
    1 q == acc, 2 q == -acc, 3 masked, 4 acc at infinity and masked."""
    from crypto3_fil_proofs_torch.ops import bls12_381 as B
    from crypto3_fil_proofs_torch.ops import msm as M

    pts, _ = M.random_walk_bases(curve, 2 * n, seed)
    two = curve.host_double(pts[0])
    acc_h = [curve.host_add(p, two) for p in pts[:n]]
    q_h = list(pts[n:])
    acc_h[0] = acc_h[4] = curve.host_inf
    q_h[1] = acc_h[1]
    x, y = curve.to_affine(acc_h[2])
    q_h[2] = (x, (-y) % B.P if curve.name == "g1" else ((-y[0]) % B.P, (-y[1]) % B.P))
    acc = curve.encode_coords([c for p in acc_h for c in p]).reshape((n, 3) + curve.coord)
    q, _ = curve.points_to_device(q_h)
    valid = torch.ones(n, dtype=torch.bool)
    valid[[3, 4]] = False
    return acc, q, valid


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_k4_k5_match_plain(dev, name):
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5

    kern = k4.K4 if name == "g1" else k5.K5
    curve = kern.curve
    acc, q, valid = _edge_batch(curve, 256, SEED)
    out, same = kern.madd_nodbl(acc.to(dev), q.to(dev), valid.to(dev))
    want, want_same = curve.madd_nodbl_plain(acc, q, valid)
    assert torch.equal(out.cpu(), want) and torch.equal(same.cpu(), want_same)
    assert same.cpu().nonzero().flatten().tolist() == [1]
    assert torch.equal(kern.dbl(out, same).cpu(), curve.dbl_plain(want, want_same))
    every = torch.ones(acc.shape[0], dtype=torch.bool)
    assert torch.equal(kern.dbl(acc.to(dev), every.to(dev)).cpu(), curve.dbl_plain(acc, every))
    p = torch.cat([want[1:], want[:1]])  # p == q on lane 0's neighbour, infinity on others
    assert torch.equal(kern.add(want.to(dev), p.to(dev)).cpu(), curve.add_plain(want, p))
    assert torch.equal(kern.add(want.to(dev), want.to(dev)).cpu(), curve.add_plain(want, want))
    if name == "g1":
        got = kern.madd(acc.to(dev), q.to(dev), valid.to(dev))
        assert torch.equal(got.cpu(), curve.madd_plain(acc, q, valid))


def _tiled_batch(curve, n):
    """n lanes tiled from a 61-lane edge batch: the edge cases fall on
    every position of a warp (16 lanes of K5's pairs, 32 of K4's)."""
    acc, q, valid = _edge_batch(curve, 61, SEED)
    idx = torch.arange(n) % 61
    return acc[idx].contiguous(), q[idx].contiguous(), valid[idx].contiguous(), idx


@pytest.mark.parametrize("n", [1, 3, 255, 257, 35_441])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_k4_k5_odd_lane_counts(dev, name, n):
    """K5 in its pair layout (and K4) where the last block is partial,
    every lane compared; g1_madd too."""
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.cuda import g2 as k5

    kern = k4.K4 if name == "g1" else k5.K5
    curve = kern.curve
    acc, q, valid, idx = _tiled_batch(curve, n)
    out, same = kern.madd_nodbl(acc.to(dev), q.to(dev), valid.to(dev))
    want, want_same = curve.madd_nodbl_plain(acc, q, valid)
    assert torch.equal(out.cpu(), want) and torch.equal(same.cpu(), want_same)
    assert torch.equal(same.cpu(), idx == 1)
    every = torch.ones(n, dtype=torch.bool)
    assert torch.equal(kern.dbl(out, every.to(dev)).cpu(), curve.dbl_plain(want, every))
    p = torch.cat([want[1:], want[:1]])
    assert torch.equal(kern.add(acc.to(dev), p.to(dev)).cpu(), curve.add_plain(acc, p))
    if name == "g1":
        got = kern.madd(acc.to(dev), q.to(dev), valid.to(dev))
        assert torch.equal(got.cpu(), curve.madd_plain(acc, q, valid))


@pytest.mark.parametrize("doubling", ["every", "none"])
def test_g1_madd_doubling_lanes(dev, doubling):
    """g1_madd where every lane, or no lane, has P == Q: every thread of
    a warp takes the doubling path, or none does."""
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4

    curve = k4.K4.curve
    acc, q, _, idx = _tiled_batch(curve, 1000)
    keep = (acc[:, 2] != 0).flatten(1).any(1) & (idx != 1)  # no lane at infinity or with q == acc
    acc, q = acc[keep].contiguous(), q[keep].contiguous()
    if doubling == "every":
        q = curve.normalize(acc)[0]
    valid = torch.ones(acc.shape[0], dtype=torch.bool)
    got = k4.madd(acc.to(dev), q.to(dev), valid.to(dev))
    assert torch.equal(got.cpu(), curve.madd_plain(acc, q, valid))
    _, same = curve.madd_nodbl_plain(acc, q, valid)
    assert bool(same.all()) == (doubling == "every") and bool(same.any()) == (doubling == "every")


@pytest.mark.parametrize("name,n,c", [("g1", 400, 5), ("g2", 200, 4)])
def test_k6_msm_matches_plain_and_logs(dev, name, n, c):
    from crypto3_fil_proofs_torch.ops import bls12_381 as B
    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2

    curve = G1 if name == "g1" else G2
    bases, logs = M.random_walk_bases(curve, 64, SEED)
    aff, _ = curve.points_to_device([bases[i % 64] for i in range(n)])
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "little") % B.R for _ in range(n)]
    scalars[:4] = [0, 1, B.R - 1, 1]
    s = F.ints_to_limbs32(scalars)
    got = M.msm(curve, aff.to(dev), s.to(dev), c)
    gen = B.g1_from_affine(B.G1_GEN) if name == "g1" else B.g2_from_affine((B.G2_GEN_X, B.G2_GEN_Y))
    mul = B.g1_mul if name == "g1" else B.g2_mul
    want = mul(gen, sum(k * logs[i % 64] for i, k in enumerate(scalars)) % B.R)
    assert curve.to_affine(got) == curve.to_affine(want)
    # each stage against its plain version
    bk = M.kernels(curve)[1]
    windows = -(-M.scalar_bits(s) // c)
    sched = M.schedule(s.to(dev), c, windows)
    chunks = bk.bucket_acc(aff.to(dev), sched.order, sched.start, sched.length)
    cpu = lambda t: t.cpu()
    assert torch.equal(chunks.cpu(), M.bucket_acc_plain(curve, aff, *map(cpu, (sched.order, sched.start, sched.length))))
    buckets = bk.bucket_reduce(chunks, sched.chunk_ptr)
    assert torch.equal(buckets.cpu(), M.bucket_reduce_plain(curve, chunks.cpu(), sched.chunk_ptr.cpu()))
    t, s = None, buckets
    for group in (2, 4):  # two aggregation levels, the second with a carried t
        got_t, got_s = bk.agg_level(s, t, group, True)
        want_t, want_s = M.agg_level_plain(curve, s.cpu(), None if t is None else t.cpu(), group, True)
        assert torch.equal(got_t.cpu(), want_t) and torch.equal(got_s.cpu(), want_s)
        t, s = got_t, got_s


def test_groth16_cubic_cuda_matches_golden(dev):
    from crypto3_fil_proofs_torch.zk import groth16
    from crypto3_fil_proofs_torch.zk.gadgets.num import AllocatedNum
    from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem, LinearCombination, lc_one

    with np.load(os.path.join(os.path.dirname(__file__), "golden", "torch_groth16_cubic.npz")) as g:
        golden = {k: g[k] for k in g.files}
    pk = groth16.proving_key_from_jax(golden)
    cs = ConstraintSystem()
    xn = AllocatedNum.alloc(cs, 3)
    x3 = xn.square(cs).mul(cs, xn)
    out = AllocatedNum.alloc_input(cs, int(golden["public_output"]))
    cs.enforce(x3.lc() + xn.lc() + LinearCombination.constant(5), lc_one(), out.lc(), "out")
    for rnd in ("fixed", "other"):
        proof = groth16.prove(pk, cs, randomness=rnd.encode())
        assert proof.to_bytes() == golden[f"proof_{rnd}"].tobytes()
        assert groth16.verify(pk.vk, proof, [int(golden["public_output"])])


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_fixed_base_and_normalize_match_plain(dev, name):
    """Setup's fixed-base batch (K4/K5 madd_nodbl) and its normalisation
    (K1 fq_montmul) against the plain versions on the card, on 300
    scalars with 0, 1 and r - 1 among them."""
    from crypto3_fil_proofs_torch.ops import fixed_base as fb
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2

    curve = G1 if name == "g1" else G2
    scalars = F.ints_to_limbs32(_elements(F.FR, 300, SEED + 9)).to(dev)
    got = fb.fixed_base(curve, scalars)
    want = fb.fixed_base(curve, scalars, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[1][0]) and bool(got[1][1:].all())
    acc = fb._run_chunk(curve, fb.window_table(curve, dev), scalars, plain=False)
    got_n, want_n = fb.normalize(curve, acc), curve.normalize(acc)
    assert torch.equal(got_n[0], want_n[0]) and torch.equal(got_n[1], want_n[1])


def test_setup_and_prove_cuda_match_golden(dev, tmp_path):
    """Setup and prove of tests/test_torch_setup.py's block circuit on
    CUDA against the JAX package's frozen key digest and proof bytes."""
    from crypto3_fil_proofs_torch.zk import groth16
    from test_torch_setup import GOLDEN, RANDOMNESS, SEED, arrays_digest, block_circuit

    with open(GOLDEN) as f:
        golden = json.load(f)
    cs = block_circuit("crypto3_fil_proofs_torch")
    pk = groth16.setup(cs, seed=SEED, device=dev)
    assert pk.a_query[0].is_cuda
    path = str(tmp_path / "key.npz")
    pk.save(path)
    with np.load(path) as d:
        assert arrays_digest({k: d[k] for k in d.files}) == golden["key_digest"]
    proof = groth16.prove(pk, cs, randomness=RANDOMNESS, device=dev)
    assert proof.to_bytes().hex() == golden["proof"]


# ---------------------------------------------------------------------------
# PoSt slice: the 2 KiB Winning and Window proofs, LevelCache proofs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sealed_2k(tmp_path_factory):
    """The 2 KiB sector of tests/golden/torch_precommit_2k.json, sealed on
    CUDA, with its golden identifiers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from crypto3_fil_proofs_torch.api import mod as api_mod
    from crypto3_fil_proofs_torch.api import seal as api_seal
    from crypto3_fil_proofs_torch.core.fr32 import to_unpadded_bytes
    from crypto3_fil_proofs_torch.types import PoRepConfig

    tmp = tmp_path_factory.mktemp("post2k")
    mp = pytest.MonkeyPatch()
    mp.setenv("FIL_PROOFS_PARENT_CACHE", str(tmp / "parents"))
    with open(os.path.join(os.path.dirname(__file__), "golden", "torch_precommit_2k.json")) as f:
        g = json.load(f)
    size = g["sector_size"]
    piece = bytes((i * 37 + 11) % 256 for i in range(to_unpadded_bytes(size)))
    config = PoRepConfig.for_sector_size(size, bytes.fromhex(g["porep_id"]))
    staged, sealed, cache = (str(tmp / n) for n in ("staged", "sealed", "cache"))
    info, _ = api_mod.add_piece(piece, staged, len(piece), [])
    p1 = api_seal.seal_pre_commit_phase1(config, cache, staged, sealed, bytes.fromhex(g["prover_id"]),
                                         g["sector_id"], bytes.fromhex(g["ticket"]), [info])
    p2 = api_seal.seal_pre_commit_phase2(config, p1, cache, sealed)
    yield g, p2.comm_r, sealed, cache, tmp
    mp.undo()


@pytest.mark.parametrize("kind", ["winning", "window"])
def test_post_2k_cuda_matches_golden(sealed_2k, kind, monkeypatch):
    """generate_{winning,window}_post on CUDA with a private parameter
    cache: the key setup made == the JAX package's (digest), the proof
    bytes == the JAX package's, and the proof verifies."""
    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path
    from crypto3_fil_proofs_torch.types import PoStConfig, PoStType, PrivateReplicaInfo, PublicReplicaInfo
    from test_torch_setup import arrays_digest

    g, comm_r, sealed, cache, tmp = sealed_2k
    with open(os.path.join(os.path.dirname(__file__), "golden", "torch_post.json")) as f:
        golden = json.load(f)
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp / f"params_{kind}"))
    caches.clear_caches()
    want = golden[kind]
    if kind == "winning":
        config = PoStConfig(g["sector_size"], want["challenge_count"], want["sector_count"], PoStType.WINNING)
        generate, verify = api_post.generate_winning_post, api_post.verify_winning_post
    else:
        config = PoStConfig.window(g["sector_size"])
        generate, verify = api_post.generate_window_post, api_post.verify_window_post
    assert (config.challenge_count, config.sector_count) == (want["challenge_count"], want["sector_count"])
    rnd, pid = bytes.fromhex(golden["randomness"]), bytes.fromhex(g["prover_id"])
    replicas = {g["sector_id"]: PrivateReplicaInfo(replica_path=sealed, comm_r=comm_r, cache_dir=cache)}
    try:
        proof = generate(config, rnd, replicas, pid)
        with np.load(params_path(want["cache_prefix"])) as d:
            assert arrays_digest({k: d[k] for k in d.files}) == want["key_digest"]
        assert proof.hex() == want["proof"]
        assert verify(config, rnd, {g["sector_id"]: PublicReplicaInfo(comm_r=comm_r)}, pid, proof)
    finally:
        caches.clear_caches()


def test_election_post_2k_cuda_matches_golden(sealed_2k, monkeypatch):
    """Election PoSt (2 x 1) of the 2 KiB sector on CUDA with a private
    parameter cache: the candidate, the key setup made (digest), the
    verifying key and the proof bytes under fixed randomness == the
    JAX package's (tests/golden/torch_election_2k.json); it verifies and
    a wrong partial ticket does not."""
    from crypto3_fil_proofs_torch import caches
    from crypto3_fil_proofs_torch.api import post as api_post
    from crypto3_fil_proofs_torch.core.compound import CompoundProof
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path, vk_path
    from crypto3_fil_proofs_torch.models.post.election import circuit as ecirc
    from crypto3_fil_proofs_torch.models.post.election import vanilla as election
    from crypto3_fil_proofs_torch.types import PoStConfig, PoStType, PrivateReplicaInfo
    from test_torch_setup import arrays_digest

    g, comm_r, sealed, cache, tmp = sealed_2k
    with open(os.path.join(os.path.dirname(__file__), "golden", "torch_election_2k.json")) as f:
        want = json.load(f)
    assert comm_r.hex() == want["comm_r"]
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp / "params_election"))
    caches.clear_caches()
    replica = PrivateReplicaInfo(replica_path=sealed, comm_r=comm_r, cache_dir=cache)
    tree = api_post._replica_tree(PoStConfig(want["sector_size"], 1, 1, PoStType.WINNING), replica)
    comm_c, comm_r_last = api_post._load_p_aux(replica)
    rnd, pid = bytes.fromhex(want["randomness"]), bytes.fromhex(want["prover_id"])
    pp = election.ElectionPoSt.setup(
        election.SetupParams(want["sector_size"], want["challenge_count"], want["challenged_nodes"]))
    cand = election.generate_candidate(pp, tree, pid, want["sector_id"], rnd, want["sector_challenge_index"])
    assert (cand.partial_ticket.hex(), cand.ticket.hex()) == (want["partial_ticket"], want["ticket"])
    pub = election.PublicInputs(randomness=rnd, sector_id=want["sector_id"], prover_id=pid, comm_r=comm_r,
                                partial_ticket=cand.partial_ticket,
                                sector_challenge_index=want["sector_challenge_index"])
    vanilla = election.ElectionPoSt.prove(pp, pub, election.PrivateInputs(tree, comm_c, comm_r_last))
    compound = CompoundProof(ecirc.ElectionPoStCompound(shape=(8, 0, 0)))
    try:
        pk = compound.get_params(pp)
        multi = compound.prove(pp, pub, [vanilla], pk, randomness=bytes.fromhex(want["proof_randomness"]))
        assert compound.adapter.cache_prefix(pp) == want["cache_prefix"]
        with np.load(params_path(want["cache_prefix"])) as d:
            assert arrays_digest({k: d[k] for k in d.files}) == want["key_digest"]
        # the JAX package writes its vk file compressed: equal arrays, other bytes
        with np.load(vk_path(want["cache_prefix"])) as d, np.load(io.BytesIO(bytes.fromhex(want["vk_npz"]))) as w:
            assert sorted(d.files) == sorted(w.files)
            assert all(np.array_equal(d[k], w[k]) and d[k].dtype == w[k].dtype for k in d.files)
        assert multi.to_bytes().hex() == want["proof"]
        assert compound.verify(pp, pub, multi, pk.vk)
        wrong = election.PublicInputs(**{**pub.__dict__, "partial_ticket": bytes(32)})
        assert not compound.verify(pp, wrong, multi, pk.vk)
    finally:
        caches.clear_caches()


def test_level_cache_proofs_cuda_match_full_store(dev, tmp_path):
    """A LevelCache tree (rows_to_discard 2) rebuilding its segments on
    CUDA: every proof == the full store's, one K2 launch per rebuilt row."""
    import random

    from crypto3_fil_proofs_torch.core.merkle import (
        StoreConfig,
        compact,
        create_lc_tree,
        create_tree,
        split_config_and_replica,
    )

    leafs = 4096
    leaves = np.random.default_rng(4096).integers(0, 64, size=(leafs, 32), dtype=np.uint8)
    replica = str(tmp_path / "replica")
    leaves.tofile(replica)
    (tmp_path / "full").mkdir()
    (tmp_path / "lc").mkdir()
    full = create_tree(leaves, 8, 0, 0, "poseidon", [StoreConfig(str(tmp_path / "full"), "tree-r-last")], dev)
    cfgs, rep = split_config_and_replica(StoreConfig(str(tmp_path / "lc"), "tree-r-last", rows_to_discard=2),
                                         replica, leafs, 1)
    shutil.copyfile(str(tmp_path / "full" / "sc-02-data-tree-r-last.dat"), cfgs[0].data_path())
    compact(cfgs[0], leafs, 8)
    lc = create_lc_tree(leafs, 8, 0, 0, cfgs, rep, "poseidon", dev)
    rng = random.Random(8)
    challenges = [0, leafs - 1] + [rng.randrange(leafs) for _ in range(8)]
    before = k2.launches[8]
    proofs = [lc.gen_proof(c) for c in challenges]
    assert k2.launches[8] - before == 2 * len(challenges)
    assert proofs == [full.gen_proof(c) for c in challenges]


@pytest.mark.parametrize("k", ["one", "two", "r-1", "random"])
def test_scale_g1_cuda_matches_plain(dev, k):
    """The phase-2 rescaling on K4 dbl / g1_madd and K1 against its plain
    version on the card: 2^16 lanes (points made by setup's fixed-base
    batch, infinity lanes among them) and the edge scalars 1, 2, r - 1;
    a few lanes against host g1_mul."""
    import random

    from crypto3_fil_proofs_torch.ops import fixed_base as fb
    from crypto3_fil_proofs_torch.ops.bls12_381 import R, g1_eq, g1_mul
    from crypto3_fil_proofs_torch.ops.cuda import g1 as k4
    from crypto3_fil_proofs_torch.ops.g1_scale import scale_g1
    from crypto3_fil_proofs_torch.ops.g1_torch import G1

    scalar = {"one": 1, "two": 2, "r-1": R - 1, "random": random.Random(SEED).randrange(R)}[k]
    aff, valid = fb.fixed_base(G1, F.ints_to_limbs32(_elements(F.FR, 1 << 16, SEED + 11)).to(dev))
    assert not bool(valid[0])  # the scalar 0: an infinity lane
    before = dict(k4.launches)
    got = scale_g1(aff[:, 0], aff[:, 1], valid, scalar)
    assert k4.launches["g1_dbl"] - before["g1_dbl"] == scalar.bit_length() - 1
    assert k4.launches["g1_madd"] - before["g1_madd"] == bin(scalar).count("1") - 1
    want = scale_g1(aff[:, 0], aff[:, 1], valid, scalar, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for p, q in zip(fb.host_points(G1, aff[:4], valid[:4]), fb.host_points(G1, got[0][:4], got[1][:4])):
        assert g1_eq(q, g1_mul(p, scalar))


def test_paramcache_only_post_2k_window_key_matches_golden(dev, tmp_path, monkeypatch):
    """paramcache --only-post for 2 KiB on CUDA into a fresh cache: the
    registered Window key (10 x 2) == the JAX package's (digest of
    tests/golden/torch_post.json); the Winning key (66 x 1) is made."""
    from crypto3_fil_proofs_torch.cli import paramcache
    from crypto3_fil_proofs_torch.core.parameter_cache import params_path, vk_path
    from test_torch_setup import arrays_digest

    with open(os.path.join(os.path.dirname(__file__), "golden", "torch_post.json")) as f:
        want = json.load(f)["window"]
    monkeypatch.setenv("FIL_PROOFS_PARAMETER_CACHE", str(tmp_path / "params"))
    assert paramcache.main(["--params-for-sector-sizes", "2048", "--only-post"]) == 0
    with np.load(params_path(want["cache_prefix"])) as d:
        assert arrays_digest({k: d[k] for k in d.files}) == want["key_digest"]
    names = sorted(os.listdir(tmp_path / "params"))
    assert len([n for n in names if n.endswith(".params")]) == 2 and os.path.exists(vk_path(want["cache_prefix"]))


@pytest.mark.parametrize("log_n,batch", [(5, 3), (11, 128), (12, 64)])
def test_k3_batched_pass_matches_plain(dev, log_n, batch):
    """A batch of rows of at most 2^12 goes to K3b (csrc/ntt_rows.cu): one
    launch of it for the batch and none of K3's passes; every row of
    [batch, 2^log_n, 8] == the plain transform of that row (every 97th
    row and the last), forward and inverse. Then the edge shapes, every
    row: a batch of 1, rows of 2^1, odd stage counts (2^3, 2^5), one row
    of 2^12 at the shared-memory limit; more rows of 2^10 than the card
    holds blocks at once (every 97th row and the last); and rows of 2^13,
    longer than K3b takes, through K3's batched pass kernel: one launch a
    pass and none of K3b."""
    from crypto3_fil_proofs_torch.ops import ntt as N
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    def check(lg, b, rows, seed):
        x = _fr(b << lg, seed).reshape(b, 1 << lg, 8)
        want = (1, 0) if lg <= k3.ROWS_MAX_LOG_N else (0, len(k3.plan(lg, b, dev)))
        for inverse in (False, True):
            before = dict(k3.launches)
            got = k3.transform(x.to(dev), lg, inverse).cpu()
            assert (k3.launches["ntt_rows"] - before["ntt_rows"], k3.launches["ntt"] - before["ntt"]) == want
            for r in rows:
                assert torch.equal(got[r], N.transform_plain(x[r], lg, inverse))

    check(log_n, batch, list(range(0, batch, 97)) + [batch - 1], SEED + batch)
    for lg, b in ((1, 1), (1, 4), (3, 2), (5, 1), (12, 1), (13, 3)):
        check(lg, b, range(b), SEED + 7 * lg + b)
    check(10, 1100, list(range(0, 1100, 97)) + [1099], SEED + 10)


def test_eight_shard_mesh_on_one_card(dev):
    """An 8-shard mesh on the card (shards share it when there is one):
    the sharded NTT, tree and G1 / G2 MSMs == the single-device functions;
    the golden shapes == the frozen JAX golden (tests/golden/torch_sharded.json)."""
    import random
    import sys

    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.bls12_381 import R, g1_eq, g1_to_compressed, g2_eq
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
    from crypto3_fil_proofs_torch.ops.g1_torch import G1
    from crypto3_fil_proofs_torch.ops.g2_torch import G2
    from crypto3_fil_proofs_torch.parallel import sharded as S

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_sharded_ref as ref

    with open(ref.GOLDEN) as f:
        golden = json.load(f)
    mesh = S.make_mesh(8)
    assert mesh.shards == 8 and mesh.cards == min(8, torch.cuda.device_count())
    inp = ref.inputs()
    roots, top = S.build_tree_sharded(F.ints_to_limbs32(inp["leaves"]).to(dev), 8, mesh)
    hexes = [v.to_bytes(32, "little").hex() for v in F.limbs32_to_ints(roots.cpu())]
    assert hexes == golden["tree"]["sub_roots"]
    assert F.limbs32_to_ints(top.cpu()[None])[0].to_bytes(32, "little").hex() == golden["tree"]["top"]
    a = F.ints_to_limbs32(inp["ntt"]).to(dev)
    fwd = S.ntt_sharded(a, ref.NTT_LOG_N, mesh)
    assert ref.digest_values(F.limbs32_to_ints(fwd.cpu())) == golden["ntt"]["forward"]
    assert torch.equal(fwd, k3.ntt(a, ref.NTT_LOG_N))
    assert torch.equal(S.ntt_sharded(fwd, ref.NTT_LOG_N, mesh, inverse=True), a)
    aff, _ = G1.points_to_device(inp["points"])
    sc = F.ints_to_limbs32(inp["scalars"])
    got = S.msm_sharded(aff.to(dev), sc.to(dev), mesh, n_buckets=ref.MSM_BUCKETS)
    assert g1_to_compressed(got).hex() == golden["msm"]["result"]
    rng = random.Random(SEED)
    aff2, _ = G2.points_to_device(M.random_walk_bases(G2, 64, 5)[0])
    sc2 = F.ints_to_limbs32([rng.randrange(R) for _ in range(64)])
    got2 = S.msm_sharded(aff2.to(dev), sc2.to(dev), mesh, n_buckets=1 << 8, curve="g2")
    assert g2_eq(got2, M.msm(G2, aff2.to(dev), sc2.to(dev)))
    x = _fr(1 << 16, SEED + 16).to(dev)
    assert torch.equal(S.ntt_sharded(x, 16, mesh), k3.ntt(x, 16))
    pts = _fr(8 ** 5, SEED + 5).to(dev)
    roots, _ = S.build_tree_sharded(pts, 8, mesh)
    assert torch.equal(roots, torch.stack([_root(b) for b in pts.split(8 ** 4)]))
    assert g1_eq(S.msm_sharded(aff.to(dev), sc.to(dev), mesh, n_buckets=1 << 8), M.msm(G1, aff.to(dev), sc.to(dev)))


def _root(block):
    from crypto3_fil_proofs_torch.ops.poseidon_torch import hash_level

    while block.shape[0] > 1:
        block = hash_level(block, 8)
    return block[0]
