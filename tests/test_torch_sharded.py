"""The port's multi-device layer (crypto3_fil_proofs_torch/parallel/
sharded.py, groth16.prove_many) on the CPU, where every shard of a mesh
is `cpu` and the kernels' plain versions run.

- The frozen JAX golden (tests/golden/torch_sharded.json, written by
  tests/torch_sharded_ref.py from the JAX package's own functions on an
  8-device virtual CPU mesh): build_tree_sharded (512 leaves, arity 8),
  ntt_sharded (2^12, forward and inverse) and G1 msm_sharded (32
  points, n_buckets = 16) on an 8-shard CPU mesh equal it exactly. No
  test calls a JAX sharded function.
- Shard counts 1, 2 and 8: each sharded function equals the port's
  single-device function (K3 ntt / intt, the tree's levels, G1 and G2
  msm as group elements).
- The batched K3 pass equals the plain transform row by row.
- prove_many of two cubic circuits on a 2-shard mesh equals the serial
  per-partition prove and the JAX package's prove_many byte for byte;
  the JAX bytes come from `shared_jax_cubic`, once per run. Over two
  stand-in cards, each partition is made and proved with its card
  current.

The tolerance is exact equality throughout.
"""
import json
import os
import random
import threading
from contextlib import contextmanager

import pytest
import torch

import torch_sharded_ref as ref
from crypto3_fil_proofs_torch.core.merkle.tree import MerkleTree
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import msm as M
from crypto3_fil_proofs_torch.ops import ntt as N
from crypto3_fil_proofs_torch.ops.bls12_381 import R, g1_eq, g1_to_compressed, g2_eq
from crypto3_fil_proofs_torch.ops.cuda import build
from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
from crypto3_fil_proofs_torch.ops.g1_torch import G1
from crypto3_fil_proofs_torch.ops.g2_torch import G2
from crypto3_fil_proofs_torch.ops.poseidon import poseidon_hash
from crypto3_fil_proofs_torch.ops.poseidon_torch import hash_level, mont_to_bytes
from crypto3_fil_proofs_torch.parallel import sharded as S
from crypto3_fil_proofs_torch.zk import groth16
from test_torch_groth16 import shared_jax_cubic
from torch_jax_ref import MANY_RANDOMNESS, MANY_X, port_cubic_cs

torch.set_num_threads(1)

with open(ref.GOLDEN) as _f:
    GOLDEN = json.load(_f)


@pytest.fixture(scope="module")
def inputs():
    inp = ref.inputs()
    aff, _ = G1.points_to_device(inp["points"])
    return {"leaves": F.ints_to_limbs32(inp["leaves"]), "ntt": F.ints_to_limbs32(inp["ntt"]),
            "points": aff, "scalars": F.ints_to_limbs32(inp["scalars"])}


def _hex(t: torch.Tensor) -> list[str]:
    return [v.to_bytes(32, "little").hex() for v in F.limbs32_to_ints(t.reshape(-1, 8))]


def cpu_mesh(shards: int) -> S.Mesh:
    return S.make_mesh(shards, device="cpu")


# ---------------------------------------------------------------------------
# The frozen JAX golden, on 8 shards
# ---------------------------------------------------------------------------


def test_tree_equals_jax_golden(inputs):
    roots, top = S.build_tree_sharded(inputs["leaves"], ref.TREE_ARITY, cpu_mesh(ref.SHARDS))
    assert _hex(roots) == GOLDEN["tree"]["sub_roots"]
    assert _hex(top) == [GOLDEN["tree"]["top"]]


def test_ntt_equals_jax_golden(inputs):
    mesh = cpu_mesh(ref.SHARDS)
    fwd = S.ntt_sharded(inputs["ntt"], ref.NTT_LOG_N, mesh)
    assert ref.digest_values(F.limbs32_to_ints(fwd)) == GOLDEN["ntt"]["forward"]
    back = S.ntt_sharded(fwd, ref.NTT_LOG_N, mesh, inverse=True)
    assert ref.digest_values(F.limbs32_to_ints(back)) == GOLDEN["ntt"]["inverse"]
    assert torch.equal(back, inputs["ntt"])


def test_g1_msm_equals_jax_golden_and_msm(inputs):
    """8 shards: the JAX golden, and the single-device msm."""
    got = S.msm_sharded(inputs["points"], inputs["scalars"], cpu_mesh(ref.SHARDS), n_buckets=ref.MSM_BUCKETS)
    assert g1_to_compressed(got).hex() == GOLDEN["msm"]["result"]
    assert g1_eq(got, M.msm(G1, inputs["points"], inputs["scalars"]))


# ---------------------------------------------------------------------------
# Shard counts against the single-device functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_tree_equals_single_device_levels(inputs, shards):
    """8 leaves a shard. With 1 and 8 shards the sub-roots are the nodes
    of the single-device arity-8 tree's level of that many nodes; with 2,
    each is its block hashed on one device. top is the host Poseidon's
    arity-2 fold of the sub-roots."""
    leaves = inputs["leaves"][: 8 * shards]
    roots, top = S.build_tree_sharded(leaves, 8, cpu_mesh(shards))
    if shards == 2:
        want = [bytes(b) for blk in leaves.split(8) for b in mont_to_bytes(hash_level(blk, 8)).numpy()]
    else:
        tree = MerkleTree.build(leaves, 8, "poseidon", device="cpu")
        off = tree.offsets[-1] if shards == 1 else tree.offsets[-2]
        want = [tree.read_at(off + i) for i in range(shards)]
    got = [bytes(b) for b in mont_to_bytes(roots).numpy()]
    assert got == want
    fold = [int.from_bytes(b, "little") for b in got]
    while len(fold) > 1:
        fold = [poseidon_hash(fold[i : i + 2], 2) for i in range(0, len(fold), 2)]
    assert bytes(mont_to_bytes(top[None]).numpy()[0]) == fold[0].to_bytes(32, "little")


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_ntt_equals_single_device(shards):
    """log_n = 7: R = 16 rows of C = 8 columns, an uneven split."""
    rng = random.Random(shards)
    x = F.ints_to_limbs32([rng.randrange(R) for _ in range(1 << 7)])
    mesh = cpu_mesh(shards)
    assert torch.equal(S.ntt_sharded(x, 7, mesh), k3.ntt(x, 7))
    assert torch.equal(S.ntt_sharded(x, 7, mesh, inverse=True), k3.intt(x, 7))


@pytest.mark.parametrize("curve,shards", [("g1", 1), ("g1", 2), ("g2", 1), ("g2", 2), ("g2", 8)])
def test_msm_equals_single_device(inputs, curve, shards):
    """G1 on the golden's 32 points (8 shards and full-width scalars: the
    golden test); G2 on 8 points of a random walk. 64-bit scalars, one of
    them 0 and one 1: 16 windows of 4 bits, so each of 8 shards holds 2
    (a plain curve op costs 15-45 ms on the CPU whatever the lanes, and
    the window scaling is c (W - 1) of them)."""
    rng = random.Random(7)
    if curve == "g1":
        cv, aff, eq = G1, inputs["points"], g1_eq
    else:
        cv, eq = G2, g2_eq
        aff, _ = G2.points_to_device(M.random_walk_bases(G2, 8, 5)[0])
    ints = [rng.randrange(1 << 64) for _ in range(aff.shape[0])]
    ints[1], ints[2] = 0, 1
    sc = F.ints_to_limbs32(ints)
    got = S.msm_sharded(aff, sc, cpu_mesh(shards), n_buckets=16, curve=curve)
    assert eq(got, M.msm(cv, aff, sc))


def test_msm_sharded_buckets_merge(inputs):
    """The merged buckets of 2 shards equal those of 1 (as affine points)."""
    pts, sc = inputs["points"][:8], inputs["scalars"][:8]
    one = S.msm_sharded_buckets(pts, sc, cpu_mesh(1), n_buckets=16)
    two = S.msm_sharded_buckets(pts, sc, cpu_mesh(2), n_buckets=16)
    assert one.shape == two.shape == (64, 16, 3, 12)
    a1, v1 = G1.normalize(one.reshape(-1, 3, 12))
    a2, v2 = G1.normalize(two.reshape(-1, 3, 12))
    assert torch.equal(v1, v2) and torch.equal(a1, a2)
    assert not bool(v1.reshape(64, 16)[:, 0].any())  # digit 0 has no bucket


# ---------------------------------------------------------------------------
# The batched pass, the mesh, the counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_pass_equals_rows(inverse):
    rng = random.Random(int(inverse))
    x = F.ints_to_limbs32([rng.randrange(R) for _ in range(3 << 5)]).reshape(3, 32, 8)
    got = k3.transform(x, 5, inverse)
    assert got.shape == x.shape
    for row in range(3):
        assert torch.equal(got[row], N.transform_plain(x[row], 5, inverse))


def test_mesh_on_the_cpu_and_without_cuda(monkeypatch):
    mesh = cpu_mesh(8)
    assert mesh.shards == 8 and mesh.cards == 0 and mesh.distinct() == [torch.device("cpu")]
    assert not mesh.threads and mesh.map(lambda i, a: (i, a), list("abcdefgh"))[5] == (5, "f")
    assert S.make_mesh(device="cpu").shards == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_mesh(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.prove_many(None, [])


def test_sharded_shapes_are_checked(inputs):
    with pytest.raises(ValueError, match="do not divide"):
        S.ntt_sharded(inputs["ntt"][:64], 6, cpu_mesh(16))
    with pytest.raises(ValueError, match="power of 8"):
        S.build_tree_sharded(inputs["leaves"], 8, cpu_mesh(4))
    with pytest.raises(ValueError, match="n_buckets"):
        S.msm_sharded(inputs["points"], inputs["scalars"], cpu_mesh(2), n_buckets=12)


def test_launch_counters_exact_under_threads():
    counts = {"k": 0}
    threads = [threading.Thread(target=lambda: [build.count(counts, "k") for _ in range(20000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts["k"] == 8 * 20000


# ---------------------------------------------------------------------------
# prove_many
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_jax_cubic(tmp_path_factory)


def test_prove_many_equals_serial_and_jax(jax_ref):
    key = groth16.proving_key_from_jax(jax_ref["arrays"])
    circuits = [port_cubic_cs(x) for x in MANY_X]
    many = groth16.prove_many(key, circuits, randomness=MANY_RANDOMNESS, devices=cpu_mesh(2), device="cpu")
    serial = [groth16.prove(key, cs, randomness=MANY_RANDOMNESS + bytes([k]), device="cpu")
              for k, cs in enumerate(circuits)]
    assert [p.to_bytes() for p in many] == [p.to_bytes() for p in serial] == jax_ref["many"]
    assert len(set(jax_ref["many"])) == len(MANY_X)


class _Cards:
    """Stand-ins for two cards on the CPU: `on_device` makes its device
    the calling thread's current one for the block, as
    `torch.cuda.device` does, and `current()` reads it."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(S, "on_device", self.on_device)
        monkeypatch.setattr(S, "caller_streams", lambda devices: {})
        self.local = threading.local()

    @contextmanager
    def on_device(self, device, stream=None, after=None):
        before = self.current()
        self.local.device = torch.device(device)
        try:
            yield
        finally:
            self.local.device = before

    def current(self):
        return getattr(self.local, "device", torch.device("cuda", 0))


def test_prove_many_names_the_card_and_streams_on_one(monkeypatch):
    """A named card is the one used, and a bare "cuda" means every card;
    on one device each partition is made just before its proof, so one
    is held at a time, on the device that proves it and with that device
    current."""
    cards = _Cards(monkeypatch)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert groth16.partition_devices(device="cuda") == cuda
    assert groth16.partition_devices(device="cuda:1") == cuda[1:]
    assert groth16.partition_devices(S.Mesh(["cuda:1", "cuda:0"])) == cuda[::-1]
    assert groth16.partition_devices(device="cpu") == [torch.device("cpu")]

    class Key:
        def to(self, device):
            events.append(("key to", device))
            return self

    def prove(pk, cs, randomness, device):
        events.append(("prove", cs, randomness[-1], device, cards.current()))
        return cs

    def make(k, device):
        events.append(("make", k, device, cards.current()))
        return k

    events = []
    monkeypatch.setattr(groth16, "prove", prove)
    got = groth16.prove_many(Key(), [lambda d, k=k: make(k, d) for k in range(3)], randomness=b"r",
                             device="cuda:1")
    assert got == [0, 1, 2]
    assert events == [("key to", cuda[1])] + [
        e for k in range(3) for e in (("make", k, cuda[1], cuda[1]), ("prove", k, k, cuda[1], cuda[1]))]


def test_prove_many_replays_each_partition_on_its_card(monkeypatch):
    """Over every card, partition k's circuit (its witness replay) is
    made in the calling thread with devices[k mod D] current, and proved
    on that card with it current."""
    cards = _Cards(monkeypatch)
    cuda = [torch.device("cuda", i) for i in range(2)]

    class Key:
        def to(self, device):
            return self

    made, proved = {}, {}

    def make(k, device):
        made[k] = (device, cards.current(), threading.current_thread() is threading.main_thread())
        return k

    def prove(pk, cs, randomness, device):
        proved[cs] = (device, cards.current(), randomness[-1])
        return cs

    monkeypatch.setattr(groth16, "prove", prove)
    got = groth16.prove_many(Key(), [lambda d, k=k: make(k, d) for k in range(4)], randomness=b"r",
                             device="cuda")
    assert got == [0, 1, 2, 3]
    assert made == {k: (cuda[k % 2], cuda[k % 2], True) for k in range(4)}
    assert proved == {k: (cuda[k % 2], cuda[k % 2], k) for k in range(4)}
