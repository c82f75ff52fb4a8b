"""The port's Poseidon (crypto3_fil_proofs_torch.ops.poseidon_torch, the
plain versions of kernels K2 and K7) against the JAX package, bit for bit.
The witness replay (K7's plain version, through zk/gadgets/tiled.py
`poseidon_witness_v` on the CPU) is held against the frozen digests of
the JAX package's XLA replay, tests/golden/torch_witness.json
(tests/torch_witness_ref.py).

The references are the JAX package's host permutation, its committed
goldens (tests/golden/poseidon/arity_*.json) and its staged kernel
constants. The Pallas kernel itself is not run here: in interpret mode
it takes minutes per batch (tests/test_pallas_poseidon.py). Inputs are
made with numpy from a seed; the tolerance is exact equality.
"""
import json
import os

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.ops import poseidon as jpos
from crypto3_fil_proofs_tpu.ops.pallas.poseidon import _staged
from crypto3_fil_proofs_tpu.ops.tree_hash import get_backend as jax_backend
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import poseidon as tpos
from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
from crypto3_fil_proofs_torch.ops.cuda import field as k1
from crypto3_fil_proofs_torch.ops.tree_hash import get_backend

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "poseidon")


def _golden(arity):
    with open(os.path.join(GOLDEN_DIR, f"arity_{arity}.json")) as fh:
        return json.load(fh)


def _elements(n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % F.R for r in raw]


def _nodes(values):
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    return torch.from_numpy(np.frombuffer(raw, np.uint8).reshape(-1, 32).copy())


@pytest.mark.parametrize("arity", [2, 4, 8, 11, 36])
def test_constants_match_golden(arity):
    g = _golden(arity)
    c = tpos.poseidon_constants(arity)
    assert (c.r_f, c.r_p, c.t, hex(c.domain_tag)) == (g["r_f"], g["r_p"], g["t"], g["domain_tag"])
    assert [hex(v) for v in c.round_constants] == g["round_constants"]
    assert [[hex(v) for v in row] for row in c.mds] == g["mds"]


@pytest.mark.parametrize("arity", [2, 8, 11])
def test_staged_constants_match_jax(arity):
    """The port's staging from its own .npz equals the JAX kernel's
    `_staged(arity)` (ops/pallas/poseidon.py:315), limb for limb."""
    mine = PT.staged(arity)
    theirs = PT.from_jax_staged(*_staged(arity))
    assert (mine.arity, mine.r_f, mine.r_p) == (theirs.arity, theirs.r_f, theirs.r_p)
    for name in ("rc", "mds", "sp", "dl", "tag"):
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name
    assert torch.equal(mine.flat(), theirs.flat())


@pytest.mark.parametrize("arity", [2, 4, 8, 11])
def test_plain_permutation_matches_host(arity, rng_seed):
    """Whole states through the plain batched permutation equal the JAX
    host `permutation` and its sparse form `permutation_optimized`."""
    t, batch = arity + 1, 3
    vals = _elements(batch * t, rng_seed + arity)
    mont = k1.to_mont(F.ints_to_limbs32(vals))
    out = PT.permute_plain(F.to_limbs16(mont).reshape(batch, t, 16), PT.staged(arity))
    got = F.limbs32_to_ints(k1.from_mont(F.to_limbs32(out).reshape(-1, 8)))
    consts = jpos.poseidon_constants(arity)
    for b in range(batch):
        state = vals[b * t : (b + 1) * t]
        want = jpos.permutation(state, consts)
        assert got[b * t : (b + 1) * t] == want
        assert jpos.permutation_optimized(state, consts) == want


@pytest.mark.parametrize("arity", [2, 4, 8, 11])
def test_hash_level_matches_golden(arity):
    """One level of three hashes (0..arity-1, all zero, all one) through
    the port's tree backend equals the committed golden digests."""
    g = _golden(arity)["digests"]
    nodes = _nodes(list(range(arity)) + [0] * arity + [1] * arity)
    out = get_backend("poseidon").hash_level(nodes, arity)
    got = [hex(int.from_bytes(out[i].numpy().tobytes(), "little")) for i in range(3)]
    assert got == [g["scalars_0_to_arity_minus_1"], g["all_zero"], g["all_one"]]


def test_tree_levels_match_jax_backend(rng_seed):
    """Every level of an arity-8 tree over 64 leaves (kept in Montgomery
    form between levels) equals the JAX package's host level hashing,
    and the plain K2 equals the host poseidon_hash per digest."""
    leaves = _nodes(_elements(64, rng_seed))
    jb = jax_backend("poseidon")
    want, level = [], leaves.numpy()
    while level.shape[0] > 1:
        level = jb.hash_level(level, 8)
        want.append(level)
    got = list(get_backend("poseidon").tree_levels(leaves, 8))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert get_backend("poseidon").hash_single([bytes(32)] * 2) == jb.hash_single([bytes(32)] * 2)


def test_tree_levels_from_montgomery_leaves(rng_seed):
    """Leaves handed over in Montgomery form (tree_c's column hashes)
    give the same levels as their canonical bytes, and the leaf level the
    store receives is those bytes."""
    leaves = _nodes(_elements(64, rng_seed + 1))
    hb = get_backend("poseidon")
    mont = PT.bytes_to_mont(leaves)
    assert mont.dtype == torch.int32
    assert np.array_equal(hb.leaf_bytes(mont), leaves.numpy())
    assert np.array_equal(hb.leaf_bytes(leaves), leaves.numpy())
    want = list(hb.tree_levels(leaves, 8))
    got = list(hb.tree_levels(mont, 8))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("arity", [2, 8, 11])
def test_witness_replay_matches_golden(arity):
    """The replay of tests/torch_witness_ref.py's seeded batch on the CPU
    (witness_plain) == the JAX package's XLA replay, by SHA-256; the
    digest, the last value, is K2's plain digest."""
    import torch_witness_ref as ref

    from crypto3_fil_proofs_torch.zk.gadgets import tiled

    with open(ref.GOLDEN) as fh:
        want = json.load(fh)["arities"][str(arity)]
    pre = ref.batch(arity)
    got = tiled.poseidon_witness_v(pre, arity, device="cpu")
    assert got.shape == (want["k"], want["n_int"], 16) == (ref.K, PT.witness_len(arity), 16)
    assert ref.digest(got) == want["sha256"]
    mont = k1.to_mont(torch.from_numpy(pre.astype("<u2").view("<i4").reshape(-1, PT.L).copy()))
    digests = k1.from_mont(PT.hash_mont_plain(mont.reshape(ref.K, arity, PT.L), arity))
    assert np.array_equal(got[:, -1], digests.numpy().view("<u2").astype(np.uint64))
