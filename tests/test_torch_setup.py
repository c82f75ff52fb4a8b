"""The port's Groth16 setup on the CPU (device="cpu": the plain versions
of kernels K1, K4 and K5) against the JAX package, bit for bit.

The circuit holds every kind of row the stacked circuit emits: dict rows
(the cubic x^3 + x + 5 == out, out public), a `BulkBlock` (bits
allocated in bulk, packed into a public input by a dict row) and a
`TiledBlock` (a one-constraint template with a full-width coefficient,
y = c x^2 + 7, tiled four times). It is small, so the JAX package's
setup stays on its host path (under HOST_FALLBACK_N). Held equal:

- the key, array for array, in the parameter-cache layout (the JAX
  package's `_save_pk`), and the proof bytes under it;
- a `.params` file written by either package loads in the other;
- the plain fixed-base batch against host g1_mul / g2_mul on 300
  scalars (0, 1 and r - 1 among them), and the K1-path normalisation
  against the plain one;
- the frozen tests/golden/torch_setup_blocks.json (the SHA-256 of the
  key's arrays and the proof bytes) is what the JAX package produces
  now; tests/test_torch_cuda.py holds the port's setup and prove on
  CUDA against it.

The JAX references and the port's key are computed once per pytest run
and shared across xdist workers (`shared_reference`). The JAX package is
imported inside the functions that call it, so test_torch_cuda.py can import this
module's circuit where JAX is not installed. The tolerance is exact
equality throughout.
"""
import fcntl
import hashlib
import importlib
import json
import os
import pickle
import random

import numpy as np
import pytest
import torch

from crypto3_fil_proofs_torch.core import parameter_cache as port_cache
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import fixed_base as fb
from crypto3_fil_proofs_torch.ops.bls12_381 import (
    G1_GEN,
    G2_GEN_X,
    G2_GEN_Y,
    R,
    g1_from_affine,
    g1_mul,
    g2_from_affine,
    g2_mul,
)
from crypto3_fil_proofs_torch.ops.g1_torch import G1
from crypto3_fil_proofs_torch.ops.g2_torch import G2
from crypto3_fil_proofs_torch.zk import groth16

torch.set_num_threads(1)

SEED = b"test-blocks"
RANDOMNESS = b"block-proof"
BIG = (1 << 250) + 12345  # a full-width template coefficient
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "torch_setup_blocks.json")


def arrays_digest(arrays: dict) -> str:
    """SHA-256 of a key's parameter-cache arrays: name, dtype, shape and
    bytes of each, in name order."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def shared_reference(tmp_path_factory, name: str, compute):
    """`compute()` once per pytest run: the first xdist worker pickles
    its result into a directory every worker of the run sees (the parent
    of the workers' base temp directories), the others wait on the lock
    and load it (as tests/test_torch_groth16.py `shared_jax_cubic`).
    `compute` writes its files into a directory of its own process, so a
    worker that died while computing leaves nothing in the next one's
    way."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = shared / f"{name}.pkl"
    with open(shared / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():
            return pickle.loads(path.read_bytes())
        work = shared / f"{name}.{os.getpid()}"
        work.mkdir()
        ref = compute(work)
        part = shared / f"{name}.pkl.part"
        part.write_bytes(pickle.dumps(ref))
        os.replace(part, path)
        return ref


def block_circuit(pkg: str):
    """The test circuit over either package's modules."""
    r1cs = importlib.import_module(f"{pkg}.zk.r1cs")
    num = importlib.import_module(f"{pkg}.zk.gadgets.num")
    boolean = importlib.import_module(f"{pkg}.zk.gadgets.boolean")
    tiled = importlib.import_module(f"{pkg}.zk.gadgets.tiled")

    cs = r1cs.ConstraintSystem()
    x = num.AllocatedNum.alloc(cs, 3)
    x3 = x.square(cs).mul(cs, x)
    out = num.AllocatedNum.alloc_input(cs, (x3.value + x.value + 5) % R)
    cs.enforce(x3.lc() + x.lc() + r1cs.LinearCombination.constant(5), r1cs.lc_one(), out.lc(), "out")
    bits = boolean.alloc_bits_bulk(cs, [(0xB5 >> i) & 1 for i in range(8)])
    packed = num.AllocatedNum.from_bits_le(cs, bits)
    packed.inputize(cs)

    def square_plus(cs_, ext):
        xv = cs_.values[ext[0]]
        y = num.AllocatedNum.alloc(cs_, (BIG * xv * xv + 7) % R)
        cs_.enforce(
            r1cs.LinearCombination({ext[0]: BIG}), r1cs.LinearCombination({ext[0]: 1}),
            y.lc() - 7, "square_plus",
        )

    tpl = tiled.CircuitTemplate(square_plus, 1)
    xs = [num.AllocatedNum.alloc(cs, v) for v in (2, 5, R - 1, 11)]
    ys = [(BIG * n.value * n.value + 7) % R for n in xs]
    tpl.instantiate(cs, np.asarray([[n.var] for n in xs], dtype=np.int64), ys)
    return cs


def _jax_reference(shared) -> dict:
    from crypto3_fil_proofs_tpu.core import parameter_cache as jax_cache
    from crypto3_fil_proofs_tpu.zk import groth16 as jax_groth16

    cs = block_circuit("crypto3_fil_proofs_tpu")
    pk = jax_groth16.setup(cs, seed=SEED)
    path = str(shared / "jax_blocks.params")
    jax_cache._save_pk(path, pk)
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    proof = jax_groth16.prove(pk, cs, randomness=RANDOMNESS).to_bytes()
    return {"arrays": arrays, "proof": proof, "params": path, "kinds": [k for k, _ in cs.row_layout]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return shared_reference(tmp_path_factory, "jax_blocks", _jax_reference)


def _port_key(shared) -> groth16.ProvingKey:
    cs = block_circuit("crypto3_fil_proofs_torch")
    assert cs.which_unsatisfied() is None
    return groth16.setup(cs, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def port_key(tmp_path_factory):
    """The port's key of the test circuit, made once per run
    (`shared_reference`): the plain fixed-base takes tens of seconds."""
    return shared_reference(tmp_path_factory, "port_blocks_key", _port_key)


def _arrays(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_circuit_has_every_row_kind(ref):
    cs = block_circuit("crypto3_fil_proofs_torch")
    kinds = [type(b).__name__ for b in cs.bulk_blocks]
    assert "BulkBlock" in kinds and "TiledBlock" in kinds
    assert [k for k, _ in cs.row_layout] == ref["kinds"]
    assert "d" in ref["kinds"]


def test_setup_equals_jax(ref, port_key, tmp_path):
    """Every array of the parameter-cache layout, dtype and bytes."""
    path = str(tmp_path / "port.params")
    port_cache._save_pk(path, port_key)
    got, want = _arrays(path), ref["arrays"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_proof_bytes_equal_jax(ref, port_key):
    cs = block_circuit("crypto3_fil_proofs_torch")
    proof = groth16.prove(port_key, cs, randomness=RANDOMNESS, device="cpu")
    assert proof.to_bytes() == ref["proof"]
    public = [v for v, i in zip(cs.values, cs.is_input) if i][1:]
    assert groth16.verify(port_key.vk, proof, public)
    assert not groth16.verify(port_key.vk, proof, [public[0], public[1] + 1])


def test_golden_is_what_jax_produces_now(ref):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["key_digest"] == arrays_digest(ref["arrays"])
    assert golden["proof"] == ref["proof"].hex()


def test_key_files_load_in_either_package(ref, port_key, tmp_path):
    """The JAX package's file loads in the port as the port's key; the
    port's file loads in the JAX package as the JAX package's key."""
    from crypto3_fil_proofs_tpu.core import parameter_cache as jax_cache

    mine = port_cache._load_pk(ref["params"])
    assert mine.vk.to_npz_dict().keys() == port_key.vk.to_npz_dict().keys()
    for k, v in port_key.vk.to_npz_dict().items():
        assert np.array_equal(mine.vk.to_npz_dict()[k], v), k
    for q in groth16.QUERIES:
        for a, b in zip(getattr(mine, q), getattr(port_key, q)):
            assert torch.equal(a, b), q
    path = str(tmp_path / "port.params")
    port_cache._save_pk(path, port_key)
    theirs = jax_cache._load_pk(path)
    back = str(tmp_path / "jax_again.params")
    jax_cache._save_pk(back, theirs)
    again, want = _arrays(back), ref["arrays"]
    for k in want:
        assert np.array_equal(again[k], want[k]), k


@pytest.mark.parametrize("curve", [G1, G2], ids=["g1", "g2"])
def test_plain_fixed_base_equals_host_mul(curve):
    rng = random.Random(300)
    scalars = [0, 1, R - 1] + [rng.randrange(R) for _ in range(297)]
    aff, valid = fb.fixed_base(curve, F.ints_to_limbs32(scalars), plain=True)
    if curve is G1:
        g = g1_from_affine(G1_GEN)
        want = curve.points_to_device([g1_mul(g, s) for s in scalars])
    else:
        g = g2_from_affine((G2_GEN_X, G2_GEN_Y))
        want = curve.points_to_device([g2_mul(g, s) for s in scalars])
    assert torch.equal(aff, want[0]) and torch.equal(valid, want[1])
    assert not bool(valid[0]) and bool(valid[1:].all())


@pytest.mark.parametrize("curve", [G1, G2], ids=["g1", "g2"])
def test_k1_normalize_equals_plain(curve):
    """normalize_k1 (the CUDA path's body, here over K1's plain version)
    against Curve.normalize, on accumulators with infinity lanes."""
    rng = random.Random(7)
    scalars = F.ints_to_limbs32([0, 1, R - 1] + [rng.randrange(R) for _ in range(13)])
    acc = fb._run_chunk(curve, fb.window_table(curve, "cpu"), scalars, plain=True)
    got, want = fb.normalize_k1(curve, acc), curve.normalize(acc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["BulkBlock", "TiledBlock"])
def test_which_unsatisfied_finds_a_bad_block_row(kind):
    """A wrong value that only a block's rows read makes the circuit
    unsatisfied, and the check names that block."""
    if kind == "TiledBlock":
        cs = block_circuit("crypto3_fil_proofs_torch")
        bi = [type(b).__name__ for b in cs.bulk_blocks].index(kind)
        var = cs.bulk_blocks[bi].base  # the first instance's y
    else:
        from crypto3_fil_proofs_torch.zk.gadgets.boolean import alloc_bits_bulk
        from crypto3_fil_proofs_torch.zk.r1cs import ConstraintSystem

        cs = ConstraintSystem()
        var = len(cs.values) + 1  # the second bit
        alloc_bits_bulk(cs, [1, 0, 1])
        bi = 0
    assert cs.which_unsatisfied() is None
    cs.values[var] = (cs.values[var] + 2) % R
    assert cs.which_unsatisfied().startswith(f"bulk[{bi}:")


def test_setup_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.setup(block_circuit("crypto3_fil_proofs_torch"), seed=SEED)
