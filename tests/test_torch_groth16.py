"""The port's Groth16 prover on the CPU (device="cpu": the plain versions
of kernels K1, K3-K6) against the JAX package on the cubic circuit of
tests/test_groth16.py, with the key of JAX `setup(cubic(3),
seed=b"test-cubic")` carried over by `proving_key_from_jax`.

Proof bytes must equal the JAX package's for randomness b"fixed" and
b"other"; both verifiers accept them and reject a wrong public input;
the frozen tests/golden/torch_groth16_cubic.npz, which the GPU smoke run
(chip_smoke.py) checks the CUDA path against, must still be what the JAX
package produces. The tolerance is exact equality throughout.
"""
import fcntl
import os
import pickle

import numpy as np
import pytest
import torch

import torch_jax_ref
from crypto3_fil_proofs_tpu.zk import groth16 as jax_groth16
from crypto3_fil_proofs_torch.zk import groth16
from torch_jax_ref import GOLDEN, RANDOMNESS, golden_arrays, jax_cubic, port_cubic_cs

torch.set_num_threads(1)


def shared_jax_cubic(tmp_path_factory) -> dict:
    """`jax_cubic()` once per pytest run. Its XLA compile takes about 20 s
    on an idle CPU and a minute on a loaded one, and under pytest-xdist
    the tests that need it land on several workers. The first worker
    computes it and pickles it into a directory that every worker of the
    run sees (the parent of the workers' base temp directories, made anew
    for each run); the others wait on its lock and load it."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = shared / "jax_cubic.pkl"
    with open(shared / "jax_cubic.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():
            return pickle.loads(path.read_bytes())
        ref = jax_cubic()
        part = shared / "jax_cubic.pkl.part"
        part.write_bytes(pickle.dumps(ref))
        os.replace(part, path)
        return ref


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return shared_jax_cubic(tmp_path_factory)


@pytest.fixture(scope="module")
def port_key(ref):
    return groth16.proving_key_from_jax(ref["arrays"])


@pytest.mark.parametrize("randomness", RANDOMNESS)
def test_cpu_proof_bytes_equal_jax(port_key, ref, randomness):
    proof = groth16.prove(port_key, port_cubic_cs(), randomness=randomness, device="cpu")
    data = proof.to_bytes()
    assert data == ref["proofs"][randomness]
    public = ref["public"]
    assert groth16.verify(port_key.vk, groth16.Proof.from_bytes(data), public)
    assert not groth16.verify(port_key.vk, proof, [(public[0] + 1) % groth16.R])
    jax_proof = jax_groth16.Proof.from_bytes(data)
    assert jax_groth16.verify(ref["pk"].vk, jax_proof, public)
    assert not jax_groth16.verify(ref["pk"].vk, jax_proof, [public[0] + 1])


def test_golden_is_what_jax_produces_now(ref, monkeypatch):
    monkeypatch.setattr(torch_jax_ref, "jax_cubic", lambda: ref)
    want = golden_arrays()
    with np.load(GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k


def test_key_save_load_roundtrip(port_key, tmp_path):
    path = str(tmp_path / "key.npz")
    port_key.save(path)
    back = groth16.ProvingKey.load(path)
    assert back.vk == port_key.vk and back.log_n == port_key.log_n
    assert (back.beta_g1, back.delta_g1) == (port_key.beta_g1, port_key.delta_g1)
    for q in groth16.QUERIES:
        for a, b in zip(getattr(back, q), getattr(port_key, q)):
            assert torch.equal(a, b), q


def test_default_device_raises_without_cuda(monkeypatch, port_key):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = port_cubic_cs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.prove(port_key, cs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.prove_from_assignment(port_key, [1], [3], [0] * 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.h_from_evals([0] * 8, [0] * 8, [0] * 8, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        groth16.compute_h(cs.finalize(), cs.values, 3)
