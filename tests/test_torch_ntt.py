"""The port's NTT (crypto3_fil_proofs_torch.ops.ntt, the plain version of
kernel K3, and the wrapper of ops/cuda/ntt.py on CPU tensors) against
the JAX package: `ntt_host` at log_n 1-8 and `_compute_h` on the cubic
circuit. Inputs are made with numpy from a seed; the tolerance is exact
equality.
"""
import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.ops.bls12_381 import FR_MULT_GEN, R
from crypto3_fil_proofs_tpu.ops.ntt import ntt_host as jax_ntt_host
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops import ntt as N
from crypto3_fil_proofs_torch.ops.cuda import ntt as k3
from crypto3_fil_proofs_torch.zk import groth16
from test_torch_groth16 import shared_jax_cubic
from torch_jax_ref import port_cubic_cs

torch.set_num_threads(1)

R_INV = pow(F.FR.mont_r, -1, R)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "little") % R for r in raw]
    vals[0] = R - 1
    return vals


def _mont(vals):
    return F.ints_to_limbs32([v * F.FR.mont_r % R for v in vals])


def _ints(t):
    return [v * R_INV % R for v in F.limbs32_to_ints(t)]


@pytest.mark.parametrize("log_n", range(1, 9))
def test_plain_transforms_match_jax_ntt_host(log_n, rng_seed):
    n = 1 << log_n
    v = _values(n, rng_seed + log_n)
    x = _mont(v)
    coset = [a * pow(FR_MULT_GEN, i, R) % R for i, a in enumerate(v)]
    assert _ints(N.ntt(x, log_n)) == jax_ntt_host(v)
    assert _ints(N.intt(x, log_n)) == jax_ntt_host(v, inverse=True)
    assert _ints(N.coset_ntt(x, log_n)) == jax_ntt_host(coset)
    # coset_intt inverts coset_ntt
    assert _ints(N.coset_intt(N.coset_ntt(x, log_n), log_n)) == v
    # the wrappers take the plain path for CPU tensors
    assert torch.equal(k3.coset_ntt(x, log_n), N.coset_ntt(x, log_n))
    assert torch.equal(k3.intt(x, log_n), N.intt(x, log_n))
    # the port's host reference is the JAX package's
    assert N.ntt_host(v) == jax_ntt_host(v)


@pytest.mark.parametrize("log_n", [1, 9, 10, 11, 19, 20, 28])
def test_passes_cover_every_stage_within_shared_memory(log_n):
    """The passes cover the stages in order; a tile (2^log_c columns of a
    pass's 2^cnt elements) fits K3's 2^TILE_LOG elements, and its columns
    exist: the first pass's groups, a later pass's 2^s0 low indices. Above
    one tile every tile is full and holds at least 2^MIN_COLS_LOG columns
    (runs of 128 bytes)."""
    passes = k3.passes(log_n)
    assert passes[0][0] == 0
    assert sum(cnt for _, cnt, _ in passes) == log_n
    assert all(s0 == p0 + c0 for (p0, c0, _), (s0, _, _) in zip(passes, passes[1:]))
    assert all(1 <= cnt and 0 <= log_c and cnt + log_c <= k3.TILE_LOG for _, cnt, log_c in passes)
    assert all(log_c <= log_n - cnt and log_c <= (s0 or log_n) for s0, cnt, log_c in passes)
    if log_n > k3.TILE_LOG:
        assert all(cnt + log_c == k3.TILE_LOG and log_c >= k3.MIN_COLS_LOG for _, cnt, log_c in passes)
    else:
        assert passes == [(0, log_n, 0)]


def test_h_pipeline_matches_coset_chain(rng_seed):
    """h_from_evals (scales folded into two vectors) equals the plain
    intt / coset_ntt / coset_intt chain on random evaluations."""
    log_n = 5
    a, b, c = (_mont(_values(1 << log_n, rng_seed + k)) for k in range(3))
    cos = [N.coset_ntt(N.intt(v, log_n), log_n) for v in (a, b, c)]
    num = F.sub32(F.mont_mul32(cos[0], cos[1]), cos[2])
    z_inv = pow((pow(FR_MULT_GEN, 1 << log_n, R) - 1) % R, R - 2, R)
    want = N.coset_intt(F.mont_mul32(num, _mont([z_inv])[0]), log_n)
    assert torch.equal(k3.h_from_evals(a, b, c, log_n), want)


def test_compute_h_matches_jax_on_cubic(tmp_path_factory):
    ref = shared_jax_cubic(tmp_path_factory)
    n_in, n_aux, rows, inputs, aux = port_cubic_cs().finalize()
    h = groth16.compute_h((n_in, n_aux, rows, inputs, aux), inputs + aux, ref["pk"].log_n, "cpu")
    assert h == ref["h"]
    assert len(h) == (1 << ref["pk"].log_n) - 1
