"""The port's field layer (crypto3_fil_proofs_torch.ops.field, the plain
version of kernel K1) against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; all
of this is integer arithmetic, so the tolerance is exact equality.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto3_fil_proofs_tpu.ops.fr_limbs import FQ as JFQ
from crypto3_fil_proofs_tpu.ops.fr_limbs import FR as JFR
from crypto3_fil_proofs_tpu.ops.fr_limbs import fq_ops, fr_ops
from crypto3_fil_proofs_tpu.ops.pallas.field import (
    fq_montmul_soa,
    fr_montmul_soa,
    pack_to_soa,
    soa_to_packed,
)
from crypto3_fil_proofs_torch.ops import field as F
from crypto3_fil_proofs_torch.ops.cuda import field as k1

torch.set_num_threads(1)

FIELDS = {
    "fr": (F.FR, JFR, fr_ops, fr_montmul_soa),
    "fq": (F.FQ, JFQ, fq_ops, fq_montmul_soa),
}


def _elements(field, n, seed):
    """n canonical elements (0, 1, p - 1 first) as python ints."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, field.nbytes), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "little") % field.modulus for r in raw]
    vals[:3] = [0, 1, field.modulus - 1]
    return vals


def _pair(name, n, seed):
    field, jfield, _, _ = FIELDS[name]
    a, b = _elements(field, n, seed), _elements(field, n, seed + 1)[::-1]
    return field, jfield, a, b


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_ops_match_jax_limb_ops(name, rng_seed):
    field, jfield, a, b = _pair(name, 64, rng_seed)
    ops = FIELDS[name][2]
    ja, jb = jnp.asarray(jfield.to_limbs(a)), jnp.asarray(jfield.to_limbs(b))
    ta, tb = F.ints_to_limbs32(a, field), F.ints_to_limbs32(b, field)
    a16, b16 = F.to_limbs16(ta), F.to_limbs16(tb)
    cases = {
        "mont_mul": (F.mont_mul(a16, b16, field), ops.mont_mul(ja, jb)),
        "add": (F.add(a16, b16, field), ops.add(ja, jb)),
        "sub": (F.sub(a16, b16, field), ops.sub(ja, jb)),
        "to_mont": (F.to_mont(a16, field), ops.to_mont(ja)),
        "from_mont": (F.from_mont(a16, field), ops.from_mont(ja)),
    }
    for op, (got, want) in cases.items():
        assert np.array_equal(F.to_jax_limbs(F.to_limbs32(got)), np.asarray(want)), op


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_montmul_matches_pallas_interpret(name, rng_seed):
    """K1's plain version against the TPU kernel it replaces, run in
    interpret mode at N=64 as tests/test_pallas_field.py runs it."""
    field, jfield, a, b = _pair(name, 64, rng_seed)
    kern = FIELDS[name][3]
    sa, _ = pack_to_soa(jnp.asarray(jfield.to_limbs(a)))
    sb, _ = pack_to_soa(jnp.asarray(jfield.to_limbs(b)))
    want = np.asarray(soa_to_packed(kern(sa, sb), 64))
    got = k1.montmul(F.ints_to_limbs32(a, field), F.ints_to_limbs32(b, field), field)
    assert np.array_equal(F.to_jax_limbs(got), want)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_wrapper_on_cpu_is_the_plain_version(name, rng_seed):
    """On CPU tensors the K1 wrapper computes a*b*R^-1 mod p exactly,
    for full-size and broadcast b, and converts in and out of
    Montgomery form."""
    field, _, a, b = _pair(name, 32, rng_seed)
    ta, tb = F.ints_to_limbs32(a, field), F.ints_to_limbs32(b, field)
    rinv = pow(field.mont_r, -1, field.modulus)
    assert F.limbs32_to_ints(k1.montmul(ta, tb, field)) == [
        x * y * rinv % field.modulus for x, y in zip(a, b)
    ]
    assert F.limbs32_to_ints(k1.montmul(ta, tb[5], field)) == [
        x * b[5] * rinv % field.modulus for x in a
    ]
    mont = k1.to_mont(ta, field)
    assert F.limbs32_to_ints(mont) == [x * field.mont_r % field.modulus for x in a]
    assert torch.equal(k1.from_mont(mont, field), ta)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_limb_converters_reinterpret_bytes(name, rng_seed):
    field, jfield, a, _ = _pair(name, 16, rng_seed)
    t = F.ints_to_limbs32(a, field)
    jax_limbs = jfield.to_limbs(a)
    assert np.array_equal(F.to_jax_limbs(t), jax_limbs)
    assert torch.equal(F.from_jax_limbs(jax_limbs), t)
    assert torch.equal(F.to_limbs32(F.to_limbs16(t)), t)
    raw = np.frombuffer(b"".join(v.to_bytes(field.nbytes, "little") for v in a), np.uint8)
    as_bytes = torch.from_numpy(raw.reshape(-1, field.nbytes).copy())
    assert torch.equal(F.bytes_to_limbs32(as_bytes), t)
    assert torch.equal(F.limbs32_to_bytes(t), as_bytes)
    assert F.limbs32_to_ints(t) == a


def test_montgomery_constants():
    """The radix is 2^(16 n16) = 2^(32 n32) on every side; n0inv is taken
    mod 2^16 for the plain CIOS and mod 2^32 for the kernels."""
    for field, jfield in ((F.FR, JFR), (F.FQ, JFQ)):
        assert field.mont_r == jfield.mont_r and field.mont_r2 == jfield.mont_r2
        assert field.n0inv16 == int(jfield.n0inv)
        assert (field.n0inv32 * field.modulus + 1) % (1 << 32) == 0
        assert (field.n0inv16 * field.modulus + 1) % (1 << 16) == 0
    assert F.FQ.n0inv32 & 0xFFFF == F.FQ.n0inv16 and F.FQ.n0inv32 != F.FQ.n0inv16


def test_kernel_header_constants():
    """csrc/field.cuh's modulus limbs (with those of 2p, 4p and 8p, and
    the carry limb of each) and -p^-1 mod 2^32 equal the field's, so the
    kernel's constants are checked here, off the card."""
    path = os.path.join(os.path.dirname(F.__file__), "..", "csrc", "field.cuh")
    with open(path) as f:
        src = f.read()
    for field, tag, struct in ((F.FR, "FR_PM", "Fr"), (F.FQ, "FQ_PM", "Fq")):
        n = field.n32
        table = re.search(rf"{tag}\[4\]\[{n + 1}\] = \{{(.*?)\}};", src, re.S).group(1)
        rows = [[int(x.strip().rstrip("u"), 16) for x in r.split(",")] for r in re.findall(r"\{([^}]*)\}", table)]
        assert rows[0][:n] == field.p32
        for m, row in zip((1, 2, 4, 8), rows):
            assert sum(v << (32 * j) for j, v in enumerate(row)) == m * field.modulus
        inv = re.search(rf"struct {struct} \{{.*?INV = (0x[0-9a-f]+)u;", src, re.S).group(1)
        assert int(inv, 16) == field.n0inv32
