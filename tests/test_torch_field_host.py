"""The carry-chain field layer of the CUDA kernels (csrc/field.cuh) on the
host: the header compiled with g++ and FIELD_HOST_TEST, which emulates
each PTX carry instruction (mad.lo.cc.u32, madc.hi.cc.u32, addc.cc.u32,
...) in C over one carry flag, so the chains' arithmetic is checked
without a card. Every piece against Python integers: the Montgomery
product (CIOS) and the unreduced wide product of Fr and Fq, modular
addition and subtraction, the wide sum of
k products with one REDC and the final reduction (the Poseidon rows of
csrc/poseidon.cu, k up to 12, all operands p - 1 included), and the Fq2
product and square of csrc/curve.cuh.

What it cannot show is that nvcc keeps the carry flag between the asm
statements; the `cuda` tests and chip_smoke.py compare the kernels with
their plain versions on the card. Inputs come from numpy with a seed;
the tolerance is exact equality.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from crypto3_fil_proofs_torch.ops import field as F

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "crypto3_fil_proofs_torch", "csrc")

HARNESS = r"""
#include "field.cuh"
#define EACH for (int i = 0; i < n; i++)
extern "C" {
void fr_mul(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH mont_mul<Fr>(r + 8 * i, a + 8 * i, b + 8 * i); }
void fq_mul(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH mont_mul<Fq>(r + 12 * i, a + 12 * i, b + 12 * i); }
void fr_wide(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH mul_wide<8>(r + 16 * i, a + 8 * i, b + 8 * i); }
void fq_wide(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH mul_wide<12>(r + 24 * i, a + 12 * i, b + 12 * i); }
void fr_add(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH add_mod<Fr>(r + 8 * i, a + 8 * i, b + 8 * i); }
void fr_sub(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH sub_mod<Fr>(r + 8 * i, a + 8 * i, b + 8 * i); }
void fq_add(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH add_mod<Fq>(r + 12 * i, a + 12 * i, b + 12 * i); }
void fq_sub(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) { EACH sub_mod<Fq>(r + 12 * i, a + 12 * i, b + 12 * i); }
// sum_j x_j c_j / R mod p over k pairs per row: the Poseidon row
void fr_dot(const uint32_t* x, const uint32_t* c, int k, uint32_t* r, int n) {
  EACH {
    uint32_t acc[16] = {0}, top = 0, w[16];
    for (int j = 0; j < k; j++) {
      mul_wide<8>(w, x + (i * k + j) * 8, c + (i * k + j) * 8);
      add_wide<8>(acc, top, w);
    }
    reduce<Fr, 3>(r + 8 * i, redc<Fr>(r + 8 * i, acc, top));
  }
}
void fq2_mul_(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  EACH fq2_mul(r + 24 * i, r + 24 * i + 12, a + 24 * i, a + 24 * i + 12, b + 24 * i, b + 24 * i + 12);
}
void fq2_sqr_(const uint32_t* a, uint32_t* r, int n) {
  EACH fq2_sqr(r + 24 * i, r + 24 * i + 12, a + 24 * i, a + 24 * i + 12);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp("field_host")
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DFIELD_HOST_TEST", "-I", CSRC,
                    str(src), "-o", str(so)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _values(field, n, seed):
    """n canonical elements: random, then 0, 1, p - 1 and p - 2."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, field.nbytes), dtype=np.uint8)
    vals = [int.from_bytes(r.tobytes(), "little") % field.modulus for r in raw]
    vals[:4] = [0, 1, field.modulus - 1, field.modulus - 2]
    return vals


def _buf(vals, n32):
    limbs = [(v >> (32 * j)) & 0xFFFFFFFF for v in vals for j in range(n32)]
    return (ctypes.c_uint32 * max(1, len(limbs)))(*limbs)


def _ints(buf, n32):
    return [sum(int(buf[i * n32 + j]) << (32 * j) for j in range(n32)) for i in range(len(buf) // n32)]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_mul_wide_add_sub(lib, name, rng_seed):
    field = F.FR if name == "fr" else F.FQ
    p, n32, n = field.modulus, field.n32, 256
    a = _values(field, n, rng_seed)
    b = _values(field, n, rng_seed + 1)[::-1]
    b[4:8] = [0, 1, p - 1, a[7]]
    r_inv = pow(1 << (32 * n32), -1, p)
    want = {
        "mul": [x * y * r_inv % p for x, y in zip(a, b)],
        "add": [(x + y) % p for x, y in zip(a, b)],
        "sub": [(x - y) % p for x, y in zip(a, b)],
    }
    for op, exp in want.items():
        out = (ctypes.c_uint32 * (n * n32))()
        getattr(lib, f"{name}_{op}")(_buf(a, n32), _buf(b, n32), out, n)
        assert _ints(out, n32) == exp, op
    out = (ctypes.c_uint32 * (n * 2 * n32))()
    getattr(lib, f"{name}_wide")(_buf(a, n32), _buf(b, n32), out, n)
    assert _ints(out, 2 * n32) == [x * y for x, y in zip(a, b)]


@pytest.mark.parametrize("k", [1, 3, 9, 12])
def test_wide_sum_one_redc(lib, k, rng_seed):
    p, n = F.FR.modulus, 64
    x = _values(F.FR, n * k, rng_seed + k)
    c = _values(F.FR, n * k, rng_seed + 100 + k)[::-1]
    x[:k] = [p - 1] * k  # the largest sum of k products
    c[:k] = [p - 1] * k
    out = (ctypes.c_uint32 * (n * 8))()
    lib.fr_dot(_buf(x, 8), _buf(c, 8), k, out, n)
    r_inv = pow(1 << 256, -1, p)
    want = [sum(x[i * k + j] * c[i * k + j] for j in range(k)) * r_inv % p for i in range(n)]
    assert _ints(out, 8) == want


def test_fq2_mul_and_sqr(lib, rng_seed):
    p, n = F.FQ.modulus, 128
    a = _values(F.FQ, 2 * n, rng_seed)
    b = _values(F.FQ, 2 * n, rng_seed + 1)[::-1]
    a[4:8] = [p - 1, p - 1, 0, p - 1]  # c0 negative before the fix-up, a0 - a1 < 0
    b[4:8] = [p - 1, 0, p - 1, p - 1]
    r_inv = pow(1 << 384, -1, p)
    out = (ctypes.c_uint32 * (2 * n * 12))()
    lib.fq2_mul_(_buf(a, 12), _buf(b, 12), out, n)
    want = []
    for i in range(n):
        a0, a1, b0, b1 = a[2 * i], a[2 * i + 1], b[2 * i], b[2 * i + 1]
        want += [(a0 * b0 - a1 * b1) * r_inv % p, (a0 * b1 + a1 * b0) * r_inv % p]
    assert _ints(out, 12) == want
    lib.fq2_sqr_(_buf(a, 12), out, n)
    want = []
    for i in range(n):
        a0, a1 = a[2 * i], a[2 * i + 1]
        want += [(a0 * a0 - a1 * a1) * r_inv % p, 2 * a0 * a1 * r_inv % p]
    assert _ints(out, 12) == want
