"""The carry-chain field layer of the CUDA kernels (csrc/field.cuh) on the
host: the header compiled with g++ and FIELD_HOST_TEST, which emulates
each PTX carry instruction (mad.lo.cc.u32, madc.hi.cc.u32, addc.cc.u32,
...) in C over one carry flag, so the chains' arithmetic is checked
without a card. Every piece against Python integers: the Montgomery
product (CIOS) and the unreduced wide product of Fr and Fq, modular
addition and subtraction, the wide sum of
k products with one REDC and the final reduction (the Poseidon rows of
csrc/poseidon.cu, k up to 12, all operands p - 1 included), the Fq2
product and square of csrc/curve.cuh, and their halves for a pair of
threads (fq2_mul_half, fq2_sqr_half).

The G2 point operations of kernel K5 in their pair layout
(csrc/curve_pair.cuh) run here too: the two threads of a pair are two
host threads that exchange coefficients through a slot where the card
shuffles them, and the results are held against the plain versions of
ops/g2_torch.py on a batch of every edge case.

The Poseidon permutation of kernels K2 and K7 (csrc/poseidon.cuh: the
sparse schedule, K2's x^5 and K7's recording S-box) runs here one
instance at a time, each with a row slice of its own, and K7's lane
groups (csrc/poseidon_group.cuh) on the 32 lanes of an emulated warp,
against the plain versions of ops/poseidon_torch.py at arities 2, 8 and
11, 0 and r - 1 among the inputs, K7's values in the caller's
[n, n_int, 8] layout.

K3b's block (csrc/ntt_rows.cuh: a batch's rows transformed whole in
shared memory, radix-8 trips of three stages with one radix-4 or
radix-2 trip for the stages left over, the bit reversal in the first)
runs here on an emulated block: its threads are fibers that meet at each
__syncthreads() and, a warp at a time, at each __syncwarp(), and its
bulk copies are memcpy; at log_n 1..12, forward and inverse, against
ops/ntt.py's `ntt_host`.

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
// the pair halves: coefficient k of row i computed as thread k of a pair
void fq2_mul_halves(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  EACH for (uint32_t k = 0; k < 2; k++) {
    const uint32_t *s = a + 24 * i + 12 * k, *o = a + 24 * i + 12 * (1 - k);
    fq2_mul_half(r + 24 * i + 12 * k, k, s, b + 24 * i + 12 * k, o, b + 24 * i + 12 * (1 - k));
  }
}
void fq2_sqr_halves(const uint32_t* a, uint32_t* r, int n) {
  EACH for (uint32_t k = 0; k < 2; k++)
    fq2_sqr_half(r + 24 * i + 12 * k, k, a + 24 * i + 12 * k, a + 24 * i + 12 * (1 - k));
}
}

// K3b's block (csrc/ntt_rows.cuh): its threads are fibers of one host
// thread (ucontext). A fiber runs until it reaches __syncthreads() or
// __syncwarp(); then the lowest-numbered fiber that may go on runs: one
// whose block (or warp) has all reached that barrier. So a warp whose
// lanes have met goes on before the next warp has read anything, and one
// thread finishes a trip before the next starts it: a trip that touched
// another warp's or thread's elements without a barrier fails. A fiber
// left with no fiber that may go on (lanes at different barriers) fails
// the run.
#include <cstdlib>
#include <cstring>
#include <ucontext.h>
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, blockDim, threadIdx;
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; i++) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <int N>
inline void load_const(uint32_t r[N], const uint32_t* p) { for (int k = 0; k < N; k++) r[k] = p[k]; }
static const int FIBERS = 512, MEETS = 64;
static ucontext_t block_ctx, fiber_ctx[FIBERS];
static int fibers, running, waits[FIBERS];  // waits: 0 none, 1 the block's barrier, 2 the warp's
static int block_meets[FIBERS], warp_meets[FIBERS];
// fibers of the block (of each warp) that have reached its k-th barrier
static int block_arrived[MEETS], warp_arrived[FIBERS / 32][MEETS];
static bool fiber_done[FIBERS], stuck;
static bool may_go(int f) {
  if (fiber_done[f]) return false;
  if (waits[f] == 1) return block_arrived[block_meets[f]] == fibers;
  const int lanes = fibers - (f & ~31) < 32 ? fibers - (f & ~31) : 32;
  return waits[f] == 0 || warp_arrived[f / 32][warp_meets[f]] == lanes;
}
static int next_fiber() {
  for (int f = 0; f < fibers; f++)
    if (may_go(f)) return f;
  return -1;
}
static void switch_from(int me) {
  const int f = next_fiber();
  if (f == me) {
    waits[me] = 0;
    return;
  }
  if (f < 0) {
    stuck = true;
    swapcontext(&fiber_ctx[me], &block_ctx);  // the run ends here
  }
  waits[f] = 0;
  running = f;
  threadIdx.x = f;
  swapcontext(&fiber_ctx[me], &fiber_ctx[f]);
}
static void count_meet(int* meets, int* arrived) {
  if (meets[running] + 1 >= MEETS) {  // more barriers than the kernel has
    stuck = true;
    swapcontext(&fiber_ctx[running], &block_ctx);
  }
  arrived[++meets[running]]++;
}
void __syncthreads() {
  count_meet(block_meets, block_arrived);
  waits[running] = 1;
  switch_from(running);
}
void __syncwarp() {
  count_meet(warp_meets, warp_arrived[running / 32]);
  waits[running] = 2;
  switch_from(running);
}
#include "ntt_pass.cuh"
// the block the fibers run: K3b's row (radix 0) or K3's tile in trips of
// radix 2^radix
static struct { int log_n, s0, cnt, log_c, radix; uint4* sh; const uint32_t *in, *tw; uint32_t* out; } job;
template <bool kFirst>
static void pass_block() {
  if (job.radix == 3)
    ntt_pass_block<3, kFirst>(job.sh, job.in, job.out, job.tw, job.log_n, job.s0, job.cnt, job.log_c);
  else
    ntt_pass_block<2, kFirst>(job.sh, job.in, job.out, job.tw, job.log_n, job.s0, job.cnt, job.log_c);
}
static void fiber_main(int f) {
  uint64_t bar = 0;
  if (job.radix > 0 && job.s0 == 0)
    pass_block<true>();
  else if (job.radix > 0)
    pass_block<false>();
  else
    ntt_rows_block(job.sh, job.in, job.out, job.tw, job.log_n, &bar);
  fiber_done[f] = true;
  const int g = next_fiber();
  if (g >= 0) {
    waits[g] = 0;
    running = g;
    threadIdx.x = g;
    setcontext(&fiber_ctx[g]);
  }
  for (int k = 0; k < fibers; k++) stuck |= !fiber_done[k];
}  // the last fiber returns to block_ctx
// one emulated block of `threads` fibers on `job`; false if its threads
// were left at different barriers
static bool run_block(int threads, char* stacks, size_t stack) {
  fibers = threads;
  blockDim.x = fibers;
  std::memset(block_arrived, 0, sizeof block_arrived);
  std::memset(warp_arrived, 0, sizeof warp_arrived);
  for (int f = 0; f < fibers; f++) {
    waits[f] = 0;
    block_meets[f] = warp_meets[f] = 0;
    fiber_done[f] = false;
    getcontext(&fiber_ctx[f]);
    fiber_ctx[f].uc_stack.ss_sp = stacks + f * stack;
    fiber_ctx[f].uc_stack.ss_size = stack;
    fiber_ctx[f].uc_link = &block_ctx;
    makecontext(&fiber_ctx[f], (void (*)())fiber_main, 1, f);
  }
  running = 0;
  threadIdx.x = 0;
  swapcontext(&block_ctx, &fiber_ctx[0]);
  return !stuck;
}
static const size_t STACK = 1 << 16;
// `batch` rows of 2^log_n, one emulated K3b block each, one after another;
// 1 if a block's threads were left at different barriers
extern "C" int ntt_rows_run(const uint32_t* in, uint32_t* out, const uint32_t* tw, int log_n, int batch) {
  const int threads = rows_threads(log_n);
  char* stacks = (char*)std::malloc(threads * STACK);
  uint4* sh = (uint4*)std::malloc((size_t)32 << log_n);  // the row
  stuck = false;
  for (int row = 0; row < batch && !stuck; row++) {
    blockIdx.x = row;
    job = {log_n, 0, 0, 0, 0, sh, in, tw, out};
    run_block(threads, stacks, STACK);
  }
  std::free(sh);
  std::free(stacks);
  return stuck ? 1 : 0;
}
// pass (s0, cnt, log_c) of K3 in radix-2^radix trips on `batch` rows of
// 2^log_n (tw: the stage table), one emulated block a tile, as csrc/ntt.cu
// launches it; 1 if a block's threads were left at different barriers
extern "C" int ntt_pass_run(const uint32_t* in, uint32_t* out, const uint32_t* tw, int log_n, int s0, int cnt,
                            int log_c, int radix, int batch) {
  const int lt = cnt + log_c, threads = pass_threads(lt, radix);
  char* stacks = (char*)std::malloc(threads * STACK);
  uint4* sh = (uint4*)std::malloc((size_t)32 << lt);  // the tile
  stuck = false;
  for (int row = 0; row < batch && !stuck; row++)
    for (uint32_t tile = 0; tile < (1u << (log_n - lt)) && !stuck; tile++) {
      blockIdx.x = tile;
      const size_t first = (size_t)row << (log_n + 3);
      job = {log_n, s0, cnt, log_c, radix, sh, in + first, tw, out + first};
      run_block(threads, stacks, STACK);
    }
  std::free(sh);
  std::free(stacks);
  return stuck ? 1 : 0;
}
"""


# curve_pair.cuh's point operations, thread k of each pair on host thread k
PAIR_HARNESS = r"""
#include <atomic>
#include <chrono>
#include <cstdint>
#include <thread>
#define __global__
#define __noinline__
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, blockDim, threadIdx;
#include "curve_pair.cuh"
static thread_local uint32_t parity;
static fq_t slot_v[2];
static bool slot_b[2];
static std::atomic<int> arrived{0}, generation{0};
static std::atomic<bool> diverged{false};
// both threads meet here; a thread left waiting for 20 s means the
// pair took different paths, and the run is marked failed, not hung
static void pair_barrier() {
  const int g = generation.load();
  if (arrived.fetch_add(1) == 1) {
    arrived.store(0);
    generation.fetch_add(1);
    return;
  }
  const auto end = std::chrono::steady_clock::now() + std::chrono::seconds(20);
  while (generation.load() == g && !diverged.load()) {
    if (std::chrono::steady_clock::now() > end) diverged.store(true);
    std::this_thread::yield();
  }
}
uint32_t pair_parity() { return parity; }
fq_t pair_swap(const fq_t& a) {
  slot_v[parity] = a;
  pair_barrier();
  const fq_t r = slot_v[1 - parity];
  pair_barrier();
  return r;
}
bool pair_all(bool b) {
  slot_b[parity] = b;
  pair_barrier();
  const bool r = b && slot_b[1 - parity];
  pair_barrier();
  return r;
}
// op 0: madd_nodbl(a, b affine, mask = valid), 1: dbl(a, mask), 2: add(a, b);
// returns 1 if the two threads of a pair diverged
extern "C" int pair_run(int op, const uint32_t* a, const uint32_t* b, const uint8_t* mask, uint32_t* out,
                        uint8_t* same, long long n) {
  arrived = 0;
  diverged = false;
  auto lanes = [=](uint32_t k) {
    parity = k;
    for (long long i = 0; i < n && !diverged; i++) {
      if (op == 0) pair_madd_nodbl(a, b, mask, out, same, i);
      if (op == 1) pair_dbl(a, mask, out, i);
      if (op == 2) pair_add(a, b, out, i);
    }
  };
  std::thread odd(lanes, 1u);
  lanes(0u);
  odd.join();
  return diverged ? 1 : 0;
}
"""


# csrc/poseidon.cuh's K2 and K7 instances, one after another, each with a
# row slice of its own (stride 1 where the card strides by blockDim.x),
# and K7's lane groups (csrc/poseidon_group.cuh): the 32 lanes of a warp
# are 32 fibers of one host thread (ucontext), which meet at each shuffle:
# every lane publishes its words, the fibers take turns, each reads its
# source lane's, and they take turns again before the next exchange. A
# warp whose lanes met a different number of times fails the run.
POSEIDON_HARNESS = r"""
#include <cstdint>
#include <cstdlib>
#include <ucontext.h>
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
template <int N>
inline void load_elem(uint32_t r[N], const uint32_t* p) { for (int k = 0; k < N; k++) r[k] = p[k]; }
template <int N>
inline void store_elem(uint32_t* p, const uint32_t r[N]) { for (int k = 0; k < N; k++) p[k] = r[k]; }
static ucontext_t main_ctx, lane_ctx[32];
static int cur, meets[32];
static bool done[32];
static uint32_t published[32][17];
// this lane waits until every lane still running has come here once
static void meet() {
  const int me = cur;
  meets[me]++;
  int nx = (me + 1) % 32;
  while (done[nx] && nx != me) nx = (nx + 1) % 32;
  if (nx == me) return;
  cur = nx;
  swapcontext(&lane_ctx[me], &lane_ctx[nx]);
}
static void exchange(uint32_t* r, const uint32_t* x, int words, int src) {
  for (int k = 0; k < words; k++) published[cur][k] = x[k];
  meet();
  for (int k = 0; k < words; k++) r[k] = published[src][k];
  meet();
}
inline void shfl_elem(uint32_t r[8], const uint32_t x[8], int src) { exchange(r, x, 8, src % 32); }
template <int W>
inline void shfl_down_words(uint32_t r[W], const uint32_t x[W], int off) {
  exchange(r, x, W, cur + off < 32 ? cur + off : cur);
}
#include "poseidon_group.cuh"
template <int T>
void run(int witness, const uint32_t* pre, uint32_t* out, const uint32_t* sc, long long n, int r_f, int r_p) {
  uint32_t rows[T * L];
  const uint32_t* tag = sc + const_words<T>(r_f, r_p) - L;
  const long long n_int = 3 * (r_f * T + r_p) + 1;
  for (long long i = 0; i < n; i++) {
    if (witness) {
      witness_one<T>(pre + i * (T - 1) * L, out + i * n_int * L, L, sc, tag, rows, 1, r_f, r_p);
      continue;
    }
    uint32_t s[T][L];
    load_state<T>(s, tag, pre + i * (T - 1) * L);
    permute<T>(s, sc, rows, 1, r_f, r_p, Sbox5{});
    store_elem<L>(out + i * L, s[1]);
  }
}
struct WarpJob { int t; long long first, n; const uint32_t *pre, *sc; uint32_t* out; int r_f, r_p; };
static WarpJob job;
static void lane_main(int lane) {
  const uint32_t* tag = job.sc + (job.t == 3 ? const_words<3>(job.r_f, job.r_p)
                                  : job.t == 9 ? const_words<9>(job.r_f, job.r_p)
                                               : const_words<12>(job.r_f, job.r_p)) - L;
  if (job.t == 3) witness_warp<3>(lane, job.first, job.n, job.pre, job.out, job.sc, tag, job.r_f, job.r_p);
  if (job.t == 9) witness_warp<9>(lane, job.first, job.n, job.pre, job.out, job.sc, tag, job.r_f, job.r_p);
  if (job.t == 12) witness_warp<12>(lane, job.first, job.n, job.pre, job.out, job.sc, tag, job.r_f, job.r_p);
  done[lane] = true;
  int nx = (lane + 1) % 32;
  while (done[nx] && nx != lane) nx = (nx + 1) % 32;
  if (nx != lane) {
    cur = nx;
    setcontext(&lane_ctx[nx]);
  }
}  // the last lane returns to main_ctx
extern "C" int poseidon_run(int witness, const uint32_t* pre, uint32_t* out, const uint32_t* sc, long long n,
                            int t, int r_f, int r_p) {
  if (t == 3) run<3>(witness, pre, out, sc, n, r_f, r_p);
  else if (t == 9) run<9>(witness, pre, out, sc, n, r_f, r_p);
  else if (t == 12) run<12>(witness, pre, out, sc, n, r_f, r_p);
  else return 1;
  return 0;
}
// K7's lane groups over the whole batch, one warp after another; returns
// 1 if the lanes of a warp met a different number of times
extern "C" int poseidon_group_run(const uint32_t* pre, uint32_t* out, const uint32_t* sc, long long n, int t,
                                  int r_f, int r_p) {
  if (t != 3 && t != 9 && t != 12) return 2;
  const int per_warp = WARP / t;
  const size_t stack = 1 << 18;
  char* stacks = (char*)std::malloc(32 * stack);
  int bad = 0;
  for (long long first = 0; first < n && !bad; first += per_warp) {
    job = {t, first, n, pre, sc, out, r_f, r_p};
    for (int k = 0; k < 32; k++) {
      meets[k] = 0;
      done[k] = false;
      getcontext(&lane_ctx[k]);
      lane_ctx[k].uc_stack.ss_sp = stacks + k * stack;
      lane_ctx[k].uc_stack.ss_size = stack;
      lane_ctx[k].uc_link = &main_ctx;
      makecontext(&lane_ctx[k], (void (*)())lane_main, 1, k);
    }
    cur = 0;
    swapcontext(&main_ctx, &lane_ctx[0]);
    for (int k = 1; k < 32; k++) bad |= meets[k] != meets[0];
  }
  std::free(stacks);
  return bad;
}
"""


def _compile(tmp_path_factory, name, source, *libs):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    d = tmp_path_factory.mktemp(name)
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(source)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-DFIELD_HOST_TEST", "-I", CSRC,
                    str(src), "-o", str(so), *libs], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _compile(tmp_path_factory, "field_host", HARNESS)


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


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fq2_pair_halves(lib, op, rng_seed):
    """fq2_mul_half / fq2_sqr_half, thread 0 (c0) and thread 1 (c1) of a
    pair, against (a0 + a1 u)(b0 + b1 u) mod p."""
    p, n = F.FQ.modulus, 128
    a = _values(F.FQ, 2 * n, rng_seed + 2)
    b = _values(F.FQ, 2 * n, rng_seed + 3)[::-1]
    # rows 2-6: a0 b0 < a1 b1 (c0 = a0 b0 - a1 b1 negative), a0 < a1, a1 = 0 (p - a1 = p), b = 0
    a[4:14] = [1, p - 1, 0, p - 1, p - 2, p - 1, 0, 1, p - 1, 0]
    b[4:14] = [1, p - 1, p - 1, p - 1, p - 1, p - 1, p - 1, p - 1, 0, 0]
    r_inv = pow(1 << 384, -1, p)
    out = (ctypes.c_uint32 * (2 * n * 12))()
    if op == "mul":
        lib.fq2_mul_halves(_buf(a, 12), _buf(b, 12), out, n)
    else:
        lib.fq2_sqr_halves(_buf(a, 12), out, n)
        b = a
    want = []
    for i in range(n):
        a0, a1, b0, b1 = a[2 * i], a[2 * i + 1], b[2 * i], b[2 * i + 1]
        want += [(a0 * b0 - a1 * b1) * r_inv % p, (a0 * b1 + a1 * b0) * r_inv % p]
    assert _ints(out, 12) == want


def test_g2_pair_layout_matches_plain(tmp_path_factory, rng_seed):
    """K5's pair formulas (madd_nodbl with its `same` flags, dbl, add) on
    two host threads against ops/g2_torch.py's plain versions, lane by
    lane: acc at infinity (lanes 0, 4), q == acc (1, n - 1), q == -acc
    (2), masked (3, 4); add with P == Q, P == -Q and Q at infinity."""
    import torch

    from crypto3_fil_proofs_torch.ops import msm as M
    from crypto3_fil_proofs_torch.ops.g2_torch import G2

    pair = _compile(tmp_path_factory, "pair_host", PAIR_HARNESS, "-lpthread")
    p, n = F.FQ.modulus, 24
    pts, _ = M.random_walk_bases(G2, 2 * n, rng_seed)
    two = G2.host_double(pts[0])
    acc_h = [G2.host_add(pt, two) for pt in pts[:n]]  # Z != 1
    q_h = list(pts[n:])
    acc_h[0] = acc_h[4] = G2.host_inf
    q_h[1], q_h[n - 1] = acc_h[1], acc_h[n - 1]
    x, y = G2.to_affine(acc_h[2])
    q_h[2] = (x, ((-y[0]) % p, (-y[1]) % p))
    acc = G2.encode_coords([c for pt in acc_h for c in pt]).reshape((n, 3) + G2.coord)
    q = G2.points_to_device(q_h)[0].contiguous()
    valid = torch.ones(n, dtype=torch.bool)
    valid[[3, 4]] = False
    every = torch.ones(n, dtype=torch.bool)

    def run(op, a, b, mask):
        out, same = torch.zeros_like(a), torch.zeros(n, dtype=torch.uint8)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        m = mask.to(torch.uint8)
        assert pair.pair_run(op, ptr(a), ptr(b), ptr(m), ptr(out), ptr(same), ctypes.c_longlong(n)) == 0
        return out, same.bool()

    out, same = run(0, acc, q, valid)
    want, want_same = G2.madd_nodbl_plain(acc, q, valid)
    assert torch.equal(out, want) and torch.equal(same, want_same)
    assert same.nonzero().flatten().tolist() == [1, n - 1]
    assert torch.equal(run(1, want, want, want_same)[0], G2.dbl_plain(want, want_same))
    assert torch.equal(run(1, acc, acc, every)[0], G2.dbl_plain(acc, every))
    other_h = acc_h[1:] + acc_h[:1]  # lane n - 1: Q at infinity
    other_h[5] = acc_h[5]  # P == Q
    X, Y, Z = acc_h[7]
    other_h[7] = (X, ((-Y[0]) % p, (-Y[1]) % p), Z)  # P == -Q
    other = G2.encode_coords([c for pt in other_h for c in pt]).reshape((n, 3) + G2.coord)
    assert torch.equal(run(2, acc, other, every)[0], G2.add_plain(acc, other))
    assert torch.equal(run(2, want, want, every)[0], G2.add_plain(want, want))


@pytest.fixture(scope="module")
def poseidon_lib(tmp_path_factory):
    return _compile(tmp_path_factory, "poseidon_host", POSEIDON_HARNESS)


@pytest.mark.parametrize("arity", [2, 8, 11])
def _poseidon_batch(arity, n, seed):
    """n preimages of `arity` Montgomery elements (0, 1, p - 1 among them)
    and the staged constants of their width."""
    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT
    from crypto3_fil_proofs_torch.ops.cuda import field as k1

    vals = _values(F.FR, n * arity, seed)
    vals[-1] = F.FR.modulus - 1
    pre = k1.to_mont(F.ints_to_limbs32(vals)).reshape(n, arity, PT.L).contiguous()
    st = PT.staged(arity)
    return pre, st, st.flat().contiguous()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("arity", [2, 8, 11])
def test_poseidon_k2_k7_instances_match_plain(poseidon_lib, arity, rng_seed):
    """K2's digests and K7's records in the caller's [n, n_int, 8] layout
    == hash_mont_plain and witness_plain: K7's one-thread instances of
    csrc/poseidon.cuh, then its lane groups (csrc/poseidon_group.cuh, t
    lanes of an emulated warp per instance, shuffles between them) on two
    warps, the second with one instance: its other groups and the spare
    lanes store nothing."""
    import torch

    from crypto3_fil_proofs_torch.ops import poseidon_torch as PT

    n, n_int = 5, PT.witness_len(arity)
    pre, st, sc = _poseidon_batch(arity, n, rng_seed + arity)

    def run(witness, rows):
        out = torch.zeros((n, rows, PT.L), dtype=torch.int32)
        assert poseidon_lib.poseidon_run(witness, _ptr(pre), _ptr(out), _ptr(sc), ctypes.c_longlong(n), st.t,
                                         st.r_f, st.r_p) == 0
        return out

    assert torch.equal(run(0, 1)[:, 0], PT.hash_mont_plain(pre, arity))
    assert torch.equal(run(1, n_int), PT.witness_plain(pre, arity))

    n = 32 // (arity + 1) + 1
    pre, st, sc = _poseidon_batch(arity, n, rng_seed + 50 + arity)
    out = torch.full((n + 1, n_int, PT.L), 7, dtype=torch.int32)  # one row past the batch
    assert poseidon_lib.poseidon_group_run(_ptr(pre), _ptr(out), _ptr(sc), ctypes.c_longlong(n), st.t, st.r_f,
                                           st.r_p) == 0
    assert torch.equal(out[:n], PT.witness_plain(pre, arity))
    assert bool((out[n] == 7).all())


def test_ntt_rows_block_matches_plain(lib, rng_seed):
    """K3b's block on an emulated block of its threads against ops/ntt.py
    `ntt_host` on Python integers (the transform is linear, so it maps
    Montgomery values to Montgomery values; the kernel's inverse is
    unscaled) at log_n 1..12, forward and inverse, 0, 1, p - 1 and p - 2
    among the inputs, two rows a launch."""
    import torch

    from crypto3_fil_proofs_torch.ops import ntt as N

    p, rows = F.FR.modulus, 2
    for log_n in range(1, 13):
        n = 1 << log_n
        vals = _values(F.FR, rows * n, rng_seed + log_n)
        x = F.ints_to_limbs32(vals).reshape(rows, n, F.FR.n32).contiguous()
        for inverse in (False, True):
            want = [N.ntt_host(vals[r * n : (r + 1) * n], inverse) for r in range(rows)]
            if inverse:
                want = [[v * n % p for v in w] for w in want]
            tw = N.table(log_n, "tw_inv" if inverse else "tw_fwd", "cpu").contiguous()
            out = torch.zeros_like(x)
            assert lib.ntt_rows_run(_ptr(x), _ptr(out), _ptr(tw), log_n, rows) == 0, log_n
            assert [F.limbs32_to_ints(out[r]) for r in range(rows)] == want, (log_n, inverse)


def test_ntt_pass_block_matches_plain(lib, rng_seed):
    """K3's pass block (csrc/ntt_pass.cuh) on emulated blocks, pass by pass
    as ops/cuda/ntt.py `passes` plans them with small tiles (2^5 elements
    up to log_n 11: up to four passes of at most three stages over tiles of
    4 to 8 adjacent columns; 2^8 from log_n 11: two or three passes of four
    to six stages), against `ntt_host` at log_n 1..14, forward and inverse,
    0, 1, p - 1 and p - 2 among the inputs, two rows a launch up to 2^8.
    Trips of radix 8 and 4 by turns; the first pass gathers through the
    bit reversal; passes whose stage count the radix does not divide end on
    a radix-4 or radix-2 trip."""
    import torch

    from crypto3_fil_proofs_torch.ops import ntt as N
    from crypto3_fil_proofs_torch.ops.cuda import ntt as k3

    p, seen = F.FR.modulus, set()
    for log_n in range(1, 15):
        n, rows = 1 << log_n, 2 if log_n <= 8 else 1
        vals = _values(F.FR, rows * n, rng_seed + log_n)
        x = F.ints_to_limbs32(vals).reshape(rows, n, F.FR.n32).contiguous()
        for inverse in (False, True):
            want = [N.ntt_host(vals[r * n : (r + 1) * n], inverse) for r in range(rows)]
            if inverse:
                want = [[v * n % p for v in w] for w in want]
            # the stage table of ops/ntt.py over w^k made with Python ints
            d = N.domain(log_n)
            tw = N.stage_table(F.ints_to_limbs32([v * F.FR.mont_r % p for v in N.powers(
                d.omega_inv if inverse else d.omega, max(n // 2, 1))]), log_n)
            for tile_log in (5,) if log_n <= 10 else (5, 8) if log_n == 11 else (8,):
                radix = 3 - (log_n + tile_log + inverse) % 2
                plan = k3.passes(log_n, tile_log, 2, radix)
                seen |= {(s0 > 0, log_c >= 2, cnt % radix, radix) for s0, cnt, log_c in plan}
                out = torch.empty_like(x)
                for s0, cnt, log_c in plan:
                    src = x if s0 == 0 else out
                    assert lib.ntt_pass_run(_ptr(src), _ptr(out), _ptr(tw), log_n, s0, cnt, log_c, radix, rows) == 0
                assert [F.limbs32_to_ints(out[r]) for r in range(rows)] == want, (tile_log, log_n, inverse, radix)
    # later passes and first passes over tiles of >= 4 columns; both
    # radices, radix-8 passes ending on a radix-4 and a radix-2 trip,
    # radix-4 passes on a radix-2 trip
    assert {(True, True), (False, True)} <= {k[:2] for k in seen}
    assert {(1, 3), (2, 3), (1, 2)} <= {k[2:] for k in seen}
