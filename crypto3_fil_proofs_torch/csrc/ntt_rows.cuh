// Kernel K3b: the four-step NTT's batched rows, each row transformed whole
// in shared memory by one block; one launch for the whole batch.
//
// Replaces the batched use of crypto3_fil_proofs_tpu/ops/pallas/ntt.py's
// stage kernels (`_make_stage_kernel` :118 through `_stage_call` :240,
// launched at :264): the JAX package's four-step transform runs its
// column and row transforms as those stage kernels over a batch. Here the
// function is ops/ntt.py `transform_plain` on each row of a contiguous
// int32 [batch, 2^log_n, 8] buffer (Fr, Montgomery form, natural order in
// and out, unscaled), log_n <= 12. parallel/sharded.py `ntt_sharded`
// runs it twice per shard: 256 rows of 2^12 and 512 rows of 2^11 at 2^23
// on 8 shards.
//
// Bound: (n/2) log2(n) - (n - 1) Montgomery products a row (the n - 1
// butterflies at w^0 = 1 need none), 272 32-bit multiply-adds each,
// against 64 bytes a row element in and out: at 512 x 2^11 that is
// 0.077 ms of the H100's multiply-add rate against 0.020 ms of its memory
// rate, so the kernel is operation-bound. The design keeps every trip
// between the products short:
// - Block and row. Block b transforms row b. A row of 2^12 elements is
//   128 KB and fits the 227 KB a Hopper block may opt into, so device
//   memory is read and written once a row, contiguously: one 1-D bulk
//   asynchronous copy (cp.async.bulk, completion on an mbarrier, no
//   tensor map) brings the row into shared memory; after the last stage
//   one bulk copy takes it back (cp.async.bulk.global.shared::cta after
//   fence.proxy.async).
// - Butterflies in registers: radix-8 trips, three DIT stages per trip
//   through shared memory and per __syncthreads(); the stages left over
//   end with one radix-4 or radix-2 trip. The first trip reads through
//   the bit reversal in shared memory (element c of butterfly m is
//   rev(c) << (log_n - r) | m, so no reversal is computed for the reads)
//   and skips the products by 1 of its stages: 5 products a radix-8
//   butterfly there instead of 12.
// - Twiddles from ops/ntt.py's tables (tw_fwd / tw_inv, w^k at k),
//   through L1.
// - Shared-memory layout. An element is two 16-byte chunks, and a warp's
//   16-byte access is served in four phases of 8 lanes, each free of
//   conflicts when its 8 chunks lie in 8 distinct bank quads. In the
//   plain layout, 8 consecutive elements take quads 0, 2, 4, 6 twice
//   (2-way), and 8 elements 4 apart take one quad (8-way: the first
//   trip's writes). Between trips the row is kept swizzled: each 128-byte
//   row of 4 elements stays in place and XORs its chunk index with
//   f(row) = (row ^ row >> 3 ^ row >> 6 ^ row >> 9) & 7. Each trip picks
//   the lanes' order: consecutive positions j (rows r, r + 1: f differs
//   in bit 0), or, where a trip has 32 or more butterfly groups,
//   consecutive groups with one twiddle set for the whole warp (groups
//   2^(s+r-2) rows apart: f maps the 3 row bits that 8 lanes vary to 3
//   independent bits). The bulk copies move the plain layout, so the
//   first trip reads it and the last trip writes it (2-way); the trips
//   between are free of conflicts.
// - Hazards. A trip reads and writes the same elements on the same
//   thread, except the first (it reads through the reversal: all reads,
//   one __syncthreads(), then the writes) and the last, which reads the
//   swizzled layout and writes the plain one (a 128-byte row's 4 elements
//   belong to 4 lanes of one warp: the lanes meet at __syncwarp() between
//   reads and writes).
// Against the alternatives measured one at a time (twiddles staged in
// shared memory beside the row, the plain layout throughout, the last
// trip's results stored from registers with 16-byte stores, radix-4
// trips; PERF.md), this design was the fastest over both four-step
// shapes together on one H100 80GB HBM3 at 700 W.
//
// Registers and occupancy: 512 threads a block at 2^12 and 256 at 2^11
// (n / 8: one radix-8 butterfly a thread a trip), launch bounds
// (512, 1), so at most 128 registers (ptxas -v in chip_smoke.py's phase
// 1; PERF.md has the count, no spill). A 2^12 row takes 128 KB: one
// block an SM, 256 rows over 132 SMs is 1.94 waves. A 2^11 row takes
// 64 KB and 256 threads: two blocks an SM by registers, 512 rows over 264
// slots is 1.94 waves. Either way 16 warps an SM. Tensor cores do not
// serve a 256-bit Montgomery product: they multiply 8-bit integers at
// most into 32-bit sums, and the carries of a 256 x 256-bit product
// across 32 such limbs would cost more than the IMAD chains they save.
//
// tests/test_torch_field_host.py compiles this header on the host
// (FIELD_HOST_TEST): a block's threads run as fibers that meet at each
// __syncthreads() and, a warp at a time, at each __syncwarp(); the bulk
// copies become memcpy.
#pragma once

#include "field.cuh"

#ifndef FIELD_HOST_TEST
#include <cuda_runtime.h>
#endif

constexpr int ROWS_MAX_LOG_N = 12;
constexpr int ROWS_MAX_THREADS = 512;

// threads a block for rows of 2^log_n: one radix-8 butterfly (two
// radix-4, four radix-2) a thread a trip
inline int rows_threads(int log_n) {
  const int t = (1 << log_n) / 8;
  return t < 32 ? 32 : (t > ROWS_MAX_THREADS ? ROWS_MAX_THREADS : t);
}

// the low `bits` bits of x reversed
__device__ __forceinline__ uint32_t rows_rev(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// 16-byte chunk of half q of element e in the swizzled or the plain layout
__device__ __forceinline__ uint32_t rows_chunk(uint32_t e, uint32_t q, bool swz) {
  if (!swz) return 2 * e + q;
  const uint32_t row = e >> 2;
  const uint32_t f = (row ^ (row >> 3) ^ (row >> 6) ^ (row >> 9)) & 7u;
  return (row << 3) | ((2 * (e & 3u) + q) ^ f);
}

__device__ __forceinline__ void rows_get(uint32_t v[8], const uint4* sh, uint32_t e, bool swz) {
  const uint4 lo = sh[rows_chunk(e, 0, swz)];
  const uint4 hi = sh[rows_chunk(e, 1, swz)];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void rows_put(uint4* sh, uint32_t e, bool swz, const uint32_t v[8]) {
  sh[rows_chunk(e, 0, swz)] = make_uint4(v[0], v[1], v[2], v[3]);
  sh[rows_chunk(e, 1, swz)] = make_uint4(v[4], v[5], v[6], v[7]);
}

// (u, v) <- (u + v, u - v)
__device__ __forceinline__ void rows_bfly(uint32_t u[8], uint32_t v[8]) {
  uint32_t s[8];
  add_mod<Fr>(s, u, v);
  sub_mod<Fr>(v, u, v);
#pragma unroll
  for (int k = 0; k < 8; k++) u[k] = s[k];
}

// K3b's twiddles: the root of stage s + 1 + i to the power p is
// w^(p 2^(L-s-i-1)) of the table of w^k (ops/ntt.py tw_fwd / tw_inv).
// `butterfly(j, s)` gives the twiddles of one butterfly at position j of a
// trip after stage s: get(w, i, low) reads the root of its stage s + 1 + i
// to the power j + low 2^s.
struct RowTw {
  const uint32_t* tw;
  int log_n;
  struct Bt {
    const uint32_t* tw;
    uint32_t j;
    int s, log_n;
    __device__ __forceinline__ void get(uint32_t w[8], int i, int low) const {
      load_const<8>(w, tw + 8 * (size_t)((j + ((uint32_t)low << s)) << (log_n - s - i - 1)));
    }
  };
  __device__ __forceinline__ Bt butterfly(uint32_t j, int s) const { return {tw, j, s, log_n}; }
};

// DIT stages s + 1 .. s + r in registers on a[k] = element t0 + k 2^s
// (k < 2^r) of a butterfly at position j = t0 mod 2^s: stage s + 1 + i
// pairs (a[k], a[k + 2^i]) for each k without bit i, at the stage's root
// to the power j + (k mod 2^i) 2^s, read by tw.butterfly(j, s).get(w, i,
// k mod 2^i). kFirst (the transform's first stages: every power with
// k mod 2^i = 0 is 0) skips the products by w^0 = 1.
template <int r, bool kFirst, class Tw>
__device__ __forceinline__ void rows_radix(uint32_t a[][8], const Tw& tw, uint32_t j, int s) {
  const auto bt = tw.butterfly(j, s);
#pragma unroll
  for (int i = 0; i < r; i++) {
    const int span = 1 << i;
#pragma unroll
    for (int low = 0; low < span; low++) {
      const bool one = kFirst && low == 0;
      uint32_t w[8];
      if (!one) bt.get(w, i, low);
#pragma unroll
      for (int k = low; k < (1 << r); k += 2 * span) {
        if (!one) mont_mul<Fr>(a[k + span], a[k + span], w);
        rows_bfly(a[k], a[k + span]);
      }
    }
  }
}

// Stages 1 .. r of 2^log_c interleaved columns through each column's bit
// reversal: element (t, col) of a column of 2^(log_n - log_c) sits at
// t 2^log_c + col, and butterfly m = (m', col) reads elements
// rev_r(c) << (log_n - r) | m and writes (g 2^r + c) 2^log_c + col,
// g = rev(m'): every read, one __syncthreads(), then every write (a
// thread holds at most 2^R elements: blockDim.x >= 2^(log_n - R)). The
// row arrives in the plain layout; the trip leaves it swizzled, or plain
// when it is the last. K3b's rows are one column (log_c = 0).
template <int r, int R, class Tw>
__device__ __forceinline__ void rows_first(uint4* sh, const Tw& tw, int log_n, int log_c) {
  constexpr int K = 1 << (R - r);
  const int lr = log_n - r;
  const uint32_t count = 1u << lr, cols = (1u << log_c) - 1u;
  const bool last = log_n - log_c == r;
  uint32_t a[K][1 << r][8];
#pragma unroll
  for (int q = 0; q < K; q++) {
    const uint32_t m = threadIdx.x + q * blockDim.x;
    if (m < count) {
#pragma unroll
      for (int c = 0; c < (1 << r); c++) rows_get(a[q][c], sh, (rows_rev(c, r) << lr) | m, false);
      rows_radix<r, true>(a[q], tw, m & cols, log_c);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; q++) {
    const uint32_t m = threadIdx.x + q * blockDim.x;
    if (m < count) {
      const uint32_t t0 = (rows_rev(m >> log_c, lr - log_c) << (r + log_c)) | (m & cols);
#pragma unroll
      for (int c = 0; c < (1 << r); c++) rows_put(sh, t0 + ((uint32_t)c << log_c), !last, a[q][c]);
    }
  }
}

// Stages s + 1 .. s + r in place, each butterfly's elements read and
// written by one thread. Lanes take consecutive positions j, or, where
// the trip has 32 or more groups, consecutive groups g on one j (one
// twiddle set a warp). The last trip writes the plain layout: a 128-byte
// row's four elements belong to four lanes of one warp, which meet at
// __syncwarp() between their reads and writes.
template <int r, class Tw>
__device__ __forceinline__ void rows_trip(uint4* sh, const Tw& tw, int s, int log_n) {
  const uint32_t n = 1u << log_n, h = 1u << s, groups = n >> (s + r), count = n >> r;
  const bool last = s + r == log_n;
  const bool group_fast = groups >= 32;
  for (uint32_t base = 0; base < count; base += blockDim.x) {
    const uint32_t b = base + threadIdx.x;
    const uint32_t j = group_fast ? b >> (log_n - s - r) : b & (h - 1);
    const uint32_t g = group_fast ? b & (groups - 1) : b >> s;
    const uint32_t t0 = (g << (s + r)) | j;
    uint32_t a[1 << r][8];
    if (b < count) {
#pragma unroll
      for (int c = 0; c < (1 << r); c++) rows_get(a[c], sh, t0 + c * h, true);
      rows_radix<r, false>(a, tw, j, s);
    }
    if (last) __syncwarp();
    if (b < count) {
#pragma unroll
      for (int c = 0; c < (1 << r); c++) rows_put(sh, t0 + c * h, !last, a[c]);
    }
  }
}

#ifndef FIELD_HOST_TEST
__device__ __forceinline__ uint32_t rows_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// the row into shared memory: bulk copies of at most 32 KB, each 16-byte
// aligned with a size a multiple of 16, completing on the mbarrier
__device__ __forceinline__ void rows_load(uint4* sh, const uint32_t* in, uint32_t bytes, uint64_t* bar) {
#ifdef FIELD_HOST_TEST
  if (threadIdx.x == 0) memcpy(sh, in, bytes);
  __syncthreads();
#else
  const uint32_t b = rows_smem(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += 32768u) {
      const uint32_t len = bytes - off < 32768u ? bytes - off : 32768u;
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                   :: "r"(rows_smem((char*)sh + off)), "l"((const char*)in + off), "r"(len), "r"(b)
                   : "memory");
    }
  }
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(b), "r"(0u) : "memory");
  } while (!done);
#endif
}

// the row, in the plain layout in shared memory, to out by one bulk copy;
// thread 0 returns once the copy has read shared memory (its writes to
// device memory complete with the grid)
__device__ __forceinline__ void rows_store(uint32_t* out, const uint4* sh, uint32_t bytes) {
#ifdef FIELD_HOST_TEST
  __syncthreads();
  if (threadIdx.x == 0) memcpy(out, sh, bytes);
#else
  // the generic proxy's writes, visible to the bulk copy's async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    for (uint32_t off = 0; off < bytes; off += 32768u) {
      const uint32_t len = bytes - off < 32768u ? bytes - off : 32768u;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"((char*)out + off), "r"(rows_smem((const char*)sh + off)), "r"(len) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
#endif
}

// Stages s + 1 .. log_n of the row in shared memory, swizzled after
// stage s: radix-2^R trips, then one radix-4 or radix-2 trip for the
// stages left over, each after a __syncthreads(); the last writes the
// plain layout.
template <int R, class Tw>
__device__ __forceinline__ void rows_trips(uint4* sh, const Tw& tw, int s, int log_n) {
  for (; s + R <= log_n; s += R) {
    __syncthreads();
    rows_trip<R>(sh, tw, s, log_n);
  }
  if (R > 2 && s + 2 <= log_n) {  // radix-8 trips leaving two stages
    __syncthreads();
    rows_trip<2>(sh, tw, s, log_n);
    s += 2;
  }
  if (s < log_n) {
    __syncthreads();
    rows_trip<1>(sh, tw, s, log_n);
  }
}

// Stages 1 .. log_n - log_c of 2^log_c interleaved columns, each read
// through its bit reversal from the plain layout (rows_first), then
// radix-2^R trips (R <= 3; blockDim.x >= 2^(log_n - R)); the row is left
// in the plain layout.
template <int R, class Tw>
__device__ __forceinline__ void rows_columns(uint4* sh, const Tw& tw, int log_n, int log_c) {
  const int r = log_n - log_c >= R ? R : log_n - log_c;
  if (R >= 3 && r == 3)
    rows_first<R >= 3 ? 3 : 1, R>(sh, tw, log_n, log_c);
  else if (R >= 2 && r == 2)
    rows_first<R >= 2 ? 2 : 1, R>(sh, tw, log_n, log_c);
  else
    rows_first<1, R>(sh, tw, log_n, log_c);
  rows_trips<R>(sh, tw, log_c + r, log_n);
}

// One block: row blockIdx.x of `in` into the same row of `out`; `sh`
// holds the row (2^log_n x 32 bytes).
__device__ __forceinline__ void ntt_rows_block(uint4* sh, const uint32_t* in, uint32_t* out, const uint32_t* tw,
                                               int log_n, uint64_t* bar) {
  const uint32_t n = 1u << log_n;
  const size_t first = (size_t)blockIdx.x << (log_n + 3);  // this row's first limb
  rows_load(sh, in + first, n * 32, bar);
  rows_columns<3>(sh, RowTw{tw, log_n}, log_n, 0);
  rows_store(out + first, sh, n * 32);
}
