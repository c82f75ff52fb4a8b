// Kernel K3: one pass of the long radix-2 DIT transform over BLS12-381 Fr
// (Montgomery form, natural order in and out, unscaled), the block's body.
// csrc/ntt.cu is its entry point.
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/ntt.py: the stage kernels
// `_make_stage_kernel` (:118), `_make_blocked_kernel` (:197) and
// `_make_split_kernel` (:220), launched through `_stage_call` (:240) at
// :264, :290 and :315 over a four-step "P-order" layout shaped for the
// TPU's (8, 128) tiles. Only the natural-order endpoints of a transform
// are unique, so the layout is not carried over. Here a transform of
// 2^log_n elements is a few passes (ops/cuda/ntt.py `passes`). Pass k runs
// stages s0 + 1 .. s0 + cnt on groups of 2^cnt elements that those stages
// mix only among themselves: element t of group (high, low) sits at
//     (high << (s0 + cnt)) | (t << s0) | low,   low < 2^s0,
// and the first pass (s0 = 0) reads element t of group g through the bit
// reversal, from rev(g) + 2^(log_n - cnt) rev_cnt(t).
//
// Bound: (n/2) log2(n) - (n - 1) Montgomery products a transform (the
// n - 1 butterflies at w^0 = 1 need none), 272 32-bit multiply-adds each,
// against 64 bytes an element a pass: at 2^19 that is 0.0725 ms of the
// H100's multiply-add rate against 0.010 ms of its memory rate a pass, so
// the kernel is operation-bound. The design:
// - Tiles of adjacent columns. A block transforms a tile of C = 2^log_c
//   groups with adjacent `low` (a later pass) or adjacent reversed
//   indices (the first pass), so every element t of the tile's groups is
//   one run of C elements in device memory: C >= 4 makes each run 128
//   bytes or more. The tile (C 2^cnt elements, at most 2^12: 128 KB) is
//   copied in by 16-byte cp.async from every thread, consecutive threads
//   on consecutive bytes, and out by 16-byte stores the same way (the
//   first pass writes each group as one run of 2^cnt elements).
// - In shared memory element t of column c sits at t C + c: the tile is a
//   K3b row of C 2^cnt elements whose first log_c stages are left out, so
//   K3b's radix-8 trips, swizzled layout and lanes' order run on it
//   unchanged (csrc/ntt_rows.cuh `rows_columns` / `rows_trips`): three
//   stages a barrier with the elements in registers, one radix-4 or
//   radix-2 trip for the stages left over, and the first trip of the
//   first pass reads through each column's reversal and skips the
//   products by 1.
// - Twiddles from the stage table (ops/ntt.py tw_stages_fwd / _inv: the
//   root of stage S to the power j at 2^(S-1) + j). A trip's lanes run
//   over the tile's adjacent columns first, whose j are adjacent, so a
//   warp reads runs of C twiddles; where a trip has 32 or more groups a
//   warp reads one twiddle set.
// - Launch shape (ops/cuda/ntt.py TILE_LOG, FILL_WARPS): a tile of 2^10
//   elements takes 32 KB and 128 threads in radix-8 trips (122
//   registers: four blocks, 16 warps an SM) or 256 in radix-4 trips (80:
//   three blocks, 24 warps). The batched transforms of the h pipeline
//   (ops/cuda/ntt.py `h_from_evals`) run three rows a launch, three times
//   the blocks at the PoSt domains; each pass of more than one wave is
//   launched behind the kernel before it (csrc/ntt.cu `ntt_transform`,
//   PDL).
// Against the alternatives measured one at a time (PERF.md: each warp
// copying in what its own first trip reads, the tile by a 2-D TMA box,
// launch bounds for five or six blocks an SM, tiles of 2^11 and 2^12,
// radix 8 or 4 everywhere), this design was the fastest over the paths'
// domains on one H100 80GB HBM3 at 700 W.
//
// tests/test_torch_field_host.py compiles this header on the host
// (FIELD_HOST_TEST) and runs the block on emulated threads; the copies
// become memcpy.
#pragma once

#include "ntt_rows.cuh"

constexpr int PASS_MAX_TILE_LOG = 12;  // 2^12 elements, 128 KB
constexpr int PASS_MAX_THREADS = 512;

// The twiddles of a pass in the row view of its tile: a trip after row
// stage s runs pass stages S0 + i (i < r), S0 = s0 + s - log_c + 1, and
// its butterfly at row position j sits in column j mod C at position
// j / C of its group, globally at jj0 = (j / C) 2^s0 + low0 + (j mod C).
// Its twiddle of stage S0 + i at sub-position low is the stage table's
// row 2^(S0+i-1) + jj0 + low 2^(S0-1) = jj0 + B (2^i + low), B = 2^(S0-1):
// a butterfly keeps one pointer and one stride. The first pass's columns
// are groups of their own (s0 = 0, low0 = 0, cols = 0: jj0 = j / C).
struct PassTw {
  const uint32_t* tw;  // the stage table of the transform
  int s0, log_c;
  uint32_t low0, cols;
  struct Bt {
    const uint32_t* p;  // row jj0 of the table
    uint32_t b8;        // 8 B: the limbs between rows jj0 + B k and jj0 + B (k + 1)
    __device__ __forceinline__ void get(uint32_t w[8], int i, int low) const {
      load_const<8>(w, p + b8 * ((1u << i) + low));
    }
  };
  __device__ __forceinline__ Bt butterfly(uint32_t j, int s) const {
    const uint32_t jj0 = ((j >> log_c) << s0) | low0 | (j & cols);
    return {tw + 8 * jj0, 8u << (s0 + s - log_c)};
  }
};

#ifndef FIELD_HOST_TEST
__device__ __forceinline__ void pass_copy16(uint4* dst_sh, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(rows_smem(dst_sh)), "l"(src) : "memory");
}
// the block's index, read anew (not kept in a register across the trips)
__device__ __forceinline__ uint32_t pass_tile() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(t));
  return t;
}
#else
inline void pass_copy16(uint4* dst_sh, const uint32_t* src) { memcpy(dst_sh, src, 16); }
inline uint32_t pass_tile() { return blockIdx.x; }
#endif

// threads a block for a tile of 2^lt elements in radix-2^R trips: one
// butterfly a thread a trip
inline int pass_threads(int lt, int R) {
  const int t = (1 << lt) >> R;
  return t < 32 ? 32 : t;
}

// Where tile `tile` of a pass lies: element (t, col) at base + t 2^lstride
// + col of the row; a later pass's first column low0.
struct PassTile {
  uint32_t base, low0;
  int lstride;
  template <bool kFirst>
  __device__ __forceinline__ static PassTile at(uint32_t tile, int log_n, int s0, int cnt, int log_c) {
    if (kFirst) return {tile << log_c, 0u, log_n - cnt};
    const int per_high = s0 - log_c;  // tiles a high index holds
    const uint32_t low0 = (tile & ((1u << per_high) - 1u)) << log_c;
    return {((tile >> per_high) << (s0 + cnt)) | low0, low0, s0};
  }
};

// One block: tile blockIdx.x of pass (s0, cnt, log_c) of the transform of
// 2^log_n elements at `in` into `out` (the same buffer in a later pass), in
// radix-2^R trips (pass_threads(cnt + log_c, R) threads); kFirst: s0 = 0,
// the pass that reads through the bit reversal. `sh` holds the tile
// (2^(cnt + log_c) x 32 bytes).
template <int R, bool kFirst>
__device__ __forceinline__ void ntt_pass_block(uint4* sh, const uint32_t* in, uint32_t* out, const uint32_t* tw,
                                               int log_n, int s0, int cnt, int log_c) {
  const int lt = cnt + log_c;  // the tile: 2^lt elements, the row view's length
  const uint32_t cols = (1u << log_c) - 1u, chunks = 2u << lt;  // 16-byte chunks of the tile
  {
    const PassTile g = PassTile::at<kFirst>(blockIdx.x, log_n, s0, cnt, log_c);
    // in: consecutive threads on consecutive chunks of each run of C; a
    // later pass lands swizzled, the first plain (its first trip gathers)
    for (uint32_t q = threadIdx.x; q < chunks; q += blockDim.x) {
      const uint32_t e = q >> 1, half = q & 1u;
      const uint32_t idx = g.base + ((e >> log_c) << g.lstride) + (e & cols);
      pass_copy16(sh + rows_chunk(e, half, !kFirst), in + 8 * (size_t)idx + 4 * half);
    }
#ifndef FIELD_HOST_TEST
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
#endif
    __syncthreads();
    if (kFirst)
      rows_columns<R>(sh, PassTw{tw, 0, log_c, 0u, 0u}, lt, log_c);
    else
      rows_trips<R>(sh, PassTw{tw, s0, log_c, g.low0, cols}, log_c, lt);
  }
  __syncthreads();
  // out, from the plain layout: a later pass where it read; the first pass
  // writes column c, group g = rev(base + c), as the run g 2^cnt .. + 2^cnt
  const PassTile g = PassTile::at<kFirst>(pass_tile(), log_n, s0, cnt, log_c);
  for (uint32_t q = threadIdx.x; q < chunks; q += blockDim.x) {
    const uint32_t half = q & 1u;
    uint32_t e, idx;
    if (kFirst) {
      const uint32_t t = (q >> 1) & ((1u << cnt) - 1u), col = q >> (cnt + 1);
      e = (t << log_c) | col;
      idx = (rows_rev(g.base + col, log_n - cnt) << cnt) | t;
    } else {
      e = q >> 1;
      idx = g.base + ((e >> log_c) << g.lstride) + (e & cols);
    }
    reinterpret_cast<uint4*>(out + 8 * (size_t)idx)[half] = sh[rows_chunk(e, half, false)];
  }
}
