// The Poseidon permutation over BLS12-381 Fr on the sparse schedule: the
// device functions of kernels K2 (csrc/poseidon.cu, the Merkle / column
// hash) and K7 (csrc/poseidon_witness.cu, the circuits' witness replay).
// One thread runs one permutation, the state in registers:
//   R_F/2 full rounds:  ARC, x^5 on every element, dense MDS mix;
//   R_P partial rounds: ARC with c', x^5 on element 0, sparse mix
//                       out0 = m00*x0 + sum v_j*x_{j+1}, out_i = w_i*x0 + x_i;
//   one dense mix by d_last;
//   R_F/2 full rounds.
// (crypto3_fil_proofs_tpu/ops/pallas/poseidon.py:252-309, host
// `permutation_optimized`, ops/poseidon.py:311-338.) The constants come
// staged by crypto3_fil_proofs_torch/ops/poseidon_torch.py as one flat
// Montgomery buffer [rc | mds | sp | d_last | tag] (the layout of
// `_staged`, pallas/poseidon.py:315, in 32-bit limbs), which the kernels
// copy into shared memory.
//
// `permute` takes the S-box as a function object, called as box(x, slot)
// on each S-box input x in turn, where `slot` counts the values recorded
// before it (three per S-box: x^2, x^4, x^5, the gadget's allocation
// order). K2's Sbox5 only raises x to the fifth power; K7's recorder
// also stores x^2, x^4 and x^5 at their slots.
//
// Compiles on the host with FIELD_HOST_TEST (tests/test_torch_field_host.py):
// define uint4 and the load_elem / store_elem of field.cuh first.
#pragma once

#include <cstddef>

#include "field.cuh"

constexpr int L = Fr::N;  // limbs per element

// threads per block and blocks per SM: the registers of t x 8 limbs of
// state and the shared memory of the constants and the row slices
// decide. At t = 9 and 12 one block fills an SM's shared memory. Arity
// 11 ran faster at 256 threads (up to 255 registers) than at 384 (168
// registers and a few spills); PERF.md has the times.
template <int T>
struct Shape;
template <>
struct Shape<3> {
  static constexpr int threads = 256, blocks = 2;
};
template <>
struct Shape<9> {
  static constexpr int threads = 384, blocks = 1;
};
template <>
struct Shape<12> {
  static constexpr int threads = 256, blocks = 1;
};

// 32-bit words of the staged constants of width T
template <int T>
inline int const_words(int r_f, int r_p) {
  return ((r_f + r_p) * T + 2 * T * T + r_p * (2 * T - 1) + 1) * L;
}

// dynamic shared memory of a block: the constants and, above t = 3, a
// row slice of T elements per thread
template <int T>
inline size_t shared_bytes(int n_words, int threads) {
  return (size_t)n_words * 4 + (T > 3 ? (size_t)T * L * 4 * threads : 0);
}

#ifndef FIELD_HOST_TEST
#include <atomic>

constexpr int MAX_CARDS = 64;

// The blocks of `threads` threads of `kernel` that the current card holds
// at once with `shmem` bytes of dynamic shared memory each, after raising
// the kernel's limit to `shmem`. The limit and the count belong to a card:
// `cache` keeps each card's count, 0 until the kernel's first launch there.
template <class Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t shmem,
                                   std::atomic<int> (&cache)[MAX_CARDS], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_CARDS) return cudaErrorInvalidDevice;
  if (cache[dev].load() == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev].store(sms * per_sm);
  }
  *blocks = cache[dev].load();
  return cudaSuccess;
}
#endif

__device__ __forceinline__ void load_shared(uint32_t r[L], const uint32_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void sbox(uint32_t x[L]) {
  uint32_t x2[L], x4[L];
  mont_mul<Fr>(x2, x, x);
  mont_mul<Fr>(x4, x2, x2);
  mont_mul<Fr>(x, x4, x);
}

// K2's S-box: x^5, nothing recorded
struct Sbox5 {
  __device__ __forceinline__ void operator()(uint32_t x[L], int) const { sbox(x); }
};

// r = sum_j s_j c_j / R mod p over the n constants at c (one REDC)
template <int T>
__device__ __forceinline__ void dot_row(uint32_t r[L], const uint32_t s[T][L], const uint32_t* c) {
  uint32_t acc[2 * L], w[2 * L], k[L], top = 0;
  load_shared(k, c);
  mul_wide<L>(acc, s[0], k);
#pragma unroll
  for (int j = 1; j < T; j++) {
    load_shared(k, c + j * L);
    mul_wide<L>(w, s[j], k);
    add_wide<L>(acc, top, w);
  }
  // below p + 1 + t p (p / R) < 8p for t <= 12
  reduce<Fr, 3>(r, redc<Fr>(r, acc, top));
}

// s = M s for a dense t x t Montgomery matrix M (row-major, in shared
// memory). Rows wait in `rows` (T x 8 words, stride `step` between words).
template <int T>
__device__ __forceinline__ void mix(uint32_t s[T][L], const uint32_t* m, uint32_t* rows, int step) {
  if constexpr (T <= 3) {
    uint32_t out[T][L];
#pragma unroll
    for (int i = 0; i < T; i++) dot_row<T>(out[i], s, m + i * T * L);
#pragma unroll
    for (int i = 0; i < T; i++)
#pragma unroll
      for (int k = 0; k < L; k++) s[i][k] = out[i][k];
  } else {
#pragma unroll 1
    for (int i = 0; i < T; i++) {
      uint32_t r[L];
      dot_row<T>(r, s, m + i * T * L);
#pragma unroll
      for (int k = 0; k < L; k++) rows[(i * L + k) * step] = r[k];
    }
#pragma unroll
    for (int i = 0; i < T; i++)
#pragma unroll
      for (int k = 0; k < L; k++) s[i][k] = rows[(i * L + k) * step];
  }
}

// ARC with c' + x^5 on element 0 + the sparse mix of one partial round.
// sp row: [m00, v_0 .. v_{t-2}, w_0 .. w_{t-2}].
template <int T, class Box>
__device__ __forceinline__ void partial_round(uint32_t s[T][L], const uint32_t* rc, const uint32_t* sp,
                                              const Box& box, int slot) {
  uint32_t c[L];
#pragma unroll
  for (int e = 0; e < T; e++) {
    load_shared(c, rc + e * L);
    add_mod<Fr>(s[e], s[e], c);
  }
  box(s[0], slot);
  uint32_t out0[L];
  dot_row<T>(out0, s, sp);
  // x_e + w_e x0: x_e enters the high half of the wide product, so one
  // REDC leaves it below p + 1 + p + p (p / R) < 4p
#pragma unroll
  for (int e = 1; e < T; e++) {
    uint32_t w[2 * L];
    load_shared(c, sp + (T + e - 1) * L);
    mul_wide<L>(w, s[0], c);
    w[L] = add_cc(w[L], s[e][0]);
#pragma unroll
    for (int k = 1; k < L; k++) w[L + k] = addc_cc(w[L + k], s[e][k]);
    const uint32_t top = addc(0, 0);
    reduce<Fr, 2>(s[e], redc<Fr>(s[e], w, top));
  }
#pragma unroll
  for (int k = 0; k < L; k++) s[0][k] = out0[k];
}

// ARC and x^5 on every element of a full round, element e's S-box at
// slot + 3e. Above t = 3 the elements pass through the row slice, so that
// one copy of the x^5 code serves all.
template <int T, class Box>
__device__ __forceinline__ void full_sbox(uint32_t s[T][L], const uint32_t* rc, uint32_t* rows, int step,
                                          const Box& box, int slot) {
  if constexpr (T <= 3) {
#pragma unroll
    for (int e = 0; e < T; e++) {
      uint32_t c[L];
      load_shared(c, rc + e * L);
      add_mod<Fr>(s[e], s[e], c);
      box(s[e], slot + 3 * e);
    }
  } else {
#pragma unroll
    for (int e = 0; e < T; e++)
#pragma unroll
      for (int k = 0; k < L; k++) rows[(e * L + k) * step] = s[e][k];
#pragma unroll 1
    for (int e = 0; e < T; e++) {
      uint32_t x[L], c[L];
#pragma unroll
      for (int k = 0; k < L; k++) x[k] = rows[(e * L + k) * step];
      load_shared(c, rc + e * L);
      add_mod<Fr>(x, x, c);
      box(x, slot + 3 * e);
#pragma unroll
      for (int k = 0; k < L; k++) rows[(e * L + k) * step] = x[k];
    }
#pragma unroll
    for (int e = 0; e < T; e++)
#pragma unroll
      for (int k = 0; k < L; k++) s[e][k] = rows[(e * L + k) * step];
  }
}

// state = [tag, the T - 1 preimage elements at pre]; the tag is the
// last element of the staged constants
template <int T>
__device__ __forceinline__ void load_state(uint32_t s[T][L], const uint32_t* tag, const uint32_t* pre) {
  load_shared(s[0], tag);
#pragma unroll
  for (int e = 1; e < T; e++) load_elem<L>(s[e], pre + (e - 1) * L);
}

// The permutation of s under the staged constants at sc (in shared
// memory): steps 0..rounds are the full and partial rounds in order, with
// the d_last mix as the extra step between the partial rounds and the
// second half of the full rounds. One call site per mix keeps the code to
// a single copy of the t x t mix.
template <int T, class Box>
__device__ __forceinline__ void permute(uint32_t s[T][L], const uint32_t* sc, uint32_t* rows, int step, int r_f,
                                        int r_p, const Box& box) {
  const int rounds = r_f + r_p;
  const int half = r_f / 2;
  const uint32_t* rc = sc;
  const uint32_t* mds = rc + rounds * T * L;
  const uint32_t* sp = mds + T * T * L;
  const uint32_t* dl = sp + r_p * (2 * T - 1) * L;
#pragma unroll 1
  for (int step_i = 0; step_i <= rounds; step_i++) {
    if (step_i >= half && step_i < half + r_p) {
      partial_round<T>(s, rc + step_i * T * L, sp + (step_i - half) * (2 * T - 1) * L, box,
                       3 * (T * half + step_i - half));
      continue;
    }
    const bool d_last = step_i == half + r_p;
    if (!d_last) {
      const int r = step_i < half ? step_i : step_i - 1;
      // before full round r: T S-boxes per earlier full round, one per partial round
      full_sbox<T>(s, rc + r * T * L, rows, step, box, 3 * (r < half ? T * r : T * (r - r_p) + r_p));
    }
    mix<T>(s, d_last ? dl : mds, rows, step);
  }
}

// K7's S-box: x^5, storing x^2, x^4 and x^5 in plain form at slots slot,
// slot + 1 and slot + 2 of `out`, `stride` words apart. Plain form is one
// REDC against 1 (the low half's reduction alone): for x < p it is
// (x + m p) / R < p + 1, and equal to p only where x = 0, which gives 0;
// so it is canonical with no final subtraction.
struct Record {
  uint32_t* out;
  long long stride;

  __device__ __forceinline__ void store(int slot, const uint32_t x[L]) const {
    uint32_t plain[L];
    redc_low<Fr>(plain, x);
    store_elem<L>(out + slot * stride, plain);
  }

  __device__ __forceinline__ void operator()(uint32_t x[L], int slot) const {
    uint32_t x2[L], x4[L];
    mont_mul<Fr>(x2, x, x);
    store(slot, x2);
    mont_mul<Fr>(x4, x2, x2);
    store(slot + 1, x4);
    mont_mul<Fr>(x, x4, x);
    store(slot + 2, x);
  }
};

// K7's work for one instance: the permutation of [tag, the preimage at
// pre] recording every S-box, then the digest (state[1]) in plain form at
// the last of the R_F t 3 + R_P 3 + 1 slots. `out` is the instance's
// first slot.
template <int T>
__device__ __forceinline__ void witness_one(const uint32_t* pre, uint32_t* out, long long stride,
                                            const uint32_t* sc, const uint32_t* tag, uint32_t* rows, int step,
                                            int r_f, int r_p) {
  uint32_t s[T][L];
  load_state<T>(s, tag, pre);
  const Record rec{out, stride};
  permute<T>(s, sc, rows, step, r_f, r_p, rec);
  rec.store(3 * (r_f * T + r_p), s[1]);
}
