// Kernel K7's permutation split over a group of T lanes of one warp: lane
// e of a group holds element e of its instance's state (8 limbs), and the
// lanes exchange elements with warp shuffles. The schedule, the staged
// constants (K2's buffer, csrc/poseidon.cuh) and the recorded values are
// those of `witness_one`; only the work is spread:
//   full round:    each lane ARC and x^5 on its own element, recording at
//                  slot + 3e; the dense mix gathers the t elements by
//                  shuffles and each lane sums its own row (t wide
//                  products, one REDC), as dot_row does;
//   partial round: x^5 on element 0 (every lane runs the S-box on its own
//                  element, so that the warp never diverges; lane 0's
//                  counts), x0 broadcast to the group, then in one pass
//                  lane e >= 1 forms w_{e-1} x0 + x_e (one wide product)
//                  while out0 = m00 x0 + sum v_j x_{j+1} is one wide
//                  product per lane and a tree sum of the wide values over
//                  the group (ceil(log2 t) shuffle steps), reduced in lane
//                  0: one REDC per lane for both.
// t = 3, 9, 12 give 10, 3 and 2 groups a warp; the warp's spare lanes run
// the same code on a dummy instance and store nothing. Shuffles name
// absolute source lanes (group base + j) or go down by an offset inside
// the group: the shuffles' power-of-two `width` does not fit t.
//
// Compiles on the host with FIELD_HOST_TEST (tests/test_torch_field_host.py):
// define shfl_elem and shfl_down_words (below) first, over emulated lanes.
#pragma once

#include "poseidon.cuh"

constexpr int WARP = 32;

#ifndef FIELD_HOST_TEST
// r = element x of lane `src` of this warp; every lane of the warp calls it
__device__ __forceinline__ void shfl_elem(uint32_t r[L], const uint32_t x[L], int src) {
#pragma unroll
  for (int k = 0; k < L; k++) r[k] = __shfl_sync(0xffffffffu, x[k], src);
}

// r = the W words x of lane (this lane + off), or this lane's own past the warp
template <int W>
__device__ __forceinline__ void shfl_down_words(uint32_t r[W], const uint32_t x[W], int off) {
#pragma unroll
  for (int k = 0; k < W; k++) r[k] = __shfl_down_sync(0xffffffffu, x[k], off);
}
#endif

// K7's recorder for one lane: x^2, x^4 and x^5 in plain form at slots
// slot, slot + 1 and slot + 2 of the instance's values at `out`
// ([n_int, 8] words), stored where `keep`. Apart from poseidon.cuh's
// `Record`: that one with this predicate made the one-thread kernel
// 1.4-2.2x slower on batches of 16,384 and more (kernel_times.py --sweep,
// PERF.md).
struct LaneRecord {
  uint32_t* out;

  __device__ __forceinline__ void store(int slot, const uint32_t x[L], bool keep) const {
    uint32_t plain[L];
    redc_low<Fr>(plain, x);
    if (keep) store_elem<L>(out + slot * L, plain);
  }

  __device__ __forceinline__ void sbox(uint32_t x[L], int slot, bool keep) const {
    uint32_t x2[L], x4[L];
    mont_mul<Fr>(x2, x, x);
    store(slot, x2, keep);
    mont_mul<Fr>(x4, x2, x2);
    store(slot + 1, x4, keep);
    mont_mul<Fr>(x, x4, x);
    store(slot + 2, x, keep);
  }
};

// (acc[2L]:acc) += (o[2L]:o), a wide value with its carry limb
__device__ __forceinline__ void add_wide_top(uint32_t acc[2 * L + 1], const uint32_t o[2 * L + 1]) {
  add_wide<L>(acc, acc[2 * L], o);
  acc[2 * L] += o[2 * L];
}

// the group's wide values summed into lane 0 (e is the lane's place in its
// group): steps 1, 2, 4, 8 down, each lane adding its partner's while the
// partner lies inside the group
template <int T>
__device__ __forceinline__ void group_sum(uint32_t acc[2 * L + 1], int e) {
#pragma unroll
  for (int off = 1; off < T; off *= 2) {
    uint32_t o[2 * L + 1];
    shfl_down_words<2 * L + 1>(o, acc, off);
    const bool in = e + off < T;
#pragma unroll
    for (int k = 0; k <= 2 * L; k++) o[k] = in ? o[k] : 0;
    add_wide_top(acc, o);
  }
}

// s = row . (the group's state) for this lane's row of a dense t x t
// Montgomery matrix (in shared memory): the elements gathered one by one
// from lanes base .. base + T - 1, summed wide, one REDC; below 8p before
// the final reduction, as in dot_row
template <int T>
__device__ __forceinline__ void group_mix(uint32_t s[L], int base, const uint32_t* row) {
  uint32_t acc[2 * L + 1];
#pragma unroll
  for (int k = 0; k <= 2 * L; k++) acc[k] = 0;
#pragma unroll 3
  for (int j = 0; j < T; j++) {
    uint32_t x[L], c[L], w[2 * L];
    shfl_elem(x, s, base + j);
    load_shared(c, row + j * L);
    mul_wide<L>(w, x, c);
    add_wide<L>(acc, acc[2 * L], w);
  }
  reduce<Fr, 3>(s, redc<Fr>(s, acc, acc[2 * L]));
}

// ARC with c', x^5 on element 0 and the sparse mix of one partial round,
// for lane e of the group at `base`. sp row: [m00, v_0 .. v_{t-2},
// w_0 .. w_{t-2}], so lane e's term of out0 has its constant at sp + e.
template <int T>
__device__ __forceinline__ void group_partial_round(uint32_t s[L], int e, int base, const uint32_t* rc,
                                                    const uint32_t* sp, const LaneRecord& rec, bool live,
                                                    int slot) {
  uint32_t c[L], x[L];
  load_shared(c, rc + e * L);
  add_mod<Fr>(s, s, c);
#pragma unroll
  for (int k = 0; k < L; k++) x[k] = s[k];
  rec.sbox(x, slot, live && e == 0);
#pragma unroll
  for (int k = 0; k < L; k++) s[k] = e == 0 ? x[k] : s[k];
  uint32_t x0[L];
  shfl_elem(x0, s, base);
  // out0's term: m00 x0 in lane 0, v_{e-1} x_e in lane e; summed into lane 0
  uint32_t acc[2 * L + 1];
  load_shared(c, sp + e * L);
  mul_wide<L>(acc, s, c);
  acc[2 * L] = 0;
  group_sum<T>(acc, e);
  // w_{e-1} x0 + x_e: x_e enters the high half, so one REDC leaves it
  // below p + 1 + p + p (p / R) < 4p (lane 0 computes one it drops)
  uint32_t w[2 * L];
  load_shared(c, sp + (T + (e > 0 ? e - 1 : 0)) * L);
  mul_wide<L>(w, x0, c);
  w[L] = add_cc(w[L], s[0]);
#pragma unroll
  for (int k = 1; k < L; k++) w[L + k] = addc_cc(w[L + k], s[k]);
  const uint32_t top = addc(0, 0);
#pragma unroll
  for (int k = 0; k < 2 * L; k++) w[k] = e == 0 ? acc[k] : w[k];
  reduce<Fr, 3>(s, redc<Fr>(s, w, e == 0 ? acc[2 * L] : top));
}

// K7's work for one warp: instances first .. first + WARP / T - 1 (those
// below n), group g on instance first + g. Every lane of the warp calls
// it (`lane` 0..31). The values of instance i go to out + i n_int 8, in
// the gadget's allocation order, each stored by the lane that holds its
// element; the digest (state[1]) by lane 1. `tag` is the last element of
// the staged constants at sc.
template <int T>
__device__ __forceinline__ void witness_warp(int lane, long long first, long long n, const uint32_t* pre,
                                             uint32_t* out, const uint32_t* sc, const uint32_t* tag, int r_f,
                                             int r_p) {
  constexpr int G = WARP / T;
  const int g = lane / T, e = lane - g * T, base = g * T;
  const long long i = first + g;
  const bool live = g < G && i < n;
  const int n_int = 3 * (r_f * T + r_p) + 1;
  const LaneRecord rec{out + (live ? i : 0) * n_int * L};
  uint32_t s[L];
  if (e == 0) {
    load_shared(s, tag);
  } else if (live) {
    load_elem<L>(s, pre + (i * (T - 1) + e - 1) * L);
  } else {
#pragma unroll
    for (int k = 0; k < L; k++) s[k] = 0;
  }
  const int rounds = r_f + r_p, half = r_f / 2;
  const uint32_t* rc = sc;
  const uint32_t* mds = rc + rounds * T * L;
  const uint32_t* sp = mds + T * T * L;
  const uint32_t* dl = sp + r_p * (2 * T - 1) * L;
  // the steps of `permute`: full rounds, partial rounds, the d_last mix,
  // full rounds
#pragma unroll 1
  for (int step = 0; step <= rounds; step++) {
    if (step >= half && step < half + r_p) {
      group_partial_round<T>(s, e, base, rc + step * T * L, sp + (step - half) * (2 * T - 1) * L, rec, live,
                             3 * (T * half + step - half));
      continue;
    }
    const bool d_last = step == half + r_p;
    if (!d_last) {
      const int r = step < half ? step : step - 1;
      uint32_t c[L];
      load_shared(c, rc + (r * T + e) * L);
      add_mod<Fr>(s, s, c);
      rec.sbox(s, 3 * (r < half ? T * r : T * (r - r_p) + r_p) + 3 * e, live);
    }
    group_mix<T>(s, base, (d_last ? dl : mds) + e * T * L);
  }
  rec.store(n_int - 1, s, live && e == 1);
}
