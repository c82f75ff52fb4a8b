// BLS12-381 G2 on two threads per point: the layout of kernel K5
// (csrc/g2.cu). Thread k of a pair (k = threadIdx.x & 1) holds
// coefficient k of every Fq2 coordinate, so each thread carries twelve
// words per temporary, as a G1 thread does, and a lane's serial path
// through an Fq2 product is one of its two balanced halves
// (field.cuh's fq2_mul_half / fq2_sqr_half): one Montgomery pass over
// two products, not three wide products and two REDCs.
//
// The coordinate type fq2h_t has the overloads that curve.cuh's formulas
// call (f_mul, f_sqr, f_add, f_sub, f_is_zero, f_set_one, f_set_zero),
// so jac_dbl / jac_madd_nodbl / jac_add instantiated on it are the pair
// formulas, inline, with the edge semantics of curve.cuh:
//   - f_mul / f_sqr take the partner's coefficients by 12 shuffles per
//     operand, then compute their own half;
//   - f_add / f_sub act on the thread's own coefficient;
//   - f_is_zero combines both coefficients across the pair, so every
//     branch of the formulas is taken by both threads of a pair together:
//     neighbouring pairs of a warp may diverge, the two threads of a pair
//     never do. Every exchange names the pair's own mask, never the
//     warp's.
//
// Memory layout: points stay [N, 3 | 2, 2, 12] 32-bit words; thread k
// reads and writes coefficient k of each coordinate, 48 bytes at a
// 96-byte stride (three aligned 16-byte vectors).
//
// With FIELD_HOST_TEST the pair's exchanges are the host harness's
// (pair_parity, pair_swap, pair_all), which runs the two threads of a
// pair as two host threads: tests/test_torch_field_host.py.
#pragma once

#include "curve.cuh"

struct alignas(16) fq2h_t {
  fq_t v;  // this thread's coefficient
};

#ifndef FIELD_HOST_TEST
__device__ __forceinline__ uint32_t pair_parity() { return threadIdx.x & 1u; }

__device__ __forceinline__ unsigned pair_mask() { return 0x3u << (threadIdx.x & 30u); }

// the partner's coefficient
__device__ __forceinline__ fq_t pair_swap(const fq_t& a) {
  const unsigned m = pair_mask();
  fq_t r;
#pragma unroll
  for (int j = 0; j < 12; j++) r.v[j] = __shfl_xor_sync(m, a.v[j], 1);
  return r;
}

// b on both threads of the pair
__device__ __forceinline__ bool pair_all(bool b) { return __all_sync(pair_mask(), b); }
#else
uint32_t pair_parity();
fq_t pair_swap(const fq_t& a);
bool pair_all(bool b);
#endif

__device__ __forceinline__ fq2h_t f_mul(const fq2h_t& a, const fq2h_t& b) {
  const fq_t ao = pair_swap(a.v), bo = pair_swap(b.v);
  fq2h_t r;
  fq2_mul_half(r.v.v, pair_parity(), a.v.v, b.v.v, ao.v, bo.v);
  return r;
}

__device__ __forceinline__ fq2h_t f_sqr(const fq2h_t& a) {
  const fq_t ao = pair_swap(a.v);
  fq2h_t r;
  fq2_sqr_half(r.v.v, pair_parity(), a.v.v, ao.v);
  return r;
}

__device__ __forceinline__ fq2h_t f_add(const fq2h_t& a, const fq2h_t& b) { return {f_add(a.v, b.v)}; }

__device__ __forceinline__ fq2h_t f_sub(const fq2h_t& a, const fq2h_t& b) { return {f_sub(a.v, b.v)}; }

__device__ __forceinline__ bool f_is_zero(const fq2h_t& a) { return pair_all(f_is_zero(a.v)); }

// one = 1 + 0 u: R on thread 0, zero on thread 1
__device__ __forceinline__ void f_set_one(fq2h_t& r) {
  const uint32_t keep = pair_parity() - 1;
#pragma unroll
  for (int j = 0; j < 12; j++) r.v.v[j] = FQ_ONE[j] & keep;
}

__device__ __forceinline__ void f_set_zero(fq2h_t& r) { f_set_zero(r.v); }

// --- one lane's operations, as thread k of its pair -------------------------
//
// Words of lane i's coefficient k of coordinate c: Jacobian points at
// 72 i + 24 c + 12 k, affine points at 48 i + 24 c + 12 k.

__device__ __forceinline__ Jac<fq2h_t> ld_jac_half(const uint32_t* p, long long i, uint32_t k) {
  const uint32_t* w = p + 72 * i + 12 * k;
  return {{ld<fq_t>(w)}, {ld<fq_t>(w + 24)}, {ld<fq_t>(w + 48)}};
}

__device__ __forceinline__ Aff<fq2h_t> ld_aff_half(const uint32_t* p, long long i, uint32_t k) {
  const uint32_t* w = p + 48 * i + 12 * k;
  return {{ld<fq_t>(w)}, {ld<fq_t>(w + 24)}};
}

__device__ __forceinline__ void st_jac_half(uint32_t* p, long long i, uint32_t k, const Jac<fq2h_t>& r) {
  uint32_t* w = p + 72 * i + 12 * k;
  st(w, r.X.v);
  st(w + 24, r.Y.v);
  st(w + 48, r.Z.v);
}

__device__ __forceinline__ void pair_madd_nodbl(const uint32_t* acc, const uint32_t* q, const uint8_t* valid,
                                                uint32_t* out, uint8_t* same, long long i) {
  const uint32_t k = pair_parity();
  bool s;
  const Jac<fq2h_t> r = jac_madd_nodbl(ld_jac_half(acc, i, k), ld_aff_half(q, i, k), valid[i] != 0, s);
  st_jac_half(out, i, k, r);
  if (k == 0) same[i] = s;
}

__device__ __forceinline__ void pair_dbl(const uint32_t* p, const uint8_t* mask, uint32_t* out, long long i) {
  const uint32_t k = pair_parity();
  const Jac<fq2h_t> a = ld_jac_half(p, i, k);
  st_jac_half(out, i, k, mask[i] ? jac_dbl(a) : a);
}

__device__ __forceinline__ void pair_add(const uint32_t* p, const uint32_t* q, uint32_t* out, long long i) {
  const uint32_t k = pair_parity();
  st_jac_half(out, i, k, jac_add(ld_jac_half(p, i, k), ld_jac_half(q, i, k)));
}
