// BLS12-381 field arithmetic for Hopper: Fr (8 x 32-bit limbs) and Fq
// (12 x 32-bit limbs), little-endian limbs, Montgomery radix 2^256 / 2^384.
//
// These device functions replace the TPU field layer of
// crypto3_fil_proofs_tpu/ops/pallas/field.py: `_montmul_tiles` (:44,
// CIOS over 16-bit limbs in u32 lanes), `_add_tiles` / `_sub_tiles` and
// `_sub_if_ge_tiles`, and their list forms `l_montmul` / `l_add` /
// `l_sub` / `l_sub_if_ge`; and the lazy reductions of
// ops/pallas/poseidon.py (`_acc_mul_const` :95, `_redc_wide` :121). The
// TPU has no 32x32->64 multiply, so the JAX package splits elements into
// 16-bit limbs; here limbs are 32 bits wide. The radix is the same (2^256
// for Fr, 2^384 for Fq), so Montgomery values are bit-identical to the
// JAX package's: only the limb width differs.
//
// Every product is a chain of PTX carry instructions, mad.lo.cc.u32 /
// madc.hi.cc.u32 / addc.cc.u32, with no 64-bit C arithmetic. It comes in
// pieces that the kernels combine:
//   mul_wide     a * b as 2N limbs, unreduced;
//   add_wide     a 2N-limb sum (with a carry limb) of such products;
//   redc         one Montgomery reduction of a wide value T < 2^(32N) p k:
//                T / 2^(32N) mod p, below (k + 1) p, not yet canonical;
//   reduce<K>    the final reduction of a value below 2^K p to [0, p);
//   mont_mul     the product and its reduction interleaved (CIOS) and one
//                conditional subtraction: canonical in, canonical out;
//   mont_mul_sum2  a b + c d in one CIOS pass: the halves of an Fq2
//                product that a pair of threads computes (fq2_mul_half).
// REDC here reduces the low half L of T = H 2^(32N) + L on its own, one
// limb at a time over an N-limb window (Q = (L + m p) / 2^(32N) <= p),
// and then adds the high half H: T / 2^(32N) = Q + H mod p exactly.
// Every product is emitted as (lo, hi) pairs on even/odd accumulators
// (below), the layout that lets ptxas fuse each pair into one wide
// multiply-add; PERF.md has the kernels' times against the 64-bit C
// product they replace.
//
// INV is -p^-1 mod 2^32. It differs from the 16-bit constant of the JAX
// package (fr_limbs.py:62, -p^-1 mod 2^16) for Fq: 0xfffcfffd here,
// 0xfffd there. tests/test_torch_field.py checks the tables below, and
// tests/test_torch_field_host.py compiles this header on the host (with
// FIELD_HOST_TEST, the carry instructions emulated in C) and holds every
// piece against Python integers.
#pragma once

#include <cstdint>

#ifdef FIELD_HOST_TEST
#define __device__
#define __forceinline__ inline
#endif

// --- carry-chain primitives ------------------------------------------------
//
// Each is one PTX instruction. `volatile` keeps them in program order, so
// the condition code that carries from one to the next is never
// separated from its chain by another carry instruction; ptxas schedules
// the machine code by its real dependencies.

#ifndef FIELD_HOST_TEST
#define CC_OP2(name, ins)                                                        \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {             \
    uint32_t r;                                                                  \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                 \
    return r;                                                                    \
  }
#define CC_OP3(name, ins)                                                        \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                                  \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));     \
    return r;                                                                    \
  }
CC_OP2(add_cc, "add.cc.u32")
CC_OP2(addc_cc, "addc.cc.u32")
CC_OP2(addc, "addc.u32")
CC_OP2(sub_cc, "sub.cc.u32")
CC_OP2(subc_cc, "subc.cc.u32")
CC_OP2(subc, "subc.u32")
CC_OP3(mad_lo_cc, "mad.lo.cc.u32")
CC_OP3(madc_lo_cc, "madc.lo.cc.u32")
CC_OP3(mad_hi_cc, "mad.hi.cc.u32")
CC_OP3(madc_hi_cc, "madc.hi.cc.u32")
CC_OP3(madc_hi, "madc.hi.u32")
#undef CC_OP2
#undef CC_OP3
#else
// The same instructions in C over one carry flag, for the host test.
static thread_local uint32_t field_cc;
inline uint32_t cc_set(uint64_t s) { field_cc = (uint32_t)(s >> 32) & 1u; return (uint32_t)s; }
inline uint32_t lo32(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
inline uint32_t hi32(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b + field_cc); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + field_cc; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { field_cc = a < b; return a - b; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  const uint32_t r = a - b - field_cc;
  field_cc = (uint64_t)a < (uint64_t)b + field_cc;
  return r;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - field_cc; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return cc_set((uint64_t)lo32(a, b) + c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)lo32(a, b) + c + field_cc);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return cc_set((uint64_t)hi32(a, b) + c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_set((uint64_t)hi32(a, b) + c + field_cc);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return hi32(a, b) + c + field_cc; }
#endif

// --- the two fields ----------------------------------------------------------
//
// p, 2p, 4p and 8p, limb by limb (the top limb N is the carry of the
// multiple), in the constant bank: with the loops unrolled every index
// is a constant, so each limb reaches its instruction as a constant-bank
// operand and takes no register.

#ifdef FIELD_HOST_TEST
#define __constant__
#endif
static __constant__ uint32_t FR_PM[4][9] = {
    {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u, 0x00000000u},
    {0x00000002u, 0xfffffffeu, 0xfffcb7fdu, 0xa77b4805u, 0x1343b00au, 0x6673b010u, 0x533afa90u, 0xe7db4ea6u, 0x00000000u},
    {0x00000004u, 0xfffffffcu, 0xfff96ffbu, 0x4ef6900bu, 0x26876015u, 0xcce76020u, 0xa675f520u, 0xcfb69d4cu, 0x00000001u},
    {0x00000008u, 0xfffffff8u, 0xfff2dff7u, 0x9ded2017u, 0x4d0ec02au, 0x99cec040u, 0x4cebea41u, 0x9f6d3a99u, 0x00000003u},
};
static __constant__ uint32_t FQ_PM[4][13] = {
    {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau, 0x00000000u},
    {0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u, 0x00000000u},
    {0xfffeaaacu, 0xe7fbffffu, 0xc54ffffeu, 0x7aaffffau, 0xdac3d890u, 0x9cc34a83u, 0xce144afdu, 0x91dd2e13u, 0x0d2eb35du, 0x2c6e9ed9u, 0xe5ff9a69u, 0x680447a8u, 0x00000000u},
    {0xfffd5558u, 0xcff7ffffu, 0x8a9ffffdu, 0xf55ffff5u, 0xb587b120u, 0x39869507u, 0x9c2895fbu, 0x23ba5c27u, 0x1a5d66bbu, 0x58dd3db2u, 0xcbff34d2u, 0xd0088f51u, 0x00000000u},
};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;
  // limb j of 2^k p
  __device__ __forceinline__ static uint32_t pm(int k, int j) { return FR_PM[k][j]; }
  __device__ __forceinline__ static uint32_t p(int j) { return FR_PM[0][j]; }
};

struct Fq {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;
  __device__ __forceinline__ static uint32_t pm(int k, int j) { return FQ_PM[k][j]; }
  __device__ __forceinline__ static uint32_t p(int j) { return FQ_PM[0][j]; }
};

// --- reductions ----------------------------------------------------------------

// (hi:x) -= 2^K p where (hi:x) >= 2^K p.
template <class F, int K>
__device__ __forceinline__ void sub_mult_if_ge(uint32_t x[F::N], uint32_t& hi) {
  constexpr int N = F::N;
  uint32_t d[N];
  d[0] = sub_cc(x[0], F::pm(K, 0));
#pragma unroll
  for (int j = 1; j < N; j++) d[j] = subc_cc(x[j], F::pm(K, j));
  const uint32_t dh = subc_cc(hi, F::pm(K, N));
  const bool ge = subc(0, 0) == 0;  // no borrow out of the top limb
#pragma unroll
  for (int j = 0; j < N; j++) x[j] = ge ? d[j] : x[j];
  hi = ge ? dh : hi;
}

// x <- (hi:x) mod p for (hi:x) < 2^K p: K conditional subtractions of
// 2^(K-1) p, ..., 2p, p.
template <class F, int K>
__device__ __forceinline__ void reduce(uint32_t x[F::N], uint32_t hi) {
  if (K >= 4) sub_mult_if_ge<F, 3>(x, hi);
  if (K >= 3) sub_mult_if_ge<F, 2>(x, hi);
  if (K >= 2) sub_mult_if_ge<F, 1>(x, hi);
  sub_mult_if_ge<F, 0>(x, hi);
}

// --- modular addition and subtraction ---------------------------------------------

// r = a + b mod p (canonical in and out).
template <class F>
__device__ __forceinline__ void add_mod(uint32_t r[F::N], const uint32_t a[F::N],
                                        const uint32_t b[F::N]) {
  constexpr int N = F::N;
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) r[j] = addc_cc(a[j], b[j]);
  uint32_t hi = addc(0, 0);
  sub_mult_if_ge<F, 0>(r, hi);
}

// r = a - b mod p (canonical in and out).
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t r[F::N], const uint32_t a[F::N],
                                        const uint32_t b[F::N]) {
  constexpr int N = F::N;
  uint32_t d[N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0, 0);  // all ones where a < b: add p back
  r[0] = add_cc(d[0], F::p(0) & mask);
#pragma unroll
  for (int j = 1; j < N; j++) r[j] = addc_cc(d[j], F::p(j) & mask);
}

// --- products on even/odd accumulators -------------------------------------------
//
// A product x_j * bi is added as its (lo, hi) pair to two adjacent limbs,
// one mad.lo.cc / madc.hi.cc pair, which ptxas turns into one wide
// multiply-add. Pairs of the even limbs x_0, x_2, ... land on even
// offsets and those of the odd limbs on odd offsets, so each chain adds
// whole pairs to one accumulator and never two pairs to one limb.

#ifdef FIELD_HOST_TEST
inline uint32_t umulhi32(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
#else
__device__ __forceinline__ uint32_t umulhi32(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#endif

// acc[0..N) = x[0], x[2], ... times bi, as pairs
template <int N>
__device__ __forceinline__ void eo_mul(uint32_t* acc, const uint32_t* x, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = x[j] * bi;
    acc[j + 1] = umulhi32(x[j], bi);
  }
}

// acc[0..N) += x[0], x[2], ... times bi; the carry out stays in CC
template <int N>
__device__ __forceinline__ void eo_cmad(uint32_t* acc, const uint32_t* x, uint32_t bi) {
  acc[0] = mad_lo_cc(x[0], bi, acc[0]);
  acc[1] = madc_hi_cc(x[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(x[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(x[j], bi, acc[j + 1]);
  }
}

// acc[0..N) += p_OFF, p_OFF+2, ... times mi
template <class F, int OFF>
__device__ __forceinline__ void eo_cmad_p(uint32_t* acc, uint32_t mi) {
  acc[0] = mad_lo_cc(F::p(OFF), mi, acc[0]);
  acc[1] = madc_hi_cc(F::p(OFF), mi, acc[1]);
#pragma unroll
  for (int j = 2; j < F::N; j += 2) {
    acc[j] = madc_lo_cc(F::p(OFF + j), mi, acc[j]);
    acc[j + 1] = madc_hi_cc(F::p(OFF + j), mi, acc[j + 1]);
  }
}

// odd[j] = odd[j + 2] + (x[0], x[2], ... times bi)[j], carry in from CC:
// the multiply-add and the two-limb shift of one CIOS step in one chain
template <int N>
__device__ __forceinline__ void eo_madc_rshift(uint32_t* odd, const uint32_t* x, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    odd[j] = madc_lo_cc(x[j], bi, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(x[j], bi, odd[j + 3]);
  }
  odd[N - 2] = madc_lo_cc(x[N - 2], bi, 0);
  odd[N - 1] = madc_hi(x[N - 2], bi, 0);
}

// One CIOS step on the value sum even[j] 2^(32j) + sum odd[j] 2^(32(j+1)):
// add a * bi, then m p with m chosen so that limb 0 vanishes. The roles
// of the two arrays swap from one step to the next (the one-limb shift).
// Both fields leave a spare bit at the top, so the value stays below
// 2^(32N) * 2 and the odd chain's carry out of limb N is 0.
template <class F>
__device__ __forceinline__ void cios_step(uint32_t* even, uint32_t* odd, const uint32_t* a,
                                          uint32_t bi, bool first) {
  constexpr int N = F::N;
  if (first) {
    eo_mul<N>(odd, a + 1, bi);
    eo_mul<N>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    eo_madc_rshift<N>(odd, a + 1, bi);
    eo_cmad<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0);
  }
  const uint32_t mi = even[0] * F::INV;
  eo_cmad_p<F, 1>(odd, mi);
  eo_cmad_p<F, 0>(even, mi);
  odd[N - 1] = addc(odd[N - 1], 0);
}

// w = a * b, 2N limbs, unreduced. Row i adds the even limbs' pairs at
// limb i and the odd limbs' at limb i + 1: pairs at even limbs go to A,
// at odd limbs to B; each chain's carry goes into the limb above it
// (at most 2 there before the next row's chain passes over it).
template <int N>
__device__ __forceinline__ void mul_wide(uint32_t w[2 * N], const uint32_t a[N], const uint32_t b[N]) {
  uint32_t A[2 * N + 2], B[2 * N + 2];
#pragma unroll
  for (int j = 0; j < 2 * N + 2; j++) A[j] = B[j] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint32_t* ev = (i % 2 == 0) ? A + i : B + i;
    uint32_t* od = (i % 2 == 0) ? B + i + 1 : A + i + 1;
    eo_cmad<N>(ev, a, b[i]);
    ev[N] = addc(ev[N], 0);
    eo_cmad<N>(od, a + 1, b[i]);
    od[N] = addc(od[N], 0);
  }
  w[0] = A[0];
  w[1] = add_cc(A[1], B[1]);
#pragma unroll
  for (int j = 2; j < 2 * N - 1; j++) w[j] = addc_cc(A[j], B[j]);
  w[2 * N - 1] = addc(A[2 * N - 1], B[2 * N - 1]);
}

// (top:acc) += w: a 2N-limb sum of products with one carry limb.
template <int N>
__device__ __forceinline__ void add_wide(uint32_t acc[2 * N], uint32_t& top,
                                         const uint32_t w[2 * N]) {
  acc[0] = add_cc(acc[0], w[0]);
#pragma unroll
  for (int j = 1; j < 2 * N; j++) acc[j] = addc_cc(acc[j], w[j]);
  top = addc(top, 0);
}

// The low half's reduction: q = (lo + m p) / 2^(32N) <= p, where m < 2^(32N)
// makes the low N limbs vanish: N steps of cios_step's reduction on
// even/odd windows, each followed by the one-limb shift (a chain of adds).
template <class F>
__device__ __forceinline__ void redc_low(uint32_t q[F::N], const uint32_t lo[F::N]) {
  constexpr int N = F::N;
  uint32_t E[N], O[N];
#pragma unroll
  for (int j = 0; j < N; j++) E[j] = lo[j], O[j] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint32_t* even = (i % 2 == 0) ? E : O;
    uint32_t* odd = (i % 2 == 0) ? O : E;
    const uint32_t mi = even[0] * F::INV;
    eo_cmad_p<F, 1>(odd, mi);
    eo_cmad_p<F, 0>(even, mi);
    odd[N - 1] = addc(odd[N - 1], 0);
    // divide by 2^32: even[0] is 0, even[1] joins odd[0], and even[2..]
    // move down two places to become the next odd window
    odd[0] = add_cc(odd[0], even[1]);
#pragma unroll
    for (int j = 0; j < N - 2; j++) even[j] = addc_cc(even[j + 2], 0);
    even[N - 2] = addc(0, 0);
    even[N - 1] = 0;
  }
  // N is even: the value is sum E[j] 2^(32j) + sum O[j] 2^(32(j+1))
  q[0] = E[0];
  q[1] = add_cc(E[1], O[0]);
#pragma unroll
  for (int j = 2; j < N; j++) q[j] = addc_cc(E[j], O[j - 1]);
}

// r (+ the returned carry limb) = T / 2^(32N) mod p, for T = (top:w),
// as redc_low(low half) + high half. For T < k p^2 it is below
// p + 1 + k p (p / 2^(32N)): reduce<K> finishes it.
template <class F>
__device__ __forceinline__ uint32_t redc(uint32_t r[F::N], const uint32_t w[2 * F::N], uint32_t top) {
  constexpr int N = F::N;
  uint32_t q[N];
  redc_low<F>(q, w);
  r[0] = add_cc(q[0], w[N]);
#pragma unroll
  for (int j = 1; j < N; j++) r[j] = addc_cc(q[j], w[N + j]);
  return addc(top, 0);
}

// r = a * b * 2^(-32N) mod p, canonical in and out: CIOS on even/odd
// accumulators, N steps, then the last shift and one conditional
// subtraction (the result is below 2p). r may alias a or b.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t r[F::N], const uint32_t a[F::N],
                                         const uint32_t b[F::N]) {
  constexpr int N = F::N;
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    cios_step<F>(even, odd, a, b[i], i == 0);
    cios_step<F>(odd, even, a, b[i + 1], false);
  }
  r[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; j++) r[j] = addc_cc(even[j], odd[j + 1]);
  r[N - 1] = addc(even[N - 1], 0);
  uint32_t hi = 0;
  sub_mult_if_ge<F, 0>(r, hi);
}

// cios_step with a second product: add a * bi and c * di, then m p. For
// a, c <= p the value stays below 3p between steps and below 2^(32(N+1))
// within one, so it fits the even/odd windows and every chain's carry
// out of limb N is 0.
template <class F>
__device__ __forceinline__ void cios_step2(uint32_t* even, uint32_t* odd, const uint32_t* a, uint32_t bi,
                                           const uint32_t* c, uint32_t di, bool first) {
  constexpr int N = F::N;
  if (first) {
    eo_mul<N>(odd, a + 1, bi);
    eo_mul<N>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    eo_madc_rshift<N>(odd, a + 1, bi);
    eo_cmad<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0);
  }
  eo_cmad<N>(odd, c + 1, di);
  eo_cmad<N>(even, c, di);
  odd[N - 1] = addc(odd[N - 1], 0);
  const uint32_t mi = even[0] * F::INV;
  eo_cmad_p<F, 1>(odd, mi);
  eo_cmad_p<F, 0>(even, mi);
  odd[N - 1] = addc(odd[N - 1], 0);
}

// r = (a b + c d) 2^(-32N) mod p for a, c <= p and b, d < p: both
// products in one CIOS pass, one reduction. The value ends below
// 2 p^2 / 2^(32N) + p < 1.25 p, so one conditional subtraction makes it
// canonical.
template <class F>
__device__ __forceinline__ void mont_mul_sum2(uint32_t r[F::N], const uint32_t a[F::N], const uint32_t b[F::N],
                                              const uint32_t c[F::N], const uint32_t d[F::N]) {
  constexpr int N = F::N;
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    cios_step2<F>(even, odd, a, b[i], c, d[i], i == 0);
    cios_step2<F>(odd, even, a, b[i + 1], c, d[i + 1], false);
  }
  r[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; j++) r[j] = addc_cc(even[j], odd[j + 1]);
  r[N - 1] = addc(even[N - 1], 0);
  uint32_t hi = 0;
  sub_mult_if_ge<F, 0>(r, hi);
}

// --- Fq2 = Fq[u] / (u^2 + 1) on wide products --------------------------------------
//
// Canonical in and out; r0, r1 may alias the operands.

template <int N>
__device__ __forceinline__ void add_limbs(uint32_t r[N], const uint32_t a[N], const uint32_t b[N]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) r[j] = addc_cc(a[j], b[j]);
}

// a -= b over N limbs; all ones if it borrowed, else 0
template <int N>
__device__ __forceinline__ uint32_t sub_limbs(uint32_t a[N], const uint32_t b[N]) {
  a[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; j++) a[j] = subc_cc(a[j], b[j]);
  return subc(0, 0);
}

// r = T / 2^384 mod p for T < 2^384 p (so the result is below 2p)
__device__ __forceinline__ void redc_fq(uint32_t r[12], const uint32_t w[24]) {
  uint32_t hi = redc<Fq>(r, w, 0);
  sub_mult_if_ge<Fq, 0>(r, hi);
}

// Karatsuba with one reduction per coefficient: c0 = a0 b0 - a1 b1 (plus
// p 2^384 where negative: below p 2^384), c1 = (a0 + a1)(b0 + b1) - a0 b0
// - a1 b1 = a0 b1 + a1 b0 < 2 p^2; the sums a0 + a1 < 2p stay unreduced.
// Three wide products and two REDCs, against three full products.
__device__ __forceinline__ void fq2_mul(uint32_t r0[12], uint32_t r1[12], const uint32_t a0[12],
                                        const uint32_t a1[12], const uint32_t b0[12],
                                        const uint32_t b1[12]) {
  uint32_t sa[12], sb[12], t0[24], t1[24], u[24];
  add_limbs<12>(sa, a0, a1);
  add_limbs<12>(sb, b0, b1);
  mul_wide<12>(t0, a0, b0);
  mul_wide<12>(t1, a1, b1);
  add_limbs<24>(u, t0, t1);
  const uint32_t neg = sub_limbs<24>(t0, t1);
  t0[12] = add_cc(t0[12], Fq::p(0) & neg);
#pragma unroll
  for (int j = 1; j < 12; j++) t0[12 + j] = addc_cc(t0[12 + j], Fq::p(j) & neg);
  mul_wide<12>(t1, sa, sb);
  sub_limbs<24>(t1, u);
  redc_fq(r0, t0);
  redc_fq(r1, t1);
}

// (a0 + a1 u)^2: c0 = (a0 + a1)(a0 - a1 + p) < 4 p^2, c1 = 2 a0 a1 < 2 p^2.
// Two wide products and two REDCs.
__device__ __forceinline__ void fq2_sqr(uint32_t r0[12], uint32_t r1[12], const uint32_t a0[12],
                                        const uint32_t a1[12]) {
  uint32_t s[12], d[12], t0[24], t1[24];
  add_limbs<12>(s, a0, a1);
  // a0 - a1 + p, in (0, 2p)
  d[0] = sub_cc(a0[0], a1[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) d[j] = subc_cc(a0[j], a1[j]);
  d[0] = add_cc(d[0], Fq::p(0));
#pragma unroll
  for (int j = 1; j < 12; j++) d[j] = addc_cc(d[j], Fq::p(j));
  mul_wide<12>(t1, a0, a1);
  // double t1 (below 2^768)
#pragma unroll
  for (int j = 23; j > 0; j--) t1[j] = (t1[j] << 1) | (t1[j - 1] >> 31);
  t1[0] <<= 1;
  mul_wide<12>(t0, s, d);
  redc_fq(r0, t0);
  redc_fq(r1, t1);
}

// --- Fq2 split over a pair of threads -----------------------------------------------
//
// Thread `parity` k of a pair holds coefficient k of every element (self)
// and has been handed its partner's (other); it computes coefficient k of
// the result, with the same instructions on both threads (the parity
// selects operands, never a branch), so a warp of pairs never diverges
// here. Each half is one Montgomery pass (CIOS) that keeps 24 words of
// accumulator, not the wide products and REDC of fq2_mul, which held
// some 100 words live. The outputs are canonical: they equal fq2_mul /
// fq2_sqr's bits.

// Coefficient `parity` of (a0 + a1 u)(b0 + b1 u). Thread 0:
// c0 = a0 b0 + (p - a1) b1, which is a0 b0 - a1 b1 mod p with no negative
// value to correct; thread 1: c1 = a1 b0 + a0 b1. Both below 2 p^2, one
// mont_mul_sum2 whose multiplicands are a_self and a value of the
// partner's a, and whose multipliers, taken a limb at a time, are b's.
__device__ __forceinline__ void fq2_mul_half(uint32_t r[12], uint32_t parity, const uint32_t a_self[12],
                                             const uint32_t b_self[12], const uint32_t a_other[12],
                                             const uint32_t b_other[12]) {
  uint32_t u[12], y[12], v[12];
  u[0] = sub_cc(Fq::p(0), a_other[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) u[j] = subc_cc(Fq::p(j), a_other[j]);
#pragma unroll
  for (int j = 0; j < 12; j++) {
    u[j] = parity ? a_other[j] : u[j];
    y[j] = parity ? b_other[j] : b_self[j];
    v[j] = parity ? b_self[j] : b_other[j];
  }
  mont_mul_sum2<Fq>(r, a_self, y, u, v);
}

// Coefficient `parity` of (a0 + a1 u)^2, one mont_mul. Thread 0:
// c0 = (a0 + a1)(a0 - a1 + p); thread 1: c1 = (a1 + a1) a0. The operands
// are below 2p, where mont_mul's value stays below 3p and ends below
// 4 p^2 / 2^384 + p < 1.5 p: its one conditional subtraction suffices.
__device__ __forceinline__ void fq2_sqr_half(uint32_t r[12], uint32_t parity, const uint32_t a_self[12],
                                             const uint32_t a_other[12]) {
  uint32_t x[12], d[12];
#pragma unroll
  for (int j = 0; j < 12; j++) x[j] = parity ? a_self[j] : a_other[j];
  add_limbs<12>(x, a_self, x);  // below 2p
  // a_self - a_other + p, in (0, 2p); thread 1 takes a0 instead
  d[0] = sub_cc(a_self[0], a_other[0]);
#pragma unroll
  for (int j = 1; j < 12; j++) d[j] = subc_cc(a_self[j], a_other[j]);
  d[0] = add_cc(d[0], Fq::p(0));
#pragma unroll
  for (int j = 1; j < 12; j++) d[j] = addc_cc(d[j], Fq::p(j));
#pragma unroll
  for (int j = 0; j < 12; j++) d[j] = parity ? a_other[j] : d[j];
  mont_mul<Fq>(r, x, d);
}

#ifndef FIELD_HOST_TEST
// 16-byte vector load/store of one element (N is a multiple of 4 and
// every element starts on a 16-byte boundary).
template <int N>
__device__ __forceinline__ void load_elem(uint32_t r[N], const uint32_t* p) {
#pragma unroll
  for (int k = 0; k < N / 4; k++) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

// the same through the read-only data cache, for constants that every
// thread of a warp reads at once
template <int N>
__device__ __forceinline__ void load_const(uint32_t r[N], const uint32_t* p) {
#pragma unroll
  for (int k = 0; k < N / 4; k++) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_elem(uint32_t* p, const uint32_t r[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; k++)
    reinterpret_cast<uint4*>(p)[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}
#endif
