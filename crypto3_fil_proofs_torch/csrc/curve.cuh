// BLS12-381 G1 and G2 in Jacobian coordinates for Hopper: one set of
// formulas templated on the coordinate field, instantiated over Fq
// (G1, csrc/g1.cu), over Fq2 = Fq[u] / (u^2 + 1) (G2's bucket kernels
// of csrc/msm.cu, one thread per point) and over one coefficient of Fq2
// on each thread of a pair (G2's point kernels, csrc/curve_pair.cuh and
// csrc/g2.cu).
//
// Replaces the kernel bodies of crypto3_fil_proofs_tpu/ops/pallas/g1.py
// (`_madd_kernel_u` :328, `_madd_nodbl_kernel_u` :418, `_dbl_kernel_u`
// :462, `_add_kernel_u` :373) and ops/pallas/g2.py, with the same formulas
// (madd-2007-bl with and without the doubling path, dbl-2009-l,
// add-2007-bl) and the same edge semantics, so every output equals the
// plain version's (ops/g1_torch.py) bit for bit:
//   - infinity is Z = 0; X and Y are what the formula left there;
//   - an accumulator at infinity lifts q with Z = 1 (Montgomery);
//   - P == -Q gives infinity;
//   - madd_nodbl keeps P on a lane with P == Q and flags it `same`, for
//     the caller to double, and keeps P where valid == 0;
//   - madd and add double where P == Q. The TPU computes the doubling on
//     every lane and selects; a thread branches, the case being rare.
//
// Products: the Fq product is field.cuh's carry-chain `mont_mul`, inlined
// (G1's kernels hold it without spills, and its bucket walk ran faster
// than with one out-of-line copy); the Fq2 product and square of one
// thread per point are field.cuh's `fq2_mul` / `fq2_sqr` (Karatsuba on
// wide products, one REDC per coefficient), one out-of-line copy each
// that takes its operands by pointer. ptxas' -v report of each kernel is
// printed by chip_smoke.py.
//
// Layout: an Fq element is 12 words (48 bytes), an Fq2 element c0 then
// c1; a point is its coordinates in order: affine (x, y), Jacobian
// (X, Y, Z). Every point starts on a 16-byte boundary.
#pragma once

#ifndef FIELD_HOST_TEST
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// R mod p: 1 in Montgomery form
static __constant__ uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

struct alignas(16) fq_t {
  uint32_t v[12];
};
struct fq2_t {
  fq_t c0, c1;
};

// Fq2's product and square stay out of line: inlined at every use, G2's
// bucket_reduce and agg_level kernels spilled several KB and ran slower.
__device__ __noinline__ void fq2_mul_p(fq2_t* r, const fq2_t* a, const fq2_t* b) {
  fq2_mul(r->c0.v, r->c1.v, a->c0.v, a->c1.v, b->c0.v, b->c1.v);
}

__device__ __noinline__ void fq2_sqr_p(fq2_t* r, const fq2_t* a) {
  fq2_sqr(r->c0.v, r->c1.v, a->c0.v, a->c1.v);
}

// --- Fq ---------------------------------------------------------------

__device__ __forceinline__ fq_t f_mul(const fq_t& a, const fq_t& b) {
  fq_t r;
  mont_mul<Fq>(r.v, a.v, b.v);
  return r;
}

__device__ __forceinline__ fq_t f_sqr(const fq_t& a) { return f_mul(a, a); }

__device__ __forceinline__ fq_t f_add(const fq_t& a, const fq_t& b) {
  fq_t r;
  add_mod<Fq>(r.v, a.v, b.v);
  return r;
}

__device__ __forceinline__ fq_t f_sub(const fq_t& a, const fq_t& b) {
  fq_t r;
  sub_mod<Fq>(r.v, a.v, b.v);
  return r;
}

__device__ __forceinline__ bool f_is_zero(const fq_t& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 12; j++) acc |= a.v[j];
  return acc == 0;
}

__device__ __forceinline__ void f_set_one(fq_t& r) {
#pragma unroll
  for (int j = 0; j < 12; j++) r.v[j] = FQ_ONE[j];
}

__device__ __forceinline__ void f_set_zero(fq_t& r) {
#pragma unroll
  for (int j = 0; j < 12; j++) r.v[j] = 0;
}

// --- Fq2 ----------------------------------------------------------------

__device__ __forceinline__ fq2_t f_mul(const fq2_t& a, const fq2_t& b) {
  fq2_t r;
  fq2_mul_p(&r, &a, &b);
  return r;
}

__device__ __forceinline__ fq2_t f_sqr(const fq2_t& a) {
  fq2_t r;
  fq2_sqr_p(&r, &a);
  return r;
}

__device__ __forceinline__ fq2_t f_add(const fq2_t& a, const fq2_t& b) {
  fq2_t r;
  r.c0 = f_add(a.c0, b.c0);
  r.c1 = f_add(a.c1, b.c1);
  return r;
}

__device__ __forceinline__ fq2_t f_sub(const fq2_t& a, const fq2_t& b) {
  fq2_t r;
  r.c0 = f_sub(a.c0, b.c0);
  r.c1 = f_sub(a.c1, b.c1);
  return r;
}

__device__ __forceinline__ bool f_is_zero(const fq2_t& a) {
  return f_is_zero(a.c0) && f_is_zero(a.c1);
}

__device__ __forceinline__ void f_set_one(fq2_t& r) {
  f_set_one(r.c0);
  f_set_zero(r.c1);
}

__device__ __forceinline__ void f_set_zero(fq2_t& r) {
  f_set_zero(r.c0);
  f_set_zero(r.c1);
}

template <class E>
__device__ __forceinline__ E f_dbl(const E& a) {
  return f_add(a, a);
}

// --- points -------------------------------------------------------------

template <class E>
struct Jac {
  E X, Y, Z;
};

template <class E>
struct Aff {
  E x, y;
};

// 16-byte loads and stores of a whole point (sizeof(T) is a multiple of
// 16). The point is read and written as the 32-bit words it is made of,
// never through a uint4 lvalue, so no type-based alias analysis can
// reorder these accesses against the field arithmetic.
template <class T>
__device__ __forceinline__ T ld(const void* p) {
  T r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 16); k++) {
    const uint4 v = s[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  return r;
}

template <class T>
__device__ __forceinline__ void st(void* p, const T& v) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 16); k++)
    d[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// The point at infinity as the plain version writes it: X = Y = 1, Z = 0.
template <class E>
__device__ __forceinline__ Jac<E> jac_infinity() {
  Jac<E> r;
  f_set_one(r.X);
  f_set_one(r.Y);
  f_set_zero(r.Z);
  return r;
}

// dbl-2009-l (2M + 5S); Z = 0 stays 0.
template <class E>
__device__ __forceinline__ Jac<E> jac_dbl(const Jac<E>& p) {
  const E A = f_sqr(p.X);
  const E B = f_sqr(p.Y);
  const E C = f_sqr(B);
  const E xb = f_add(p.X, B);
  const E D = f_dbl(f_sub(f_sub(f_sqr(xb), A), C));
  const E E3 = f_add(f_dbl(A), A);
  Jac<E> r;
  r.X = f_sub(f_sqr(E3), f_dbl(D));
  r.Y = f_sub(f_mul(E3, f_sub(D, r.X)), f_dbl(f_dbl(f_dbl(C))));
  r.Z = f_dbl(f_mul(p.Y, p.Z));
  return r;
}

// madd-2007-bl (7M + 4S) without the doubling path: p + affine q.
template <class E>
__device__ __forceinline__ Jac<E> jac_madd_nodbl(const Jac<E>& p, const Aff<E>& q, bool valid, bool& same) {
  same = false;
  if (!valid) return p;
  Jac<E> o;
  if (f_is_zero(p.Z)) {
    o.X = q.x;
    o.Y = q.y;
    f_set_one(o.Z);
    return o;
  }
  const E Z1Z1 = f_sqr(p.Z);
  const E U2 = f_mul(q.x, Z1Z1);
  const E S2 = f_mul(f_mul(q.y, p.Z), Z1Z1);
  const E H = f_sub(U2, p.X);
  const E r = f_dbl(f_sub(S2, p.Y));
  const bool h_zero = f_is_zero(H);
  if (h_zero && f_is_zero(r)) {
    same = true;
    return p;
  }
  const E HH = f_sqr(H);
  const E I = f_dbl(f_dbl(HH));
  const E J = f_mul(H, I);
  const E V = f_mul(p.X, I);
  o.X = f_sub(f_sub(f_sqr(r), J), f_dbl(V));
  o.Y = f_sub(f_mul(r, f_sub(V, o.X)), f_dbl(f_mul(p.Y, J)));
  if (h_zero) {  // P == -Q
    f_set_zero(o.Z);
  } else {
    const E zh = f_add(p.Z, H);
    o.Z = f_sub(f_sub(f_sqr(zh), Z1Z1), HH);
  }
  return o;
}

// madd-2007-bl with its doubling path: P == Q doubles. The TPU kernel
// computes the doubling on every lane and selects it where P == Q; the
// result is the same bits.
template <class E>
__device__ __forceinline__ Jac<E> jac_madd(const Jac<E>& p, const Aff<E>& q, bool valid) {
  bool same;
  const Jac<E> r = jac_madd_nodbl(p, q, valid, same);
  return same ? jac_dbl(p) : r;
}

// add-2007-bl (11M + 5S), doubling where P == Q.
template <class E>
__device__ __forceinline__ Jac<E> jac_add(const Jac<E>& p, const Jac<E>& q) {
  if (f_is_zero(p.Z)) return q;
  if (f_is_zero(q.Z)) return p;
  const E Z1Z1 = f_sqr(p.Z);
  const E Z2Z2 = f_sqr(q.Z);
  const E U1 = f_mul(p.X, Z2Z2);
  const E U2 = f_mul(q.X, Z1Z1);
  const E S1 = f_mul(f_mul(p.Y, q.Z), Z2Z2);
  const E S2 = f_mul(f_mul(q.Y, p.Z), Z1Z1);
  const E H = f_sub(U2, U1);
  const E r = f_dbl(f_sub(S2, S1));
  const bool h_zero = f_is_zero(H);
  if (h_zero && f_is_zero(r)) return jac_dbl(p);
  const E dh = f_dbl(H);
  const E I = f_sqr(dh);
  const E J = f_mul(H, I);
  const E V = f_mul(U1, I);
  Jac<E> o;
  o.X = f_sub(f_sub(f_sqr(r), J), f_dbl(V));
  o.Y = f_sub(f_mul(r, f_sub(V, o.X)), f_dbl(f_mul(S1, J)));
  if (h_zero) {  // P == -Q
    f_set_zero(o.Z);
  } else {
    const E zz = f_add(p.Z, q.Z);
    o.Z = f_mul(H, f_sub(f_sub(f_sqr(zz), Z1Z1), Z2Z2));
  }
  return o;
}

// --- the point operations as the kernels call them ------------------------------
//
// G1's are inlined. G2's add and doubling (one thread per point, in the
// bucket stages of csrc/msm.cu) hold some ten Fq2 temporaries each, so a
// kernel that calls them several times ran out of registers and spilled
// kilobytes; each has one out-of-line copy instead, with its points passed
// by pointer.

template <class E>
__device__ __forceinline__ Jac<E> p_add(const Jac<E>& p, const Jac<E>& q) {
  return jac_add(p, q);
}

template <class E>
__device__ __forceinline__ Jac<E> p_dbl(const Jac<E>& p) {
  return jac_dbl(p);
}

__device__ __noinline__ void g2_add_call(Jac<fq2_t>* r, const Jac<fq2_t>* p, const Jac<fq2_t>* q) {
  *r = jac_add(*p, *q);
}

__device__ __noinline__ void g2_dbl_call(Jac<fq2_t>* r, const Jac<fq2_t>* p) { *r = jac_dbl(*p); }

template <>
__device__ __forceinline__ Jac<fq2_t> p_add<fq2_t>(const Jac<fq2_t>& p, const Jac<fq2_t>& q) {
  Jac<fq2_t> r;
  g2_add_call(&r, &p, &q);
  return r;
}

template <>
__device__ __forceinline__ Jac<fq2_t> p_dbl<fq2_t>(const Jac<fq2_t>& p) {
  Jac<fq2_t> r;
  g2_dbl_call(&r, &p);
  return r;
}

// --- the entry points of one thread per point (K4, G1) ---------------------
//
// Each takes packed point arrays (see Layout above), byte masks, the
// lane count and PyTorch's current stream, and returns cudaGetLastError().
// G2's (K5) are the pair kernels of csrc/g2.cu.

template <class E>
__global__ void madd_nodbl_kernel(const Jac<E>* __restrict__ acc, const Aff<E>* __restrict__ q,
                                  const uint8_t* __restrict__ valid, Jac<E>* __restrict__ out,
                                  uint8_t* __restrict__ same, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool s;
  const Jac<E> r = jac_madd_nodbl(ld<Jac<E>>(acc + i), ld<Aff<E>>(q + i), valid[i] != 0, s);
  st(out + i, r);
  same[i] = s;
}

template <class E>
__global__ void madd_kernel(const Jac<E>* __restrict__ acc, const Aff<E>* __restrict__ q,
                            const uint8_t* __restrict__ valid, Jac<E>* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  st(out + i, jac_madd(ld<Jac<E>>(acc + i), ld<Aff<E>>(q + i), valid[i] != 0));
}

template <class E>
__global__ void dbl_kernel(const Jac<E>* __restrict__ p, const uint8_t* __restrict__ mask,
                           Jac<E>* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<E> a = ld<Jac<E>>(p + i);
  st(out + i, mask[i] ? p_dbl(a) : a);
}

template <class E>
__global__ void add_kernel(const Jac<E>* __restrict__ p, const Jac<E>* __restrict__ q,
                           Jac<E>* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  st(out + i, p_add(ld<Jac<E>>(p + i), ld<Jac<E>>(q + i)));
}

constexpr int CURVE_THREADS = 128;

inline unsigned curve_blocks(long long n) {
  return (unsigned)((n + CURVE_THREADS - 1) / CURVE_THREADS);
}

#define CURVE_ENTRY_POINTS(PFX, E)                                                            \
  extern "C" int PFX##_madd_nodbl(const void* acc, const void* q, const void* valid, void* out, \
                                  void* same, long long n, void* stream) {                      \
    if (n <= 0) return 0;                                                                       \
    madd_nodbl_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(          \
        (const Jac<E>*)acc, (const Aff<E>*)q, (const uint8_t*)valid, (Jac<E>*)out,              \
        (uint8_t*)same, n);                                                                     \
    return (int)cudaGetLastError();                                                             \
  }                                                                                             \
  extern "C" int PFX##_dbl(const void* p, const void* mask, void* out, long long n,            \
                           void* stream) {                                                      \
    if (n <= 0) return 0;                                                                       \
    dbl_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(                 \
        (const Jac<E>*)p, (const uint8_t*)mask, (Jac<E>*)out, n);                               \
    return (int)cudaGetLastError();                                                             \
  }                                                                                             \
  extern "C" int PFX##_add(const void* p, const void* q, void* out, long long n, void* stream) { \
    if (n <= 0) return 0;                                                                       \
    add_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(                 \
        (const Jac<E>*)p, (const Jac<E>*)q, (Jac<E>*)out, n);                                   \
    return (int)cudaGetLastError();                                                             \
  }
