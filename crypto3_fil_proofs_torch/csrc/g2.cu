// Kernel K5: BLS12-381 G2 point operations over lanes, Jacobian over
// Fq2 = Fq[u] / (u^2 + 1), two threads per lane.
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/g2.py `madd_nodbl_soa`
// (`_madd_nodbl_kernel_u` :347, pallas_call :486), `dbl_soa`
// (`_dbl_kernel_u` :435, :511) and `add_soa` (`_add_kernel_u` :390,
// :533). The formulas are those of G1 (curve.cuh) over Fq2, in the pair
// layout of curve_pair.cuh: thread k of a pair holds coefficient k of
// every coordinate and computes half of every Fq2 product.
//
// Bound: a mixed add needs 29 Fq products' worth of multiply-adds, a
// doubling 16, a full add 43 (three per Fq2 product, two per square),
// against 577 to 864 bytes of points in and out: the kernels are
// operation-bound. One thread per point held some ten Fq2 temporaries of
// 24 words, ran at the 255-register cap with two warps per scheduler and
// passed its products out of line through local memory. A pair holds 12
// words per temporary and inlines everything; each thread's half of an
// Fq2 product is one CIOS pass over two products (876 multiply-adds,
// against Karatsuba's 1,488 on one thread), its half of a square one
// Montgomery product (588), and each product costs 24 shuffles, a square
// 12. Per lane that is 97 % of the bound's multiply-adds, and a lane's
// serial chain per product is 0.6 of one thread's.
//
// Launch: 2 n threads for n lanes, PAIR_THREADS a block (64 measured a
// few per cent faster than 128 on the short launches of the prove's
// halving sums, 256 and 512 slower); lane i is the pair of threads 2i,
// 2i + 1, which leave together past the last lane. No register cap: the
// caps that fit more blocks on an SM spilled.
#include "curve_pair.cuh"

constexpr int PAIR_THREADS = 64;

inline unsigned pair_blocks(long long n) {
  return (unsigned)((2 * n + PAIR_THREADS - 1) / PAIR_THREADS);
}

__device__ __forceinline__ long long pair_lane() {
  return (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 1;
}

__global__ void __launch_bounds__(PAIR_THREADS)
    pair_madd_nodbl_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ q,
                           const uint8_t* __restrict__ valid, uint32_t* __restrict__ out,
                           uint8_t* __restrict__ same, long long n) {
  const long long i = pair_lane();
  if (i >= n) return;
  pair_madd_nodbl(acc, q, valid, out, same, i);
}

__global__ void __launch_bounds__(PAIR_THREADS)
    pair_dbl_kernel(const uint32_t* __restrict__ p, const uint8_t* __restrict__ mask,
                    uint32_t* __restrict__ out, long long n) {
  const long long i = pair_lane();
  if (i >= n) return;
  pair_dbl(p, mask, out, i);
}

__global__ void __launch_bounds__(PAIR_THREADS)
    pair_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                    uint32_t* __restrict__ out, long long n) {
  const long long i = pair_lane();
  if (i >= n) return;
  pair_add(p, q, out, i);
}

// The entry points of ops/cuda/g1.py's PointKernels: packed points,
// byte masks, the lane count and PyTorch's current stream; each returns
// cudaGetLastError().

extern "C" int g2_madd_nodbl(const void* acc, const void* q, const void* valid, void* out, void* same,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  pair_madd_nodbl_kernel<<<pair_blocks(n), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const uint32_t*)q, (const uint8_t*)valid, (uint32_t*)out, (uint8_t*)same, n);
  return (int)cudaGetLastError();
}

extern "C" int g2_dbl(const void* p, const void* mask, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  pair_dbl_kernel<<<pair_blocks(n), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint8_t*)mask, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int g2_add(const void* p, const void* q, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  pair_add_kernel<<<pair_blocks(n), PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
