// Kernel K1: elementwise Montgomery product c = a * b * R^-1 mod p over
// BLS12-381 Fr (R = 2^256) and Fq (R = 2^384), canonical in and out.
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/field.py `fr_montmul_soa` /
// `fq_montmul_soa` (_make_montmul_call :95, pallas_call :113, body
// `_montmul_tiles` :44). The TPU kernel runs CIOS over a struct-of-arrays
// [n, N] layout of 16-bit limbs so each limb fills its own vector tile.
// On Hopper one thread owns one element: its limbs sit in registers, a
// 32x32->64-bit product is native, and the element is one 32- or 48-byte
// vector load. The layout is packed [N, limbs] int32 (u32 reinterpreted),
// which is also the byte layout of the LE field element, so no transpose
// is needed on either side.
//
// Bound: on the pre-commit path b is one broadcast constant (R^2 mod p to
// enter Montgomery form, 1 to leave it), so an Fr call moves 64 bytes
// per element and does 8*8*2 + 8 = 136 32x32->64 products (272 32-bit
// multiply-adds). At the H100's 3.35 TB/s and 33.5 T 32-bit multiply-adds/s
// the bytes take about 2.4x as long as the products: the kernel is
// memory-bound, and the design does nothing more than one coalesced
// vector read of a and one write of c per thread.
//
// `fr_sub` (c = a - b mod r) is the elementwise subtraction of the
// Groth16 h pipeline, `_sub_soa` of ops/pallas/ntt.py (:667), which the
// JAX package leaves to XLA. It moves 96 bytes per element and is
// memory-bound like the product.
//
// Launch contract: the caller allocates `out`, passes PyTorch's current
// stream, and raises if the returned cudaError_t is not 0.
#include <cuda_runtime.h>

#include "field.cuh"

template <class F>
__global__ void montmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ out, long long n, long long b_step) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F::N], y[F::N];
  load_elem<F::N>(x, a + i * F::N);
  if (b_step == 0) {
    load_const<F::N>(y, b);
  } else {
    load_elem<F::N>(y, b + i * b_step);
  }
  mont_mul<F>(x, x, y);
  store_elem<F::N>(out + i * F::N, x);
}

template <class F>
static int launch(const void* a, const void* b, void* out, long long n, int b_broadcast,
                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  montmul_kernel<F><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_broadcast ? 0 : F::N);
  return (int)cudaGetLastError();
}

__global__ void fr_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8];
  load_elem<8>(x, a + i * 8);
  load_elem<8>(y, b + i * 8);
  sub_mod<Fr>(x, x, y);
  store_elem<8>(out + i * 8, x);
}

extern "C" int fr_sub(const void* a, const void* b, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  fr_sub_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int fr_montmul(const void* a, const void* b, void* out, long long n, int b_broadcast,
                          void* stream) {
  return launch<Fr>(a, b, out, n, b_broadcast, stream);
}

extern "C" int fq_montmul(const void* a, const void* b, void* out, long long n, int b_broadcast,
                          void* stream) {
  return launch<Fq>(a, b, out, n, b_broadcast, stream);
}
