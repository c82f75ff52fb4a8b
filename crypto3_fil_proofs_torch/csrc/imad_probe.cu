// Measurement probe, not a port of a TPU kernel: the card's rate of
// 32-bit integer multiply-adds, which chip_smoke.py uses for the
// operations bound of the field and curve kernels.
//
// Each thread runs `chains` independent chains x <- x * m + k (one IMAD
// each, mad.lo.u32) or, with wide = 1, x <- (u64)x * m + x (one
// 32 x 32 -> 64-bit multiply-add, mad.wide.u32), `iters` times, and
// writes a digest so that nothing is optimised away. m and k are
// arguments, so the compiler cannot fold the chains.
#include <cuda_runtime.h>

#include <cstdint>

template <bool WIDE>
__global__ void imad_probe_kernel(uint32_t* out, uint32_t m, uint32_t k, int iters) {
  uint32_t x[8];
#pragma unroll
  for (int c = 0; c < 8; c++) x[c] = threadIdx.x + c * 7919u + blockIdx.x;
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int c = 0; c < 8; c++) {
      if (WIDE) {
        const uint64_t w = (uint64_t)x[c] * m + x[c];
        x[c] = (uint32_t)(w >> 32) ^ (uint32_t)w;
      } else {
        x[c] = x[c] * m + k;
      }
    }
  }
  uint32_t d = 0;
#pragma unroll
  for (int c = 0; c < 8; c++) d ^= x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = d;
}

// 8 chains per thread; returns cudaGetLastError().
extern "C" int imad_probe(void* out, unsigned m, unsigned k, int iters, int blocks, int threads,
                          int wide, void* stream) {
  if (wide) {
    imad_probe_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, m, k, iters);
  } else {
    imad_probe_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, m, k, iters);
  }
  return (int)cudaGetLastError();
}
