// Kernel K3b: the four-step NTT's batched rows (csrc/ntt_rows.cuh has the
// design note and the block's body).
//
// Launch contract: `in` and `out` are distinct contiguous int32
// [batch, 2^log_n, 8] buffers and `tw` the table of w^k (k < 2^log_n / 2),
// all 16-byte aligned; the caller passes PyTorch's current stream and
// raises if the returned cudaError_t is not 0 (a shared-memory size the
// card refuses among them).
#include <cstdint>

#include "ntt_rows.cuh"

__global__ void __launch_bounds__(ROWS_MAX_THREADS, 1)
    ntt_rows_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                    int log_n) {
  extern __shared__ __align__(128) uint4 rows_sh[];
  __shared__ uint64_t bar;
  ntt_rows_block(rows_sh, in, out, tw, log_n, &bar);
}

// `batch` rows of 2^log_n elements, one block each
extern "C" int ntt_rows(const void* in, void* out, const void* tw, int log_n, int batch, void* stream) {
  if (log_n < 1 || log_n > ROWS_MAX_LOG_N || batch < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)in | (uintptr_t)out | (uintptr_t)tw) % 16) return (int)cudaErrorMisalignedAddress;
  const size_t shmem = (size_t)32 << log_n;
  // above 48 KB only after this opt-in; the card refuses more than it has
  cudaError_t err = cudaFuncSetAttribute((const void*)ntt_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shmem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return (int)err;
  }
  ntt_rows_kernel<<<(unsigned)batch, rows_threads(log_n), shmem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n);
  return (int)cudaGetLastError();
}
