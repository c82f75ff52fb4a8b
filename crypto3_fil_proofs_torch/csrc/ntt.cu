// Kernel K3: radix-2 DIT number-theoretic transform over BLS12-381 Fr,
// Montgomery form, natural order in and out, unscaled (the caller
// multiplies by 1/n and the coset powers with K1).
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/ntt.py: the stage kernels
// `_make_stage_kernel` (:118), `_make_blocked_kernel` (:197) and
// `_make_split_kernel` (:220), launched through `_stage_call` (:240) at
// :264, :290 and :315 over a four-step "P-order" layout shaped for the
// TPU's (8, 128) tiles. Only the natural-order endpoints of a transform
// are unique, so the layout is not carried over. Here a transform of
// 2^log_n elements is one to four passes. Pass k runs stages
// s0+1 .. s0+cnt of the DIT on groups of 2^cnt elements that those
// stages mix only among themselves: element t of group g sits at
//     ((g >> s0) << (s0 + cnt)) | (t << s0) | (g & (2^s0 - 1)).
// A block loads its group into shared memory (the first pass gathers
// through the bit reversal), runs its stages there with one thread per
// butterfly, and writes the group back. cnt <= 10, so a group is at most
// 32 KB of shared memory; log_n = 19 is two passes, of 10 and 9 stages.
//
// Bound: a transform of n elements needs (n/2) log2(n) Montgomery
// products (one per butterfly) and moves n * 32 bytes in and out. At
// n = 2^19 that is 4,980,736 products against 33.5 MB: by the H100's
// integer multiply-add rate the products take longer than the bytes, so
// the kernel is operation-bound. Each pass reads and writes the whole
// vector once (16 MiB, which fits the 50 MB L2); the design keeps every
// stage of a pass in shared memory so that a transform is two passes
// over memory, not nineteen.
//
// A batch runs the same pass on `batch` transforms at once: row
// blockIdx.y of a contiguous [batch, 2^log_n, 8] buffer. The four-step
// transform of the sharded NTT (parallel/sharded.py) runs thousands of
// short transforms (2^11 of 2^12 elements at n = 2^23); one launch each
// would leave the card idle between launches. A batch of 1 runs the
// kBatched = false instance, the single transform's code as it was.
//
// Launch contract: the caller allocates `out` (distinct from `in` on a
// pass with bit reversal, the same buffer otherwise), passes PyTorch's
// current stream, and raises if the returned cudaError_t is not 0.
#include <cuda_runtime.h>

#include "field.cuh"

template <bool kBatched>
__global__ void ntt_pass_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                                const uint32_t* __restrict__ tw, int log_n, int s0, int cnt,
                                int bitrev_in) {
  extern __shared__ uint32_t sh[];  // 2^cnt elements of 8 limbs
  if (kBatched) {
    const size_t row = (size_t)blockIdx.y << (log_n + 3);  // this transform's first limb
    in += row;
    out += row;
  }
  const unsigned G = 1u << cnt;
  const unsigned g = blockIdx.x;
  const unsigned low = g & ((1u << s0) - 1u);
  const unsigned long long high = (unsigned long long)(g >> s0) << (s0 + cnt);
  for (unsigned t = threadIdx.x; t < G; t += blockDim.x) {
    const unsigned long long idx = high | ((unsigned long long)t << s0) | low;
    const unsigned long long src = bitrev_in ? (__brevll(idx) >> (64 - log_n)) : idx;
    uint32_t v[8];
    load_elem<8>(v, in + src * 8);
    store_elem<8>(sh + t * 8, v);
  }
  __syncthreads();
  for (int k = 0; k < cnt; k++) {
    const int s = s0 + k + 1;  // global stage: butterflies span 2^(s-1)
    for (unsigned b = threadIdx.x; b < G / 2; b += blockDim.x) {
      const unsigned j_in = b & ((1u << k) - 1u);
      const unsigned t0 = ((b >> k) << (k + 1)) | j_in;
      const unsigned t1 = t0 + (1u << k);
      // the butterfly's position in its 2^s block: j = idx0 mod 2^(s-1)
      const unsigned long long j = ((unsigned long long)j_in << s0) | low;
      uint32_t u[8], v[8], w[8], x[8];
      load_elem<8>(u, sh + t0 * 8);
      load_elem<8>(v, sh + t1 * 8);
      load_const<8>(w, tw + (j << (log_n - s)) * 8);
      mont_mul<Fr>(v, v, w);
      add_mod<Fr>(x, u, v);
      sub_mod<Fr>(w, u, v);
      store_elem<8>(sh + t0 * 8, x);
      store_elem<8>(sh + t1 * 8, w);
    }
    __syncthreads();
  }
  for (unsigned t = threadIdx.x; t < G; t += blockDim.x) {
    const unsigned long long idx = high | ((unsigned long long)t << s0) | low;
    uint32_t v[8];
    load_elem<8>(v, sh + t * 8);
    store_elem<8>(out + idx * 8, v);
  }
}

// One pass: stages s0+1 .. s0+cnt of `batch` transforms of 2^log_n
// elements each.
extern "C" int ntt_pass(const void* in, void* out, const void* tw, int log_n, int s0, int cnt,
                        int bitrev_in, int batch, void* stream) {
  if (cnt < 1 || cnt > 10 || s0 < 0 || s0 + cnt > log_n || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(1u << (log_n - cnt), (unsigned)batch);
  const int threads = cnt >= 2 ? (1 << (cnt - 1)) : 1;
  const size_t shmem = ((size_t)1 << cnt) * 8 * sizeof(uint32_t);
  const uint32_t* src = (const uint32_t*)in;
  uint32_t* dst = (uint32_t*)out;
  const uint32_t* w = (const uint32_t*)tw;
  if (batch > 1)
    ntt_pass_kernel<true><<<grid, threads, shmem, (cudaStream_t)stream>>>(src, dst, w, log_n, s0, cnt, bitrev_in);
  else
    ntt_pass_kernel<false><<<grid, threads, shmem, (cudaStream_t)stream>>>(src, dst, w, log_n, s0, cnt, bitrev_in);
  return (int)cudaGetLastError();
}
