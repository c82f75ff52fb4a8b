// Kernel K7: the Poseidon witness replay of the circuits. Each thread
// replays one instance of the Poseidon gadget: the permutation of
// [domain tag, preimage...] on the sparse schedule, recording x^2, x^4
// and x^5 of every S-box in the gadget's allocation order (R_F/2 full
// rounds of t S-boxes, R_P single S-boxes, R_F/2 full rounds of t), then
// the digest: n_int = R_F t 3 + R_P 3 + 1 values per instance (238, 388,
// 460 at t = 3, 9, 12), each stored in plain form.
//
// Replaces the XLA program of crypto3_fil_proofs_tpu/zk/gadgets/tiled.py
// `_poseidon_witness_jax_fn` (:659-790), entered through
// `poseidon_witness_jax` (:792) from `poseidon_witness_v` (:215, batches
// of 8 or more); no `pallas_call`. The port calls it from
// zk/gadgets/tiled.py `poseidon_witness_v` for every batch on a card.
//
// Bound: per instance one permutation, 128,832 / 393,696 / 555,456
// 32-bit multiply-adds at arity 2 / 8 / 11 (the 64,416 / 196,848 /
// 277,728 wide products of K2's count, each a low and a high half;
// chip_smoke.py `poseidon_mads`), plus one REDC (144 multiply-adds) per
// stored value, against (arity + n_int) * 32 bytes read and written:
// 0.02-0.05 bytes per multiply-add, far below the card's 0.2 (3.35 TB/s
// against 16.73 T multiply-adds/s), so bound by the multiplies.
//
// Design: K2's device functions (csrc/poseidon.cuh), with a recording
// S-box, on K2's staged constants in shared memory. One thread per
// instance, the state in registers. The values are stored element-major,
// [n_int, n, 8] u32: at each S-box the threads of a warp write 32
// adjacent elements, one coalesced kilobyte; the wrapper transposes to
// [n, n_int, 8] on the card. The circuits replay a few dozen to some
// tens of thousands of instances, too few to fill the card with K2's
// blocks (23,490 threads at 384 a block are 62 blocks on 132 SMs), so a
// batch smaller than the persistent grid goes out in smaller blocks, one
// share on every SM, and each SM runs fewer instances at once: 22-30 %
// less time than K2's fixed blocks at chip_smoke.py's three replay
// shapes (kernel_times.py; PERF.md).
//
// Launch contract: the caller allocates `out`, passes PyTorch's current
// stream, and raises if the returned cudaError_t is not 0.
#include <cuda_runtime.h>

#include "poseidon.cuh"

template <int T>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::blocks)
    witness_kernel(const uint32_t* __restrict__ pre, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ consts, int n_words, long long n, int r_f, int r_p) {
  extern __shared__ uint4 shm[];
  uint32_t* sc = reinterpret_cast<uint32_t*>(shm);
  for (int k = threadIdx.x; k < n_words / 4; k += blockDim.x)
    shm[k] = __ldg(reinterpret_cast<const uint4*>(consts) + k);
  __syncthreads();
  uint32_t* rows = sc + n_words + threadIdx.x;  // this thread's row slice
  const uint32_t* tag = sc + n_words - L;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    witness_one<T>(pre + i * (T - 1) * L, out + i * L, n * L, sc, tag, rows, blockDim.x, r_f, r_p);
}

template <int T>
static int launch(const void* pre, void* out, const void* consts, long long n, int r_f, int r_p,
                  void* stream) {
  if (n <= 0) return 0;
  constexpr int most = Shape<T>::threads;
  const int n_words = const_words<T>(r_f, r_p);
  static std::atomic<int> per_card[MAX_CARDS];  // blocks of `most` threads on the card at once, per card
  int resident = 0;
  cudaError_t err = resident_blocks(witness_kernel<T>, most, shared_bytes<T>(n_words, most), per_card, &resident);
  if (err != cudaSuccess) return (int)err;
  // threads per block: the batch's share of each resident block, in whole
  // warps, at most `most` (then the grid is persistent)
  long long threads = (n + resident - 1) / resident;
  threads = (threads + 31) / 32 * 32;
  if (threads > most) threads = most;
  const long long needed = (n + threads - 1) / threads;
  const int blocks = (int)(needed < resident ? needed : resident);
  witness_kernel<T><<<blocks, (int)threads, shared_bytes<T>(n_words, (int)threads), (cudaStream_t)stream>>>(
      (const uint32_t*)pre, (uint32_t*)out, (const uint32_t*)consts, n_words, n, r_f, r_p);
  return (int)cudaGetLastError();
}

// pre: [n, t-1, 8] u32 Montgomery; out: [n_int, n, 8] u32 plain; consts:
// the staged buffer of width t (K2's). Widths 3, 9 and 12 (arity 2, 8
// and 11) are built.
extern "C" int poseidon_witness(const void* pre, void* out, const void* consts, long long n, int t, int r_f,
                                int r_p, void* stream) {
  switch (t) {
    case 3:
      return launch<3>(pre, out, consts, n, r_f, r_p, stream);
    case 9:
      return launch<9>(pre, out, consts, n, r_f, r_p, stream);
    case 12:
      return launch<12>(pre, out, consts, n, r_f, r_p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
