// Kernel K7: the Poseidon witness replay of the circuits. For each
// instance, the permutation of [domain tag, preimage...] on the sparse
// schedule, recording x^2, x^4 and x^5 of every S-box in the gadget's
// allocation order (R_F/2 full rounds of t S-boxes, R_P single S-boxes,
// R_F/2 full rounds of t), then the digest: n_int = R_F t 3 + R_P 3 + 1
// values per instance (238, 388, 460 at t = 3, 9, 12), each stored in
// plain form at out[i, slot] of the caller's [n, n_int, 8] u32 layout.
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
// against 16.73 T multiply-adds/s), so bound by the multiplies. But the
// circuits replay a few to a few thousand instances a launch (C2's
// columns and tree levels, a PoSt's sector headers and PoR levels), far
// fewer than the card runs at once: there a launch takes the latency of
// one permutation, and the multiplies' bound is not reached.
//
// Design, two layouts over K2's staged constants in shared memory:
// - the lane-group layout (csrc/poseidon_group.cuh), for small batches:
//   a group of t lanes of one warp per instance, lane e holding element
//   e, the elements exchanged by shuffles. A full round's S-boxes and mix
//   run t-wide, and a partial round needs two wide products and one REDC
//   per lane instead of 2t - 1 products and t REDCs in one thread, so one
//   permutation's latency falls several-fold, at the price of more
//   instructions per instance (idle spare lanes, every lane running the
//   partial round's S-box, the shuffles);
// - the one-thread layout (`witness_one`, K2's device functions with a
//   recording S-box), for large batches: one thread per instance, the
//   state in registers, fewest instructions per instance.
// The launcher takes the lane groups below a batch size per width and one
// thread from there on (`one_thread_from`, with its measured crossover).
// Both write the caller's layout, so no transpose follows: a group
// writes each full round's 3t values as one run of 96 B per lane, the
// one-thread layout 32 B per value and thread. Blocks are cut to the
// batch's share of each SM: a batch smaller than the card's resident
// threads goes out in smaller blocks, one share on every SM.
//
// Launch contract: the caller allocates `out`, passes PyTorch's current
// stream, and raises if the returned cudaError_t is not 0.
#include <cuda_runtime.h>

#include "poseidon_group.cuh"

// blocks of the lane-group layout: at most 8 warps, two blocks an SM (the
// constants fit twice in shared memory at t = 12)
constexpr int GROUP_THREADS = 256;

// Instances from which the one-thread layout runs, per width; below, the
// lane groups. Measured on an H100 80GB HBM3 at 700 W (`kernel_times.py
// --sweep`, and its `witness_times` at sizes 48 apart; PERF.md): the
// groups take one permutation's latency, 0.23 / 0.27 / 0.29 ms at t = 3
// / 9 / 12, while the card holds their warps at two a scheduler: 1,056
// warps of the shrunken blocks at t = 3 (four a block on 264 resident
// blocks) and the 2,112 of a full pass at t = 9 and 12 (264 blocks of 8
// warps on 132 SMs), 10,560 / 6,336 / 4,224 instances. Past that their
// time steps up, to 0.54 ms at 10,561, 1.02 ms at 6,385, 1.08 ms up to
// 5,473 and 1.42 ms from 5,713 (at 5,521-5,665 one or the other, reading
// by reading), and the one thread, flat at 0.35 / 0.94 / 1.31 ms up to
// 16,384, wins.
template <int T>
constexpr long long one_thread_from = T == 3 ? 10561 : T == 9 ? 6385 : 5521;

// the staged constants into this block's shared memory
__device__ __forceinline__ void stage(uint32_t* sc, const uint32_t* consts, int n_words) {
  uint4* shm = reinterpret_cast<uint4*>(sc);
  for (int k = threadIdx.x; k < n_words / 4; k += blockDim.x)
    shm[k] = __ldg(reinterpret_cast<const uint4*>(consts) + k);
  __syncthreads();
}

template <int T>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::blocks)
    witness_kernel(const uint32_t* __restrict__ pre, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ consts, int n_words, long long n, int r_f, int r_p) {
  extern __shared__ uint4 shm[];
  uint32_t* sc = reinterpret_cast<uint32_t*>(shm);
  stage(sc, consts, n_words);
  uint32_t* rows = sc + n_words + threadIdx.x;  // this thread's row slice
  const uint32_t* tag = sc + n_words - L;
  const long long n_int = 3 * (r_f * T + r_p) + 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    witness_one<T>(pre + i * (T - 1) * L, out + i * n_int * L, L, sc, tag, rows, blockDim.x, r_f, r_p);
}

template <int T>
__global__ void __launch_bounds__(GROUP_THREADS, 2)
    witness_group_kernel(const uint32_t* __restrict__ pre, uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ consts, int n_words, long long n, int r_f, int r_p) {
  extern __shared__ uint4 shm[];
  uint32_t* sc = reinterpret_cast<uint32_t*>(shm);
  stage(sc, consts, n_words);
  constexpr int G = WARP / T;
  const int per_block = blockDim.x / WARP;
  const long long warps = (long long)gridDim.x * per_block;
  // the loop's condition is the warp's, so its lanes shuffle together
  for (long long w = blockIdx.x * (long long)per_block + threadIdx.x / WARP; w * G < n; w += warps)
    witness_warp<T>(threadIdx.x % WARP, w * G, n, pre, out, sc, sc + n_words - L, r_f, r_p);
}

// Launches `kernel` over `units` units of work (threads of the one-thread
// layout, warps of the groups) in blocks of at most `most` threads: the
// batch's share of each resident block, in whole warps, so that a small
// batch spreads over every SM (then the grid is persistent).
template <class Kernel>
static int launch_spread(Kernel kernel, long long units, int unit_threads, int most, size_t fixed_shmem,
                         size_t shmem_per_thread, std::atomic<int> (&per_card)[MAX_CARDS], const void* pre,
                         void* out, const void* consts, int n_words, long long n, int r_f, int r_p,
                         void* stream) {
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, most, fixed_shmem + shmem_per_thread * most, per_card, &resident);
  if (err != cudaSuccess) return (int)err;
  long long threads = (units + resident - 1) / resident * unit_threads;
  threads = (threads + WARP - 1) / WARP * WARP;
  if (threads > most) threads = most;
  const long long needed = (units * unit_threads + threads - 1) / threads;
  const int blocks = (int)(needed < resident ? needed : resident);
  kernel<<<blocks, (int)threads, fixed_shmem + shmem_per_thread * threads, (cudaStream_t)stream>>>(
      (const uint32_t*)pre, (uint32_t*)out, (const uint32_t*)consts, n_words, n, r_f, r_p);
  return (int)cudaGetLastError();
}

enum Layout { PICK = 0, ONE_THREAD = 1, GROUP = 2 };

template <int T>
static int launch(const void* pre, void* out, const void* consts, long long n, int r_f, int r_p, Layout layout,
                  void* stream) {
  if (n <= 0) return 0;
  const int n_words = const_words<T>(r_f, r_p);
  if (layout == PICK) layout = n < one_thread_from<T> ? GROUP : ONE_THREAD;
  if (layout == GROUP) {
    static std::atomic<int> per_card[MAX_CARDS];
    constexpr int G = WARP / T;
    return launch_spread(witness_group_kernel<T>, (n + G - 1) / G, WARP, GROUP_THREADS, (size_t)n_words * 4, 0,
                         per_card, pre, out, consts, n_words, n, r_f, r_p, stream);
  }
  static std::atomic<int> per_card[MAX_CARDS];
  return launch_spread(witness_kernel<T>, n, 1, Shape<T>::threads, shared_bytes<T>(n_words, 0),
                       shared_bytes<T>(0, 1), per_card, pre, out, consts, n_words, n, r_f, r_p, stream);
}

static int dispatch(const void* pre, void* out, const void* consts, long long n, int t, int r_f, int r_p,
                    Layout layout, void* stream) {
  switch (t) {
    case 3:
      return launch<3>(pre, out, consts, n, r_f, r_p, layout, stream);
    case 9:
      return launch<9>(pre, out, consts, n, r_f, r_p, layout, stream);
    case 12:
      return launch<12>(pre, out, consts, n, r_f, r_p, layout, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// pre: [n, t-1, 8] u32 Montgomery; out: [n, n_int, 8] u32 plain; consts:
// the staged buffer of width t (K2's). Widths 3, 9 and 12 (arity 2, 8
// and 11) are built. The layout follows the batch size.
extern "C" int poseidon_witness(const void* pre, void* out, const void* consts, long long n, int t, int r_f,
                                int r_p, void* stream) {
  return dispatch(pre, out, consts, n, t, r_f, r_p, PICK, stream);
}

// The same in one layout, whatever the batch size: for timing the two
// against each other (kernel_times.py).
extern "C" int poseidon_witness_one_thread(const void* pre, void* out, const void* consts, long long n, int t,
                                           int r_f, int r_p, void* stream) {
  return dispatch(pre, out, consts, n, t, r_f, r_p, ONE_THREAD, stream);
}

extern "C" int poseidon_witness_group(const void* pre, void* out, const void* consts, long long n, int t, int r_f,
                                      int r_p, void* stream) {
  return dispatch(pre, out, consts, n, t, r_f, r_p, GROUP, stream);
}

// The batch size from which width t runs one thread per instance (0 for a
// width that is not built).
extern "C" long long poseidon_witness_one_thread_from(int t) {
  return t == 3 ? one_thread_from<3> : t == 9 ? one_thread_from<9> : t == 12 ? one_thread_from<12> : 0;
}
