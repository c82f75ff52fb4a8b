// Kernel K2: the Poseidon permutation over BLS12-381 Fr as a Merkle /
// column hash. Each thread hashes one preimage of `arity` Montgomery
// elements: state = [domain tag, preimage...], one permutation, digest =
// state[1].
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/poseidon.py `permute_soa`
// (:594, pallas_call :613, body `_make_permute_kernel` :241) and its MXU
// form `permute_soa_mxu` (:548, pallas_call :566), entered through
// `hash_level_packed` (:653). It runs the same sparse schedule, with the
// constants staged as the JAX kernel stages them: the device functions of
// csrc/poseidon.cuh, which kernel K7 (csrc/poseidon_witness.cu) shares.
//
// Bound: per hash the permutation needs 64,416 (arity 2), 196,848
// (arity 8) and 277,728 (arity 11) 32-bit multiply-adds when each mixed
// element is summed wide and reduced once and x^2, x^4 are squarings
// (chip_smoke.py `poseidon_mads`), against (arity + 1) * 32 bytes of
// traffic: bound by integer multiplies by three orders of magnitude.
//
// Design, for that bound:
// - Accumulate-then-REDC, as the JAX kernel does (pallas/poseidon.py
//   :95-161): a dense row, out0 of a partial round and each w_i * x0 + x_i
//   is a sum of wide products (field.cuh `mul_wide`, `add_wide`) that
//   takes one REDC and one final reduction. Every product is a PTX carry
//   chain of 32-bit multiply-adds. The function is unchanged: every
//   mixed element is reduced to canonical form, as the plain version's.
// - The constants are staged once per block into shared memory (15 / 54
//   / 76 KB at t = 3 / 9 / 12, dynamic shared memory above 48 KB); all
//   threads of a warp read the same constant at once, a broadcast.
// - The state stays in registers. The dense mix's row loop stays rolled
//   (unrolled, t^2 inline products make the code too large for the
//   instruction cache), so its finished rows wait in a per-thread slice of
//   shared memory, not in local memory; so do the elements of a full
//   round between their x^5 (one copy of that code for all t). At t = 3
//   both loops are unrolled and everything stays in registers.
// - The grid is persistent: as many blocks as fit on the card at once,
//   each walking the hashes with a stride, so the constants are staged
//   once per resident block and every SM is busy at every width.
//
// Launch contract: the caller allocates `out`, passes PyTorch's current
// stream, and raises if the returned cudaError_t is not 0.
#include <cuda_runtime.h>

#include "poseidon.cuh"

template <int T>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::blocks)
    poseidon_kernel(const uint32_t* __restrict__ pre, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ consts, int n_words, long long n, int r_f, int r_p) {
  extern __shared__ uint4 shm[];
  uint32_t* sc = reinterpret_cast<uint32_t*>(shm);
  for (int k = threadIdx.x; k < n_words / 4; k += blockDim.x)
    shm[k] = __ldg(reinterpret_cast<const uint4*>(consts) + k);
  __syncthreads();
  uint32_t* rows = sc + n_words + threadIdx.x;  // this thread's row slice
  const int step = blockDim.x;

  const uint32_t* tag = sc + n_words - L;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t s[T][L];
    load_state<T>(s, tag, pre + i * (T - 1) * L);
    permute<T>(s, sc, rows, step, r_f, r_p, Sbox5{});
    store_elem<L>(out + i * L, s[1]);
  }
}

template <int T>
static int launch(const void* pre, void* out, const void* consts, long long n, int r_f, int r_p,
                  void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = Shape<T>::threads;
  const int n_words = const_words<T>(r_f, r_p);
  const size_t shmem = shared_bytes<T>(n_words, threads);
  static std::atomic<int> resident[MAX_CARDS];  // resident blocks of this width, per card
  int blocks_on_card = 0;
  cudaError_t err = resident_blocks(poseidon_kernel<T>, threads, shmem, resident, &blocks_on_card);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (n + threads - 1) / threads;
  const int blocks = (int)(needed < blocks_on_card ? needed : blocks_on_card);
  poseidon_kernel<T><<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      (const uint32_t*)pre, (uint32_t*)out, (const uint32_t*)consts, n_words, n, r_f, r_p);
  return (int)cudaGetLastError();
}

// pre: [n, t-1, 8] u32 Montgomery; out: [n, 8]; consts: the staged buffer
// of width t. Widths 3, 9 and 12 (arity 2, 8 and 11) are built.
extern "C" int poseidon_hash(const void* pre, void* out, const void* consts, long long n, int t,
                             int r_f, int r_p, void* stream) {
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
