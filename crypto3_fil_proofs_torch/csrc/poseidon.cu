// Kernel K2: the Poseidon permutation over BLS12-381 Fr as a Merkle /
// column hash. Each thread hashes one preimage of `arity` Montgomery
// elements: state = [domain tag, preimage...], one permutation, digest =
// state[1].
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/poseidon.py `permute_soa`
// (:594, pallas_call :613, body `_make_permute_kernel` :241) and its MXU
// form `permute_soa_mxu` (:548, pallas_call :566), entered through
// `hash_level_packed` (:653). It runs the same sparse schedule
// (pallas/poseidon.py:252-309, host `permutation_optimized`,
// ops/poseidon.py:311-338):
//   R_F/2 full rounds:  ARC, x^5 on every element, dense MDS mix;
//   R_P partial rounds: ARC with c', x^5 on element 0, sparse mix
//                       out0 = m00*x0 + sum v_j*x_{j+1}, out_i = w_i*x0 + x_i;
//   one dense mix by d_last;
//   R_F/2 full rounds.
// The constants come staged by crypto3_fil_proofs_torch/ops/poseidon_torch.py
// as one flat Montgomery buffer [rc | mds | sp | d_last | tag] (the layout
// of `_staged`, pallas/poseidon.py:315, in 32-bit limbs).
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

#include "field.cuh"

constexpr int L = Fr::N;  // limbs per element

// threads per block and blocks per SM: the registers of t x 8 limbs of
// state and the shared memory of the constants and the row slices
// decide. At t = 9 and 12 one block fills an SM's shared memory. Arity
// 11 ran faster at 256 threads (up to 255 registers) than at 384 (168
// registers and a few spills); PERF.md has the times.
template <int T>
struct Shape;
template <>
struct Shape<3> {
  static constexpr int threads = 256, blocks = 2;
};
template <>
struct Shape<9> {
  static constexpr int threads = 384, blocks = 1;
};
template <>
struct Shape<12> {
  static constexpr int threads = 256, blocks = 1;
};

__device__ __forceinline__ void load_shared(uint32_t r[L], const uint32_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void sbox(uint32_t x[L]) {
  uint32_t x2[L], x4[L];
  mont_mul<Fr>(x2, x, x);
  mont_mul<Fr>(x4, x2, x2);
  mont_mul<Fr>(x, x4, x);
}

// r = sum_j s_j c_j / R mod p over the n constants at c (one REDC)
template <int T>
__device__ __forceinline__ void dot_row(uint32_t r[L], const uint32_t s[T][L], const uint32_t* c) {
  uint32_t acc[2 * L], w[2 * L], k[L], top = 0;
  load_shared(k, c);
  mul_wide<L>(acc, s[0], k);
#pragma unroll
  for (int j = 1; j < T; j++) {
    load_shared(k, c + j * L);
    mul_wide<L>(w, s[j], k);
    add_wide<L>(acc, top, w);
  }
  // below p + 1 + t p (p / R) < 8p for t <= 12
  reduce<Fr, 3>(r, redc<Fr>(r, acc, top));
}

// s = M s for a dense t x t Montgomery matrix M (row-major, in shared
// memory). Rows wait in `rows` (T x 8 words, stride `step` between words).
template <int T>
__device__ __forceinline__ void mix(uint32_t s[T][L], const uint32_t* m, uint32_t* rows, int step) {
  if constexpr (T <= 3) {
    uint32_t out[T][L];
#pragma unroll
    for (int i = 0; i < T; i++) dot_row<T>(out[i], s, m + i * T * L);
#pragma unroll
    for (int i = 0; i < T; i++)
#pragma unroll
      for (int k = 0; k < L; k++) s[i][k] = out[i][k];
  } else {
#pragma unroll 1
    for (int i = 0; i < T; i++) {
      uint32_t r[L];
      dot_row<T>(r, s, m + i * T * L);
#pragma unroll
      for (int k = 0; k < L; k++) rows[(i * L + k) * step] = r[k];
    }
#pragma unroll
    for (int i = 0; i < T; i++)
#pragma unroll
      for (int k = 0; k < L; k++) s[i][k] = rows[(i * L + k) * step];
  }
}

// ARC with c' + x^5 on element 0 + the sparse mix of one partial round.
// sp row: [m00, v_0 .. v_{t-2}, w_0 .. w_{t-2}].
template <int T>
__device__ __forceinline__ void partial_round(uint32_t s[T][L], const uint32_t* rc, const uint32_t* sp) {
  uint32_t c[L];
#pragma unroll
  for (int e = 0; e < T; e++) {
    load_shared(c, rc + e * L);
    add_mod<Fr>(s[e], s[e], c);
  }
  sbox(s[0]);
  uint32_t out0[L];
  dot_row<T>(out0, s, sp);
  // x_e + w_e x0: x_e enters the high half of the wide product, so one
  // REDC leaves it below p + 1 + p + p (p / R) < 4p
#pragma unroll
  for (int e = 1; e < T; e++) {
    uint32_t w[2 * L];
    load_shared(c, sp + (T + e - 1) * L);
    mul_wide<L>(w, s[0], c);
    w[L] = add_cc(w[L], s[e][0]);
#pragma unroll
    for (int k = 1; k < L; k++) w[L + k] = addc_cc(w[L + k], s[e][k]);
    const uint32_t top = addc(0, 0);
    reduce<Fr, 2>(s[e], redc<Fr>(s[e], w, top));
  }
#pragma unroll
  for (int k = 0; k < L; k++) s[0][k] = out0[k];
}

// ARC and x^5 on every element of a full round. Above t = 3 the elements
// pass through the row slice, so that one copy of the x^5 code serves all.
template <int T>
__device__ __forceinline__ void full_sbox(uint32_t s[T][L], const uint32_t* rc, uint32_t* rows,
                                          int step) {
  if constexpr (T <= 3) {
#pragma unroll
    for (int e = 0; e < T; e++) {
      uint32_t c[L];
      load_shared(c, rc + e * L);
      add_mod<Fr>(s[e], s[e], c);
      sbox(s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < T; e++)
#pragma unroll
      for (int k = 0; k < L; k++) rows[(e * L + k) * step] = s[e][k];
#pragma unroll 1
    for (int e = 0; e < T; e++) {
      uint32_t x[L], c[L];
#pragma unroll
      for (int k = 0; k < L; k++) x[k] = rows[(e * L + k) * step];
      load_shared(c, rc + e * L);
      add_mod<Fr>(x, x, c);
      sbox(x);
#pragma unroll
      for (int k = 0; k < L; k++) rows[(e * L + k) * step] = x[k];
    }
#pragma unroll
    for (int e = 0; e < T; e++)
#pragma unroll
      for (int k = 0; k < L; k++) s[e][k] = rows[(e * L + k) * step];
  }
}

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

  const int rounds = r_f + r_p;
  const int half = r_f / 2;
  const uint32_t* rc = sc;
  const uint32_t* mds = rc + rounds * T * L;
  const uint32_t* sp = mds + T * T * L;
  const uint32_t* dl = sp + r_p * (2 * T - 1) * L;
  const uint32_t* tag = dl + T * T * L;

  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t s[T][L];
    load_shared(s[0], tag);
#pragma unroll
    for (int e = 1; e < T; e++) load_elem<L>(s[e], pre + (i * (T - 1) + e - 1) * L);

    // steps 0..rounds: the full and partial rounds in order, with the
    // d_last mix as the extra step between the partial rounds and the
    // second half of the full rounds. One call site per mix keeps the
    // code to a single copy of the t x t mix.
#pragma unroll 1
    for (int step_i = 0; step_i <= rounds; step_i++) {
      if (step_i >= half && step_i < half + r_p) {
        partial_round<T>(s, rc + step_i * T * L, sp + (step_i - half) * (2 * T - 1) * L);
        continue;
      }
      const bool d_last = step_i == half + r_p;
      if (!d_last) full_sbox<T>(s, rc + (step_i < half ? step_i : step_i - 1) * T * L, rows, step);
      mix<T>(s, d_last ? dl : mds, rows, step);
    }
    store_elem<L>(out + i * L, s[1]);
  }
}

template <int T>
static int launch(const void* pre, void* out, const void* consts, long long n, int r_f, int r_p,
                  void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = Shape<T>::threads;
  const int n_words = ((r_f + r_p) * T + 2 * T * T + r_p * (2 * T - 1) + 1) * L;
  const size_t shmem = (size_t)n_words * 4 + (T > 3 ? (size_t)T * L * 4 * threads : 0);
  static int blocks_on_card = 0;  // resident blocks of this width, once per process
  if (blocks_on_card == 0) {
    cudaError_t err = cudaFuncSetAttribute(poseidon_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, poseidon_kernel<T>, threads, shmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks_on_card = sms * per_sm;
  }
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
