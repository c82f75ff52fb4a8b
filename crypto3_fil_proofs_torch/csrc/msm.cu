// Kernel K6: the bucket stages of the Pippenger multi-scalar product over
// BLS12-381 G1 and G2, around the point formulas of curve.cuh.
//
// Replaces the bucket work of crypto3_fil_proofs_tpu/ops/pallas/msm.py:
// `_bucket_accumulate_soa` (:206), a while_loop of whole-lane mixed-add
// passes in which pass s adds the s-th point of every bucket, and the
// aggregation `_aggregate_soa` (:367, a suffix scan over whole lanes) /
// `_aggregate_split` (:438, the hi/lo digit split into tree sums). The
// schedule (digits, sort, chunking) is built by ops/msm.py with torch
// ops, as the JAX package builds it with lax.sort.
//
// - msm_<g>_bucket_acc: one thread per chunk of at most S points of one
//   bucket walks its run of the sorted point order with the mixed add,
//   doubling where the point equals the sum so far (tiled bases make
//   such collisions real). Splitting buckets into chunks keeps a
//   crowded bucket from serialising the launch.
// - msm_<g>_bucket_reduce: one thread per bucket adds its chunks' sums.
// - msm_<g>_agg_level: one level of sum_b b * S_b per window (below), one
//   thread per pair of entries; ops/msm.py runs log2(buckets) levels.
//
// Bound: the work is the mixed adds (one per nonzero digit of a scalar,
// 11 Fq products each) and the full adds of the reduction and the
// aggregation (16 each); the bytes are the points and scalars, read once.
// The products dominate by far, so the stages are operation-bound; the
// design keeps every lane's running sum in registers for its whole walk,
// and the products are the carry chains of field.cuh (G2: Karatsuba on
// wide products, one REDC per coefficient).
//
// Launch contract: the caller allocates every output, passes PyTorch's
// current stream, and raises if the returned cudaError_t is not 0.
#include "curve.cuh"

template <class E>
__global__ void bucket_acc_kernel(const Aff<E>* __restrict__ pts, const int* __restrict__ order,
                                  const int* __restrict__ start, const int* __restrict__ len,
                                  Jac<E>* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<E> acc = jac_infinity<E>();
  const int s = start[i], cnt = len[i];
  for (int k = 0; k < cnt; k++) {
    bool same;
    // inlined for both groups: the walk holds one point, so G2's formulas
    // fit its registers here (out of line it ran slower)
    acc = jac_madd_nodbl(acc, ld<Aff<E>>(pts + order[s + k]), true, same);
    if (same) acc = jac_dbl(acc);
  }
  st(out + i, acc);
}

template <class E>
__global__ void bucket_reduce_kernel(const Jac<E>* __restrict__ chunks, const int* __restrict__ ptr,
                                     Jac<E>* __restrict__ out, long long n) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int first = ptr[b], last = ptr[b + 1];
  Jac<E> acc = first < last ? ld<Jac<E>>(chunks + first) : jac_infinity<E>();
  for (int c = first + 1; c < last; c++) acc = p_add(acc, ld<Jac<E>>(chunks + c));
  st(out + b, acc);
}

// One level of the aggregation. Over groups of L consecutive entries S_j,
// T_j (j < L) of the same window it writes
//   T'_g = sum_j j S_j + sum_j T_j,   S'_g = L sum_j S_j,
// so sum_t t S_t + sum_t T_t over a window stays the same while the
// window shrinks L-fold. From the buckets (T = 0) ops/msm.py repeats it
// until one entry per window is left: its T' is sum_b b S_b. At L = 2 a
// level costs one full add for the pair and two for the carried T (one
// for the first level, which has none) and one doubling, i.e. about two
// full adds and one doubling per bucket over all levels, and each level
// is as deep as three adds: every level has one thread per pair, so the
// first fills the card and the whole aggregation takes log2(buckets)
// short launches.
template <class E>
__global__ void agg_level_kernel(const Jac<E>* __restrict__ S, const Jac<E>* __restrict__ T, int L,
                                 int log_l, Jac<E>* __restrict__ t_out, Jac<E>* __restrict__ s_out,
                                 long long n) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= n) return;
  const Jac<E>* s = S + g * L;
  Jac<E> run = jac_infinity<E>(), acc = jac_infinity<E>();
  for (int j = L - 1; j >= 1; j--) {
    run = p_add(run, ld<Jac<E>>(s + j));
    acc = p_add(acc, run);  // adds S_j' for every j' >= j: j S_j in all
  }
  run = p_add(run, ld<Jac<E>>(s));
  if (T != nullptr)
    for (int j = 0; j < L; j++) acc = p_add(acc, ld<Jac<E>>(T + g * L + j));
  st(t_out + g, acc);
  if (s_out != nullptr) {
    for (int k = 0; k < log_l; k++) run = p_dbl(run);
    st(s_out + g, run);
  }
}

#define MSM_ENTRY_POINTS(PFX, E)                                                                \
  extern "C" int PFX##_bucket_acc(const void* pts, const void* order, const void* start,          \
                                  const void* len, void* out, long long n, void* stream) {        \
    if (n <= 0) return 0;                                                                         \
    bucket_acc_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(            \
        (const Aff<E>*)pts, (const int*)order, (const int*)start, (const int*)len, (Jac<E>*)out, \
        n);                                                                                       \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int PFX##_bucket_reduce(const void* chunks, const void* ptr, void* out, long long n, \
                                     void* stream) {                                              \
    if (n <= 0) return 0;                                                                         \
    bucket_reduce_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(         \
        (const Jac<E>*)chunks, (const int*)ptr, (Jac<E>*)out, n);                                 \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int PFX##_agg_level(const void* S, const void* T, int L, int log_l, void* t_out,      \
                                 void* s_out, long long n, void* stream) {                        \
    if (n <= 0) return 0;                                                                         \
    agg_level_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(             \
        (const Jac<E>*)S, (const Jac<E>*)T, L, log_l, (Jac<E>*)t_out, (Jac<E>*)s_out, n);         \
    return (int)cudaGetLastError();                                                               \
  }

MSM_ENTRY_POINTS(msm_g1, fq_t)
MSM_ENTRY_POINTS(msm_g2, fq2_t)
