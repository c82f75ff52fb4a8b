// Kernel K6: the bucket stages of the Pippenger multi-scalar product over
// BLS12-381 G1 and G2, around the point formulas of curve.cuh.
//
// Replaces the bucket work of crypto3_fil_proofs_tpu/ops/pallas/msm.py:
// `_bucket_accumulate_soa` (:206), a while_loop of whole-lane mixed-add
// passes in which pass s adds the s-th point of every bucket, and the
// aggregation `_aggregate_soa` (:367) / `_aggregate_split` (:438). The
// schedule (digits, sort, chunking) is built by ops/msm.py with torch
// ops, as the JAX package builds it with lax.sort.
//
// - msm_<g>_bucket_acc: one thread per chunk of at most S points of one
//   bucket walks its run of the sorted point order with the mixed add,
//   doubling where the point equals the sum so far (tiled bases make
//   such collisions real). Splitting buckets into chunks keeps a
//   crowded bucket from serialising the launch.
// - msm_<g>_bucket_reduce: one thread per bucket adds its chunks' sums.
// - msm_<g>_agg_segments: one thread per segment of L consecutive
//   buckets S_0 .. S_{L-1} computes sum_j j * S_j and sum_j S_j with two
//   running sums walked from the top; ops/msm.py combines segments.
//
// Bound: the work is the mixed adds (one per nonzero digit of a scalar,
// 11 Fq products each) and the full adds of the reduction and the
// aggregation (16 each); the bytes are the points and scalars, read once.
// The products dominate by far, so the stages are operation-bound; the
// design keeps every lane's running sum in registers for its whole walk.
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
  for (int c = first + 1; c < last; c++) acc = jac_add(acc, ld<Jac<E>>(chunks + c));
  st(out + b, acc);
}

template <class E>
__global__ void agg_segments_kernel(const Jac<E>* __restrict__ buckets, int seg,
                                    Jac<E>* __restrict__ acc_out, Jac<E>* __restrict__ sum_out,
                                    long long n) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n) return;
  Jac<E> acc = jac_infinity<E>(), run = jac_infinity<E>();
  const Jac<E>* b = buckets + t * seg;
  for (int j = seg - 1; j >= 0; j--) {
    acc = jac_add(acc, run);  // adds sum_{j' > j} S_j' once for every j
    run = jac_add(run, ld<Jac<E>>(b + j));
  }
  st(acc_out + t, acc);
  st(sum_out + t, run);
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
  extern "C" int PFX##_agg_segments(const void* buckets, int seg, void* acc_out, void* sum_out,   \
                                    long long n, void* stream) {                                  \
    if (n <= 0) return 0;                                                                         \
    agg_segments_kernel<E><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(          \
        (const Jac<E>*)buckets, seg, (Jac<E>*)acc_out, (Jac<E>*)sum_out, n);                      \
    return (int)cudaGetLastError();                                                               \
  }

MSM_ENTRY_POINTS(msm_g1, fq_t)
MSM_ENTRY_POINTS(msm_g2, fq2_t)
