// Kernel K4: BLS12-381 G1 point operations over lanes, Jacobian over Fq.
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/g1.py `madd_nodbl_soa`
// (:521, pallas_call :533), `dbl_soa` (:551, :559), `add_soa` (:574,
// :580) and `madd_soa` (:496, pallas_call :506), the mixed add with its
// doubling path, which no path of the repository runs today (the MSMs
// use madd_nodbl and dbl). The formulas are in curve.cuh; one thread owns
// one lane.
//
// Bound: a mixed add needs 11 Fq products, a doubling 7 and a full add
// 16 (madd with its rare doubling: 11), each 2 x (144 + 156) 32-bit
// multiply-adds, against 240 to 432
// bytes of points in and out: at the H100's integer multiply-add rate
// the products take several times as long as the bytes, so the kernels
// are operation-bound. The design spends nothing on data movement (one
// 16-byte-vector load of each operand, one store of the result).
#include "curve.cuh"

CURVE_ENTRY_POINTS(g1, fq_t)

extern "C" int g1_madd(const void* acc, const void* q, const void* valid, void* out, long long n,
                       void* stream) {
  if (n <= 0) return 0;
  madd_kernel<fq_t><<<curve_blocks(n), CURVE_THREADS, 0, (cudaStream_t)stream>>>(
      (const Jac<fq_t>*)acc, (const Aff<fq_t>*)q, (const uint8_t*)valid, (Jac<fq_t>*)out, n);
  return (int)cudaGetLastError();
}
