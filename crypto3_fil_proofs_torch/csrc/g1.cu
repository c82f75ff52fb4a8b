// Kernel K4: BLS12-381 G1 point operations over lanes, Jacobian over Fq.
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/g1.py `madd_nodbl_soa`
// (:521, pallas_call :533), `dbl_soa` (:551, :559) and `add_soa` (:574,
// :580). The formulas are in curve.cuh; one thread owns one lane.
//
// Bound: a mixed add needs 11 Fq products, a doubling 7 and a full add
// 16, each 2 x (144 + 156) 32-bit multiply-adds, against 240 to 432
// bytes of points in and out: at the H100's integer multiply-add rate
// the products take several times as long as the bytes, so the kernels
// are operation-bound. The design spends nothing on data movement (one
// 16-byte-vector load of each operand, one store of the result) and
// keeps the CIOS product out of line to hold register pressure down.
#include "curve.cuh"

CURVE_ENTRY_POINTS(g1, fq_t)
