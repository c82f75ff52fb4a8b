// Kernel K5: BLS12-381 G2 point operations over lanes, Jacobian over
// Fq2 = Fq[u] / (u^2 + 1).
//
// Replaces crypto3_fil_proofs_tpu/ops/pallas/g2.py `madd_nodbl_soa`
// (pallas_call :486), `dbl_soa` (:511) and `add_soa` (:533). The
// formulas are those of G1 (curve.cuh) over Fq2, whose product is three
// Fq products (Karatsuba); one thread owns one lane.
//
// Bound: three times G1's products against twice its bytes, so the
// kernels are operation-bound like K4.
#include "curve.cuh"

CURVE_ENTRY_POINTS(g2, fq2_t)
