// Pieces shared by the curve kernels: K5-K7 (g1.cu) and K12-K14 (g2.cu).
// The complete formulas of Renes-Costello-Batina 2015 for y^2 = x^3 + b
// fold 3b into an operand as a few modular additions (mul12) and end the
// two additions (complete and mixed) in the same six round-2 products
// (rcb_lhs, rcb_rhs).  Canonical in and out (fp381.cuh holds the field
// arithmetic).

#pragma once

#include "fp381.cuh"

namespace fp381 {

// r = 12 x mod p: 2x, 4x, 8x, then 8x + 4x.  r may alias x.
__device__ __forceinline__ void mul12(uint32_t* r, const uint32_t* x) {
  uint32_t x4[NL];
  add_mod<NL>(x4, x, x);
  add_mod<NL>(x4, x4, x4);
  add_mod<NL>(r, x4, x4);
  add_mod<NL>(r, r, x4);
}

// The round-2 products of the complete and the mixed addition, over the
// round-2 operands j = 0..5 (t3, t4, bt5, w, z3a, t1m): product k is
// operand rcb_lhs(k) times operand rcb_rhs(k), that is
// t1m t3, bt5 t4, t1m z3a, bt5 w, z3a t4, w t3; then
// X3 = t1m t3 - bt5 t4, Y3 = t1m z3a + bt5 w, Z3 = z3a t4 + w t3.
__device__ __forceinline__ int rcb_lhs(int k) { return (0x342525 >> 4 * k) & 15; }
__device__ __forceinline__ int rcb_rhs(int k) { return (0x013410 >> 4 * k) & 15; }

}  // namespace fp381
