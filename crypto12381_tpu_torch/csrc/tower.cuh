// Karatsuba pieces shared by the tower kernels: K2 and K4 (tower.cu) and
// K8-K11 (fp12.cu).  Device functions over Fp values in shared memory,
// canonical in and out unless a comment says otherwise (fp381.cuh holds
// the field arithmetic and the shared-memory helpers).

#pragma once

#include "fp381.cuh"

namespace fp381 {

constexpr int F2 = 2 * NL;   // limbs of one Fp2 value
constexpr int F6 = 3 * F2;   // limbs of one Fp6 value
constexpr int S6 = F6 + 4;   // a padded shared Fp6 row (304 bytes: 19 16-byte units)

// Coefficient f (0 real, 1 imaginary) of an Fp2 Karatsuba product from its
// Fp products t0 = t[0], t1 = t[d], t2 = t[2 d] in shared memory:
// re = t0 - t1, im = t2 - t0 - t1.
__device__ __forceinline__ void fp2_coeff(uint32_t* r, const uint32_t* t, int d, int f) {
  if (f == 0) {
    ld_fp(r, t);
  } else {
    ld_fp(r, t + 2 * d);
    sub_sh(r, t);
  }
  sub_sh(r, t + d);
}

// ------------------------------------------------------ Fp6 Karatsuba
//
// The 6 Fp2 products of an Fp6 product are pairs p = 0..5: t0, t1, t2,
// m01, m12, m02; Fp product q = 3 p + k is product k of pair p's Fp2
// Karatsuba (fp6_coeff gives the combine).

// Component f of coefficient j of pair p of the Fp6 value x in shared
// memory: x_p (p < 3), or x_j + x_l mod p for pairs (0, 1), (1, 2), (0, 2).
__device__ __forceinline__ void fp6_presum(uint32_t* r, const uint32_t* x, int p, int f) {
  const int j = p < 3 ? p : (p == 4 ? 1 : 0);
  ld_fp(r, x + j * F2 + f * NL);
  if (p >= 3) add_sh(r, x + (p == 3 ? 1 : 2) * F2 + f * NL);
}

// The operand of Fp product q = 3 p + k from the Fp6 value x: operand k of
// pair p's Fp2 pre-sum (kara_operand).
__device__ __forceinline__ void fp6_operand(uint32_t* r, const uint32_t* x, int q) {
  const int p = q / 3, k = q % 3;
  fp6_presum(r, x, p, k == 1);
  if (k == 2) {
    uint32_t s[NL];
    fp6_presum(s, x, p, 1);
    add_raw<NL>(r, r, s);
  }
}

// Coefficient f of output c from the Fp2 products in shared memory, where
// v(p, g) = v + (2 p + g) d is component g of pair p.
__device__ __forceinline__ void fp6_coeff(uint32_t* r, const uint32_t* v, int d, int c, int f) {
  auto at = [=](int p, int g) { return v + (2 * p + g) * d; };
  uint32_t x[NL];
  if (c == 0) {            // t0 + xi u, u = m12 - t1 - t2
    uint32_t u[NL];
    ld_fp(x, at(4, 0));
    sub_sh(x, at(1, 0));
    sub_sh(x, at(2, 0));
    ld_fp(u, at(4, 1));
    sub_sh(u, at(1, 1));
    sub_sh(u, at(2, 1));
    if (f == 0) sub_mod<NL>(r, x, u); else add_mod<NL>(r, x, u);
    add_sh(r, at(0, f));
  } else if (c == 1) {     // m01 - t0 - t1 + xi t2
    ld_fp(x, at(2, 1));
    ld_fp(r, at(2, 0));
    if (f == 0) sub_mod<NL>(r, r, x); else add_mod<NL>(r, r, x);
    add_sh(r, at(3, f));
    sub_sh(r, at(0, f));
    sub_sh(r, at(1, f));
  } else {                 // m02 - t0 - t2 + t1
    ld_fp(r, at(5, f));
    sub_sh(r, at(0, f));
    sub_sh(r, at(2, f));
    add_sh(r, at(1, f));
  }
}

}  // namespace fp381
