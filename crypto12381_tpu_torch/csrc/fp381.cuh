// Device arithmetic for the BLS12-381 base field Fp and scalar field Fr
// on 32-bit limbs.
//
// An Fp element is 12 little-endian uint32 limbs of its Montgomery form
// x * 2^384 mod p, canonical (0 <= v < p) at every function boundary.  An
// operand of mont_mul<12> may also be the raw sum of two canonical values
// (below 2p < 2^382): then a*b < 4p^2, and (a*b + m*p) / 2^384 < 2p, so one
// conditional subtraction gives the canonical product.
//
// An Fr element is 8 limbs of x * 2^256 mod r, and mont_mul<8> takes
// canonical operands only.  There is no room for pre-sums: 4r > 2^256, and
// for a, b < 2r the reduced product (a*b + m*r) / 2^256 can reach about
// 2.8r, past one conditional subtraction.  For a, b < r it is below
// r^2 / 2^256 + r < 2r, since r < 2^256, and 2r < 2^256 keeps it in 8
// limbs with a zero top word.  So add_raw never feeds the Fr product.
//
// mont_mul is the CIOS (coarsely integrated operand scanning) Montgomery
// product and mont_sqr the Montgomery square, both on PTX carry chains
// (each row of partial products split into two independent chains, its
// even and its odd limbs), templates over the limb count that selects the
// field.  Every loop is unrolled; the limbs live in registers.  On the
// host the same schedules run on an emulated carry flag (see "carry
// chains" below).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace fp381 {

constexpr int NL = 12;

// -p^-1 mod 2^32
constexpr uint32_t FP_N0 = 0xfffcfffdu;

constexpr int FR_NL = 8;

// -r^-1 mod 2^32 (r = 1 mod 2^32)
constexpr uint32_t FR_N0 = 0xffffffffu;

// Modulus traits: the limb count selects the field.  Every loop over the
// limbs is unrolled, so p(j) folds to an immediate operand of the
// instruction that reads it.  Read from __constant__ memory instead, the
// moduli cost registers: up to 42 more per thread (the cyclotomic power),
// and K11's spill grew from 24 to 60 bytes (PERF.md).
template <int N>
struct Field;

template <>
struct Field<NL> {
  static __device__ __forceinline__ uint32_t p(int j) {
    constexpr uint32_t FP_P[NL] = {
        0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
        0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return FP_P[j];
  }
  static constexpr uint32_t n0 = FP_N0;
};

template <>
struct Field<FR_NL> {
  static __device__ __forceinline__ uint32_t p(int j) {
    constexpr uint32_t FR_R[FR_NL] = {
        0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
        0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return FR_R[j];
  }
  static constexpr uint32_t n0 = FR_N0;
};

// ------------------------------------------------------- carry chains
//
// The products are written once, over these primitives.  On the card each
// is one PTX instruction, and the carry between them is the hardware's
// carry flag CC.CF: `mad_lo_cc` and `add_cc` start a chain (no carry in),
// the `..._cc` forms set the flag, the `c` forms (madc, addc, subc) read
// it.  Every call is `asm volatile`, so the compiler keeps their order and
// puts nothing between two of them that could write the flag (it emits no
// carry instruction of its own in this code).  On the host, where the g++
// harness of the tests runs the kernel bodies, the flag is the word `cf` of
// the chain's Carry, emulated in 64-bit arithmetic.  Only these functions
// differ between the card and the host; the schedules that call them are
// the same text, so the harness runs the card's schedule, carry for carry.
// The PTX itself is checked only on the card (chip_smoke.py).

struct Carry {
  uint32_t cf = 0;
};

__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}

#ifdef __CUDA_ARCH__
#define FP381_CHAIN3(name, op)                                                        \
  __device__ __forceinline__ uint32_t name(Carry&, uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                                       \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));          \
    return r;                                                                         \
  }
#define FP381_CHAIN2(name, op)                                            \
  __device__ __forceinline__ uint32_t name(Carry&, uint32_t a, uint32_t b) { \
    uint32_t r;                                                           \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));          \
    return r;                                                             \
  }
FP381_CHAIN3(mad_lo_cc, "mad.lo.cc.u32")
FP381_CHAIN3(madc_lo_cc, "madc.lo.cc.u32")
FP381_CHAIN3(madc_hi_cc, "madc.hi.cc.u32")
FP381_CHAIN3(madc_hi, "madc.hi.u32")
FP381_CHAIN2(add_cc, "add.cc.u32")
FP381_CHAIN2(addc_cc, "addc.cc.u32")
FP381_CHAIN2(addc, "addc.u32")
FP381_CHAIN2(sub_cc, "sub.cc.u32")
FP381_CHAIN2(subc_cc, "subc.cc.u32")
FP381_CHAIN2(subc, "subc.u32")
#undef FP381_CHAIN3
#undef FP381_CHAIN2
// m = x n0 inside a chain: mul.lo leaves the flag alone, and as an asm
// statement it keeps its place between the chain's instructions.
__device__ __forceinline__ uint32_t mul_lo_in_chain(Carry&, uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
#else
inline uint32_t chain_out(Carry& k, uint64_t s) {
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t mad_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
  return chain_out(k, (uint64_t)(a * b) + c);
}
inline uint32_t madc_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
  return chain_out(k, (uint64_t)(a * b) + c + k.cf);
}
inline uint32_t madc_hi_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
  return chain_out(k, (((uint64_t)a * b) >> 32) + c + k.cf);
}
inline uint32_t madc_hi(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + k.cf);
}
inline uint32_t add_cc(Carry& k, uint32_t a, uint32_t b) { return chain_out(k, (uint64_t)a + b); }
inline uint32_t addc_cc(Carry& k, uint32_t a, uint32_t b) {
  return chain_out(k, (uint64_t)a + b + k.cf);
}
inline uint32_t addc(Carry& k, uint32_t a, uint32_t b) { return a + b + k.cf; }
// the subtractions' flag is the borrow
inline uint32_t sub_cc(Carry& k, uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a - b;
  k.cf = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
inline uint32_t subc_cc(Carry& k, uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a - b - k.cf;
  k.cf = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
inline uint32_t subc(Carry& k, uint32_t a, uint32_t b) { return a - b - k.cf; }
inline uint32_t mul_lo_in_chain(Carry&, uint32_t a, uint32_t b) { return a * b; }
#endif

// r = t - p if t >= p (t given as N limbs plus a top word of 0 or 1), else
// t: one borrow chain through t - p and the top word, then a branch-free
// select on the final borrow.
template <int N>
__device__ __forceinline__ void cond_sub_p(uint32_t* r, const uint32_t* t, uint32_t top) {
  Carry k;
  uint32_t d[N];
  d[0] = sub_cc(k, t[0], Field<N>::p(0));
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(k, t[j], Field<N>::p(j));
  // top - borrow: 0xffffffff exactly when t < p (top 0, a borrow out)
  const uint32_t keep = 0u - (subc(k, top, 0) >> 31);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (t[j] & keep) | (d[j] & ~keep);
}

// ------------------------------------------------- Montgomery product
//
// mont_mul is a CIOS (coarsely integrated operand scanning) product on
// carry chains.  The running value (a b_0..i + m p) / 2^32(i+1) is kept as
// two N-limb arrays X + 2^32 Y: X takes the partial products of the even
// limbs, a_0 b_i, a_2 b_i, ... (each a 64-bit pair that fills two limbs,
// so one carry chain adds a whole row of them), and Y those of the odd
// limbs, one limb up.  The two chains of a row, and the two of its
// reduction m p, are independent, so the scheduler always has a second
// instruction to issue.  Dividing by 2^32 then turns Y into the next
// row's X and X, one limb down, into its Y (the shift is folded into the
// next row's odd chain), so the two arrays swap roles every row; after
// the N rows (N even) the odd array is merged into the even one.
//
// Bounds.  Fp: for a, b < 2p < 2^382 the value after row i is
// (a b_0..i + M p) / 2^32(i+1) < a + p < 3p, so before its division it is
// below 2^32 3p < 2^(32(N+1)): no carry leaves the top limb Y_(N-1), and
// the odd chain's last carry, which would land above it, is 0 (it is
// dropped).  At the end (a b + M p) / 2^384 < 4p^2 / 2^384 + p < 1.5p, so
// one conditional subtraction makes it canonical.  Fr: for a, b < r the
// same steps give < 2r < 2^256 (row values below 2^(32 9)); the operands
// must be canonical, since 4r > 2^256 leaves no room for pre-sums.

// acc = x_0 y, x_2 y, ..., x_(N-2) y as 64-bit pairs (no carries): the
// first row.  x is read at even offsets (pass a + 1 for the odd limbs).
template <int N>
__device__ __forceinline__ void row_mul(uint32_t* acc, const uint32_t* x, uint32_t y) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = mul_lo(x[j], y);
    acc[j + 1] = mul_hi(x[j], y);
  }
}

// acc += x_0 y + x_2 y 2^64 + ... in one carry chain; the carry out is left
// in the flag.
template <int N>
__device__ __forceinline__ void row_mad(Carry& k, uint32_t* acc, const uint32_t* x, uint32_t y) {
  acc[0] = mad_lo_cc(k, x[0], y, acc[0]);
  acc[1] = madc_hi_cc(k, x[0], y, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(k, x[j], y, acc[j]);
    acc[j + 1] = madc_hi_cc(k, x[j], y, acc[j + 1]);
  }
}

// acc = (acc >> 64) + x_0 y + x_2 y 2^64 + ... + the flag, in one chain that
// ends the carry in the top limb (the caller's bound keeps it there).
template <int N>
__device__ __forceinline__ void row_mad_shift(Carry& k, uint32_t* acc, const uint32_t* x,
                                              uint32_t y) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    acc[j] = madc_lo_cc(k, x[j], y, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(k, x[j], y, acc[j + 3]);
  }
  acc[N - 2] = madc_lo_cc(k, x[N - 2], y, 0);
  acc[N - 1] = madc_hi(k, x[N - 2], y, 0);
}

// The modulus's even and odd limbs as arrays the rows can read at even
// offsets.
template <int N>
struct Limbs {
  uint32_t v[N];
  __device__ __forceinline__ Limbs() {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = Field<N>::p(j);
  }
};

// The reduction of one row: x + 2^32 y += m p with m = x_0 n0, so that x_0
// becomes 0; y's carry out of its top limb is 0 by the caller's bound.
template <int N>
__device__ __forceinline__ void redc_row(Carry& k, uint32_t* x, uint32_t* y, const uint32_t* p) {
  const uint32_t m = mul_lo_in_chain(k, x[0], Field<N>::n0);
  row_mad<N>(k, y, p + 1, m);
  row_mad<N>(k, x, p, m);
  y[N - 1] = addc(k, y[N - 1], 0);
}

// Row i >= 1 of mont_mul: on entry x holds the value's limbs 0..N-1 and y
// (the previous row's x) its limbs -1..N-2, y_0 = 0.  Adds a b_i and m p;
// on exit y holds limbs 0..N-1 and x limbs -1..N-2 of the value / 2^32.
template <int N>
__device__ __forceinline__ void mul_row(Carry& k, uint32_t* x, uint32_t* y, const uint32_t* a,
                                        uint32_t bi, const uint32_t* p) {
  x[0] = add_cc(k, x[0], y[1]);            // y's limb 0 into x; its carry to limb 1
  row_mad_shift<N>(k, y, a + 1, bi);       // y: limbs 1..N, + the odd a_j b_i
  row_mad<N>(k, x, a, bi);                 // x: + the even a_j b_i
  y[N - 1] = addc(k, y[N - 1], 0);
  redc_row<N>(k, x, y, p);
}

// x (limbs 0..N-1) + y (limbs -1..N-2, y_0 = 0) into x.
template <int N>
__device__ __forceinline__ void merge_rows(Carry& k, uint32_t* x, const uint32_t* y) {
  x[0] = add_cc(k, x[0], y[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) x[j] = addc_cc(k, x[j], y[j + 1]);
  x[N - 1] = addc(k, x[N - 1], 0);
}

// r = a * b * 2^(-32N) mod p, canonical.  a, b < 2p for Fp, canonical for
// Fr.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  static_assert(N % 2 == 0, "the rows pair limbs");
  const Limbs<N> p;
  Carry k;
  uint32_t ev[N], od[N];
  row_mul<N>(ev, a, b[0]);
  row_mul<N>(od, a + 1, b[0]);
  redc_row<N>(k, ev, od, p.v);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    if (i & 1) mul_row<N>(k, od, ev, a, b[i], p.v);
    else mul_row<N>(k, ev, od, a, b[i], p.v);
  }
  merge_rows<N>(k, ev, od);                // row N - 1 is odd: ev holds limbs 0..N-1
  cond_sub_p<N>(r, ev, 0);
}
// ------------------------------------------------ Montgomery squaring
//
// mont_sqr forms a^2 as the 2N-limb T and then reduces it (separated
// operand scanning).  Each off-diagonal product a_i a_j (i < j) is formed
// once: row i runs two carry chains, j - i odd into od and j - i even into
// ev, each a run of non-overlapping 64-bit pairs (two accumulators, so the
// chains are independent).  Each chain ends by adding its carry into the
// next limb, which earlier rows have given at most one carry and no
// product, so that limb cannot wrap.  One chain sums od + ev, a funnel
// shift doubles the sum, and one chain adds the squares a_i^2 on the
// diagonal.  Then N reduction rows, mont_mul's even/odd rows without their
// product part, take T's low half L to (L + M p) / 2^32N <= p (M < 2^32N),
// and one chain adds T's high half: (T + M p) / 2^32N, the Montgomery
// square.  32-bit multiply-adds: Fp 2 (66 + 12 + 144) + 12 = 456 against
// mont_mul's 588, Fr 2 (28 + 8 + 64) + 8 = 208 against 264.
//
// Operands: those of mont_mul.  Fp: a < 2p gives T < 4p^2 and a result
// below 4p^2 / 2^384 + p < 1.5p; Fr: a < r gives T < r^2 and a result below
// r^2 / 2^256 + r < 2r.  Reduction row i leaves (L + M p) / 2^32(i+1) <
// 2^32(N-i-1) + p, so before its division its value is below
// 2^32N + 2^32 p < 2^(32(N+1)): as in mont_mul, no carry leaves the top
// limb.  One conditional subtraction makes the result canonical.  r may
// alias a.  The chain kernel (fp.cu) squares canonical values only.
template <int N>
__device__ __forceinline__ void mont_sqr(uint32_t* r, const uint32_t* a) {
  static_assert(N % 2 == 0, "the rows pair limbs");
  const Limbs<N> p;
  Carry k;
  uint32_t ev[2 * N], od[2 * N];
#pragma unroll
  for (int q = 0; q < 2 * N; ++q) ev[q] = od[q] = 0;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    int j = i + 1;                         // od: j = i + 1, i + 3, ... from limb 2i + 1
    od[i + j] = mad_lo_cc(k, a[i], a[j], od[i + j]);
    od[i + j + 1] = madc_hi_cc(k, a[i], a[j], od[i + j + 1]);
#pragma unroll
    for (j = i + 3; j < N; j += 2) {
      od[i + j] = madc_lo_cc(k, a[i], a[j], od[i + j]);
      od[i + j + 1] = madc_hi_cc(k, a[i], a[j], od[i + j + 1]);
    }
    od[i + j] = addc(k, od[i + j], 0);     // the limb after the last pair
    if (i + 2 < N) {                       // ev: j = i + 2, i + 4, ... from limb 2i + 2
      j = i + 2;
      ev[i + j] = mad_lo_cc(k, a[i], a[j], ev[i + j]);
      ev[i + j + 1] = madc_hi_cc(k, a[i], a[j], ev[i + j + 1]);
#pragma unroll
      for (j = i + 4; j < N; j += 2) {
        ev[i + j] = madc_lo_cc(k, a[i], a[j], ev[i + j]);
        ev[i + j + 1] = madc_hi_cc(k, a[i], a[j], ev[i + j + 1]);
      }
      ev[i + j] = addc(k, ev[i + j], 0);
    }
  }
  // od = od + ev: the off-diagonal sum U < 2^(64N - 1) (od_0 = ev_0 = ev_1 = 0)
  od[2] = add_cc(k, od[2], ev[2]);
#pragma unroll
  for (int q = 3; q < 2 * N - 1; ++q) od[q] = addc_cc(k, od[q], ev[q]);
  od[2 * N - 1] = addc(k, od[2 * N - 1], ev[2 * N - 1]);
  // ev = T = 2 U + sum a_i^2 2^(64 i); limb q of 2U is U_q << 1 | U_(q-1) >> 31
  ev[0] = mad_lo_cc(k, a[0], a[0], 0);
  ev[1] = madc_hi_cc(k, a[0], a[0], od[1] << 1);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    ev[2 * i] = madc_lo_cc(k, a[i], a[i], (od[2 * i] << 1) | (od[2 * i - 1] >> 31));
    const uint32_t hi = (od[2 * i + 1] << 1) | (od[2 * i] >> 31);
    ev[2 * i + 1] = i + 1 < N ? madc_hi_cc(k, a[i], a[i], hi) : madc_hi(k, a[i], a[i], hi);
  }
  // reduce L = ev_0..N-1 (od_0..N-1 the odd rows' array), then add H = ev_N..2N-1
  {
    const uint32_t m = mul_lo(ev[0], Field<N>::n0);
    row_mul<N>(od, p.v + 1, m);
    row_mad<N>(k, ev, p.v, m);
    od[N - 1] = addc(k, od[N - 1], 0);
  }
#pragma unroll
  for (int i = 1; i < N; ++i) {
    uint32_t* x = i & 1 ? od : ev;         // limbs 0..N-1
    uint32_t* y = i & 1 ? ev : od;         // limbs -1..N-2
    x[0] = add_cc(k, x[0], y[1]);
    const uint32_t m = mul_lo_in_chain(k, x[0], Field<N>::n0);
    row_mad_shift<N>(k, y, p.v + 1, m);    // y: limbs 1..N, + the odd p_j m
    row_mad<N>(k, x, p.v, m);
    y[N - 1] = addc(k, y[N - 1], 0);
  }
  merge_rows<N>(k, ev, od);                // row N - 1 is odd: ev holds limbs 0..N-1
  ev[0] = add_cc(k, ev[0], ev[N]);
#pragma unroll
  for (int q = 1; q < N - 1; ++q) ev[q] = addc_cc(k, ev[q], ev[N + q]);
  ev[N - 1] = addc(k, ev[N - 1], ev[2 * N - 1]);
  cond_sub_p<N>(r, ev, 0);
}

// r = a + b without reduction (a value below 2p for canonical a, b).
template <int N>
__device__ __forceinline__ void add_raw(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = (a + b) mod p for canonical a, b.  r may alias a or b.
template <int N>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p<N>(r, s, (uint32_t)c);
}

// r = (a - b) mod p for canonical a, b.  r may alias a or b.
template <int N>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // add p back on borrow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)d[j] + (Field<N>::p(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// ------------------------------------------------------- global memory

template <int N>
__device__ __forceinline__ void load(uint32_t* r, const uint32_t* g) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = g[j];
}

template <int N>
__device__ __forceinline__ void store(uint32_t* g, const uint32_t* r) {
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = r[j];
}

// ------------------------------------------------------ shared memory
//
// The block-cooperative kernels (K2-K14) stage their operands and
// products in shared memory and move them with 16-byte accesses.

// 16 bytes from s to d, both 16-byte aligned.
__device__ __forceinline__ void copy16(uint32_t* d, const uint32_t* s) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
#else
  for (int k = 0; k < 4; ++k) d[k] = s[k];
#endif
}

// One Fp value from s, in shared or device memory, 16-byte aligned, into
// registers r, 16 bytes at a time.
__device__ __forceinline__ void ld_fp(uint32_t* r, const uint32_t* s) {
#pragma unroll
  for (int k = 0; k < NL; k += 4) {
#ifdef __CUDA_ARCH__
    const uint4 v = *reinterpret_cast<const uint4*>(s + k);
    r[k] = v.x;
    r[k + 1] = v.y;
    r[k + 2] = v.z;
    r[k + 3] = v.w;
#else
    for (int j = 0; j < 4; ++j) r[k + j] = s[k + j];
#endif
  }
}

// One Fp value from registers r to s, in shared or device memory, 16-byte
// aligned.
__device__ __forceinline__ void st_fp(uint32_t* s, const uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NL; k += 4) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(s + k) = make_uint4(r[k], r[k + 1], r[k + 2], r[k + 3]);
#else
    for (int j = 0; j < 4; ++j) s[k + j] = r[k + j];
#endif
  }
}

// r = r + s mod p, r = r - s mod p, for s in shared memory.
__device__ __forceinline__ void add_sh(uint32_t* r, const uint32_t* s) {
  uint32_t y[NL];
  ld_fp(y, s);
  add_mod<NL>(r, r, y);
}

__device__ __forceinline__ void sub_sh(uint32_t* r, const uint32_t* s) {
  uint32_t y[NL];
  ld_fp(y, s);
  sub_mod<NL>(r, r, y);
}

// 16 bytes from device memory s to shared memory d, asynchronously on the
// card (cp.async, bypassing L1): the copy lands by the issuing thread's
// next async_wait().  On the host it is copy16.
__device__ __forceinline__ void copy16_async(uint32_t* d, const uint32_t* s) {
#ifdef __CUDA_ARCH__
  const unsigned sa = (unsigned)__cvta_generic_to_shared(d);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(s) : "memory");
#else
  copy16(d, s);
#endif
}

// Waits for every copy16_async of this thread.
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Copy `rows` rows of W limbs from device memory g into shared memory s as
// rows of S limbs, each of BLOCK threads moving 16 bytes per step.
template <int W, int S, int BLOCK>
__device__ __forceinline__ void stage_in(uint32_t* s, const uint32_t* g, int rows, int tid) {
  for (int v = tid; v < rows * (W / 4); v += BLOCK) {
    const int r = v / (W / 4), c = 4 * (v % (W / 4));
    copy16(s + r * S + c, g + (int64_t)r * W + c);
  }
}

// stage_in by copy16_async: the rows land by each thread's async_wait().
template <int W, int S, int BLOCK>
__device__ __forceinline__ void stage_in_async(uint32_t* s, const uint32_t* g, int rows, int tid) {
  for (int v = tid; v < rows * (W / 4); v += BLOCK) {
    const int r = v / (W / 4), c = 4 * (v % (W / 4));
    copy16_async(s + r * S + c, g + (int64_t)r * W + c);
  }
}

// The reverse: shared rows of S limbs to device rows of W limbs.
template <int W, int S, int BLOCK>
__device__ __forceinline__ void stage_out(uint32_t* g, const uint32_t* s, int rows, int tid) {
  for (int v = tid; v < rows * (W / 4); v += BLOCK) {
    const int r = v / (W / 4), c = 4 * (v % (W / 4));
    copy16(g + (int64_t)r * W + c, s + r * S + c);
  }
}

// Rows of the block `blk` of `per` instances each: min(per, n - blk per).
__device__ __forceinline__ int block_rows(int64_t n, int64_t blk, int per) {
  const int64_t left = n - blk * per;
  return left < per ? (int)left : per;
}

// Instances per block R of the kernels that take it as a template parameter
// (fp12.cu K8-K11 and the power, g2.cu K12-K14) at n rows: the largest of 8,
// 4, 2 that still makes at least 128 blocks (the card's 132 SMs, less a
// ragged margin), else 2.
inline int rows_per_block(int64_t n) {
  return n >= 8 * 128 ? 8 : (n >= 4 * 128 ? 4 : 2);
}

// Calls go(std::integral_constant<int, R>()) with R = rows_per_block(n).
template <class Go>
void with_rows(int64_t n, Go go) {
  const int r = rows_per_block(n);
  if (r == 8) go(std::integral_constant<int, 8>());
  else if (r == 4) go(std::integral_constant<int, 4>());
  else go(std::integral_constant<int, 2>());
}

// Blocks of `rows` instances each over n rows.
inline unsigned grid_of(int64_t n, int rows) { return (unsigned)((n + rows - 1) / rows); }

// Operand k of a Karatsuba product of the pair x = (x0, x1) of Fp values
// in shared memory, x1 at x0 + d: x0 (k = 0), x1 (k = 1) or the raw sum
// x0 + x1 (k = 2, < 2p).
__device__ __forceinline__ void kara_operand(uint32_t* r, const uint32_t* x, int k, int d = NL) {
  ld_fp(r, x + (k == 1 ? d : 0));
  if (k == 2) {
    uint32_t s[NL];
    ld_fp(s, x + d);
    add_raw<NL>(r, r, s);
  }
}

// ---------------------------------------------------- public exponents
//
// A public exponent 1 <= e < 2^(32 EXP_WORDS) of a power chain (K1's
// pow_fixed_kernel, fp12.cu's cyclotomic power): little-endian words and
// the bit length.  Only this header fixes the limit: the host passes e's
// bit length and (bits + 31) / 32 words, and `exponent_of` refuses a
// longer e.
constexpr int EXP_WORDS = 12;
struct Exponent {
  uint32_t w[EXP_WORDS];
  int bits;
};

__host__ __device__ __forceinline__ bool exp_bit(const Exponent& e, int k) {
  return (e.w[k >> 5] >> (k & 31)) & 1u;
}

// e from its bit length and its (bits + 31) / 32 host words; false if the
// bit length is outside [1, 32 EXP_WORDS].
inline bool exponent_of(const uint32_t* words, int bits, Exponent* e) {
  if (bits < 1 || bits > 32 * EXP_WORDS) return false;
  for (int k = 0; k < EXP_WORDS; ++k) e->w[k] = k < (bits + 31) / 32 ? words[k] : 0u;
  e->bits = bits;
  return true;
}

constexpr int THREADS = 128;

inline int64_t blocks_for(int64_t n) { return (n + THREADS - 1) / THREADS; }

}  // namespace fp381
