// K5, K6, K7: whole G1 curve operations per thread, one point per thread.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py run through
// `_fused_pallas`: `prog_g1_madd` (K5, `_rcb_madd_generic`), `prog_g1_add`
// (K6, `_rcb_add_generic`) and `prog_g1_dbl` (K7, `_rcb_dbl_generic`).
// They are the complete formulas of Renes-Costello-Batina 2015 for
// y^2 = x^3 + b with b = 4: Alg. 7 (add), Alg. 7 with Z2 = 1 (mixed add)
// and Alg. 9 (doubling), with 3b = 12 folded into the operands, so each
// is two rounds of Montgomery products: 12 (K6), 11 (K5) and 8 (K7).
// One formula covers every input, the identity (0 : 1 : 0), P = Q and
// P = -Q included: there are no branches.  E(Fp) has odd order, so no
// point of order two breaks completeness.
//
// The TPU programs worked on signed float32 digits and had to keep every
// intermediate above -4096 p: hence their 2^16 p protective offset and the
// `tighten` calls.  Here every value is canonical, subtraction is sub_mod,
// and x12 is three modular doublings and an add (8x + 4x), so neither is
// needed.  Bound: every operand of a product is canonical, or the raw sum
// of two canonical values (below 2p), which mont_mul takes (fp381.cuh).
//
// Bound on the card: per point K5 reads 240 bytes and writes 144 for 11
// products, K6 288 and 144 for 12, K7 144 and 144 for 8 (588 32-bit
// multiply-adds per product), so the integer multiply rate bounds all
// three.  What costs is register pressure: K6 takes two points (72 words).
// The design reads each coordinate from device memory just before its
// products, folds each round-1 product into the sums that use it at once,
// and writes each output coordinate as soon as its two round-2 products
// are done: six reduced values carry from round 1 to round 2, and round 2
// holds two products beside them.
//
// Layouts (int32 limbs, row-major, contiguous): a projective point is
// (n, 3, 12) [X, Y, Z], an affine point (n, 2, 12) [x, y].  Inputs are
// canonical; outputs are canonical.

#include "fp381.cuh"

using namespace fp381;

constexpr int PT = 3 * NL;   // limbs of one projective point
constexpr int AF = 2 * NL;   // limbs of one affine point

// r = 12 x mod p: 2x, 4x, 8x, then 8x + 4x.
__device__ __forceinline__ void mul12(uint32_t* r, const uint32_t* x) {
  uint32_t x4[NL];
  add_mod<NL>(x4, x, x);
  add_mod<NL>(x4, x4, x4);
  add_mod<NL>(r, x4, x4);
  add_mod<NL>(r, r, x4);
}

// t = a * b for coordinates a, b read from device memory.
__device__ __forceinline__ void coord_product(uint32_t* t, const uint32_t* ga,
                                              const uint32_t* gb) {
  uint32_t a[NL], b[NL];
  load<NL>(a, ga);
  load<NL>(b, gb);
  mont_mul<NL>(t, a, b);
}

// t = (a0 + a1) * (b0 + b1) for coordinates read from device memory; the
// pre-sums are raw (below 2p).
__device__ __forceinline__ void presum_product(uint32_t* t, const uint32_t* ga0,
                                               const uint32_t* ga1, const uint32_t* gb0,
                                               const uint32_t* gb1) {
  uint32_t a[NL], b[NL], s[NL];
  load<NL>(a, ga0);
  load<NL>(s, ga1);
  add_raw<NL>(a, a, s);
  load<NL>(b, gb0);
  load<NL>(s, gb1);
  add_raw<NL>(b, b, s);
  mont_mul<NL>(t, a, b);
}

// Round 2, shared by K5 and K6:
//   X3 = t1m t3 - bt5 t4,  Y3 = t1m z3a + bt5 w,  Z3 = z3a t4 + w t3.
__device__ __forceinline__ void rcb_round2(uint32_t* o, const uint32_t* t1m,
                                           const uint32_t* z3a, const uint32_t* t3,
                                           const uint32_t* t4, const uint32_t* w,
                                           const uint32_t* bt5) {
  uint32_t a[NL], b[NL];
  mont_mul<NL>(a, t1m, t3);
  mont_mul<NL>(b, bt5, t4);
  sub_mod<NL>(a, a, b);
  store<NL>(o, a);
  mont_mul<NL>(a, t1m, z3a);
  mont_mul<NL>(b, bt5, w);
  add_mod<NL>(a, a, b);
  store<NL>(o + NL, a);
  mont_mul<NL>(a, z3a, t4);
  mont_mul<NL>(b, w, t3);
  add_mod<NL>(a, a, b);
  store<NL>(o + 2 * NL, a);
}

// K5: P + (x2 : y2 : 1), 5 + 6 products.
//   t0 = X1 x2, t1 = Y1 y2, t3 = (X1 + Y1)(x2 + y2) - t0 - t1,
//   t4 = y2 Z1 + Y1, t5 = x2 Z1 + X1, w = 3 t0,
//   bt5 = 12 t5, z3a = t1 + 12 Z1, t1m = t1 - 12 Z1.
__global__ void __launch_bounds__(THREADS)
g1_madd_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* X1 = p + i * PT;
  const uint32_t* Y1 = X1 + NL;
  const uint32_t* Z1 = X1 + 2 * NL;
  const uint32_t* x2 = q + i * AF;
  const uint32_t* y2 = x2 + NL;
  uint32_t t0[NL], t1[NL], t3[NL], t4[NL], bt5[NL], u[NL];

  coord_product(t0, X1, x2);
  coord_product(t1, Y1, y2);
  presum_product(t3, X1, Y1, x2, y2);
  sub_mod<NL>(t3, t3, t0);
  sub_mod<NL>(t3, t3, t1);
  coord_product(t4, y2, Z1);
  load<NL>(u, Y1);
  add_mod<NL>(t4, t4, u);
  coord_product(bt5, x2, Z1);
  load<NL>(u, X1);
  add_mod<NL>(bt5, bt5, u);
  mul12(bt5, bt5);

  uint32_t w[NL], z3a[NL];
  add_mod<NL>(w, t0, t0);
  add_mod<NL>(w, w, t0);
  load<NL>(u, Z1);
  mul12(u, u);
  add_mod<NL>(z3a, t1, u);
  sub_mod<NL>(t1, t1, u);          // t1m
  rcb_round2(out + i * PT, t1, z3a, t3, t4, w, bt5);
}

// K6: P1 + P2, 6 + 6 products.
//   t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
//   t3 = (X1 + Y1)(X2 + Y2) - t0 - t1, t4 = (Y1 + Z1)(Y2 + Z2) - t1 - t2,
//   t5 = (X1 + Z1)(X2 + Z2) - t0 - t2, w = 3 t0,
//   bt5 = 12 t5, z3a = t1 + 12 t2, t1m = t1 - 12 t2.
__global__ void __launch_bounds__(THREADS)
g1_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* X1 = p + i * PT;
  const uint32_t* Y1 = X1 + NL;
  const uint32_t* Z1 = X1 + 2 * NL;
  const uint32_t* X2 = q + i * PT;
  const uint32_t* Y2 = X2 + NL;
  const uint32_t* Z2 = X2 + 2 * NL;
  uint32_t t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], bt5[NL];

  coord_product(t0, X1, X2);
  coord_product(t1, Y1, Y2);
  coord_product(t2, Z1, Z2);
  presum_product(t3, X1, Y1, X2, Y2);
  sub_mod<NL>(t3, t3, t0);
  sub_mod<NL>(t3, t3, t1);
  presum_product(t4, Y1, Z1, Y2, Z2);
  sub_mod<NL>(t4, t4, t1);
  sub_mod<NL>(t4, t4, t2);
  presum_product(bt5, X1, Z1, X2, Z2);
  sub_mod<NL>(bt5, bt5, t0);
  sub_mod<NL>(bt5, bt5, t2);
  mul12(bt5, bt5);

  uint32_t w[NL], z3a[NL];
  add_mod<NL>(w, t0, t0);
  add_mod<NL>(w, w, t0);
  mul12(t2, t2);
  add_mod<NL>(z3a, t1, t2);
  sub_mod<NL>(t1, t1, t2);         // t1m
  rcb_round2(out + i * PT, t1, z3a, t3, t4, w, bt5);
}

// K7: 2P, 4 + 4 products.
//   t0 = Y^2, t1 = Y Z, xy = X Y, t2 = 12 Z^2,
//   X3 = 2 (t0 - 3 t2) xy, Y3 = (t0 - 3 t2)(t0 + t2) + 8 t0 t2,
//   Z3 = 8 t0 t1.
__global__ void __launch_bounds__(THREADS)
g1_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* X = p + i * PT;
  const uint32_t* Y = X + NL;
  const uint32_t* Z = X + 2 * NL;
  uint32_t t0[NL], t1[NL], xy[NL], t2[NL];

  coord_product(t0, Y, Y);
  coord_product(t1, Y, Z);
  coord_product(xy, X, Y);
  coord_product(t2, Z, Z);
  mul12(t2, t2);

  uint32_t e8[NL], y3a[NL], a[NL], b[NL];
  add_mod<NL>(e8, t0, t0);
  add_mod<NL>(e8, e8, e8);
  add_mod<NL>(e8, e8, e8);         // 8 Y^2
  add_mod<NL>(y3a, t0, t2);        // Y^2 + 3b Z^2
  add_mod<NL>(a, t2, t2);
  add_mod<NL>(a, a, t2);
  sub_mod<NL>(t0, t0, a);          // t0m = Y^2 - 9b Z^2

  uint32_t* o = out + i * PT;
  mont_mul<NL>(a, t0, xy);
  add_mod<NL>(a, a, a);
  store<NL>(o, a);
  mont_mul<NL>(a, t0, y3a);
  mont_mul<NL>(b, e8, t2);
  add_mod<NL>(a, a, b);
  store<NL>(o + NL, a);
  mont_mul<NL>(a, e8, t1);
  store<NL>(o + 2 * NL, a);
}

extern "C" int g1_madd(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_madd_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int g1_add(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_add_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int g1_dbl(const void* p, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_dbl_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
