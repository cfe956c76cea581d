// K5, K6, K7: the G1 curve operations.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py run through
// `_fused_pallas`: `prog_g1_madd` (K5, `_rcb_madd_generic`), `prog_g1_add`
// (K6, `_rcb_add_generic`) and `prog_g1_dbl` (K7, `_rcb_dbl_generic`).
// They are the complete formulas of Renes-Costello-Batina 2015 for
// y^2 = x^3 + b with b = 4: Alg. 7 (add), Alg. 7 with Z2 = 1 (mixed add)
// and Alg. 9 (doubling), with 3b = 12 folded into the operands, so each
// is two rounds of Montgomery products: 6 + 6 (K6), 5 + 6 (K5) and 4 + 4
// (K7).  One formula covers every input, the identity (0 : 1 : 0), P = Q
// and P = -Q included: there are no branches.  E(Fp) has odd order, so no
// point of order two breaks completeness.
//
// The TPU programs worked on signed float32 digits and had to keep every
// intermediate above -4096 p: hence their 2^16 p protective offset and the
// `tighten` calls.  Here every value is canonical, subtraction is sub_mod,
// and x12 is three modular doublings and an add (8x + 4x), so neither is
// needed.
//
// Bound on the card: per point K5 reads 240 bytes and writes 144 for 11
// products, K6 288 and 144 for 12, K7 144 and 144 for 8 (588 32-bit
// multiply-adds per product), so the integer multiply rate bounds all
// three.  At the row counts of their paths one point per thread is far
// from that bound: the MSM's bucket step launches K5 on 2,112 rows (17
// blocks of 128 threads on 132 SMs), its Horner loop K7 and K6 on one row,
// and a thread that owned a point would run 11, 12 or 8 products as one
// dependent chain (K6 took 166 registers that way).
//
// Each kernel therefore gives each Fp product of a round its own thread,
// as K2 and K4 do (tower.cu): 6 threads per K5 or K6 instance, 4 per K7
// instance.  A block takes K5_ROWS, K6_ROWS or K7_ROWS consecutive
// instances and runs in phases with a barrier between each two:
//   stage      the block's span of each operand into shared memory, 16
//              bytes per thread, consecutive threads on consecutive bytes;
//   product 1  K5: X1 x2, Y1 y2, (X1 + Y1)(x2 + y2), x2 Z1, y2 Z1 (a
//              sixth thread idles); K6: X1 X2, Y1 Y2, Z1 Z2 and the three
//              pre-sum products (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2),
//              (X1 + Z1)(X2 + Z2), every thread busy; K7: Y^2, Y Z, X Y,
//              Z^2;
//   combine 1  K5 and K6: the six operands of round 2, t3, t4, bt5, w, z3a
//              and t1m, one per thread;
//   product 2  K5 and K6: the same six products of round 2; K7: each
//              thread forms its two operands from the round-1 products
//              (t0m, y3a, e8, 12 Z^2) and runs one of the four products;
//   combine 2  X3, Y3 and Z3, one per thread;
//   store      the outputs from shared memory, 16 bytes per thread.
// K5 and K6 share one copy of their last three phases (rcb_round2_phase);
// mul12 and the round-2 operand tables rcb_lhs/rcb_rhs are in curve.cuh,
// shared with the G2 kernels (g2.cu).
// Each phase is a function of (phase, block, thread), and the __global__
// body only calls the phases with a barrier after each.  A projective row
// in shared memory is 144 bytes and an affine row is padded from 96 to 112,
// so that the 16-byte accesses of 8 consecutive threads fall in 32
// distinct banks.  The last block of a ragged launch masks its copies,
// products and combines; every thread reaches every barrier.
//
// Bound proof of the product operands: each is a coordinate, a product or
// a combine (all canonical), or the raw sum of two canonical coordinates
// (below 2p), which mont_mul takes (fp381.cuh).  The combines are add_mod
// and sub_mod of canonical values, so every output is canonical.
//
// Layouts (int32 limbs, row-major, contiguous, 16-byte aligned): a
// projective point is (n, 3, 12) [X, Y, Z], an affine point (n, 2, 12)
// [x, y].  Inputs are canonical; outputs are canonical.

#include "fp381.cuh"
#include "curve.cuh"

using namespace fp381;

constexpr int PT = 3 * NL;   // limbs of one projective point
constexpr int AF = 2 * NL;   // limbs of one affine point

// --------------------------------------------- K5 and K6: round 2
//
// Both end in the same six products and combines:
//   round 2   t1m t3, bt5 t4, t1m z3a, bt5 w, z3a t4, w t3;
//   combine 2 X3 = t1m t3 - bt5 t4, Y3 = t1m z3a + bt5 w,
//             Z3 = z3a t4 + w t3.
// Their combine 1 writes the round-2 operands U[j][i] (j: t3, t4, bt5, w,
// z3a, t1m) of a block of ROWS instances, 6 threads each.

// w = 3 t0 (j = 3), z3a = t1 + 12 z (j = 4) or t1m = t1 - 12 z (j = 5)
// from t0, t1 = t0 + d and z in shared memory (K5: z = Z1, K6: z = t2).
__device__ __forceinline__ void rcb_wz(uint32_t* r, const uint32_t* t, int d,
                                       const uint32_t* z, int j) {
  if (j == 3) {
    uint32_t t0[NL];
    ld_fp(t0, t);
    add_mod<NL>(r, t0, t0);
    add_mod<NL>(r, r, t0);
  } else {
    uint32_t bz[NL];
    ld_fp(bz, z);
    mul12(bz, bz);
    ld_fp(r, t + d);
    if (j == 4) add_mod<NL>(r, r, bz); else sub_mod<NL>(r, r, bz);
  }
}

// Phases 3-5 of K5 and K6 (product 2, combine 2, store) for thread `tid` of
// a block of `rows` live instances whose round-2 operands lie at sm + U;
// out points at the block's first output row.  The round-2 products
// V[k][i] go to sm (over the dead operand rows and round-1 products), the
// outputs over U.
template <int ROWS, int U>
__device__ __forceinline__ void rcb_round2_phase(int ph, uint32_t* sm, uint32_t* out, int rows,
                                                 int tid) {
  static_assert(6 * ROWS * NL <= U, "V fits below U");
  static_assert(ROWS * PT <= 6 * ROWS * NL, "the outputs fit over U");
  const int k = tid / ROWS, i = tid % ROWS;
  if (ph == 3) {                            // round-2 product k of instance i
    if (i < rows) {
      uint32_t x[NL], y[NL];
      ld_fp(x, sm + U + (rcb_lhs(k) * ROWS + i) * NL);
      ld_fp(y, sm + U + (rcb_rhs(k) * ROWS + i) * NL);
      mont_mul<NL>(x, x, y);
      st_fp(sm + tid * NL, x);
    }
  } else if (ph == 4) {                     // output coordinate k of instance i
    if (k < 3 && i < rows) {
      const uint32_t* v = sm + (2 * k * ROWS + i) * NL;
      uint32_t r[NL];
      ld_fp(r, v);
      if (k == 0) sub_sh(r, v + ROWS * NL); else add_sh(r, v + ROWS * NL);
      st_fp(sm + U + i * PT + k * NL, r);
    }
  } else {                                  // store
    stage_out<PT, PT, 6 * ROWS>(out, sm + U, rows, tid);
  }
}

// ------------------------------------------------------------- K5
//
// P + (x2 : y2 : 1), 5 + 6 products:
//   round 1   t0 = X1 x2, t1 = Y1 y2, m3 = (X1 + Y1)(x2 + y2), zx = x2 Z1,
//             zy = y2 Z1;
//   combine 1 t3 = m3 - t0 - t1, t4 = zy + Y1, bt5 = 12 (zx + X1), w = 3 t0,
//             z3a = t1 + 12 Z1, t1m = t1 - 12 Z1;
//   round 2   as above.

// 16 instances per block make the MSM's 2,112 rows 132 blocks, one per SM.
// Measured on the card and not taken (PERF.md): 32 instances per block,
// and round-2 threads that form their own operands in place of the
// combine-1 phase (one barrier fewer, but bt5 and the others each formed
// twice on the critical path), 13% and 17% slower at 2,112 rows.
constexpr int K5_ROWS = 16;                  // instances per block
constexpr int K5_BLOCK = 6 * K5_ROWS;        // one thread per round-2 product
constexpr int SA = AF + 4;                   // a padded shared affine row
// shared layout (limbs): P rows, Q rows, the round-1 products T[k][i] and
// the round-2 operands U[j][i]; then rcb_round2_phase's products over P, Q
// and T, and the outputs over U
constexpr int K5_P = 0, K5_Q = K5_ROWS * PT, K5_T = K5_Q + K5_ROWS * SA;
constexpr int K5_U = K5_T + 5 * K5_ROWS * NL;
constexpr int K5_SMEM = K5_U + 6 * K5_ROWS * NL;
constexpr int K5_PHASES = 6;

// Round-1 product k of K5 from the shared rows p = (X1, Y1, Z1) and
// q = (x2, y2): X1 x2, Y1 y2, (X1 + Y1)(x2 + y2), Z1 x2, Z1 y2.
__device__ __forceinline__ void k5_round1(uint32_t* r, const uint32_t* p, const uint32_t* q,
                                          int k) {
  uint32_t a[NL], b[NL];
  if (k < 3) {
    kara_operand(a, p, k);
    kara_operand(b, q, k);
  } else {
    ld_fp(a, p + 2 * NL);
    ld_fp(b, q + (k - 3) * NL);
  }
  mont_mul<NL>(r, a, b);
}

// Round-2 operand j of K5 (t3, t4, bt5, w, z3a, t1m) from the shared row
// p = (X1, Y1, Z1) and the round-1 products t0, t1, m3, zx, zy at t + k d.
__device__ __forceinline__ void k5_operand(uint32_t* r, const uint32_t* p, const uint32_t* t,
                                           int d, int j) {
  if (j == 0) {                    // t3 = m3 - t0 - t1
    ld_fp(r, t + 2 * d);
    sub_sh(r, t);
    sub_sh(r, t + d);
  } else if (j == 1) {             // t4 = zy + Y1
    ld_fp(r, t + 4 * d);
    add_sh(r, p + NL);
  } else if (j == 2) {             // bt5 = 12 (zx + X1)
    ld_fp(r, t + 3 * d);
    add_sh(r, p);
    mul12(r, r);
  } else {                         // w, z3a, t1m with z = Z1
    rcb_wz(r, t, d, p + 2 * NL, j);
  }
}

// Phase `ph` of K5 for thread `tid` of block `blk`.
__device__ __forceinline__ void g1_madd_phase(int ph, uint32_t* sm, const uint32_t* p,
                                              const uint32_t* q, uint32_t* out, int64_t n,
                                              int64_t blk, int tid) {
  const int64_t row0 = blk * K5_ROWS;
  const int rows = block_rows(n, blk, K5_ROWS);
  const int k = tid / K5_ROWS, i = tid % K5_ROWS;
  const uint32_t* pi = sm + K5_P + i * PT;
  if (ph == 0) {                            // stage
    stage_in<PT, PT, K5_BLOCK>(sm + K5_P, p + row0 * PT, rows, tid);
    stage_in<AF, SA, K5_BLOCK>(sm + K5_Q, q + row0 * AF, rows, tid);
  } else if (ph == 1) {                     // round-1 product k of instance i
    if (k < 5 && i < rows) {
      uint32_t r[NL];
      k5_round1(r, pi, sm + K5_Q + i * SA, k);
      st_fp(sm + K5_T + tid * NL, r);
    }
  } else if (ph == 2) {                     // round-2 operand k of instance i
    if (i < rows) {
      uint32_t r[NL];
      k5_operand(r, pi, sm + K5_T + i * NL, K5_ROWS * NL, k);
      st_fp(sm + K5_U + tid * NL, r);
    }
  } else {                                  // round 2, combine 2, store
    rcb_round2_phase<K5_ROWS, K5_U>(ph, sm, out + row0 * PT, rows, tid);
  }
}

__global__ void __launch_bounds__(K5_BLOCK)
g1_madd_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K5_SMEM];
#pragma unroll
  for (int ph = 0; ph < K5_PHASES; ++ph) {
    g1_madd_phase(ph, sm, p, q, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K5_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------- K6
//
// P1 + P2, 6 + 6 products:
//   round 1   t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2),
//             m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2);
//   combine 1 t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, bt5 = 12 (m5 - t0 - t2),
//             w = 3 t0, z3a = t1 + 12 t2, t1m = t1 - 12 t2;
//   round 2   as K5's.

// 16 instances per block.  Measured on the card and not taken (PERF.md):
// 32 instances per block, 15-19% slower at 1 and 33 rows (80 of the MSM's
// 94 launches), 6-8% faster at 8,192 and 136,224: the loss of one GLV call
// and one MSM call, summed, within 1% of this one's.
constexpr int K6_ROWS = 16;                  // instances per block
constexpr int K6_BLOCK = 6 * K6_ROWS;        // one thread per product of a round
// shared layout (limbs): P rows, Q rows, the round-1 products T[k][i] and
// the round-2 operands U[j][i]; then rcb_round2_phase's products over P, Q
// and T, and the outputs over U
constexpr int K6_P = 0, K6_Q = K6_ROWS * PT, K6_T = 2 * K6_ROWS * PT;
constexpr int K6_U = K6_T + 6 * K6_ROWS * NL;
constexpr int K6_SMEM = K6_U + 6 * K6_ROWS * NL;
constexpr int K6_PHASES = 6;

// The factor from the shared row x = (X, Y, Z) of K6's round-1 product k:
// X, Y, Z (k < 3), or the raw sums X + Y, Y + Z, Z + X (below 2p).
__device__ __forceinline__ void k6_factor(uint32_t* r, const uint32_t* x, int k) {
  ld_fp(r, x + (k % 3) * NL);
  if (k >= 3) {
    uint32_t s[NL];
    ld_fp(s, x + ((k + 1) % 3) * NL);
    add_raw<NL>(r, r, s);
  }
}

// Round-2 operand j of K6 (t3, t4, bt5, w, z3a, t1m) from the round-1
// products t0, t1, t2, m3, m4, m5 at t + k d.
__device__ __forceinline__ void k6_operand(uint32_t* r, const uint32_t* t, int d, int j) {
  if (j < 3) {                     // m(3 + j) minus two of t0, t1, t2
    ld_fp(r, t + (3 + j) * d);
    sub_sh(r, t + (j == 1 ? d : 0));
    sub_sh(r, t + (j == 0 ? d : 2 * d));
    if (j == 2) mul12(r, r);
  } else {                         // w, z3a, t1m with z = t2
    rcb_wz(r, t, d, t + 2 * d, j);
  }
}

// Phase `ph` of K6 for thread `tid` of block `blk`.
__device__ __forceinline__ void g1_add_phase(int ph, uint32_t* sm, const uint32_t* p,
                                             const uint32_t* q, uint32_t* out, int64_t n,
                                             int64_t blk, int tid) {
  const int64_t row0 = blk * K6_ROWS;
  const int rows = block_rows(n, blk, K6_ROWS);
  const int k = tid / K6_ROWS, i = tid % K6_ROWS;
  if (ph == 0) {                            // stage
    stage_in<PT, PT, K6_BLOCK>(sm + K6_P, p + row0 * PT, rows, tid);
    stage_in<PT, PT, K6_BLOCK>(sm + K6_Q, q + row0 * PT, rows, tid);
  } else if (ph == 1) {                     // round-1 product k of instance i
    if (i < rows) {
      uint32_t x[NL], y[NL];
      k6_factor(x, sm + K6_P + i * PT, k);
      k6_factor(y, sm + K6_Q + i * PT, k);
      mont_mul<NL>(x, x, y);
      st_fp(sm + K6_T + tid * NL, x);
    }
  } else if (ph == 2) {                     // round-2 operand k of instance i
    if (i < rows) {
      uint32_t r[NL];
      k6_operand(r, sm + K6_T + i * NL, K6_ROWS * NL, k);
      st_fp(sm + K6_U + tid * NL, r);
    }
  } else {                                  // round 2, combine 2, store
    rcb_round2_phase<K6_ROWS, K6_U>(ph, sm, out + row0 * PT, rows, tid);
  }
}

// At least one block per SM: with no such bound ptxas capped K6 at 56
// registers and spilled 12 bytes; with it, 64 and no spill (PERF.md).
__global__ void __launch_bounds__(K6_BLOCK, 1)
g1_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K6_SMEM];
#pragma unroll
  for (int ph = 0; ph < K6_PHASES; ++ph) {
    g1_add_phase(ph, sm, p, q, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K6_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------- K7
//
// 2P, 4 + 4 products:
//   round 1   t0 = Y^2, t1 = Y Z, xy = X Y, z2 = Z^2; t2 = 12 z2;
//   round 2   t0m xy, t0m y3a, e8 t2, e8 t1 with t0m = t0 - 3 t2,
//             y3a = t0 + t2, e8 = 8 t0;
//   combine   X3 = 2 t0m xy, Y3 = t0m y3a + e8 t2, Z3 = e8 t1.

constexpr int K7_ROWS = 32;                  // instances per block
constexpr int K7_BLOCK = 4 * K7_ROWS;        // one thread per product of a round
// shared layout (limbs): the round-1 products T[k][i], P rows; then the
// round-2 products V[k][i] over P, and the outputs over T
constexpr int K7_T = 0, K7_P = 4 * K7_ROWS * NL, K7_V = K7_P, K7_O = 0;
constexpr int K7_SMEM = K7_V + 4 * K7_ROWS * NL;
constexpr int K7_PHASES = 5;
static_assert(K7_ROWS * PT <= 4 * K7_ROWS * NL, "P and the outputs fit in T's span");

// Round-1 product k of K7 from the shared row p = (X, Y, Z):
// Y Y, Y Z, X Y, Z Z.
__device__ __forceinline__ void k7_round1(uint32_t* r, const uint32_t* p, int k) {
  uint32_t a[NL], b[NL];
  ld_fp(a, p + (k == 2 ? 0 : k == 3 ? 2 : 1) * NL);
  ld_fp(b, p + (k == 0 || k == 2 ? 1 : 2) * NL);
  mont_mul<NL>(r, a, b);
}

// Round-2 product k of K7 from the round-1 products t0, t1, xy, z2 at
// t + j d: t0m xy, t0m y3a, e8 t2, e8 t1.
__device__ __forceinline__ void k7_round2(uint32_t* r, const uint32_t* t, int d, int k) {
  uint32_t t0[NL], a[NL], b[NL];
  ld_fp(t0, t);
  if (k < 2) {                     // t0m = t0 - 3 t2, with xy or y3a = t0 + t2
    uint32_t t2[NL];
    ld_fp(t2, t + 3 * d);
    mul12(t2, t2);
    add_mod<NL>(a, t2, t2);
    add_mod<NL>(a, a, t2);
    sub_mod<NL>(a, t0, a);
    if (k == 0) ld_fp(b, t + 2 * d); else add_mod<NL>(b, t0, t2);
  } else {                         // e8 = 8 t0, with t2 or t1
    add_mod<NL>(a, t0, t0);
    add_mod<NL>(a, a, a);
    add_mod<NL>(a, a, a);
    if (k == 2) {
      ld_fp(b, t + 3 * d);
      mul12(b, b);
    } else {
      ld_fp(b, t + d);
    }
  }
  mont_mul<NL>(r, a, b);
}

// Phase `ph` of K7 for thread `tid` of block `blk`.
__device__ __forceinline__ void g1_dbl_phase(int ph, uint32_t* sm, const uint32_t* p,
                                             uint32_t* out, int64_t n, int64_t blk, int tid) {
  const int64_t row0 = blk * K7_ROWS;
  const int rows = block_rows(n, blk, K7_ROWS);
  const int k = tid / K7_ROWS, i = tid % K7_ROWS;
  if (ph == 0) {                            // stage
    stage_in<PT, PT, K7_BLOCK>(sm + K7_P, p + row0 * PT, rows, tid);
  } else if (ph == 1) {                     // round-1 product k of instance i
    if (i < rows) {
      uint32_t r[NL];
      k7_round1(r, sm + K7_P + i * PT, k);
      st_fp(sm + K7_T + tid * NL, r);
    }
  } else if (ph == 2) {                     // round-2 product k of instance i
    if (i < rows) {
      uint32_t r[NL];
      k7_round2(r, sm + K7_T + i * NL, K7_ROWS * NL, k);
      st_fp(sm + K7_V + tid * NL, r);
    }
  } else if (ph == 3) {                     // output coordinate k of instance i
    if (k < 3 && i < rows) {
      const uint32_t* v = sm + K7_V + i * NL;   // product j at v + j d
      const int d = K7_ROWS * NL;
      uint32_t r[NL];
      ld_fp(r, v + (k == 2 ? 3 : k) * d);
      if (k == 0) add_mod<NL>(r, r, r); else if (k == 1) add_sh(r, v + 2 * d);
      st_fp(sm + K7_O + i * PT + k * NL, r);
    }
  } else {                                  // store
    stage_out<PT, PT, K7_BLOCK>(out + row0 * PT, sm + K7_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K7_BLOCK)
g1_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K7_SMEM];
#pragma unroll
  for (int ph = 0; ph < K7_PHASES; ++ph) {
    g1_dbl_phase(ph, sm, p, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K7_PHASES) __syncthreads();
  }
}

extern "C" int g1_madd(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_madd_kernel<<<(unsigned)((n + K5_ROWS - 1) / K5_ROWS), K5_BLOCK, 0,
                     (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int g1_add(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_add_kernel<<<(unsigned)((n + K6_ROWS - 1) / K6_ROWS), K6_BLOCK, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int g1_dbl(const void* p, void* out, int64_t n, void* stream) {
  if (n > 0) {
    g1_dbl_kernel<<<(unsigned)((n + K7_ROWS - 1) / K7_ROWS), K7_BLOCK, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
