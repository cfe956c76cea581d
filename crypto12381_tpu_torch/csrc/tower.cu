// K2, K3, K4: the Fp2 product, the Fp2 square and the Fp6 product.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py run through
// `_fused_pallas`: `prog_fp2_mul` (K2), `prog_fp2_sqr` (K3) and
// `prog_fp6_mul` (K4).  On the TPU a program normalized its signed digits,
// ran every product's lane-shifted FMAs, reduced all products together in
// two stacked bf16 matrix products and combined them in registers.
//
// Bound on the card.  Per instance K2 reads 192 bytes and writes 96 for 3
// Fp products, K3 96 and 96 for 2, K4 576 and 288 for 18, at 588 32-bit
// multiply-adds per product: the integer multiply rate bounds all three.
// At the pairing's row counts (K2 2,048 to 30,720 rows, K3 18,432, K4
// 4,096 and 6,144) one thread per instance is far from that bound: a
// launch is a partial wave of a few warps per SM, each stalled on a
// dependent chain of multiply-adds with carry, and K4's 18 products in one
// thread need 255 registers and spill.
//
// Each kernel therefore gives each Fp product its own thread: 3 threads
// per K2 instance (Karatsuba: a0 b0, a1 b1, (a0 + a1)(b0 + b1)), 2 per K3
// instance ((a0 + a1)(a0 - a1) and a0 (a1 + a1), each an output
// coefficient as it stands) and 18 per K4 instance (the 3 of each of its 6
// Fp2 Karatsuba products).  A thread holds two operands and the
// accumulator (K2 53 registers, K3 56, K4 60, no spills), so three
// 288-thread K4 blocks share an SM and hide each other's latency, and the
// launch has 3x (K2), 2x (K3) or 18x (K4) the threads.  A block takes 32
// (K2), 64 (K3) or 16 (K4) consecutive instances and runs in phases with a
// barrier between each two:
//   stage    the block's span of each operand into shared memory, 16 bytes
//            per thread, consecutive threads on consecutive bytes;
//   product  each thread forms its operands from shared memory (pre-sums
//            included), runs mont_mul (fp381.cuh: the CIOS product of K1)
//            and writes the product back to shared memory;
//   combine  K2 and K4 only: the Karatsuba combines, one output Fp
//            coefficient per thread: K2 re = t0 - t1, im = t2 - t0 - t1;
//            K4 first forms its 6 Fp2 products that way (12 coefficients),
//            then the Fp6 combine (6 coefficients);
//   store    the outputs from shared memory, 16 bytes per thread.
// Shared memory per block: K2 11,776 bytes, K3 14,336, K4 23,552
// (operands, then the products; each combine writes over what is dead by
// then).  A shared row is padded (Fp2 96 -> 112 bytes, Fp6 288 -> 304) so
// that the 16-byte accesses of 8 consecutive threads fall in 32 distinct
// banks.  The last block of a ragged launch masks its copies, products and
// combines; every thread reaches every barrier.
//
// Bound proof of the product operands.  The pre-sum of two Fp2
// coefficients of an Fp6 is reduced mod p (add_mod), and the third product
// of an Fp2 Karatsuba takes the raw sum of two canonical values; K3's
// operands are a0 (canonical), a0 - a1 (sub_mod, canonical) and the raw
// sums a0 + a1 and a1 + a1 of canonical values.  Every operand is
// canonical or below 2p, which mont_mul takes.  The combines are add_mod
// and sub_mod of canonical values, so every output is canonical.
//
// Layouts (int32 limbs, row-major, contiguous, 16-byte aligned): Fp2
// (n, 2, 12), Fp6 (n, 3, 2, 12).  Operands are canonical; outputs are
// canonical.

#include "fp381.cuh"
#include "tower.cuh"

using namespace fp381;

// ------------------------------------------------------------- K2

constexpr int K2_ROWS = 32;              // instances per block
constexpr int K2_BLOCK = 3 * K2_ROWS;    // one thread per Fp product
constexpr int S2 = F2 + 4;               // a padded shared Fp2 row
// shared layout (limbs): operands A, B; products T[k][i]; outputs over A
constexpr int K2_A = 0, K2_B = K2_ROWS * S2, K2_T = 2 * K2_ROWS * S2;
constexpr int K2_SMEM = K2_T + 3 * K2_ROWS * NL;
constexpr int K2_PHASES = 4;

// Phase `ph` of K2 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp2_mul_phase(int ph, uint32_t* sm, const uint32_t* a,
                                              const uint32_t* b, uint32_t* out, int64_t n,
                                              int64_t blk, int tid) {
  const int64_t row0 = blk * K2_ROWS;
  const int rows = block_rows(n, blk, K2_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F2, S2, K2_BLOCK>(sm + K2_A, a + row0 * F2, rows, tid);
    stage_in<F2, S2, K2_BLOCK>(sm + K2_B, b + row0 * F2, rows, tid);
  } else if (ph == 1) {                     // product k of instance i
    const int k = tid / K2_ROWS, i = tid % K2_ROWS;
    if (i < rows) {
      uint32_t x[NL], y[NL];
      kara_operand(x, sm + K2_A + i * S2, k);
      kara_operand(y, sm + K2_B + i * S2, k);
      mont_mul<NL>(x, x, y);
      st_fp(sm + K2_T + tid * NL, x);
    }
  } else if (ph == 2) {                     // coefficient f of instance i
    const int f = tid / K2_ROWS, i = tid % K2_ROWS;
    if (f < 2 && i < rows) {
      uint32_t r[NL];
      fp2_coeff(r, sm + K2_T + i * NL, K2_ROWS * NL, f);
      st_fp(sm + K2_A + i * S2 + f * NL, r);
    }
  } else {                                  // store
    stage_out<F2, S2, K2_BLOCK>(out + row0 * F2, sm + K2_A, rows, tid);
  }
}

__global__ void __launch_bounds__(K2_BLOCK)
fp2_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K2_SMEM];
#pragma unroll
  for (int ph = 0; ph < K2_PHASES; ++ph) {
    fp2_mul_phase(ph, sm, a, b, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K2_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------- K3
//
// a^2 for a = (a0, a1): re = (a0 + a1)(a0 - a1), im = a0 (a1 + a1).

// 64 instances per block make the pairing's 18,432 rows 288 blocks of 128
// threads.  Measured on the card and not taken (PERF.md): 32 instances per
// block, within 3%.
constexpr int K3_ROWS = 64;              // instances per block
constexpr int K3_BLOCK = 2 * K3_ROWS;    // one thread per Fp product
// shared layout (limbs): operands A; outputs O, padded Fp2 rows in a span
// of their own.  Both threads of an instance read its whole operand row in
// the product phase, so neither may write its product over that row then;
// writing there after a barrier would hold the product in registers across
// it, outside the phase functions.  The span costs 7 KB of shared memory.
constexpr int K3_A = 0, K3_O = K3_ROWS * S2;
constexpr int K3_SMEM = 2 * K3_ROWS * S2;
constexpr int K3_PHASES = 3;

// Phase `ph` of K3 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp2_sqr_phase(int ph, uint32_t* sm, const uint32_t* a,
                                              uint32_t* out, int64_t n, int64_t blk, int tid) {
  const int64_t row0 = blk * K3_ROWS;
  const int rows = block_rows(n, blk, K3_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F2, S2, K3_BLOCK>(sm + K3_A, a + row0 * F2, rows, tid);
  } else if (ph == 1) {                     // coefficient k of instance i
    const int k = tid / K3_ROWS, i = tid % K3_ROWS;
    if (i < rows) {
      const uint32_t* x = sm + K3_A + i * S2;
      uint32_t a0[NL], y[NL];
      ld_fp(a0, x);
      ld_fp(y, x + NL);
      if (k == 0) {                         // (a0 + a1)(a0 - a1)
        uint32_t s[NL];
        add_raw<NL>(s, a0, y);
        sub_mod<NL>(y, a0, y);
        mont_mul<NL>(y, s, y);
      } else {                              // a0 (a1 + a1)
        add_raw<NL>(y, y, y);
        mont_mul<NL>(y, a0, y);
      }
      st_fp(sm + K3_O + i * S2 + k * NL, y);
    }
  } else {                                  // store
    stage_out<F2, S2, K3_BLOCK>(out + row0 * F2, sm + K3_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K3_BLOCK)
fp2_sqr_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K3_SMEM];
#pragma unroll
  for (int ph = 0; ph < K3_PHASES; ++ph) {
    fp2_sqr_phase(ph, sm, a, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K3_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------- K4
//
// Fp6 product c = a * b with v^3 = xi, Karatsuba over the coefficients:
//   c0 = t0 + xi (m12 - t1 - t2)
//   c1 = m01 - t0 - t1 + xi t2
//   c2 = m02 - t0 - t2 + t1
// with t_j = a_j b_j, m_jl = (a_j + a_l)(b_j + b_l) and
// xi (x0 + x1 i) = (x0 - x1) + (x0 + x1) i.  The 6 Fp2 products are pairs
// p = 0..5: t0, t1, t2, m01, m12, m02; Fp product q = 3 p + k is product
// k of pair p's Fp2 Karatsuba.

constexpr int K4_ROWS = 16;                      // instances per block
constexpr int K4_BLOCK = 18 * K4_ROWS;           // one thread per Fp product
// shared layout (limbs): operands A, B; products T[q][i]; then the Fp2
// products V[2 p + f][i] over A and B, and the outputs over T
constexpr int K4_A = 0, K4_B = K4_ROWS * S6, K4_T = 2 * K4_ROWS * S6;
constexpr int K4_V = 0, K4_O = K4_T;
constexpr int K4_SMEM = K4_T + 18 * K4_ROWS * NL;
constexpr int K4_PHASES = 5;
static_assert(12 * K4_ROWS * NL <= K4_T, "V fits over the operands");
static_assert(K4_ROWS * S6 <= 18 * K4_ROWS * NL, "the outputs fit over T");

// Phase `ph` of K4 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp6_mul_phase(int ph, uint32_t* sm, const uint32_t* a,
                                              const uint32_t* b, uint32_t* out, int64_t n,
                                              int64_t blk, int tid) {
  const int64_t row0 = blk * K4_ROWS;
  const int rows = block_rows(n, blk, K4_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F6, S6, K4_BLOCK>(sm + K4_A, a + row0 * F6, rows, tid);
    stage_in<F6, S6, K4_BLOCK>(sm + K4_B, b + row0 * F6, rows, tid);
  } else if (ph == 1) {                     // product q of instance i
    const int q = tid / K4_ROWS, i = tid % K4_ROWS;
    if (i < rows) {
      uint32_t x[NL], y[NL];
      fp6_operand(x, sm + K4_A + i * S6, q);
      fp6_operand(y, sm + K4_B + i * S6, q);
      mont_mul<NL>(x, x, y);
      st_fp(sm + K4_T + tid * NL, x);
    }
  } else if (ph == 2) {                     // Fp2 coefficient w / K4_ROWS of instance i
    for (int w = tid; w < 12 * K4_ROWS; w += K4_BLOCK) {
      const int v = w / K4_ROWS, i = w % K4_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp2_coeff(r, sm + K4_T + (3 * (v / 2) * K4_ROWS + i) * NL, K4_ROWS * NL, v % 2);
        st_fp(sm + K4_V + w * NL, r);
      }
    }
  } else if (ph == 3) {                     // output coefficient o of instance i
    for (int w = tid; w < 6 * K4_ROWS; w += K4_BLOCK) {
      const int o = w / K4_ROWS, i = w % K4_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp6_coeff(r, sm + K4_V + i * NL, K4_ROWS * NL, o / 2, o % 2);
        st_fp(sm + K4_O + i * S6 + o * NL, r);
      }
    }
  } else {                                  // store
    stage_out<F6, S6, K4_BLOCK>(out + row0 * F6, sm + K4_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K4_BLOCK)
fp6_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K4_SMEM];
#pragma unroll
  for (int ph = 0; ph < K4_PHASES; ++ph) {
    fp6_mul_phase(ph, sm, a, b, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K4_PHASES) __syncthreads();
  }
}

extern "C" int fp2_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp2_mul_kernel<<<(unsigned)((n + K2_ROWS - 1) / K2_ROWS), K2_BLOCK, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                             (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp2_sqr(const void* a, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp2_sqr_kernel<<<(unsigned)((n + K3_ROWS - 1) / K3_ROWS), K3_BLOCK, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)a, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp6_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp6_mul_kernel<<<(unsigned)((n + K4_ROWS - 1) / K4_ROWS), K4_BLOCK, 0,
                     (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                             (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
