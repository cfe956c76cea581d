// K8, K9, K10, K11: the Fp12 product, the Fp12 square, the cyclotomic
// square and the product by a sparse Miller line, one whole Fp12
// operation per instance.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py that its
// program table marks [xla-only]: `prog_fp12_mul` (K8), `prog_fp12_sqr`
// (K9), `prog_fp12_usqr` (K10) and `prog_fp12_sparse_mul` (K11).  Mosaic's
// compile of such a program did not finish, so the TPU ran each as one
// small kernel (K4, K3 or K2) over row-stacked instances with the
// cross-instance Karatsuba combines in plain XLA.  nvcc builds them whole,
// so here the pre-sums, the products and every combine stay inside one
// kernel and no intermediate leaves it.
//
// Algebra (x = a + b w with Fp6 halves a, b; v^3 = xi = 1 + i, w^2 = v):
//   K8  x y = t0 + v t1 + (m - t0 - t1) w with t0 = a c, t1 = b d,
//       m = (a + b)(c + d) for y = c + d w: 3 Fp6 Karatsuba products, 54
//       Fp products;
//   K9  x^2 = t - m - v m + 2 m w with t = (a + b)(a + v b), m = a b: 2 Fp6
//       products, 36 Fp products;
//   K10 the Granger-Scott square: for (X_j, Y_j) = (b1, a0), (a2, b0),
//       (b2, a1) the 9 Fp2 squares X_j^2, Y_j^2, (X_j + Y_j)^2 (18 Fp
//       products; each square's two products are its two coefficients,
//       as in K3), then with U_j = xi X_j^2 + Y_j^2 and the cross terms
//       C_j = (X_j + Y_j)^2 - X_j^2 - Y_j^2:
//       x^2 = 3 U - 2 a + (3 (xi C_2, C_0, C_1) + 2 b) w.  It equals the
//       square only in the cyclotomic subgroup; as a polynomial it is the
//       same for every input;
//   K11 f (c0 + c3 w^3 + c5 w^5) = t0 + v t1 + (m - t0 - t1) w with
//       t0 = a c0, t1 = (xi (b1 c5 + b2 c3), b0 c3 + xi b2 c5,
//       b0 c5 + b1 c3) and m = (a + b)(c0, c3, c5) an Fp6 Karatsuba
//       product: 15 Fp2 products, 45 Fp products.
//
// Bound on the card.  Per instance K8 reads 1,152 bytes and writes 576 for
// 54 Fp products, K9 576 and 576 for 36, K10 576 and 576 for 18, K11 864
// and 576 for 45, at 588 32-bit multiply-adds per product: 9 to 18
// multiply-adds per byte, above the card's 5 (1.673e13 per s over
// 3.35e12 bytes per s), so the integer multiply rate bounds all four.
// One thread per instance would run 18 to 54 products as one dependent
// chain in far too many registers (K4's 18 already spilled), at the
// pairing's 2,048 rows a partial wave.
//
// Each kernel therefore gives each Fp product its own thread, as K2-K4 do
// (tower.cu): 54 (K8), 36 (K9), 18 (K10) or 45 (K11) threads per
// instance.  A block takes K*_ROWS consecutive instances and runs in
// phases with a barrier between each two:
//   stage    the block's span of each operand into shared memory, 16 bytes
//            per thread, consecutive threads on consecutive bytes;
//   pre-sum  the reduced sums the products take: K8 a + b and c + d, K9
//            a + b and a + v b, K10 X_j + Y_j, K11 a + b, its pair sums
//            and the line's pair sums, one Fp coefficient per item;
//   product  each thread forms its two operands from shared memory (the
//            Fp2 Karatsuba's raw sum included), runs mont_mul (fp381.cuh:
//            the CIOS product of K1) and writes the product back;
//   combine  the Fp2 Karatsuba combines (K8, K9, K11), then the Fp6 ones
//            (K8, K9: fp6_coeff; K11: t0, t1 and m), then the Fp12 one,
//            one Fp coefficient per item; K10 has one combine phase;
//   store    the outputs from shared memory, 16 bytes per thread.
// Pre-sums and combines loop w = tid, tid + BLOCK, ... over their items,
// item w being coefficient w / ROWS of instance w % ROWS.  Each phase is a
// function of (phase, block, thread) that the __global__ body only calls,
// with a barrier after each.  Shared memory per block: K8 35,072 bytes,
// K9 23,424, K10 32,768, K11 31,744, each later phase writing over what
// is dead by then (the layouts below).  A shared Fp12 row is padded from
// 576 to 592 bytes and an Fp6 row from 288 to 304, so that the 16-byte
// accesses of 8 consecutive threads fall in 32 distinct banks.  The last
// block of a ragged launch masks its copies, pre-sums, products and
// combines; every thread reaches every barrier.
//
// Bound proof of the product operands.  Every pre-sum is add_mod of
// canonical values (xi b2 in K9's a + v b is a sub_mod and an add_mod),
// so canonical.  A product's operand is then a canonical coefficient or,
// as the third operand of an Fp2 Karatsuba (kara_operand, fp6_operand),
// the raw sum of two canonical values, below 2p; K10's operands are
// canonical, their difference (sub_mod) or raw sums of two canonical
// values, as in K3.  mont_mul takes operands below 2p.  The combines are
// add_mod and sub_mod of canonical values, so every output is canonical.
//
// Layouts (int32 limbs, row-major, contiguous, 16-byte aligned): Fp12
// (n, 2, 3, 2, 12), the line (n, 3, 2, 12) as c0, c3, c5.  Operands are
// canonical; outputs are canonical.

#include "fp381.cuh"
#include "tower.cuh"

using namespace fp381;

constexpr int F12 = 2 * F6;   // limbs of one Fp12 value
constexpr int S12 = F12 + 4;  // a padded shared Fp12 row (592 bytes: 37 16-byte units)

// ------------------------------------------------------ Fp12 pieces

// Component f of xi x for x = (x0, x1) in shared memory: x0 - x1 (f = 0)
// or x0 + x1 (f = 1).
__device__ __forceinline__ void xi_coeff(uint32_t* r, const uint32_t* x0, const uint32_t* x1,
                                         int f) {
  ld_fp(r, x0);
  if (f == 0) sub_sh(r, x1); else add_sh(r, x1);
}

// Component f of coefficient c of v x, for the Fp6 value x whose
// coefficient j has its component g at x(j, g): v x = (xi x2, x0, x1).
template <class X>
__device__ __forceinline__ void v_coeff(uint32_t* r, X x, int c, int f) {
  if (c == 0) xi_coeff(r, x(2, 0), x(2, 1), f); else ld_fp(r, x(c - 1, f));
}

// Output coefficient o (half o / 6, coefficient o % 6 / 2, component o % 2)
// of t0 + v t1 + (m - t0 - t1) w, for the Fp6 values t0, t1, m whose
// coefficient c has its component f at u(k, c, f), k = 0, 1, 2.
template <class U>
__device__ __forceinline__ void fp12_kara_coeff(uint32_t* r, U u, int o) {
  const int c = o % 6 / 2, f = o % 2;
  if (o < 6) {                              // t0 + v t1
    v_coeff(r, [=](int j, int g) { return u(1, j, g); }, c, f);
    add_sh(r, u(0, c, f));
  } else {                                  // m - t0 - t1
    ld_fp(r, u(2, c, f));
    sub_sh(r, u(0, c, f));
    sub_sh(r, u(1, c, f));
  }
}

// ------------------------------------------------------------- K8

constexpr int K8_ROWS = 8;                       // instances per block
constexpr int K8_BLOCK = 54 * K8_ROWS;           // one thread per Fp product
// shared layout (limbs): operands X, Y; pre-sums P[k][i] (k = 0: a + b,
// 1: c + d); products T[q][i]; then the Fp2 products V[v][i] over the
// operands, the Fp6 products U[o][i] over T, and the outputs over V
constexpr int K8_X = 0, K8_Y = K8_ROWS * S12, K8_P = 2 * K8_ROWS * S12;
constexpr int K8_T = K8_P + 2 * K8_ROWS * S6;
constexpr int K8_V = 0, K8_U = K8_T, K8_O = 0;
constexpr int K8_SMEM = K8_T + 54 * K8_ROWS * NL;
constexpr int K8_PHASES = 7;
static_assert(36 * K8_ROWS * NL <= K8_T, "V fits over the operands");
static_assert(K8_ROWS * S12 <= 36 * K8_ROWS * NL, "the outputs fit over V");

// Phase `ph` of K8 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp12_mul_phase(int ph, uint32_t* sm, const uint32_t* x,
                                               const uint32_t* y, uint32_t* out, int64_t n,
                                               int64_t blk, int tid) {
  const int64_t row0 = blk * K8_ROWS;
  const int rows = block_rows(n, blk, K8_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F12, S12, K8_BLOCK>(sm + K8_X, x + row0 * F12, rows, tid);
    stage_in<F12, S12, K8_BLOCK>(sm + K8_Y, y + row0 * F12, rows, tid);
  } else if (ph == 1) {                     // pre-sum e = 6 k + c of instance i
    for (int w = tid; w < 12 * K8_ROWS; w += K8_BLOCK) {
      const int e = w / K8_ROWS, i = w % K8_ROWS, k = e / 6;
      if (i < rows) {
        const uint32_t* half0 = sm + (k ? K8_Y : K8_X) + i * S12 + e % 6 * NL;
        uint32_t r[NL];
        ld_fp(r, half0);
        add_sh(r, half0 + F6);
        st_fp(sm + K8_P + (k * K8_ROWS + i) * S6 + e % 6 * NL, r);
      }
    }
  } else if (ph == 2) {                     // product q = 18 k + q6 of instance i
    const int q = tid / K8_ROWS, i = tid % K8_ROWS, k = q / 18;
    if (i < rows) {                         // k = 0: a c, 1: b d, 2: (a + b)(c + d)
      const uint32_t* xs = k < 2 ? sm + K8_X + i * S12 + k * F6 : sm + K8_P + i * S6;
      const uint32_t* ys =
          k < 2 ? sm + K8_Y + i * S12 + k * F6 : sm + K8_P + (K8_ROWS + i) * S6;
      uint32_t a[NL], b[NL];
      fp6_operand(a, xs, q % 18);
      fp6_operand(b, ys, q % 18);
      mont_mul<NL>(a, a, b);
      st_fp(sm + K8_T + tid * NL, a);
    }
  } else if (ph == 3) {                     // Fp2 coefficient v of instance i
    for (int w = tid; w < 36 * K8_ROWS; w += K8_BLOCK) {
      const int v = w / K8_ROWS, i = w % K8_ROWS;
      if (i < rows) {                       // its Fp products are q = 3 (v / 2) + 0..2
        uint32_t r[NL];
        fp2_coeff(r, sm + K8_T + (3 * (v / 2) * K8_ROWS + i) * NL, K8_ROWS * NL, v % 2);
        st_fp(sm + K8_V + w * NL, r);
      }
    }
  } else if (ph == 4) {                     // coefficient o = 6 k + c of Fp6 product k
    for (int w = tid; w < 18 * K8_ROWS; w += K8_BLOCK) {
      const int o = w / K8_ROWS, i = w % K8_ROWS, c = o % 6;
      if (i < rows) {
        uint32_t r[NL];
        fp6_coeff(r, sm + K8_V + (12 * (o / 6) * K8_ROWS + i) * NL, K8_ROWS * NL, c / 2,
                  c % 2);
        st_fp(sm + K8_U + w * NL, r);
      }
    }
  } else if (ph == 5) {                     // output coefficient o of instance i
    for (int w = tid; w < 12 * K8_ROWS; w += K8_BLOCK) {
      const int o = w / K8_ROWS, i = w % K8_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp12_kara_coeff(r, [=](int k, int c, int f) {
          return sm + K8_U + ((6 * k + 2 * c + f) * K8_ROWS + i) * NL; }, o);
        st_fp(sm + K8_O + i * S12 + o * NL, r);
      }
    }
  } else {                                  // store
    stage_out<F12, S12, K8_BLOCK>(out + row0 * F12, sm + K8_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K8_BLOCK)
fp12_mul_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K8_SMEM];
#pragma unroll
  for (int ph = 0; ph < K8_PHASES; ++ph) {
    fp12_mul_phase(ph, sm, x, y, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K8_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------- K9

constexpr int K9_ROWS = 8;                       // instances per block
constexpr int K9_BLOCK = 36 * K9_ROWS;           // one thread per Fp product
// shared layout (limbs): operand X; pre-sums P[k][i] (k = 0: a + b,
// 1: a + v b); products T[q][i]; then the Fp2 products V[v][i] over the
// operand, the Fp6 products U[o][i] (t, m) over T, and the outputs over V
constexpr int K9_X = 0, K9_P = K9_ROWS * S12, K9_T = K9_P + 2 * K9_ROWS * S6;
constexpr int K9_V = 0, K9_U = K9_T, K9_O = 0;
constexpr int K9_SMEM = K9_T + 36 * K9_ROWS * NL;
constexpr int K9_PHASES = 7;
static_assert(24 * K9_ROWS * NL <= K9_T, "V fits over the operand");
static_assert(K9_ROWS * S12 <= 24 * K9_ROWS * NL, "the outputs fit over V");

// Phase `ph` of K9 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp12_sqr_phase(int ph, uint32_t* sm, const uint32_t* x,
                                               uint32_t* out, int64_t n, int64_t blk, int tid) {
  const int64_t row0 = blk * K9_ROWS;
  const int rows = block_rows(n, blk, K9_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F12, S12, K9_BLOCK>(sm + K9_X, x + row0 * F12, rows, tid);
  } else if (ph == 1) {                     // pre-sum e = 6 k + c of instance i
    for (int w = tid; w < 12 * K9_ROWS; w += K9_BLOCK) {
      const int e = w / K9_ROWS, i = w % K9_ROWS, c = e % 6;
      if (i < rows) {
        const uint32_t* a = sm + K9_X + i * S12;
        uint32_t r[NL];
        if (e < 6) ld_fp(r, a + F6 + c * NL);             // b
        else v_coeff(r, [=](int j, int g) { return a + F6 + j * F2 + g * NL; }, c / 2, c % 2);
        add_sh(r, a + c * NL);
        st_fp(sm + K9_P + (e / 6 * K9_ROWS + i) * S6 + c * NL, r);
      }
    }
  } else if (ph == 2) {                     // product q = 18 k + q6 of instance i
    const int q = tid / K9_ROWS, i = tid % K9_ROWS;
    if (i < rows) {                         // k = 0: (a + b)(a + v b), 1: a b
      const uint32_t* xs = q < 18 ? sm + K9_P + i * S6 : sm + K9_X + i * S12;
      const uint32_t* ys = q < 18 ? sm + K9_P + (K9_ROWS + i) * S6 : sm + K9_X + i * S12 + F6;
      uint32_t a[NL], b[NL];
      fp6_operand(a, xs, q % 18);
      fp6_operand(b, ys, q % 18);
      mont_mul<NL>(a, a, b);
      st_fp(sm + K9_T + tid * NL, a);
    }
  } else if (ph == 3) {                     // Fp2 coefficient v of instance i
    for (int w = tid; w < 24 * K9_ROWS; w += K9_BLOCK) {
      const int v = w / K9_ROWS, i = w % K9_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp2_coeff(r, sm + K9_T + (3 * (v / 2) * K9_ROWS + i) * NL, K9_ROWS * NL, v % 2);
        st_fp(sm + K9_V + w * NL, r);
      }
    }
  } else if (ph == 4) {                     // coefficient o = 6 k + c of Fp6 product k
    for (int w = tid; w < 12 * K9_ROWS; w += K9_BLOCK) {
      const int o = w / K9_ROWS, i = w % K9_ROWS, c = o % 6;
      if (i < rows) {
        uint32_t r[NL];
        fp6_coeff(r, sm + K9_V + (12 * (o / 6) * K9_ROWS + i) * NL, K9_ROWS * NL, c / 2,
                  c % 2);
        st_fp(sm + K9_U + w * NL, r);
      }
    }
  } else if (ph == 5) {                     // output coefficient o of instance i
    for (int w = tid; w < 12 * K9_ROWS; w += K9_BLOCK) {
      const int o = w / K9_ROWS, i = w % K9_ROWS, c = o % 6 / 2, f = o % 2;
      if (i < rows) {
        auto m = [=](int j, int g) { return sm + K9_U + ((6 + 2 * j + g) * K9_ROWS + i) * NL; };
        uint32_t r[NL];
        if (o < 6) {                        // t - m - v m
          uint32_t s[NL];
          v_coeff(s, m, c, f);
          ld_fp(r, sm + K9_U + ((2 * c + f) * K9_ROWS + i) * NL);
          sub_sh(r, m(c, f));
          sub_mod<NL>(r, r, s);
        } else {                            // 2 m
          ld_fp(r, m(c, f));
          add_sh(r, m(c, f));
        }
        st_fp(sm + K9_O + i * S12 + o * NL, r);
      }
    }
  } else {                                  // store
    stage_out<F12, S12, K9_BLOCK>(out + row0 * F12, sm + K9_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K9_BLOCK)
fp12_sqr_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K9_SMEM];
#pragma unroll
  for (int ph = 0; ph < K9_PHASES; ++ph) {
    fp12_sqr_phase(ph, sm, x, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K9_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------ K10

constexpr int K10_ROWS = 16;                     // instances per block
constexpr int K10_BLOCK = 18 * K10_ROWS;         // one thread per Fp product
// shared layout (limbs): operand X; pre-sums P (rows X_0 + Y_0,
// X_1 + Y_1, X_2 + Y_2); the squares' coefficients Q[2 s + k][i]; the
// outputs over P
constexpr int K10_X = 0, K10_P = K10_ROWS * S12, K10_Q = 2 * K10_ROWS * S12;
constexpr int K10_O = K10_P;
constexpr int K10_SMEM = K10_Q + 18 * K10_ROWS * NL;
constexpr int K10_PHASES = 5;

// Offsets in an Fp12 row of the Granger-Scott pair (X_j, Y_j): (b1, a0),
// (a2, b0), (b2, a1).
__device__ __forceinline__ int gs_x(int j) { return j == 1 ? 2 * F2 : F6 + (j / 2 + 1) * F2; }
__device__ __forceinline__ int gs_y(int j) { return j == 0 ? 0 : (j == 1 ? F6 : F2); }

// Phase `ph` of K10 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp12_usqr_phase(int ph, uint32_t* sm, const uint32_t* x,
                                                uint32_t* out, int64_t n, int64_t blk, int tid) {
  const int64_t row0 = blk * K10_ROWS;
  const int rows = block_rows(n, blk, K10_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F12, S12, K10_BLOCK>(sm + K10_X, x + row0 * F12, rows, tid);
  } else if (ph == 1) {                     // pre-sum e = 2 j + f of instance i
    for (int w = tid; w < 6 * K10_ROWS; w += K10_BLOCK) {
      const int e = w / K10_ROWS, i = w % K10_ROWS;
      if (i < rows) {
        const uint32_t* a = sm + K10_X + i * S12 + e % 2 * NL;
        uint32_t r[NL];
        ld_fp(r, a + gs_x(e / 2));
        add_sh(r, a + gs_y(e / 2));
        st_fp(sm + K10_P + i * S12 + e * NL, r);
      }
    }
  } else if (ph == 2) {                     // coefficient k of square s = 3 g + j
    const int q = tid / K10_ROWS, i = tid % K10_ROWS, s = q / 2, j = s % 3;
    if (i < rows) {                         // g = 0: X_j^2, 1: Y_j^2, 2: (X_j + Y_j)^2
      const uint32_t* a = sm + K10_X + i * S12;
      const uint32_t* z = s < 3 ? a + gs_x(j) : (s < 6 ? a + gs_y(j) : sm + K10_P + i * S12 + j * F2);
      uint32_t z0[NL], y[NL];
      ld_fp(z0, z);
      ld_fp(y, z + NL);
      if (q % 2 == 0) {                     // (z0 + z1)(z0 - z1)
        uint32_t t[NL];
        add_raw<NL>(t, z0, y);
        sub_mod<NL>(y, z0, y);
        mont_mul<NL>(y, t, y);
      } else {                              // z0 (z1 + z1)
        add_raw<NL>(y, y, y);
        mont_mul<NL>(y, z0, y);
      }
      st_fp(sm + K10_Q + tid * NL, y);
    }
  } else if (ph == 3) {                     // output coefficient o of instance i
    for (int w = tid; w < 12 * K10_ROWS; w += K10_BLOCK) {
      const int o = w / K10_ROWS, i = w % K10_ROWS, c = o % 6 / 2, f = o % 2;
      if (i < rows) {
        // component g of square 3 g' + j, and of the cross term C_j
        auto sq = [=](int gg, int j, int g) {
          return sm + K10_Q + ((2 * (3 * gg + j) + g) * K10_ROWS + i) * NL; };
        auto cross = [=](uint32_t* r, int j, int g) {
          ld_fp(r, sq(2, j, g));
          sub_sh(r, sq(0, j, g));
          sub_sh(r, sq(1, j, g));
        };
        uint32_t u[NL], r[NL], d[NL];
        if (o < 6) {                        // U_c = xi X_c^2 + Y_c^2
          xi_coeff(u, sq(0, c, 0), sq(0, c, 1), f);
          add_sh(u, sq(1, c, f));
        } else if (c == 0) {                // xi C_2
          cross(u, 2, 0);
          cross(d, 2, 1);
          if (f == 0) sub_mod<NL>(u, u, d); else add_mod<NL>(u, u, d);
        } else {                            // C_0, C_1
          cross(u, c - 1, f);
        }
        add_mod<NL>(r, u, u);               // 3 u -/+ 2 x_o
        add_mod<NL>(r, r, u);
        ld_fp(d, sm + K10_X + i * S12 + o * NL);
        add_mod<NL>(d, d, d);
        if (o < 6) sub_mod<NL>(r, r, d); else add_mod<NL>(r, r, d);
        st_fp(sm + K10_O + i * S12 + o * NL, r);
      }
    }
  } else {                                  // store
    stage_out<F12, S12, K10_BLOCK>(out + row0 * F12, sm + K10_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K10_BLOCK)
fp12_usqr_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K10_SMEM];
#pragma unroll
  for (int ph = 0; ph < K10_PHASES; ++ph) {
    fp12_usqr_phase(ph, sm, x, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K10_PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------ K11
//
// The 15 Fp2 products p = 0..14 of f = a + b w by the line (c0, c3, c5):
// a0 c0, a1 c0, a2 c0 (t0); b1 c5, b2 c3, b0 c3, b2 c5, b0 c5, b1 c3 (the
// u of t1); s0 c0, s1 c3, s2 c5, s01 c03, s12 c35, s02 c05 (the Fp6
// Karatsuba of m, s = a + b), with s_jl = s_j + s_l and c_jl = c_j + c_l.
// Left operand codes: 0-5 a0, a1, a2, b0, b1, b2 (the row of f), 6-8 s0,
// s1, s2, 9-11 s01, s12, s02; right: 0-2 c0, c3, c5, 3-5 c03, c35, c05.

__constant__ uint8_t K11_LHS[15] = {0, 1, 2, 4, 5, 3, 5, 3, 4, 6, 7, 8, 9, 10, 11};
__constant__ uint8_t K11_RHS[15] = {0, 0, 0, 2, 1, 1, 2, 2, 1, 0, 1, 2, 3, 4, 5};

constexpr int K11_ROWS = 8;                      // instances per block
constexpr int K11_BLOCK = 45 * K11_ROWS;         // one thread per Fp product
// shared layout (limbs): operands F, L (the line); pre-sums P[k][i] (k = 0:
// s0, s1, s2; 1: s01, s12, s02; 2: c03, c35, c05); products T[q][i]; then
// the Fp2 products W[v][i] over the operands, the Fp6 values U[o][i] (t0,
// t1, m) over T, and the outputs over T after U
constexpr int K11_F = 0, K11_L = K11_ROWS * S12, K11_P = K11_L + K11_ROWS * S6;
constexpr int K11_T = K11_P + 3 * K11_ROWS * S6;
constexpr int K11_W = 0, K11_U = K11_T, K11_O = K11_T + 18 * K11_ROWS * NL;
constexpr int K11_SMEM = K11_T + 45 * K11_ROWS * NL;
constexpr int K11_PHASES = 7;
static_assert(30 * K11_ROWS * NL <= K11_T, "W fits over the operands");
static_assert(K11_O + K11_ROWS * S12 <= K11_SMEM, "U and the outputs fit over T");

// Phase `ph` of K11 for thread `tid` of block `blk`.
__device__ __forceinline__ void fp12_sparse_mul_phase(int ph, uint32_t* sm, const uint32_t* f,
                                                      const uint32_t* line, uint32_t* out,
                                                      int64_t n, int64_t blk, int tid) {
  const int64_t row0 = blk * K11_ROWS;
  const int rows = block_rows(n, blk, K11_ROWS);
  if (ph == 0) {                            // stage
    stage_in<F12, S12, K11_BLOCK>(sm + K11_F, f + row0 * F12, rows, tid);
    stage_in<F6, S6, K11_BLOCK>(sm + K11_L, line + row0 * F6, rows, tid);
  } else if (ph == 1) {                     // pre-sum e = 6 k + 2 j + g of instance i
    for (int w = tid; w < 18 * K11_ROWS; w += K11_BLOCK) {
      const int e = w / K11_ROWS, i = w % K11_ROWS, k = e / 6, j = e % 6 / 2, g = e % 2;
      if (i < rows) {
        const uint32_t* a = sm + K11_F + i * S12 + g * NL;
        const uint32_t* l = sm + K11_L + i * S6 + g * NL;
        const int l1 = j == 1 ? 1 : 0, l2 = j == 0 ? 1 : 2;   // pair j: (0, 1), (1, 2), (0, 2)
        uint32_t r[NL];
        if (k == 0) {                       // s_j = a_j + b_j
          ld_fp(r, a + j * F2);
          add_sh(r, a + F6 + j * F2);
        } else if (k == 1) {                // s_l1 + s_l2
          uint32_t s[NL];
          ld_fp(r, a + l1 * F2);
          add_sh(r, a + F6 + l1 * F2);
          ld_fp(s, a + l2 * F2);
          add_sh(s, a + F6 + l2 * F2);
          add_mod<NL>(r, r, s);
        } else {                            // c_l1 + c_l2
          ld_fp(r, l + l1 * F2);
          add_sh(r, l + l2 * F2);
        }
        st_fp(sm + K11_P + (k * K11_ROWS + i) * S6 + e % 6 * NL, r);
      }
    }
  } else if (ph == 2) {                     // product q = 3 p + k of instance i
    const int q = tid / K11_ROWS, i = tid % K11_ROWS, p = q / 3;
    if (i < rows) {
      const int lc = K11_LHS[p], rc = K11_RHS[p];
      const uint32_t* xs = lc < 6 ? sm + K11_F + i * S12 + lc * F2
                                  : sm + K11_P + ((lc - 6) / 3 * K11_ROWS + i) * S6 + (lc - 6) % 3 * F2;
      const uint32_t* ys = rc < 3 ? sm + K11_L + i * S6 + rc * F2
                                  : sm + K11_P + (2 * K11_ROWS + i) * S6 + (rc - 3) * F2;
      uint32_t a[NL], b[NL];
      kara_operand(a, xs, q % 3);
      kara_operand(b, ys, q % 3);
      mont_mul<NL>(a, a, b);
      st_fp(sm + K11_T + tid * NL, a);
    }
  } else if (ph == 3) {                     // Fp2 coefficient v = 2 p + g of instance i
    for (int w = tid; w < 30 * K11_ROWS; w += K11_BLOCK) {
      const int v = w / K11_ROWS, i = w % K11_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp2_coeff(r, sm + K11_T + (3 * (v / 2) * K11_ROWS + i) * NL, K11_ROWS * NL, v % 2);
        st_fp(sm + K11_W + w * NL, r);
      }
    }
  } else if (ph == 4) {                     // coefficient o = 6 k + 2 c + g of t0, t1, m
    for (int w = tid; w < 18 * K11_ROWS; w += K11_BLOCK) {
      const int o = w / K11_ROWS, i = w % K11_ROWS, c = o % 6 / 2, g = o % 2;
      if (i < rows) {
        auto at = [=](int p, int gg) { return sm + K11_W + ((2 * p + gg) * K11_ROWS + i) * NL; };
        uint32_t r[NL];
        if (o < 6) {                        // t0_c = a_c c0
          ld_fp(r, at(c, g));
        } else if (o >= 12) {               // m: the Fp6 combine of products 9-14
          fp6_coeff(r, at(9, 0), K11_ROWS * NL, c, g);
        } else if (c == 0) {                // t1_0 = xi (b1 c5 + b2 c3)
          uint32_t s[NL];
          ld_fp(r, at(3, 0));
          add_sh(r, at(4, 0));
          ld_fp(s, at(3, 1));
          add_sh(s, at(4, 1));
          if (g == 0) sub_mod<NL>(r, r, s); else add_mod<NL>(r, r, s);
        } else if (c == 1) {                // t1_1 = b0 c3 + xi b2 c5
          xi_coeff(r, at(6, 0), at(6, 1), g);
          add_sh(r, at(5, g));
        } else {                            // t1_2 = b0 c5 + b1 c3
          ld_fp(r, at(7, g));
          add_sh(r, at(8, g));
        }
        st_fp(sm + K11_U + w * NL, r);
      }
    }
  } else if (ph == 5) {                     // output coefficient o of instance i
    for (int w = tid; w < 12 * K11_ROWS; w += K11_BLOCK) {
      const int o = w / K11_ROWS, i = w % K11_ROWS;
      if (i < rows) {
        uint32_t r[NL];
        fp12_kara_coeff(r, [=](int k, int c, int g) {
          return sm + K11_U + ((6 * k + 2 * c + g) * K11_ROWS + i) * NL; }, o);
        st_fp(sm + K11_O + i * S12 + o * NL, r);
      }
    }
  } else {                                  // store
    stage_out<F12, S12, K11_BLOCK>(out + row0 * F12, sm + K11_O, rows, tid);
  }
}

__global__ void __launch_bounds__(K11_BLOCK)
fp12_sparse_mul_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ line,
                       uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K11_SMEM];
#pragma unroll
  for (int ph = 0; ph < K11_PHASES; ++ph) {
    fp12_sparse_mul_phase(ph, sm, f, line, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K11_PHASES) __syncthreads();
  }
}

extern "C" int fp12_mul(const void* x, const void* y, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp12_mul_kernel<<<(unsigned)((n + K8_ROWS - 1) / K8_ROWS), K8_BLOCK, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)x, (const uint32_t*)y,
                                              (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp12_sqr(const void* x, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp12_sqr_kernel<<<(unsigned)((n + K9_ROWS - 1) / K9_ROWS), K9_BLOCK, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp12_usqr(const void* x, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp12_usqr_kernel<<<(unsigned)((n + K10_ROWS - 1) / K10_ROWS), K10_BLOCK, 0,
                       (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp12_sparse_mul(const void* f, const void* line, void* out, int64_t n,
                               void* stream) {
  if (n > 0) {
    fp12_sparse_mul_kernel<<<(unsigned)((n + K11_ROWS - 1) / K11_ROWS), K11_BLOCK, 0,
                             (cudaStream_t)stream>>>((const uint32_t*)f,
                                                     (const uint32_t*)line, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
