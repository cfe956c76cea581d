// K8, K9, K10, K11: the Fp12 product, the Fp12 square, the cyclotomic
// square and the product by k sparse Miller lines, one whole Fp12
// operation per instance; and the cyclotomic power x^e for a public
// exponent e (the final exponentiation's g^|x|), the whole chain of K10
// squares and K8 products in ONE launch.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py that its
// program table marks [xla-only]: `prog_fp12_mul` (K8), `prog_fp12_sqr`
// (K9), `prog_fp12_usqr` (K10) and `prog_fp12_sparse_mul` (K11).  Mosaic's
// compile of such a program did not finish, so the TPU ran each as one
// small kernel (K4, K3 or K2) over row-stacked instances with the
// cross-instance Karatsuba combines in plain XLA.  nvcc builds them whole,
// so here the pre-sums, the products and every combine stay inside one
// kernel and no intermediate leaves it.  The power chain replaces the JAX
// package's `_pow_abs_x` (crypto12381_tpu/pairing/pairing.py), 63 K10 and
// 5 K8 programs in a row; K11 over k lines replaces its loop of k
// `_mul_sparse` calls per Miller digit step.
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
//       product: 15 Fp2 products, 45 Fp products per line; k lines are
//       absorbed in order, f l_1 ... l_k;
//   the power x^e: from the top bit of e down, a K10 square at each later
//       bit and a K8 product by x at each set one (the JAX `_pow_abs_x`
//       order): (bits - 1) x 18 + (set bits - 1) x 54 Fp products, for
//       e = |x| = 0xd201000000010000 63 x 18 + 5 x 54 = 1,404.
//
// Bound on the card.  Per instance K8 reads 1,152 bytes and writes 576 for
// 54 Fp products, K9 576 and 576 for 36, K10 576 and 576 for 18, K11 576 +
// 288 k and 576 for 45 k, the power 576 and 576 for 1,404 (at e = |x|), at
// 588 32-bit multiply-adds per product: 9 to 1,400 multiply-adds per byte,
// above the card's 5 (1.673e13 per s over 3.35e12 bytes per s), so the
// integer multiply rate bounds all of them: at 2,048 rows K9 0.00259 ms,
// K10 0.00130, K11 0.00324 k, the power 0.1011 (0.0253 at 512 rows).  Tensor
// cores do not apply: there is no 32-bit integer wgmma.  TMA and cp.async
// do not matter for one stage-in of a few KB per launch; K11 prefetches
// each later line with cp.async (below).
//
// One thread per instance would run 18 to 54 products as one dependent
// chain in far too many registers (K4's 18 already spilled), at the
// pairing's 2,048 rows a partial wave.  Each kernel therefore spreads an
// instance over threads, as K2-K4 do (tower.cu): one Fp product per thread
// in K8 (54 threads per instance), K9 (36), K10 (18) and K11 (45), one Fp2
// product (three Fp products) per thread in the power's product step and
// K8Step, K8's layout from 4,096 rows on (18).  A block takes R
// consecutive instances and runs in phases with a barrier between each
// two; each phase is a function of (phase, block, thread) that the
// __global__ body only calls.  Thread q R + i works on item q (a product,
// or an output coefficient) of instance i.  A shared Fp12 row is padded
// from 576 to 592 bytes and an Fp6 row from 288 to 304, so that the
// 16-byte accesses of 8 consecutive threads fall in 32 distinct banks (a
// product or an Fp2 value is 48 bytes, which does the same).  The last block of a ragged
// launch masks its copies, products and combines; every thread reaches
// every barrier.
//
// All five kernels were redesigned after their first form (8 instances per
// block, one Fp product per thread, a phase for each pre-sum and combine
// level: K8 stage, pre-sum, product, the Fp2, Fp6 and Fp12 combines,
// store) sat at about 0.009-0.011 ms per launch at any row count up to 1,024
// rows, 5-10x their bounds: the launch, the stage, one product's latency
// and every barrier-separated phase (K9's first form, 7 phases, took
// 0.010539 ms at 1 row and 0.014818 at 2,048 on an H100 at 700 W; at
// 2,048 rows its 73,728 products keep the SM busy, so a layout that adds
// instructions loses there: forms whose product threads built their own
// pair sums of a + b and a + v b took 0.018 ms).  Their designs:
//   - the instances per block R are a template parameter, 8, 4 or 2,
//     picked from n (rows_per_block): at least 128 blocks where n allows,
//     so 512 rows make 128 blocks of 4 (the first form's 16 per block made
//     32 blocks on 132 SMs); __launch_bounds__ asks for 2 blocks per SM
//     (K8Step 4), so that 2,048 rows (256 blocks of 8) run in one wave;
//   - pre-sums are formed by the product's own thread from shared memory
//     (K10's X_j + Y_j, K11's a_j + b_j, their pair sums and the line's
//     pair sums, the power's pair sums of a + b), a predicated sum of up
//     to four values (sum_at), or in the stage phase from device memory
//     (K9's a + b and a + v b, the power's c + d), so there is no pre-sum
//     phase;
//   - a combine computes each output coefficient as one signed sum of the
//     products, a row of a table (SQR, USQR, CYCMUL, SPARSE, MUL3, generated
//     from the algebra by tools/fp12_tables.py), and writes it over its
//     input Fp12 row in place: each output depends only on the products
//     and, in K10, on its own input coefficient.  K9's rows are long (up to
//     13 + 13 terms), so below 1,024 rows (R < 8), where a block's latency
//     is the launch's time, its 36 threads per instance each sum a third
//     of a row (SQR3) and the store phase adds the three thirds.  Consecutive threads of a warp
//     hold different outputs (item w is output w / R of instance w % R),
//     so branchy combines serialise; a table row runs the same
//     instructions on every thread.  A first form with branchy combines
//     and a K11 merged through nested lambdas took 2.5x as long on the
//     card (K11 0.0415 ms at 2,048 rows, 148 registers);
//   - K10's product thread forms both coefficients' operands of its Fp2
//     square and selects one, for the same reason.
// K8 (its first form took 0.008662 ms at 1 row and 0.012852 at 2,048 on
// an H100 at 700 W): stage x, y, a + b and c + d (from device memory) and
// product, then below 1,024 rows (R < 8) a table combine in thirds (MUL3)
// and a store that adds the thirds (4 phases), at R = 8 the first form's
// Fp2, Fp6 and Fp12 combines, one phase each (5 phases; 7 before); the
// last phase writes to device memory.  From 4,096 rows on K8Step runs the
// power's product step (mul_product, mul_combine: the same functions),
// 18 threads per instance with three products each, 3 phases.  Each was
// the fastest form at its row counts in one call on the card, against
// these three everywhere and a 54-thread form that ran the CYCMUL table
// after an Fp2 combine (PERF.md, PR 18): 18 threads with three dependent
// products each lose to 54 threads while the card is not full (mont_mul's
// carry chains are one flag, so a thread's products do not overlap), the
// table combines' extra additions lose once the card is busy.
// K9 and K10: stage, product, combine, store (4 phases; 7 and 5 before;
// K9's store also adds the partial sums at R < 8).  K11: stage f
// and line 0; per line s a product phase, which also issues the cp.async
// copies of line s + 1 into the other slot of a two-line ring, and one
// combine phase (the Fp2, Fp6 and Fp12 combines in one table sum over the
// 45 products), which then waits for its copies; store: 2 k + 2 phases
// (7 per line before).
// The power: stage x twice (the fixed operand X and the accumulator A)
// and x's half sum c + d (read from device memory by its own thread);
// per bit a K10 square of A (its product and combine phases, the very
// functions of the single-step K10) and at a set bit a product A x in two
// phases: each of the 18 threads of an instance runs one Fp2 Karatsuba
// product of the three Fp6 products (3 independent Fp products and the Fp2
// combine in registers), then one table sum per output coefficient over
// the 18 Fp2 products (the Fp6 and Fp12 combines); store.  Nothing leaves
// the block between steps, and the block keeps K10's 18 threads per
// instance: a product step does three products per thread, once per set
// bit (5 of the 68 steps at |x|), where a block sized for 54 would idle
// two thirds of its threads through the 63 squares.  On an H100 (700 W)
// the 5 product steps took 0.114 of the 0.501 ms of x^|x| at 2,048 rows
// (chip_smoke.py's ms_squares_only times x^(2^63), the 63 squares alone).
// The exponent is a kernel argument (fp381.cuh `Exponent`), so every
// branch on its bits is uniform.  What bounds the power at 2,048 rows is
// the product itself: mont_mul's 64-bit-accumulator CIOS runs at about
// 7e9 products per s on the card (K8 at 16,384 rows), a quarter of the
// 588-multiply-adds-per-product bound, and x^|x| there is 2.9e6 products;
// at 512 rows it is one product's latency per step.
//
// Shared memory per block (limbs), R instances:
//   K8     X, Y (R rows of 148 each), P: a + b and c + d (2 R rows of 76),
//          T: the 54 products T[q][i], and over X, Y and P the partial
//          sums or Fp2 products, over T the Fp6 products; R = 8: 35,072
//          bytes; K8Step X, Y, YS: c + d (R rows of 76), W: the 18 Fp2
//          products as 36 Fp values per instance; 25,728 bytes;
//   K9     X (R rows of 148), P: a + b and a + v b (2 R rows of 76), T: the
//          36 products of each instance, T[q][i], and at R < 8 W: the 36
//          partial sums; R = 8: 23,424 bytes;
//   K10    X (R rows of 148), Q: the 18 products of each instance, Q[q][i];
//          R = 8: 11,648 bytes;
//   power  X, A (R rows of 148 each), XS: c + d (R rows of 76), Q: 18 Fp
//          products (a square) or 18 Fp2 products as 36 Fp values (a
//          product) per instance; R = 8: 25,728 bytes;
//   K11    F: the accumulator (R rows of 148), LN: two line slots of R rows
//          of 76, T: the 45 products T[q][i]; R = 8: 26,880 bytes.
//
// Bound proof of the product operands.  Every pre-sum is add_mod of
// canonical values (xi b2 in K9's a + v b is a sub_mod or an add_mod of
// b2's components), so canonical.  A product's operand is then a canonical coefficient or,
// as the third operand of an Fp2 Karatsuba (kara_operand, fp6_operand,
// kara_pick, the power's in-register Karatsuba), the raw sum of two
// canonical values, below 2p; K10's operands are canonical, their difference
// (sub_mod) or raw sums of two canonical values, as in K3.  mont_mul takes
// operands below 2p and returns canonical values.  The combines are
// add_mod and sub_mod of canonical values, so every output, and every
// accumulator between the power's steps, is canonical.
//
// Layouts (int32 limbs, row-major, contiguous, 16-byte aligned): Fp12
// (n, 2, 3, 2, 12), the lines (k, n, 3, 2, 12) as c0, c3, c5.  Operands
// are canonical; outputs are canonical.

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

// ------------------------------------------------------ combine tables
//
// Generated by tools/fp12_tables.py; each row's signed sum is the output.
// SQR: per output, the Fp products T[18 k + 3 p + kk] it adds and subtracts
constexpr int SQR_POS = 13, SQR_NEG = 13;
__device__ const uint8_t SQR_ADD[12][13] = {
    {0, 5, 8, 12, 12, 18, 19, 24, 24, 24, 24, 32, 35},
    {2, 4, 4, 7, 7, 14, 18, 26, 26, 31, 31, 34, 34},
    {1, 4, 6, 6, 9, 21, 21, 21, 28, 32, 255, 255, 255},
    {0, 1, 3, 4, 8, 11, 23, 23, 27, 28, 31, 31, 255},
    {1, 3, 7, 15, 18, 18, 26, 28, 34, 255, 255, 255, 255},
    {0, 1, 5, 6, 7, 17, 20, 20, 25, 27, 28, 33, 34},
    {18, 18, 23, 23, 26, 26, 30, 30, 30, 30, 255, 255, 255},
    {20, 20, 22, 22, 22, 22, 25, 25, 25, 25, 32, 32, 255},
    {19, 19, 22, 22, 24, 24, 24, 24, 27, 27, 255, 255, 255},
    {18, 18, 19, 19, 21, 21, 22, 22, 26, 26, 29, 29, 255},
    {19, 19, 21, 21, 25, 25, 33, 33, 255, 255, 255, 255, 255},
    {18, 18, 19, 19, 23, 23, 24, 24, 25, 25, 35, 35, 255},
};
__device__ const uint8_t SQR_SUB[12][13] = {
    {1, 3, 3, 6, 6, 14, 20, 26, 26, 30, 30, 33, 33},
    {0, 1, 5, 8, 13, 13, 19, 25, 25, 25, 25, 32, 35},
    {0, 3, 8, 10, 22, 23, 27, 30, 30, 255, 255, 255, 255},
    {2, 5, 7, 7, 9, 10, 21, 22, 22, 22, 29, 32, 255},
    {0, 4, 6, 16, 19, 19, 24, 25, 27, 33, 255, 255, 255},
    {2, 3, 4, 8, 15, 16, 18, 18, 19, 19, 24, 29, 35},
    {19, 19, 21, 21, 21, 21, 24, 24, 24, 24, 32, 32, 255},
    {18, 18, 19, 19, 23, 23, 26, 26, 31, 31, 31, 31, 255},
    {18, 18, 21, 21, 26, 26, 28, 28, 255, 255, 255, 255, 255},
    {20, 20, 23, 23, 25, 25, 25, 25, 27, 27, 28, 28, 255},
    {18, 18, 22, 22, 24, 24, 34, 34, 255, 255, 255, 255, 255},
    {20, 20, 21, 21, 22, 22, 26, 26, 33, 33, 34, 34, 255},
};
// SQR3: per output, the Fp products T[18 k + 3 p + kk] (SQR's rows in thirds) it adds and subtracts
constexpr int SQR3_POS = 5, SQR3_NEG = 5;
__device__ const uint8_t SQR3_ADD[36][5] = {
    {0, 12, 19, 24, 35},
    {2, 7, 18, 31, 34},
    {1, 6, 21, 32, 255},
    {0, 4, 23, 28, 255},
    {1, 15, 26, 255, 255},
    {0, 6, 20, 27, 34},
    {18, 23, 30, 30, 255},
    {20, 22, 25, 25, 255},
    {19, 22, 24, 27, 255},
    {18, 19, 22, 26, 255},
    {19, 21, 33, 255, 255},
    {18, 19, 24, 25, 255},
    {5, 12, 24, 24, 255},
    {4, 7, 26, 31, 255},
    {4, 9, 21, 255, 255},
    {1, 8, 23, 31, 255},
    {3, 18, 28, 255, 255},
    {1, 7, 20, 28, 255},
    {18, 26, 30, 255, 255},
    {20, 22, 25, 32, 255},
    {19, 24, 24, 255, 255},
    {18, 21, 22, 29, 255},
    {19, 25, 33, 255, 255},
    {18, 23, 24, 35, 255},
    {8, 18, 24, 32, 255},
    {4, 14, 26, 34, 255},
    {6, 21, 28, 255, 255},
    {3, 11, 27, 31, 255},
    {7, 18, 34, 255, 255},
    {5, 17, 25, 33, 255},
    {23, 26, 30, 255, 255},
    {22, 22, 25, 32, 255},
    {22, 24, 27, 255, 255},
    {19, 21, 26, 29, 255},
    {21, 25, 255, 255, 255},
    {19, 23, 25, 35, 255},
};
__device__ const uint8_t SQR3_SUB[36][5] = {
    {1, 6, 20, 30, 33},
    {0, 8, 19, 25, 35},
    {0, 10, 27, 255, 255},
    {2, 7, 21, 22, 255},
    {0, 16, 24, 33, 255},
    {2, 8, 18, 19, 35},
    {19, 21, 24, 24, 255},
    {18, 19, 26, 31, 255},
    {18, 21, 28, 255, 255},
    {20, 23, 25, 27, 255},
    {18, 22, 34, 255, 255},
    {20, 21, 26, 33, 255},
    {3, 6, 26, 30, 255},
    {1, 13, 25, 25, 255},
    {3, 22, 30, 255, 255},
    {5, 9, 22, 29, 255},
    {4, 19, 25, 255, 255},
    {3, 15, 18, 24, 255},
    {19, 21, 24, 32, 255},
    {18, 23, 26, 31, 255},
    {18, 26, 28, 255, 255},
    {20, 25, 25, 28, 255},
    {18, 24, 34, 255, 255},
    {20, 22, 26, 34, 255},
    {3, 14, 26, 33, 255},
    {5, 13, 25, 32, 255},
    {8, 23, 30, 255, 255},
    {7, 10, 22, 32, 255},
    {6, 19, 27, 255, 255},
    {4, 16, 19, 29, 255},
    {21, 21, 24, 32, 255},
    {19, 23, 31, 31, 255},
    {21, 26, 255, 255, 255},
    {23, 25, 27, 28, 255},
    {22, 24, 255, 255, 255},
    {21, 22, 33, 34, 255},
};
// USQR: per output, the square coefficients Q[2 s + k] (times 3, then -/+ 2 x_o) it adds and subtracts
constexpr int USQR_POS = 3, USQR_NEG = 4;
__device__ const uint8_t USQR_ADD[12][3] = {
    {0, 6, 255},
    {0, 1, 7},
    {2, 8, 255},
    {2, 3, 9},
    {4, 10, 255},
    {4, 5, 11},
    {5, 11, 16},
    {16, 17, 255},
    {12, 255, 255},
    {13, 255, 255},
    {14, 255, 255},
    {15, 255, 255},
};
__device__ const uint8_t USQR_SUB[12][4] = {
    {1, 255, 255, 255},
    {255, 255, 255, 255},
    {3, 255, 255, 255},
    {255, 255, 255, 255},
    {5, 255, 255, 255},
    {255, 255, 255, 255},
    {4, 10, 17, 255},
    {4, 5, 10, 11},
    {0, 6, 255, 255},
    {1, 7, 255, 255},
    {2, 8, 255, 255},
    {3, 9, 255, 255},
};
// CYCMUL: per output, the Fp2 product components W[2 pp + g] it adds and subtracts
constexpr int CYCMUL_POS = 11, CYCMUL_NEG = 11;
__device__ const uint8_t CYCMUL_ADD[12][11] = {
    {0, 3, 5, 8, 13, 14, 17, 22, 255, 255, 255},
    {1, 8, 9, 14, 15, 22, 23, 255, 255, 255, 255},
    {4, 6, 12, 15, 17, 20, 255, 255, 255, 255, 255},
    {4, 5, 7, 13, 20, 21, 255, 255, 255, 255, 255},
    {2, 10, 16, 18, 255, 255, 255, 255, 255, 255, 255},
    {3, 11, 16, 17, 19, 255, 255, 255, 255, 255, 255},
    {2, 4, 9, 14, 16, 21, 24, 27, 29, 32, 255},
    {2, 3, 4, 5, 14, 15, 16, 17, 25, 32, 33},
    {0, 2, 5, 12, 14, 17, 28, 30, 255, 255, 255},
    {1, 3, 13, 15, 28, 29, 31, 255, 255, 255, 255},
    {0, 4, 12, 16, 26, 34, 255, 255, 255, 255, 255},
    {1, 5, 13, 17, 27, 35, 255, 255, 255, 255, 255},
};
__device__ const uint8_t CYCMUL_SUB[12][11] = {
    {2, 4, 9, 12, 15, 16, 23, 255, 255, 255, 255},
    {2, 3, 4, 5, 12, 13, 16, 17, 255, 255, 255},
    {0, 2, 5, 14, 16, 21, 255, 255, 255, 255, 255},
    {1, 3, 14, 15, 16, 17, 255, 255, 255, 255, 255},
    {0, 4, 12, 14, 17, 255, 255, 255, 255, 255, 255},
    {1, 5, 13, 15, 255, 255, 255, 255, 255, 255, 255},
    {0, 3, 5, 8, 12, 15, 17, 20, 26, 28, 33},
    {1, 8, 9, 13, 20, 21, 26, 27, 28, 29, 255},
    {4, 6, 16, 18, 24, 26, 29, 255, 255, 255, 255},
    {4, 5, 7, 16, 17, 19, 25, 27, 255, 255, 255},
    {2, 10, 14, 22, 24, 28, 255, 255, 255, 255, 255},
    {3, 11, 15, 23, 25, 29, 255, 255, 255, 255, 255},
};
// SPARSE: per output, the Fp products T[3 p + k] it adds and subtracts
constexpr int SPARSE_POS = 12, SPARSE_NEG = 11;
__device__ const uint8_t SPARSE_ADD[12][12] = {
    {0, 21, 21, 24, 24, 255, 255, 255, 255, 255, 255, 255},
    {2, 23, 26, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {3, 9, 9, 12, 12, 255, 255, 255, 255, 255, 255, 255},
    {5, 11, 14, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {6, 15, 18, 18, 255, 255, 255, 255, 255, 255, 255, 255},
    {8, 17, 20, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    {1, 11, 14, 27, 32, 35, 39, 39, 255, 255, 255, 255},
    {0, 1, 10, 10, 13, 13, 29, 31, 31, 34, 34, 41},
    {4, 16, 20, 28, 31, 33, 33, 36, 255, 255, 255, 255},
    {3, 4, 15, 16, 19, 19, 27, 28, 30, 31, 35, 38},
    {7, 22, 25, 28, 30, 34, 42, 255, 255, 255, 255, 255},
    {6, 7, 21, 22, 24, 25, 27, 28, 32, 33, 34, 44},
};
__device__ const uint8_t SPARSE_SUB[12][11] = {
    {1, 23, 26, 255, 255, 255, 255, 255, 255, 255, 255},
    {0, 1, 22, 22, 25, 25, 255, 255, 255, 255, 255},
    {4, 11, 14, 255, 255, 255, 255, 255, 255, 255, 255},
    {3, 4, 10, 10, 13, 13, 255, 255, 255, 255, 255},
    {7, 16, 20, 255, 255, 255, 255, 255, 255, 255, 255},
    {6, 7, 15, 16, 19, 19, 255, 255, 255, 255, 255},
    {0, 9, 9, 12, 12, 28, 30, 30, 33, 33, 41},
    {2, 11, 14, 27, 28, 32, 35, 40, 40, 255, 255},
    {3, 15, 18, 18, 27, 30, 35, 37, 255, 255, 255},
    {5, 17, 20, 29, 32, 34, 34, 36, 37, 255, 255},
    {6, 21, 24, 27, 31, 33, 43, 255, 255, 255, 255},
    {8, 23, 26, 29, 30, 31, 35, 42, 43, 255, 255},
};

// MUL3: per output, the Fp products T[18 k + 3 p + kk] (K8's rows in thirds) it adds and subtracts
constexpr int MUL3_POS = 6, MUL3_NEG = 6;
__device__ const uint8_t MUL3_ADD[36][6] = {
    {0, 12, 21, 33, 255, 255},
    {2, 7, 19, 25, 255, 255},
    {1, 6, 23, 30, 255, 255},
    {0, 4, 20, 25, 255, 255},
    {1, 15, 24, 255, 255, 255},
    {0, 6, 18, 22, 255, 255},
    {1, 6, 19, 24, 36, 48},
    {0, 8, 18, 26, 38, 43},
    {0, 10, 26, 40, 45, 255},
    {2, 7, 20, 25, 36, 40},
    {0, 16, 24, 39, 255, 255},
    {2, 8, 20, 26, 36, 42},
    {5, 12, 21, 33, 255, 255},
    {4, 7, 19, 25, 255, 255},
    {4, 9, 26, 255, 255, 255},
    {1, 8, 22, 25, 255, 255},
    {3, 19, 24, 255, 255, 255},
    {1, 7, 19, 26, 255, 255},
    {3, 6, 21, 24, 41, 48},
    {1, 13, 19, 31, 40, 43},
    {3, 18, 28, 42, 255, 255},
    {5, 9, 23, 27, 37, 44},
    {4, 18, 34, 43, 255, 255},
    {3, 15, 21, 33, 37, 43},
    {8, 20, 26, 255, 255, 255},
    {4, 14, 23, 35, 255, 255},
    {6, 18, 30, 255, 255, 255},
    {3, 11, 22, 32, 255, 255},
    {7, 22, 27, 255, 255, 255},
    {5, 17, 21, 29, 255, 255},
    {3, 14, 21, 32, 44, 255},
    {5, 13, 23, 31, 40, 50},
    {8, 21, 37, 42, 255, 255},
    {7, 10, 25, 28, 39, 47},
    {6, 22, 37, 51, 255, 255},
    {4, 16, 22, 34, 41, 53},
};
__device__ const uint8_t MUL3_SUB[36][6] = {
    {1, 6, 18, 24, 255, 255},
    {0, 8, 20, 26, 255, 255},
    {0, 10, 21, 32, 255, 255},
    {2, 7, 18, 26, 255, 255},
    {0, 16, 26, 255, 255, 255},
    {2, 8, 20, 25, 255, 255},
    {0, 12, 23, 30, 39, 50},
    {2, 7, 20, 25, 36, 44},
    {1, 6, 22, 27, 44, 255},
    {0, 4, 18, 22, 38, 43},
    {1, 15, 25, 40, 255, 255},
    {0, 6, 18, 24, 38, 44},
    {3, 6, 18, 24, 255, 255},
    {1, 13, 22, 34, 255, 255},
    {3, 19, 24, 255, 255, 255},
    {5, 9, 19, 31, 255, 255},
    {4, 18, 28, 255, 255, 255},
    {3, 15, 23, 27, 255, 255},
    {5, 12, 26, 37, 42, 255},
    {4, 7, 22, 25, 37, 49},
    {4, 9, 24, 36, 46, 255},
    {1, 8, 19, 26, 41, 45},
    {3, 19, 33, 42, 255, 255},
    {1, 7, 19, 25, 39, 51},
    {3, 14, 23, 35, 255, 255},
    {5, 13, 22, 34, 255, 255},
    {8, 21, 24, 255, 255, 255},
    {7, 10, 23, 31, 255, 255},
    {6, 21, 255, 255, 255, 255},
    {4, 16, 25, 28, 255, 255},
    {8, 18, 30, 39, 42, 255},
    {4, 14, 22, 32, 41, 49},
    {6, 19, 24, 39, 255, 255},
    {3, 11, 21, 29, 43, 46},
    {7, 21, 36, 52, 255, 255},
    {5, 17, 23, 35, 40, 52},
};

// ------------------------------------- K10, the power and K11: shared pieces

// The coefficients (l1, l2) of pair j = 0, 1, 2 of an Fp6 Karatsuba:
// (0, 1), (1, 2), (0, 2).
__device__ __forceinline__ int pair_lo(int j) { return j == 1 ? 1 : 0; }
__device__ __forceinline__ int pair_hi(int j) { return j == 0 ? 1 : 2; }

// r = the sum of the n <= 4 shared Fp values at x + off[t], reduced.
__device__ __forceinline__ void sum_at(uint32_t* r, const uint32_t* x, const int* off, int n) {
  ld_fp(r, x + off[0]);
#pragma unroll
  for (int t = 1; t < 4; ++t)
    if (t < n) add_sh(r, x + off[t]);
}

// Component f of pair p's pre-sum of an Fp6 value in shared memory at x,
// or with nh = 2 of the sum of the two at x and x + F6: the pair's one or
// two coefficients of each, added (up to 4 values, fp6_presum's sum).
__device__ __forceinline__ void pair_sum(uint32_t* r, const uint32_t* x, int nh, int p, int f) {
  const int ja = p < 3 ? p : pair_lo(p - 3), jb = p < 3 ? p : pair_hi(p - 3);
  const int off[4] = {ja * F2 + f * NL, (nh == 1 ? jb * F2 : F6 + ja * F2) + f * NL,
                      jb * F2 + f * NL, F6 + jb * F2 + f * NL};
  sum_at(r, x, off, nh * (p < 3 ? 1 : 2));
}

// r = sum of v[a[t] d] - sum of v[b[t] d] over a row of a combine table (a
// and b padded with 255): the same instructions on every thread whatever
// its row, the two sums in two independent chains.
template <int NA, int NB>
__device__ __forceinline__ void signed_sum(uint32_t* r, const uint32_t* v, int d, const uint8_t* a,
                                           const uint8_t* b) {
  uint32_t s[NL], y[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = s[k] = 0;
#pragma unroll
  for (int t = 0; t < (NA > NB ? NA : NB); ++t) {
    if (t < NA && a[t] != 255) {
      ld_fp(y, v + a[t] * d);
      add_mod<NL>(r, r, y);
    }
    if (t < NB && b[t] != 255) {
      ld_fp(y, v + b[t] * d);
      add_mod<NL>(s, s, y);
    }
  }
  sub_mod<NL>(r, r, s);
}

// ------------------------------------------------------------- K9

// Layout at R instances per block (limbs): operand X (R rows of S12), the
// combine writing over it at R = 8; the pre-sums P[k][i] (k = 0: a + b,
// 1: a + v b; R rows of S6 each); the 36 products T[q][i]; at R < 8 the
// combine's 36 partial sums W[w][i].  SPLIT: the combine is spread over all
// 36 threads of an instance (R < 8, below 1,024 rows, where a block's
// latency is the launch's time), or each of 12 threads makes a whole
// output (R = 8, two blocks per SM busy: the fewest instructions).
template <int R>
struct K9 {
  static constexpr int BLOCK = 36 * R;       // one thread per Fp product
  static constexpr bool SPLIT = R < 8;
  static constexpr int X = 0, P = R * S12, T = P + 2 * R * S6, W = T + 36 * R * NL;
  static constexpr int SMEM = SPLIT ? W + 36 * R * NL : W;
  static constexpr int PHASES = 4;
};

// Pre-sum e = 6 k + c of the Fp12 row g in device memory, formed in the
// stage phase by its own thread: component c = 2 j + f of a + b (k = 0) or
// of a + v b (k = 1), v b = (xi b2, b0, b1), reduced.  The b term is b_j,
// b_(j-1) or xi b2's component b2_f -/+ b2_(1-f), selected, so a warp's
// lanes run the same instructions.
__device__ __forceinline__ void sqr_presum(uint32_t* r, const uint32_t* g, int e) {
  const int k = e / 6, c = e % 6, j = c / 2, f = c % 2;
  const int jb = k == 0 ? j : (j > 0 ? j - 1 : 2);
  uint32_t y[NL], z[NL], s[NL];
  ld_fp(r, g + c * NL);                     // a_j, component f
  ld_fp(y, g + F6 + jb * F2 + f * NL);
  ld_fp(z, g + F6 + 2 * F2 + (1 - f) * NL);
  add_mod<NL>(s, y, z);                     // xi b2: b2_1 + b2_0 (f = 1)
  sub_mod<NL>(z, y, z);                     //        b2_0 - b2_1 (f = 0)
  const bool xi = k == 1 && j == 0;
#pragma unroll
  for (int t = 0; t < NL; ++t) y[t] = xi ? (f ? s[t] : z[t]) : y[t];
  add_mod<NL>(r, r, y);
}

// The combine phase of the Fp12 square over the 36 products t of each
// instance: at R = 8 output coefficient o of instance i (thread o R + i,
// o < 12), the row o of SQR (t - m - v m, or 2 m), written over the
// instance's row of x; at R < 8 the partial sum w of instance i (thread
// w R + i, every thread), the row w of SQR3 (a third of the terms of
// output w % 12), written to w's slot of the partial sums, which the store
// phase adds up.
template <int R>
__device__ __forceinline__ void sqr_combine(uint32_t* x, uint32_t* w, const uint32_t* t, int rows,
                                            int tid) {
  const int o = tid / R, i = tid % R;
  if (i >= rows || (!K9<R>::SPLIT && o >= 12)) return;
  uint32_t r[NL];
  if (K9<R>::SPLIT) {
    signed_sum<SQR3_POS, SQR3_NEG>(r, t + i * NL, R * NL, SQR3_ADD[o], SQR3_SUB[o]);
    st_fp(w + tid * NL, r);
  } else {
    signed_sum<SQR_POS, SQR_NEG>(r, t + i * NL, R * NL, SQR_ADD[o], SQR_SUB[o]);
    st_fp(x + i * S12 + o * NL, r);
  }
}

// Phase `ph` of K9 for thread `tid` of block `blk`: stage (with the
// pre-sums), product, combine, store (at R < 8 thread q R + i, q < 12, adds
// output q's three partial sums and writes it to device memory).
template <int R>
__device__ __forceinline__ void fp12_sqr_phase(int ph, uint32_t* sm, const uint32_t* x,
                                               uint32_t* out, int64_t n, int64_t blk, int tid) {
  using L = K9<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  const int q = tid / R, i = tid % R;
  if (ph == 0) {                            // stage; pre-sum q of instance i
    stage_in<F12, S12, L::BLOCK>(sm + L::X, x + row0 * F12, rows, tid);
    if (q < 12 && i < rows) {
      uint32_t r[NL];
      sqr_presum(r, x + (row0 + i) * F12, q);
      st_fp(sm + L::P + (q / 6 * R + i) * S6 + q % 6 * NL, r);
    }
  } else if (ph == 1) {                     // product q = 18 k + q6 of instance i
    if (i < rows) {                         // k = 0: (a + b)(a + v b), 1: a b
      const uint32_t* xs = q < 18 ? sm + L::P + i * S6 : sm + L::X + i * S12;
      const uint32_t* ys = q < 18 ? sm + L::P + (R + i) * S6 : sm + L::X + i * S12 + F6;
      uint32_t a[NL], b[NL];
      fp6_operand(a, xs, q % 18);
      fp6_operand(b, ys, q % 18);
      mont_mul<NL>(a, a, b);
      st_fp(sm + L::T + tid * NL, a);
    }
  } else if (ph == 2) {
    sqr_combine<R>(sm + L::X, sm + L::W, sm + L::T, rows, tid);
  } else if (!L::SPLIT) {                   // store
    stage_out<F12, S12, L::BLOCK>(out + row0 * F12, sm + L::X, rows, tid);
  } else if (q < 12 && i < rows) {
    uint32_t r[NL];
    ld_fp(r, sm + L::W + tid * NL);
    add_sh(r, sm + L::W + (12 * R + tid) * NL);
    add_sh(r, sm + L::W + (24 * R + tid) * NL);
    st_fp(out + (row0 + i) * F12 + q * NL, r);
  }
}

template <int R>
__global__ void __launch_bounds__(K9<R>::BLOCK, 2)
fp12_sqr_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K9<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K9<R>::PHASES; ++ph) {
    fp12_sqr_phase<R>(ph, sm, x, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K9<R>::PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------ K10

// Layout of the single-step K10 at R instances per block (limbs): operand
// X (R rows of S12), the combine writing over it; the squares'
// coefficients Q[2 s + k][i].
template <int R>
struct K10 {
  static constexpr int BLOCK = 18 * R;       // one thread per Fp product
  static constexpr int X = 0, Q = R * S12;
  static constexpr int SMEM = Q + 18 * R * NL;
  static constexpr int PHASES = 4;
};

// Offsets in an Fp12 row of the Granger-Scott pair (X_j, Y_j): (b1, a0),
// (a2, b0), (b2, a1).
__device__ __forceinline__ int gs_x(int j) { return j == 1 ? 2 * F2 : F6 + (j / 2 + 1) * F2; }
__device__ __forceinline__ int gs_y(int j) { return j == 0 ? 0 : (j == 1 ? F6 : F2); }

// The product phase of the cyclotomic square of the Fp12 rows x (R rows of
// S12) into q: thread tid = qq R + i computes coefficient qq % 2 of square
// s = qq / 2 = 3 g + j of instance i, X_j^2 (g = 0), Y_j^2 (1) or
// (X_j + Y_j)^2 (2), the sum formed here; both coefficients' operands
// are formed and one selected, so a warp's threads stay on one path.
template <int R>
__device__ __forceinline__ void usqr_product(const uint32_t* x, uint32_t* q, int rows, int tid) {
  const int qq = tid / R, i = tid % R, s = qq / 2, j = s % 3;
  if (i >= rows) return;
  const uint32_t* a = x + i * S12;
  const uint32_t* z = a + (s < 3 || s >= 6 ? gs_x(j) : gs_y(j));
  uint32_t z0[NL], z1[NL], u[NL], v[NL], w[NL];
  ld_fp(z0, z);
  ld_fp(z1, z + NL);
  if (s >= 6) {                             // X_j + Y_j
    add_sh(z0, a + gs_y(j));
    add_sh(z1, a + gs_y(j) + NL);
  }
  add_raw<NL>(u, z0, z1);                   // coefficient 0: (z0 + z1)(z0 - z1)
  sub_mod<NL>(v, z0, z1);
  add_raw<NL>(w, z1, z1);                   // coefficient 1: z0 (z1 + z1)
  const bool odd = qq & 1;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    u[k] = odd ? z0[k] : u[k];
    v[k] = odd ? w[k] : v[k];
  }
  mont_mul<NL>(u, u, v);
  st_fp(q + tid * NL, u);
}

// The combine phase of the cyclotomic square: output coefficient o of
// instance i, 3 u_o -/+ 2 x_o with u_o the row o of USQR over the products
// q, written over x_o.
template <int R>
__device__ __forceinline__ void usqr_combine(uint32_t* x, const uint32_t* q, int rows, int tid) {
  const int o = tid / R, i = tid % R;
  if (o >= 12 || i >= rows) return;
  uint32_t u[NL], r[NL], d[NL];
  signed_sum<USQR_POS, USQR_NEG>(u, q + i * NL, R * NL, USQR_ADD[o], USQR_SUB[o]);
  add_mod<NL>(r, u, u);
  add_mod<NL>(r, r, u);
  uint32_t* xo = x + i * S12 + o * NL;
  ld_fp(d, xo);
  add_mod<NL>(d, d, d);
  add_mod<NL>(u, r, d);                     // 3 u + 2 x (o >= 6)
  sub_mod<NL>(r, r, d);                     // 3 u - 2 x (o < 6)
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = o < 6 ? r[k] : u[k];
  st_fp(xo, r);
}

// Phase `ph` of K10 for thread `tid` of block `blk`: stage, product,
// combine, store.
template <int R>
__device__ __forceinline__ void fp12_usqr_phase(int ph, uint32_t* sm, const uint32_t* x,
                                                uint32_t* out, int64_t n, int64_t blk, int tid) {
  using L = K10<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  if (ph == 0) stage_in<F12, S12, L::BLOCK>(sm + L::X, x + row0 * F12, rows, tid);
  else if (ph == 1) usqr_product<R>(sm + L::X, sm + L::Q, rows, tid);
  else if (ph == 2) usqr_combine<R>(sm + L::X, sm + L::Q, rows, tid);
  else stage_out<F12, S12, L::BLOCK>(out + row0 * F12, sm + L::X, rows, tid);
}

template <int R>
__global__ void __launch_bounds__(K10<R>::BLOCK, 2)
fp12_usqr_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K10<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K10<R>::PHASES; ++ph) {
    fp12_usqr_phase<R>(ph, sm, x, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K10<R>::PHASES) __syncthreads();
  }
}

// ------------------------------------- K8 and the power's product step

// Component e < 6 of the half sum c + d of the R Fp12 rows at g in device
// memory, instance i = tid % R with e = tid / R, reduced, into the rows of
// S6 at ys.
template <int R>
__device__ __forceinline__ void stage_half_sum(uint32_t* ys, const uint32_t* g, int rows, int tid) {
  const int e = tid / R, i = tid % R;
  if (e < 6 && i < rows) {
    const uint32_t* c = g + (int64_t)i * F12 + e * NL;
    uint32_t r[NL], s[NL];
    load<NL>(r, c);
    load<NL>(s, c + F6);
    add_mod<NL>(r, r, s);
    st_fp(ys + i * S6 + e * NL, r);
  }
}

// The product phase of the Fp12 product a y, for the R rows a and y (of
// S12) and y's half sums c + d at ys (rows of S6): thread pp R + i runs Fp2
// product p = pp % 6 of Fp6 product k = pp / 6 (a c, b d, (a + b)(c + d))
// of instance i, the three Fp products of its Karatsuba in registers (its
// pair sums formed here: a + b's from a's four coefficients), and writes
// the product's two components to w[2 pp + g][i].
template <int R>
__device__ __forceinline__ void mul_product(const uint32_t* a, const uint32_t* y,
                                            const uint32_t* ys, uint32_t* w, int rows, int tid) {
  const int pp = tid / R, i = tid % R, k = pp / 6, p = pp % 6;
  if (i >= rows) return;
  const uint32_t* l = a + i * S12 + (k == 1 ? F6 : 0);
  const uint32_t* r = k < 2 ? y + i * S12 + k * F6 : ys + i * S6;
  uint32_t l0[NL], l1[NL], r0[NL], r1[NL], t0[NL], t1[NL];
  pair_sum(l0, l, k == 2 ? 2 : 1, p, 0);
  pair_sum(l1, l, k == 2 ? 2 : 1, p, 1);
  pair_sum(r0, r, 1, p, 0);
  pair_sum(r1, r, 1, p, 1);
  mont_mul<NL>(t0, l0, r0);                 // l0 r0, l1 r1, (l0 + l1)(r0 + r1)
  mont_mul<NL>(t1, l1, r1);
  add_raw<NL>(l0, l0, l1);
  add_raw<NL>(r0, r0, r1);
  mont_mul<NL>(l1, l0, r0);
  uint32_t* o = w + (2 * pp * R + i) * NL;
  sub_mod<NL>(r1, t0, t1);                  // re = t0 - t1
  st_fp(o, r1);
  add_mod<NL>(t0, t0, t1);                  // im = t2 - t0 - t1
  sub_mod<NL>(l1, l1, t0);
  st_fp(o + R * NL, l1);
}

// The combine phase of the Fp12 product: output coefficient o of instance
// i, the row o of CYCMUL over the Fp2 products at w (the Fp6 and Fp12
// combines in one sum), written to dst + i stride + o NL, in shared or in
// device memory.
template <int R>
__device__ __forceinline__ void mul_combine(const uint32_t* w, uint32_t* dst, int stride, int rows,
                                            int tid) {
  const int o = tid / R, i = tid % R;
  if (o >= 12 || i >= rows) return;
  uint32_t r[NL];
  signed_sum<CYCMUL_POS, CYCMUL_NEG>(r, w + i * NL, R * NL, CYCMUL_ADD[o], CYCMUL_SUB[o]);
  st_fp(dst + i * stride + o * NL, r);
}

// K8 runs one of two layouts, each picked where it measured fastest.
// Below K8_STEP_ROWS rows, K8<R>: 54 threads per instance, one Fp product
// each, the half sums a + b and c + d formed in the stage from device
// memory; at R < 8 (SPLIT, below 1,024 rows, where a block's latency is
// the launch's time) each output is three partial sums, rows of MUL3 over
// the 54 products on 36 threads, which the store phase adds (4 phases); at
// R = 8 the Fp2, Fp6 and Fp12 combines each have a phase, the fewest
// instructions (5 phases).  From K8_STEP_ROWS rows on, where K8<8> takes
// two waves, K8Step<8>: the power's product step, 18 threads per instance
// with three Fp products each (3 phases).
constexpr int64_t K8_STEP_ROWS = 4096;

// Layout of K8 at R instances per block (limbs): the operands X and Y (R
// rows of S12 each), the half sums P[k][i] (k = 0: a + b, 1: c + d; R rows
// of S6 each), the 54 products T[q][i]; over X, Y and P (dead after the
// product phase) the partial sums or the Fp2 products V[w][i], over T
// (dead after the Fp2 combine) the Fp6 products U[o][i].
template <int R>
struct K8 {
  static constexpr int BLOCK = 54 * R;       // one thread per Fp product
  static constexpr bool SPLIT = R < 8;
  static constexpr int D = R * NL;
  static constexpr int X = 0, Y = R * S12, P = 2 * R * S12, T = P + 2 * R * S6;
  static constexpr int V = 0, U = T;
  static constexpr int SMEM = T + 54 * D;
  static constexpr int PHASES = SPLIT ? 4 : 5;
};
static_assert(36 * K8<8>::D <= K8<8>::T, "36 partial sums or Fp2 values fit below T");

// Phase `ph` of K8 for thread `tid` of block `blk`: stage (with the half
// sums), product, then at R < 8 the partial sums and a store that adds
// them, at R = 8 the Fp2, Fp6 and Fp12 combines; the outputs go to device
// memory.
template <int R>
__device__ __forceinline__ void fp12_mul_phase(int ph, uint32_t* sm, const uint32_t* x,
                                               const uint32_t* y, uint32_t* out, int64_t n,
                                               int64_t blk, int tid) {
  using L = K8<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  const int q = tid / R, i = tid % R;
  if (ph == 0) {                            // stage; half sum q of instance i
    stage_in<F12, S12, L::BLOCK>(sm + L::X, x + row0 * F12, rows, tid);
    stage_in<F12, S12, L::BLOCK>(sm + L::Y, y + row0 * F12, rows, tid);
    if (q < 12 && i < rows) {               // a + b (q < 6), c + d
      const uint32_t* c = (q < 6 ? x : y) + (row0 + i) * F12 + q % 6 * NL;
      uint32_t r[NL], s[NL];
      load<NL>(r, c);
      load<NL>(s, c + F6);
      add_mod<NL>(r, r, s);
      st_fp(sm + L::P + (q / 6 * R + i) * S6 + q % 6 * NL, r);
    }
    return;
  }
  if (i >= rows) return;
  uint32_t r[NL];
  if (ph == 1) {                            // product q = 18 k + q6 of instance i
    const int k = q / 18;                   // k = 0: a c, 1: b d, 2: (a + b)(c + d)
    const uint32_t* xs = k < 2 ? sm + L::X + i * S12 + k * F6 : sm + L::P + i * S6;
    const uint32_t* ys = k < 2 ? sm + L::Y + i * S12 + k * F6 : sm + L::P + (R + i) * S6;
    uint32_t b[NL];
    fp6_operand(r, xs, q % 18);
    fp6_operand(b, ys, q % 18);
    mont_mul<NL>(r, r, b);
    st_fp(sm + L::T + tid * NL, r);
  } else if (L::SPLIT) {
    if (ph == 2 && q < 36) {                // partial sum q of instance i
      signed_sum<MUL3_POS, MUL3_NEG>(r, sm + L::T + i * NL, L::D, MUL3_ADD[q], MUL3_SUB[q]);
      st_fp(sm + L::V + tid * NL, r);
    } else if (ph == 3 && q < 12) {         // output q: its three partial sums
      ld_fp(r, sm + L::V + tid * NL);
      add_sh(r, sm + L::V + (12 * R + tid) * NL);
      add_sh(r, sm + L::V + (24 * R + tid) * NL);
      st_fp(out + (row0 + i) * F12 + q * NL, r);
    }
  } else if (ph == 2) {                     // Fp2 coefficient q of instance i
    if (q < 36) {                           // its Fp products are 3 (q / 2) + 0..2
      fp2_coeff(r, sm + L::T + (3 * (q / 2) * R + i) * NL, L::D, q % 2);
      st_fp(sm + L::V + tid * NL, r);
    }
  } else if (ph == 3) {                     // coefficient q = 6 k + c of Fp6 product k
    if (q < 18) {
      fp6_coeff(r, sm + L::V + (12 * (q / 6) * R + i) * NL, L::D, q % 6 / 2, q % 2);
      st_fp(sm + L::U + tid * NL, r);
    }
  } else if (q < 12) {                      // output coefficient q
    fp12_kara_coeff(r, [=](int k, int c, int f) {
      return sm + L::U + ((6 * k + 2 * c + f) * R + i) * NL; }, q);
    st_fp(out + (row0 + i) * F12 + q * NL, r);
  }
}

template <int R>
__global__ void __launch_bounds__(K8<R>::BLOCK, 2)
fp12_mul_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K8<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K8<R>::PHASES; ++ph) {
    fp12_mul_phase<R>(ph, sm, x, y, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K8<R>::PHASES) __syncthreads();
  }
}

// Layout of K8Step at R instances per block (limbs): X and Y (R rows of
// S12 each), y's half sums c + d YS (R rows of S6), the 18 Fp2 products
// W[2 pp + g][i].
template <int R>
struct K8Step {
  static constexpr int BLOCK = 18 * R;       // one thread per Fp2 product
  static constexpr int X = 0, Y = R * S12, YS = 2 * R * S12, W = YS + R * S6;
  static constexpr int SMEM = W + 36 * R * NL;
  static constexpr int PHASES = 3;
};

// Phase `ph` of K8Step for thread `tid` of block `blk`: stage (with y's
// half sums), product, combine (written to device memory).
template <int R>
__device__ __forceinline__ void fp12_mul_step_phase(int ph, uint32_t* sm, const uint32_t* x,
                                                    const uint32_t* y, uint32_t* out, int64_t n,
                                                    int64_t blk, int tid) {
  using L = K8Step<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  if (ph == 0) {
    stage_in<F12, S12, L::BLOCK>(sm + L::X, x + row0 * F12, rows, tid);
    stage_in<F12, S12, L::BLOCK>(sm + L::Y, y + row0 * F12, rows, tid);
    stage_half_sum<R>(sm + L::YS, y + row0 * F12, rows, tid);
  } else if (ph == 1) {
    mul_product<R>(sm + L::X, sm + L::Y, sm + L::YS, sm + L::W, rows, tid);
  } else {
    mul_combine<R>(sm + L::W, out + row0 * F12, F12, rows, tid);
  }
}

template <int R>
__global__ void __launch_bounds__(K8Step<R>::BLOCK, 4)
fp12_mul_step_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                     uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K8Step<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K8Step<R>::PHASES; ++ph) {
    fp12_mul_step_phase<R>(ph, sm, x, y, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K8Step<R>::PHASES) __syncthreads();
  }
}

// ---------------------------------------- the cyclotomic power x^e

// Layout at R instances per block (limbs): x's rows X and the accumulator
// A (R rows of S12 each), x's half sum c + d XS (R rows of S6), and Q:
// the 18 products of a square, or the 18 Fp2 products W[2 pp + g][i] of a
// product step (pp = 6 k + p: pair p of Fp6 product k).
template <int R>
struct CycPow {
  static constexpr int BLOCK = 18 * R;       // K10's threads
  static constexpr int X = 0, A = R * S12, XS = 2 * R * S12, Q = XS + R * S6;
  static constexpr int SMEM = Q + 36 * R * NL;
};

// The power's phases.
enum { CP_STAGE, CP_SQR_PRODUCT, CP_SQR_COMBINE, CP_MUL_PRODUCT, CP_MUL_COMBINE, CP_STORE };

// Calls run(phase) for each phase of x^e in order: the stage, a square
// (two phases) at each bit after the top one and a product by x (two
// phases) after it where the bit is set, the store.  The kernel puts a
// barrier after each; the host harness runs the same sequence.
template <class Run>
__device__ __forceinline__ void cyc_pow_schedule(const Exponent& e, Run&& run) {
  run(CP_STAGE);
#pragma unroll 1
  for (int k = e.bits - 2; k >= 0; --k) {
    run(CP_SQR_PRODUCT);
    run(CP_SQR_COMBINE);
    if (exp_bit(e, k)) {
      run(CP_MUL_PRODUCT);
      run(CP_MUL_COMBINE);
    }
  }
  run(CP_STORE);
}

// Phase `ph` of the power for thread `tid` of block `blk`.
template <int R>
__device__ __forceinline__ void fp12_cyc_pow_phase(int ph, uint32_t* sm, const uint32_t* x,
                                                   uint32_t* out, int64_t n, int64_t blk,
                                                   int tid) {
  using L = CycPow<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  if (ph == CP_STAGE) {                     // X = A = x; XS = c + d from device memory
    stage_in<F12, S12, L::BLOCK>(sm + L::X, x + row0 * F12, rows, tid);
    stage_in<F12, S12, L::BLOCK>(sm + L::A, x + row0 * F12, rows, tid);
    stage_half_sum<R>(sm + L::XS, x + row0 * F12, rows, tid);
  } else if (ph == CP_SQR_PRODUCT) {
    usqr_product<R>(sm + L::A, sm + L::Q, rows, tid);
  } else if (ph == CP_SQR_COMBINE) {
    usqr_combine<R>(sm + L::A, sm + L::Q, rows, tid);
  } else if (ph == CP_MUL_PRODUCT) {        // the product A x
    mul_product<R>(sm + L::A, sm + L::X, sm + L::XS, sm + L::Q, rows, tid);
  } else if (ph == CP_MUL_COMBINE) {        // written over A
    mul_combine<R>(sm + L::Q, sm + L::A, S12, rows, tid);
  } else {                                  // store
    stage_out<F12, S12, L::BLOCK>(out + row0 * F12, sm + L::A, rows, tid);
  }
}

// Runs one phase of the power and a barrier (the schedule's callback).
template <int R>
struct CycPowStep {
  uint32_t* sm;
  const uint32_t* x;
  uint32_t* out;
  int64_t n;
  __device__ __forceinline__ void operator()(int ph) {
    fp12_cyc_pow_phase<R>(ph, sm, x, out, n, blockIdx.x, threadIdx.x);
    __syncthreads();
  }
};

template <int R>
__global__ void __launch_bounds__(CycPow<R>::BLOCK, 2)
fp12_cyc_pow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                    const __grid_constant__ Exponent e, int64_t n) {
  __shared__ __align__(16) uint32_t sm[CycPow<R>::SMEM];
  CycPowStep<R> step{sm, x, out, n};
  cyc_pow_schedule(e, step);
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

// Layout at R instances per block (limbs): the accumulator F (R rows of
// S12; f staged there, each combine writing over it), the line ring
// LN[s % 2] (R rows of S6 per slot), the products T[q][i].
template <int R>
struct K11 {
  static constexpr int BLOCK = 45 * R;       // one thread per Fp product
  static constexpr int F = 0, LN = R * S12, T = LN + 2 * R * S6;
  static constexpr int SMEM = T + 45 * R * NL;
};

// Component g of K11's left operand `lc` from the accumulator row a: a
// coefficient of f (codes 0-5), a_j + b_j (6-8) or a_l1 + b_l1 + a_l2 +
// b_l2 (9-11), reduced.
__device__ __forceinline__ void sparse_lhs(uint32_t* r, const uint32_t* a, int lc, int g) {
  const int ja = lc < 6 ? lc % 3 : (lc < 9 ? lc - 6 : pair_lo(lc - 9));
  const int jb = lc < 9 ? ja : pair_hi(lc - 9);
  const int off[4] = {(lc < 6 ? lc / 3 * F6 : 0) + ja * F2 + g * NL, F6 + ja * F2 + g * NL,
                      jb * F2 + g * NL, F6 + jb * F2 + g * NL};
  sum_at(r, a, off, lc < 6 ? 1 : (lc < 9 ? 2 : 4));
}

// Component g of K11's right operand `rc` from the line row c: c0, c3, c5
// (codes 0-2) or c_l1 + c_l2 (3-5), reduced.
__device__ __forceinline__ void sparse_rhs(uint32_t* r, const uint32_t* c, int rc, int g) {
  const int off[4] = {(rc < 3 ? rc : pair_lo(rc - 3)) * F2 + g * NL,
                      pair_hi(rc < 3 ? 0 : rc - 3) * F2 + g * NL, 0, 0};
  sum_at(r, c, off, rc < 3 ? 1 : 2);
}

// The product phase of one line: thread tid = q R + i computes Fp product
// q = 3 p + kk of instance i (Karatsuba product kk of Fp2 product p), its
// operands formed here from the accumulator row fa and the line row ln:
// component kk of each (kk < 2), or the raw sum of both (kk = 2).
template <int R>
__device__ __forceinline__ void sparse_product(const uint32_t* fa, const uint32_t* ln, uint32_t* t,
                                               int rows, int tid) {
  const int q = tid / R, i = tid % R, p = q / 3, kk = q % 3;
  if (i >= rows) return;
  const uint32_t* a = fa + i * S12;
  const uint32_t* c = ln + i * S6;
  const int lc = K11_LHS[p], rc = K11_RHS[p];
  uint32_t x[NL], y[NL], z[NL];
  sparse_lhs(x, a, lc, kk == 1);
  sparse_rhs(y, c, rc, kk == 1);
  if (kk == 2) {
    sparse_lhs(z, a, lc, 1);
    add_raw<NL>(x, x, z);
    sparse_rhs(z, c, rc, 1);
    add_raw<NL>(y, y, z);
  }
  mont_mul<NL>(x, x, y);
  st_fp(t + tid * NL, x);
}

// The combine phase of one line: output coefficient o of instance i, the
// row o of SPARSE over its 45 products t (the Fp2, Fp6 and Fp12 combines
// in one), written over the accumulator row.
template <int R>
__device__ __forceinline__ void sparse_combine(const uint32_t* t, uint32_t* fa, int rows, int tid) {
  const int o = tid / R, i = tid % R;
  if (o >= 12 || i >= rows) return;
  uint32_t r[NL];
  signed_sum<SPARSE_POS, SPARSE_NEG>(r, t + i * NL, R * NL, SPARSE_ADD[o], SPARSE_SUB[o]);
  st_fp(fa + i * S12 + o * NL, r);
}

// Phase `ph` of K11 over k lines for thread `tid` of block `blk`: 0 stage
// (f and line 0), 2 s + 1 the product of line s (and the prefetch of line
// s + 1), 2 s + 2 its combine, 2 k + 1 store.
template <int R>
__device__ __forceinline__ void fp12_sparse_mul_phase(int ph, uint32_t* sm, const uint32_t* f,
                                                      const uint32_t* lines, uint32_t* out,
                                                      int k, int64_t n, int64_t blk, int tid) {
  using L = K11<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  uint32_t* slot = sm + L::LN + (ph / 2) % 2 * R * S6;          // line ph / 2's slot
  uint32_t* next = sm + L::LN + (ph / 2 + 1) % 2 * R * S6;
  if (ph == 0) {
    stage_in<F12, S12, L::BLOCK>(sm + L::F, f + row0 * F12, rows, tid);
    stage_in<F6, S6, L::BLOCK>(slot, lines + row0 * F6, rows, tid);
  } else if (ph == 2 * k + 1) {
    stage_out<F12, S12, L::BLOCK>(out + row0 * F12, sm + L::F, rows, tid);
  } else if (ph % 2 == 1) {
    const int s = ph / 2;
    if (s + 1 < k)
      stage_in_async<F6, S6, L::BLOCK>(next, lines + ((int64_t)(s + 1) * n + row0) * F6, rows,
                                       tid);
    sparse_product<R>(sm + L::F, slot, sm + L::T, rows, tid);
  } else {
    sparse_combine<R>(sm + L::T, sm + L::F, rows, tid);
    async_wait();                           // line s + 1 has landed before the barrier
  }
}

template <int R>
__global__ void __launch_bounds__(K11<R>::BLOCK, 2)
fp12_sparse_mul_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ lines,
                       uint32_t* __restrict__ out, int k, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K11<R>::SMEM];
  const int phases = 2 * k + 2;
#pragma unroll 1
  for (int ph = 0; ph < phases; ++ph) {
    fp12_sparse_mul_phase<R>(ph, sm, f, lines, out, k, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < phases) __syncthreads();
  }
}

extern "C" int fp12_mul(const void* x, const void* y, void* out, int64_t n, void* stream) {
  if (n >= K8_STEP_ROWS) {
    fp12_mul_step_kernel<8><<<grid_of(n, 8), K8Step<8>::BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  } else if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      fp12_mul_kernel<R><<<grid_of(n, R), K8<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int fp12_sqr(const void* x, void* out, int64_t n, void* stream) {
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      fp12_sqr_kernel<R><<<grid_of(n, R), K9<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int fp12_usqr(const void* x, void* out, int64_t n, void* stream) {
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      fp12_usqr_kernel<R><<<grid_of(n, R), K10<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

// x, out: (n, 2, 3, 2, 12) rows; words: the (bits + 31) / 32 host words of
// e >= 1; bits: e's bit length.  An e past the limit launches nothing and
// returns cudaErrorInvalidValue.
extern "C" int fp12_cyc_pow_fixed(const void* x, void* out, const uint32_t* words, int bits,
                                  int64_t n, void* stream) {
  Exponent e;
  if (!exponent_of(words, bits, &e)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      fp12_cyc_pow_kernel<R><<<grid_of(n, R), CycPow<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)x, (uint32_t*)out, e, n);
    });
  }
  return (int)cudaGetLastError();
}

// f, out: (n, 2, 3, 2, 12) rows; lines: (k, n, 3, 2, 12), k >= 1 (a
// smaller k launches nothing and returns cudaErrorInvalidValue).
extern "C" int fp12_sparse_mul(const void* f, const void* lines, void* out, int k, int64_t n,
                               void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      fp12_sparse_mul_kernel<R><<<grid_of(n, R), K11<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)f, (const uint32_t*)lines, (uint32_t*)out, k, n);
    });
  }
  return (int)cudaGetLastError();
}
