// K12, K13, K14: the G2 curve operations.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py that its
// program table marks [xla-only]: `prog_g2_add` (K12, `_rcb_add_generic`
// over Fp2), `prog_g2_madd` (K13, `_rcb_madd_generic`) and `prog_g2_dbl`
// (K14, `_rcb_dbl_generic`).  Mosaic's compile of such a program did not
// finish, so the TPU ran the composites `g2_add_c`, `g2_madd_c` and
// `g2_dbl_c`: three rounds of stacked K2 launches (3b' as a Montgomery
// product) with the combines in plain XLA.  Here each is one kernel.
//
// They are K5-K7's formulas (g1.cu) over Fp2, for the twist
// y^2 = x^3 + 4(1 + i): 3b' = 12(1 + i) = 12 xi is folded into an operand
// as 12 xi(x) = (12 (x0 - x1), 12 (x0 + x1)), mul12 of a sub_mod and of an
// add_mod, so each is two rounds of Fp2 products, 6 + 6 (K12), 5 + 6 (K13)
// and 4 + 4 (K14), each Fp2 product a Karatsuba of 3 Fp products (K14's
// two squares 2 each): 36, 33 and 22 Fp products per point.  Complete: no branch, the identity
// (0 : 1 : 0), P = Q and P = -Q included (the twist's group has no point
// of order two).  K13's affine operand must not be the identity.
//
// Bound on the card: per point K12 reads 576 bytes and writes 288 for 36
// products, K13 480 and 288 for 33, K14 288 and 288 for 22, at 588 32-bit
// multiply-adds per product: about 25 multiply-adds per byte, above the
// card's 5 (1.673e13 per s over 3.35e12 bytes per s), so the integer
// multiply rate bounds all three.  One thread per point would run 24 to
// 36 products as one dependent chain, and the paths launch these kernels
// at 1 to 4,096 rows: far from filling the card.
//
// Each kernel therefore gives each Fp product of a round its own thread, as
// K5-K11 do: 18 threads per K12 or K13 instance (K13's round 1 runs 15
// products and leaves 3 threads idle), 12 per K14 instance.  The first
// forms (8 instances per block) ran in six phases with a barrier between
// each two:
//   stage      the block's span of each operand into shared memory, 16
//              bytes per thread, consecutive threads on consecutive bytes;
//   product 1  Fp product q = 3 j + k of instance i, piece k of the Fp2
//              Karatsuba of round-1 product j, its two operands read from
//              the shared rows with the reduced pre-sums (X1 + Y1 and the
//              like) formed in the thread: a point (X, Y, Z) has the
//              layout of an Fp6 value, and K12's round 1 is the six pair
//              products of an Fp6 Karatsuba (tower.cuh `fp6_operand`);
//   combine 1  the round-2 operands, one Fp coefficient per item (12 per
//              instance), each item reading the round-1 Fp2 products it
//              needs from their three Fp products (tower.cuh `fp2_coeff`);
//   product 2  the round-2 Fp products, operands from combine 1
//              (fp381.cuh `kara_operand`; K12 and K13 through curve.cuh's
//              rcb_lhs/rcb_rhs, the same six products as K5 and K6);
//   combine 2  X3, Y3 and Z3, one Fp coefficient per item (6 per instance);
//   store      the outputs from shared memory, 16 bytes per thread.
// Each has since been redesigned: a block takes R = 8, 4 or 2 instances, a
// template parameter picked from n (fp381.cuh rows_per_block, as fp12.cu's
// K8-K11), and its last phase writes the outputs to device memory.
//
// K14 was redesigned after its first form (that layout: 8 instances per
// block, six phases, 24 Fp products, a combine 1 that branched four ways
// per lane) took 0.009626 ms at 1 row and 0.012249 at 2,048 on an H100 at
// 700 W, 8x its bound.  A block takes R = 8, 4 or 2 instances, a template
// parameter picked from n (fp381.cuh rows_per_block, as fp12.cu's K8-K11),
// and runs four phases: stage; round 1; round 2, whose thread forms its
// two Karatsuba operands in registers from the round-1 products
// (k14_round2, kara_pick: the same instructions on every lane, then a
// select); and the combine, which writes X3, Y3 and Z3 straight to device
// memory, 48 bytes per thread.  Round 1 takes Y^2 and Z^2 as complex
// squares and folds 3b' = 12 xi's 12 into a Z operand, so that t0 and t2
// are products or one add_mod of two, and the combine applies e8's 8 to
// two round-2 products: a first 4-phase form that built t2 = 12 xi z2,
// t0m and e8 on every round-2 lane (about 33 modular additions) took
// 0.015005 ms at 2,048 rows.  The combine runs on 6 of the 12 threads of
// an instance: an output is one Fp value, and splitting its sum over two
// threads would need another exchange and barrier.  __launch_bounds__
// asks for 5 blocks per SM (at most 136 registers; 128 and a 20-byte
// spill at R = 8): at 191 registers 3 blocks fit, and 4,096 rows (512
// blocks of 8) took two waves.  A form that folded each component into
// its operand as it came (12 fewer live values, an 8-byte spill) ran
// slower on the card at 2,048 and 4,096 rows.
//
// K12 was redesigned after its first form (8 instances per block, six
// phases, a combine 1 on 12 of an instance's 18 threads and a store phase)
// took 0.009660 ms at 1 row, 0.012613 at 2,048 and 0.542550 at 136,224
// (the G2 MSM's bucket sums; 32% of its bound there) on an H100 at 700 W.
// It takes R = 8, 4 or 2 instances per block as K14 does and runs five
// phases: stage; round 1; combine 1; round 2; combine 2, which writes X3,
// Y3 and Z3 to device memory.  Below 1,024 rows (R < 8), where a block's
// latency is the launch's time and a warp holds every kind of item of an
// instance, every lane runs the same instructions: round 1 forms its
// operands by selects (fp6_operand_sel), and combine 1 makes each of the
// 18 Karatsuba pieces (component 0, component 1, their sum) of the six
// round-2 operands on its own thread, straight from the round-1 Fp
// products (k12_piece: every operand as D +/- 12^z (A +/- B +/- C) over
// pieces), so round 2 multiplies two pieces as they lie.  At R = 8 the
// first form's combine 1 stays (12 components on 12 threads, the fewest
// instructions; round 2 forms the Karatsuba sums): in one call the select
// form took 0.0155 ms at 2,048 rows and 0.627 at 136,224 where the first
// form took 0.0125 and 0.538, and this layout takes 0.0124 and 0.481.  A
// 4-phase form whose round-2 threads formed both operand pieces in
// registers took 0.017189 at 2,048 and 0.781674 at 136,224.
//
// K13 was redesigned after its first form (8 instances per block, six
// phases, the outputs stored from an area of shared memory, 23,808 bytes a
// block) took 0.008534 ms at 2 rows, 0.009791 at 512, 0.011526 at 2,048
// and 0.015403 at 4,096 on an H100 at 700 W (4.8x its bound at 2,048).  It
// runs K12's five phases at R = 8, 4 or 2 (rcb2_phase holds round 2 and
// combine 2 for both) in one of two layouts picked from n.  Below
// K13_PIECES_ROWS = 2,048 rows (PIECES: up to one block of 8 per SM, so a
// block's latency is the launch's time) every lane runs the same
// instructions: round 1 runs six Fp2 products on all 18 threads, X1 y2 and
// Y1 x2 in place of m3 = (X1 + Y1)(x2 + y2), so that its operands are
// coordinates (kara_pick, no pre-sum) and t3 is one sum; combine 1 makes
// the 18 pieces (k13_piece: two pieces, mul12, three modular additions and
// selects; a coordinate's piece through any_piece's `staged` case).  From
// 2,048 rows (two or more blocks per SM) the first form's round 1 (15
// products) and 12-component combine 1 stay: there 3 more products cost
// more than the additions they save.  In one call, ms at 2 / 512 / 1,024 /
// 2,048 / 4,096 rows: these layouts 0.0070 / 0.0071 / 0.0085 / 0.0112 /
// 0.0153, the first form 0.0089 / 0.0096 / 0.0100 / 0.0116 / 0.0155.
// Dropped (another call): round 1 with m3 and t3 = m3 - t0 - t1 as pieces
// (16 modular additions a lane) 0.0073 / 0.0079 at 2 / 512 rows and, at
// R = 8, 0.0092 / 0.0124 / 0.0186 at 1,024 / 2,048 / 4,096; the six
// products with components at R = 8 0.0155 at 4,096; round 1's idle
// threads forming 12 xi Z1, and __launch_bounds__(.., 4), within the
// passes' spread.
//
// Each phase is a function of (phase, block, thread), and the __global__
// body only calls the phases with a barrier after each.  A projective row
// in shared memory is padded from 288 to 304 bytes and an affine row from
// 192 to 208, so that the 16-byte accesses of 8 consecutive threads fall in
// 32 distinct banks; products and coefficients take 48-byte slots,
// consecutive instances in consecutive slots.  No phase writes over data
// another phase still reads: shared memory per block is 18,688 bytes (K12
// at R = 8), 17,920 (K13 at R = 8 with PIECES, 15,616 without; each its
// round-2 products over the round-1 ones) and 10,880 (K14 at R = 8).  The
// last block of a ragged launch masks its copies, products and combines;
// every thread reaches every barrier.
//
// Bound proof of the product operands: each is a canonical coordinate,
// reduced pre-sum (add_mod) or combine, or the Fp2 Karatsuba's raw sum of
// two canonical values, below 2p, which mont_mul takes (fp381.cuh).  The
// combines are add_mod, sub_mod and mul12 of canonical values, so every
// output is canonical.  The TPU programs' 2^16 p offsets and `tighten`
// calls kept signed float digits in range and have no counterpart here.
//
// Layouts (int32 limbs, row-major, contiguous, 16-byte aligned): a
// projective point is (n, 3, 2, 12) [X, Y, Z], an affine point
// (n, 2, 2, 12) [x, y], each coordinate (re, im).  Inputs are canonical;
// outputs are canonical.

#include "fp381.cuh"
#include "tower.cuh"
#include "curve.cuh"

using namespace fp381;

constexpr int G2P = F6;             // limbs of a projective G2 point
constexpr int G2A = 2 * F2;         // limbs of an affine G2 point
constexpr int SA2 = G2A + 4;        // a padded shared affine row (208 bytes: 13 16-byte units)
constexpr int G2_D = 8 * NL;        // slot stride at R = 8 (k12_operand, k13_operand)

// ---------------------------------------------- pieces of K12-K14

// Component f of 12 xi x for x = (s0, s1) in registers: 12 (s0 - s1)
// (f = 0) or 12 (s0 + s1) (f = 1).
__device__ __forceinline__ void xi12(uint32_t* r, const uint32_t* s0, const uint32_t* s1, int f) {
  if (f == 0) sub_mod<NL>(r, s0, s1); else add_mod<NL>(r, s0, s1);
  mul12(r, r);
}

// Operand k of a Karatsuba product of the pair (x0, x1) of Fp values in
// registers: x0 (k = 0), x1 (k = 1) or the raw sum x0 + x1 (k = 2, < 2p),
// selected, so that threads with different k run the same instructions.
// r may alias x0 or x1.
__device__ __forceinline__ void kara_pick(uint32_t* r, const uint32_t* x0, const uint32_t* x1,
                                          int k) {
  uint32_t s[NL];
  add_raw<NL>(s, x0, x1);
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = k == 0 ? x0[j] : (k == 1 ? x1[j] : s[j]);
}

// Component g of Fp2 product m of a round, from its Fp products
// 3 m + k at t + (3 m + k) d.
__device__ __forceinline__ void fp2_of(uint32_t* r, const uint32_t* t, int m, int g) {
  fp2_coeff(r, t + 3 * m * G2_D, G2_D, g);
}

// Component g of Fp2 products m - a - b of a round.
__device__ __forceinline__ void fp2_diff(uint32_t* r, const uint32_t* t, int m, int a, int b,
                                         int g) {
  uint32_t s[NL];
  fp2_of(r, t, m, g);
  fp2_of(s, t, a, g);
  sub_mod<NL>(r, r, s);
  fp2_of(s, t, b, g);
  sub_mod<NL>(r, r, s);
}

// Round-2 operand j >= 3 of K12 and K13, component f: w = 3 t0 (j = 3),
// z3a = t1 + 12 xi z (j = 4) or t1m = t1 - 12 xi z (j = 5), for the
// round-1 Fp2 products t0, t1 (products 0 and 1 at t) and z = (z0, z1).
__device__ __forceinline__ void rcb2_wz(uint32_t* r, const uint32_t* t, const uint32_t* z0,
                                        const uint32_t* z1, int j, int f) {
  if (j == 3) {
    uint32_t t0[NL];
    fp2_of(t0, t, 0, f);
    add_mod<NL>(r, t0, t0);
    add_mod<NL>(r, r, t0);
  } else {
    uint32_t bz[NL];
    xi12(bz, z0, z1, f);
    fp2_of(r, t, 1, f);
    if (j == 4) add_mod<NL>(r, r, bz); else sub_mod<NL>(r, r, bz);
  }
}

// ------------------------------------------------------------ K12
//
// P1 + P2, 6 + 6 Fp2 products:
//   round 1   t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, m3 = (X1 + Y1)(X2 + Y2),
//             m4 = (Y1 + Z1)(Y2 + Z2), m5 = (X1 + Z1)(X2 + Z2);
//   combine 1 t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, bt5 = 12 xi (m5 - t0 - t2),
//             w = 3 t0, z3a = t1 + 12 xi t2, t1m = t1 - 12 xi t2;
//   round 2   the six products of curve.cuh's rcb_lhs/rcb_rhs;
//   combine 2 X3 = V0 - V1, Y3 = V2 + V3, Z3 = V4 + V5.

// Layout at R instances per block (limbs): P and Q rows, the round-1
// products T[q][i], the round-2 operands U, the round-2 products V[q][i]
// over T (dead by round 2); D from one slot to the next.  PIECES (R < 8):
// combine 1 makes the 18 Karatsuba pieces U[3 j + kk][i] of the round-2
// operands on all 18 threads of an instance, the same instructions on every
// lane; else (R = 8, the fewest instructions) the first form's 12
// components U[2 j + f][i] on 12, which round 2 turns into pieces.
template <int R>
struct K12 {
  static constexpr int BLOCK = 18 * R;       // one thread per Fp product of a round
  static constexpr bool PIECES = R < 8;
  static constexpr int D = R * NL;
  static constexpr int P = 0, Q = R * S6, T = 2 * R * S6, U = T + 18 * D, V = T;
  static constexpr int SMEM = U + 18 * D;
  static constexpr int PHASES = 5;
};
static_assert(K12<8>::D == G2_D, "at R = 8 combine 1 is k12_operand over G2_D slots");

// Round-2 operand j of K12 (t3, t4, bt5, w, z3a, t1m), component f, from
// the round-1 Fp2 products t0, t1, t2, m3, m4, m5 (Fp products at t, slots
// G2_D apart).
__device__ __forceinline__ void k12_operand(uint32_t* r, const uint32_t* t, int j, int f) {
  if (j < 2) {                     // t3 = m3 - t0 - t1, t4 = m4 - t1 - t2
    fp2_diff(r, t, 3 + j, j, j + 1, f);
  } else if (j == 2) {             // bt5 = 12 xi (m5 - t0 - t2)
    uint32_t s0[NL], s1[NL];
    fp2_diff(s0, t, 5, 0, 2, 0);
    fp2_diff(s1, t, 5, 0, 2, 1);
    xi12(r, s0, s1, f);
  } else {                         // w, z3a, t1m with z = t2
    uint32_t z0[NL], z1[NL];
    fp2_of(z0, t, 2, 0);
    fp2_of(z1, t, 2, 1);
    rcb2_wz(r, t, z0, z1, j, f);
  }
}

// The operand of Fp product q = 3 p + k of an Fp6 Karatsuba from the Fp6
// value x in shared memory, fp6_operand's, with the same instructions on
// every lane: both components of pair p's pre-sum are formed, the sums
// selected away for p < 3, then kara_pick.
__device__ __forceinline__ void fp6_operand_sel(uint32_t* r, const uint32_t* x, int q) {
  const int p = q / 3, j = p < 3 ? p : (p == 4 ? 1 : 0), l = p < 3 ? p : (p == 3 ? 1 : 2);
  uint32_t a0[NL], a1[NL], b0[NL], b1[NL];
  ld_fp(a0, x + j * F2);
  ld_fp(a1, x + j * F2 + NL);
  ld_fp(b0, x + l * F2);
  ld_fp(b1, x + l * F2 + NL);
  add_mod<NL>(b0, a0, b0);
  add_mod<NL>(b1, a1, b1);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    b0[k] = p < 3 ? a0[k] : b0[k];
    b1[k] = p < 3 ? a1[k] : b1[k];
  }
  kara_pick(r, b0, b1, q % 3);
}

// Piece kk of the Fp2 Karatsuba product whose Fp products T0, T1, T2 are
// at t, t + d, t + 2 d (xi = 0), or of xi times it (xi = 1,
// xi (y0 + y1 i) = (y0 - y1) + (y0 + y1) i): the operand a round-2 thread
// with piece kk multiplies, component 0 (kk = 0), component 1 (kk = 1) or
// their sum (kk = 2):
//   xi = 0: T0 - T1, (T2 - T1) - T0, (T2 - T1) - T1;
//   xi = 1: (T0 - T2) + T0, (T2 - T1) - T1, (T0 - T1) + (T0 - T1).
// Each is u = T_a - T_b, then u, u + y or u - y with y = T_c or u; the
// operands are picked by address and the result by a select, so every
// lane runs the same instructions whatever its case c = 3 xi + kk.
__device__ __forceinline__ void piece(uint32_t* r, const uint32_t* t, int d, bool xi, int kk) {
  const int c = 3 * xi + kk;
  uint32_t u[NL], y[NL], v[NL];
  ld_fp(u, t + ((0x020220 >> 4 * c) & 15) * d);        // a
  sub_sh(u, t + ((0x112111 >> 4 * c) & 15) * d);       // b
  ld_fp(y, t + ((0x010100 >> 4 * c) & 15) * d);        // c
#pragma unroll
  for (int k = 0; k < NL; ++k) y[k] = c == 5 ? u[k] : y[k];
  add_mod<NL>(v, u, y);
  sub_mod<NL>(y, u, y);
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = c == 0 ? u[k] : ((c == 3 || c == 5) ? v[k] : y[k]);
}

// a = a + b (op 0), a - b (op 1) or a (op 2), selected.
__device__ __forceinline__ void signed_step(uint32_t* a, const uint32_t* b, int op) {
  uint32_t s[NL], u[NL];
  add_mod<NL>(s, a, b);
  sub_mod<NL>(u, a, b);
#pragma unroll
  for (int k = 0; k < NL; ++k) a[k] = op == 0 ? s[k] : (op == 1 ? u[k] : a[k]);
}

// Piece kk of K12's round-2 operand j (t3, t4, bt5, w, z3a, t1m) from the
// round-1 Fp products at t (slot stride d; Fp2 product m at t + 3 m d),
// the same instructions on every lane: each operand is D +/- 12^z
// (A +/- B +/- C) over pieces of round-1 products, with
//   t3 = m3 - t0 - t1, t4 = m4 - t1 - t2, w = t0 + t0 + t0 (no 12, no D);
//   bt5 = 12 (xi m5 - xi t0 - xi t2) (no D);
//   z3a = t1 + 12 (xi t2), t1m = t1 - 12 (xi t2) (no B, C).
// A piece is linear in its Fp2 value, so 12 xi Y's piece is 12 times xi Y's.
__device__ __forceinline__ void k12_piece(uint32_t* r, const uint32_t* t, int d, int j, int kk) {
  const bool xi = (0x34 >> j) & 1;           // bt5, z3a, t1m: xi pieces and the 12
  const int op = (0x220111 >> 4 * j) & 15;   // B and C: -, -, -, +, none, none
  uint32_t a[NL], b[NL], c[NL];
  piece(a, t + 3 * ((0x220543 >> 4 * j) & 15) * d, d, xi, kk);
  piece(b, t + 3 * ((0x000010 >> 4 * j) & 15) * d, d, xi, kk);
  piece(c, t + 3 * ((0x000221 >> 4 * j) & 15) * d, d, xi, kk);
  signed_step(a, b, op);
  signed_step(a, c, op);
  mul12(b, a);
#pragma unroll
  for (int k = 0; k < NL; ++k) a[k] = xi ? b[k] : a[k];
  piece(b, t + 3 * d, d, false, kk);         // D = t1: D + a (z3a), D - a (t1m)
  signed_step(b, a, j == 4 ? 0 : (j == 5 ? 1 : 2));
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = j >= 4 ? b[k] : a[k];
}

// Phases 3 and 4 of K12 and K13 (layout L) for thread `tid`, item e of
// live instance i: round 2, piece e % 3 of round-2 Fp2 product e / 3, its
// operands the pieces in U (L::PIECES) or Karatsuba operands of the
// components there; and combine 2, component e % 2 of coordinate e / 2
// (X3 = V0 - V1, Y3 = V2 + V3, Z3 = V4 + V5) written to the instance's
// output row o in device memory.
template <class L>
__device__ __forceinline__ void rcb2_phase(int ph, uint32_t* sm, uint32_t* o, int e, int i,
                                           int tid) {
  if (ph == 3) {
    const int k = e / 3, kk = e % 3;
    const uint32_t* u = sm + L::U + i * NL;
    uint32_t x[NL], y[NL];
    if (L::PIECES) {
      ld_fp(x, u + (3 * rcb_lhs(k) + kk) * L::D);
      ld_fp(y, u + (3 * rcb_rhs(k) + kk) * L::D);
    } else {
      kara_operand(x, u + 2 * rcb_lhs(k) * L::D, kk, L::D);
      kara_operand(y, u + 2 * rcb_rhs(k) * L::D, kk, L::D);
    }
    mont_mul<NL>(x, x, y);
    st_fp(sm + L::V + tid * NL, x);
  } else if (e < 6) {
    const int c = e / 2, f = e % 2;
    const uint32_t* v = sm + L::V + i * NL;
    uint32_t r[NL], s[NL];
    fp2_coeff(r, v + 6 * c * L::D, L::D, f);
    fp2_coeff(s, v + 3 * (2 * c + 1) * L::D, L::D, f);
    if (c == 0) sub_mod<NL>(r, r, s); else add_mod<NL>(r, r, s);
    st_fp(o + c * F2 + f * NL, r);
  }
}

// Phase `ph` of K12 for thread `tid` of block `blk`: stage, round 1,
// combine 1, round 2, combine 2 (written to device memory).
template <int R>
__device__ __forceinline__ void g2_add_phase(int ph, uint32_t* sm, const uint32_t* p,
                                             const uint32_t* q, uint32_t* out, int64_t n,
                                             int64_t blk, int tid) {
  using L = K12<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  const int e = tid / R, i = tid % R;
  if (ph == 0) {                            // stage
    stage_in<G2P, S6, L::BLOCK>(sm + L::P, p + row0 * G2P, rows, tid);
    stage_in<G2P, S6, L::BLOCK>(sm + L::Q, q + row0 * G2P, rows, tid);
  } else if (i >= rows) {
    return;
  } else if (ph == 1) {                     // round-1 Fp product e of instance i
    uint32_t x[NL], y[NL];
    if (L::PIECES) {
      fp6_operand_sel(x, sm + L::P + i * S6, e);
      fp6_operand_sel(y, sm + L::Q + i * S6, e);
    } else {
      fp6_operand(x, sm + L::P + i * S6, e);
      fp6_operand(y, sm + L::Q + i * S6, e);
    }
    mont_mul<NL>(x, x, y);
    st_fp(sm + L::T + tid * NL, x);
  } else if (ph == 2) {                     // combine 1: pieces, or components (e < 12)
    uint32_t r[NL];
    if (L::PIECES) {
      k12_piece(r, sm + L::T + i * NL, L::D, e / 3, e % 3);
      st_fp(sm + L::U + tid * NL, r);
    } else if (e < 12) {
      k12_operand(r, sm + L::T + i * NL, e / 2, e % 2);
      st_fp(sm + L::U + tid * NL, r);
    }
  } else {                                  // round 2, combine 2
    rcb2_phase<L>(ph, sm, out + (row0 + i) * G2P, e, i, tid);
  }
}

template <int R>
__global__ void __launch_bounds__(K12<R>::BLOCK, 5)
g2_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K12<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K12<R>::PHASES; ++ph) {
    g2_add_phase<R>(ph, sm, p, q, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K12<R>::PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------ K13
//
// P + (x2 : y2 : 1), 5 + 6 Fp2 products:
//   round 1   t0 = X1 x2, t1 = Y1 y2, m3 = (X1 + Y1)(x2 + y2), zx = Z1 x2,
//             zy = Z1 y2;
//   combine 1 t3 = m3 - t0 - t1, t4 = zy + Y1, bt5 = 12 xi (zx + X1),
//             w = 3 t0, z3a = t1 + 12 xi Z1, t1m = t1 - 12 xi Z1;
//   round 2   as K12's.
// With PIECES (below K13_PIECES_ROWS rows) round 1 takes m3's place with
// two products, a = X1 y2 and b = Y1 x2, on the 3 threads the first form
// left idle, and t3 = a + b.

// Layout at R instances per block (limbs): P rows, affine Q rows, the
// round-1 products T[q][i] (18 slots, 15 used without PIECES), the round-2
// operands U, the round-2 products V[q][i] over T (dead by round 2); D
// from one slot to the next.  PIECES: combine 1 makes the 18 Karatsuba
// pieces U[3 j + kk][i] on all 18 threads of an instance; else (R = 8)
// the first form's 12 components U[2 j + f][i] on 12.
template <int R, bool PIECES_>
struct K13 {
  static constexpr int BLOCK = 18 * R;       // one thread per Fp product of round 2
  static constexpr bool PIECES = PIECES_;
  static constexpr int D = R * NL;
  static constexpr int P = 0, Q = R * S6, T = Q + R * SA2, U = T + 18 * D, V = T;
  static constexpr int SMEM = U + (PIECES ? 18 : 12) * D;
  static constexpr int PHASES = 5;
  static constexpr int PRODUCTS = PIECES ? 18 : 15;      // round 1's Fp products
};
static_assert(K13<8, false>::D == G2_D, "without PIECES combine 1 is k13_operand");

// Rows from which K13 runs without PIECES (at R = 8).
constexpr int64_t K13_PIECES_ROWS = 2048;

// Round-1 Fp2 product j of K13 multiplies the Fp6-layout pair
// (k13_lhs(j) of P, k13_rhs(j) of Q): pairs 0, 1, 2 are a row's
// coordinates, pair 3 the sum of the first two (fp6_presum).
// X1 x2, Y1 y2, (X1 + Y1)(x2 + y2), Z1 x2, Z1 y2; with PIECES
// X1 x2, Y1 y2, X1 y2, Y1 x2, Z1 x2, Z1 y2.
__device__ __forceinline__ int k13_lhs(int j, bool pieces) {
  return ((pieces ? 0x221010 : 0x22310) >> 4 * j) & 15;
}
__device__ __forceinline__ int k13_rhs(int j, bool pieces) {
  return ((pieces ? 0x100110 : 0x10310) >> 4 * j) & 15;
}

// Round-2 operand j of K13 without PIECES (t3, t4, bt5, w, z3a, t1m),
// component f, from the shared row p = (X1, Y1, Z1) and the round-1 Fp2
// products t0, t1, m3, zx, zy (Fp products at t, G2_D apart).
__device__ __forceinline__ void k13_operand(uint32_t* r, const uint32_t* p, const uint32_t* t,
                                            int j, int f) {
  if (j == 0) {                    // t3 = m3 - t0 - t1
    fp2_diff(r, t, 2, 0, 1, f);
  } else if (j == 1) {             // t4 = zy + Y1
    fp2_of(r, t, 4, f);
    add_sh(r, p + F2 + f * NL);
  } else if (j == 2) {             // bt5 = 12 xi (zx + X1)
    uint32_t s0[NL], s1[NL];
    fp2_of(s0, t, 3, 0);
    add_sh(s0, p);
    fp2_of(s1, t, 3, 1);
    add_sh(s1, p + NL);
    xi12(r, s0, s1, f);
  } else {                         // w, z3a, t1m with z = Z1
    uint32_t z0[NL], z1[NL];
    ld_fp(z0, p + 2 * F2);
    ld_fp(z1, p + 2 * F2 + NL);
    rcb2_wz(r, t, z0, z1, j, f);
  }
}

// piece(), or with `staged` the piece of the Fp2 value y = (y0, y1) at
// t, t + d (a coordinate of K13's P): y0, y1, y0 + y1 (xi = 0); y0 - y1,
// y0 + y1, y0 + y0 (xi = 1), as u = y_a - 0, then u, u + y1 or u - y1
// (u + u for y0 + y0).  The same instructions whatever the kind, so that
// a K13 lane takes a product's piece or a coordinate's by its operands.
// K12 keeps piece(): built over this function, it ran 11% slower at 13
// and 512 rows on the card (another register allocation).
__device__ __forceinline__ void any_piece(uint32_t* r, const uint32_t* t, int d, bool xi, int kk,
                                          bool staged) {
  const int c = 3 * xi + kk;
  uint32_t u[NL], y[NL], v[NL];
  ld_fp(u, t + (staged ? c == 1 : (0x020220 >> 4 * c) & 15) * d);      // a
  ld_fp(y, t + (staged ? 0 : (0x112111 >> 4 * c) & 15) * d);           // b
#pragma unroll
  for (int k = 0; k < NL; ++k) y[k] = staged ? 0u : y[k];
  sub_mod<NL>(u, u, y);
  ld_fp(y, t + (staged ? 1 : (0x010100 >> 4 * c) & 15) * d);           // c
#pragma unroll
  for (int k = 0; k < NL; ++k) y[k] = c == 5 ? u[k] : y[k];
  add_mod<NL>(v, u, y);
  sub_mod<NL>(y, u, y);
  const bool take_u = staged ? c < 2 : c == 0;
  const bool take_y = staged ? c == 3 : c == 1 || c == 2 || c == 4;
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = take_u ? u[k] : (take_y ? y[k] : v[k]);
}

// Piece kk of K13's round-2 operand j (t3, t4, bt5, w, z3a, t1m) with
// PIECES, from the staged row p = (X1, Y1, Z1) and the round-1 Fp products
// at t (slot stride d; Fp2 product m of t0, t1, a, b, zx, zy at
// t + 3 m d), the same instructions on every lane: the pieces A and Y, the
// sum s0 = A + Y and m = 12 s0 (bt5) or 12 Y, then base +/- q:
//   t3 = a + b, t4 = zy + Y1, bt5 = 12 (xi zx + xi X1) (s0 or m);
//   w = s0 + t0 with s0 = t0 + t0, z3a = t1 + m, t1m = t1 - m (m = 12 xi Z1),
// with Y a round-1 product (t3: b, w: t0) or a staged coordinate
// (any_piece's `staged`: Y1, X1, Z1).
__device__ __forceinline__ void k13_piece(uint32_t* r, const uint32_t* p, const uint32_t* t,
                                          int d, int j, int kk) {
  const bool staged = (0x36 >> j) & 1;       // Y: Y1, X1, Z1 for t4, bt5, z3a, t1m
  const bool xi = (0x34 >> j) & 1;           // bt5, z3a, t1m: xi pieces
  uint32_t a[NL], y[NL], s0[NL], m[NL];
  any_piece(a, t + 3 * ((0x110452 >> 4 * j) & 15) * d, d, j == 2, kk, false);
  any_piece(y, staged ? p + ((0x220010 >> 4 * j) & 15) * F2
                      : t + 3 * ((0x000003 >> 4 * j) & 15) * d,
            staged ? NL : d, xi, kk, staged);
  add_mod<NL>(s0, a, y);
#pragma unroll
  for (int k = 0; k < NL; ++k) m[k] = j == 2 ? s0[k] : y[k];
  mul12(m, m);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    y[k] = j == 3 ? a[k] : m[k];             // q
    a[k] = j >= 4 ? a[k] : s0[k];            // base
  }
  add_mod<NL>(r, a, y);
  sub_mod<NL>(a, a, y);
#pragma unroll
  for (int k = 0; k < NL; ++k) r[k] = j < 2 ? s0[k] : (j == 2 ? m[k] : (j == 5 ? a[k] : r[k]));
}

// Phase `ph` of K13 for thread `tid` of block `blk`: stage, round 1,
// combine 1, round 2, combine 2 (written to device memory).
template <int R, bool PIECES>
__device__ __forceinline__ void g2_madd_phase(int ph, uint32_t* sm, const uint32_t* p,
                                              const uint32_t* q, uint32_t* out, int64_t n,
                                              int64_t blk, int tid) {
  using L = K13<R, PIECES>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  const int e = tid / R, i = tid % R;
  if (ph == 0) {                            // stage
    stage_in<G2P, S6, L::BLOCK>(sm + L::P, p + row0 * G2P, rows, tid);
    stage_in<G2A, SA2, L::BLOCK>(sm + L::Q, q + row0 * G2A, rows, tid);
  } else if (i >= rows) {
    return;
  } else if (ph == 1) {                     // round-1 Fp product e of instance i
    if (e < L::PRODUCTS) {
      const int j = e / 3, k = e % 3;
      uint32_t x[NL], y[NL];
      if (PIECES) {                         // coordinates only: kara_pick on every lane
        const uint32_t* a = sm + L::P + i * S6 + k13_lhs(j, true) * F2;
        const uint32_t* b = sm + L::Q + i * SA2 + k13_rhs(j, true) * F2;
        uint32_t z[NL];
        ld_fp(x, a);
        ld_fp(z, a + NL);
        kara_pick(x, x, z, k);
        ld_fp(y, b);
        ld_fp(z, b + NL);
        kara_pick(y, y, z, k);
      } else {
        fp6_operand(x, sm + L::P + i * S6, 3 * k13_lhs(j, false) + k);
        fp6_operand(y, sm + L::Q + i * SA2, 3 * k13_rhs(j, false) + k);
      }
      mont_mul<NL>(x, x, y);
      st_fp(sm + L::T + tid * NL, x);
    }
  } else if (ph == 2) {                     // combine 1: pieces, or components (e < 12)
    uint32_t r[NL];
    if (PIECES) {
      k13_piece(r, sm + L::P + i * S6, sm + L::T + i * NL, L::D, e / 3, e % 3);
      st_fp(sm + L::U + tid * NL, r);
    } else if (e < 12) {
      k13_operand(r, sm + L::P + i * S6, sm + L::T + i * NL, e / 2, e % 2);
      st_fp(sm + L::U + tid * NL, r);
    }
  } else {                                  // round 2, combine 2
    rcb2_phase<L>(ph, sm, out + (row0 + i) * G2P, e, i, tid);
  }
}

template <int R, bool PIECES>
__global__ void __launch_bounds__(K13<R, PIECES>::BLOCK, 5)
g2_madd_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
               uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K13<R, PIECES>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K13<R, PIECES>::PHASES; ++ph) {
    g2_madd_phase<R, PIECES>(ph, sm, p, q, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K13<R, PIECES>::PHASES) __syncthreads();
  }
}

// ------------------------------------------------------------ K14
//
// 2P, 4 + 4 Fp2 products:
//   round 1   t0 = Y^2 and 12 z2 = 12 Z^2 as complex squares (2 Fp
//             products each: (w0 + w1)(w0 - w1) and w0 (w1 + w1), the 12
//             folded into the left operand), t1 = Y Z and xy = X Y as
//             Karatsuba products (3 each): 10 Fp products;
//   round 2   t0m xy, t0m y3a, t0 t2 and t0 t1 with t2 = xi (12 z2),
//             t0m = t0 - 3 t2 and y3a = t0 + t2;
//   combine   X3 = 2 t0m xy, Y3 = t0m y3a + 8 t0 t2, Z3 = 8 t0 t1
//             (e8 = 8 t0 of the plain version, applied to the products).

// Layout at R instances per block (limbs): P rows, the round-1 products
// T[q][i], the round-2 products V[q][i]; D from one product's slot to the
// next.
template <int R>
struct K14 {
  static constexpr int BLOCK = 12 * R;       // one thread per Fp product of round 2
  static constexpr int D = R * NL;
  static constexpr int P = 0, T = R * S6, V = T + 10 * D;
  static constexpr int SMEM = V + 12 * D;
  static constexpr int PHASES = 4;
};

// The operands of K14's round-1 Fp product e < 10 from the staged point
// pt = (X, Y, Z): e = 0, 1 and 8, 9 the complex squares of Y and of Z,
// (w0 + w1)(w0 - w1) (even e) and w0 (w1 + w1) (odd e), the left operand
// times 12 for Z; e = 2..4 and 5..7 the Karatsuba pieces e - 2 and e - 5
// of Y Z and X Y.
__device__ __forceinline__ void k14_round1(uint32_t* l, uint32_t* r, const uint32_t* pt, int e) {
  if (e >= 2 && e < 8) {
    const int kk = (e - 2) % 3;
    kara_operand(l, pt + (e < 5 ? F2 : 0), kk);
    kara_operand(r, pt + (e < 5 ? 2 * F2 : F2), kk);
    return;
  }
  const uint32_t* w = pt + (e < 8 ? F2 : 2 * F2);
  uint32_t w0[NL], w1[NL], s[NL];
  ld_fp(w0, w);
  ld_fp(w1, w + NL);
  add_mod<NL>(l, w0, w1);
  sub_mod<NL>(r, w0, w1);
  add_raw<NL>(s, w1, w1);                   // below 2p
  const bool odd = e & 1;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    l[j] = odd ? w0[j] : l[j];
    r[j] = odd ? s[j] : r[j];
  }
  if (e >= 8) mul12(l, l);
}

// The round-2 operands of K14's Fp2 product k from the round-1 Fp
// products at t (slot stride d), both components of each, into (u0, u1)
// and (v0, v1): t0m (k < 2) or t0, and xy, y3a, t2 or t1 (k = 0..3).
// t0 = (T0, T1) and t2 = (T8 - T9, T8 + T9) come straight from the
// products; every lane forms t2, t0m, y3a and one Karatsuba product (xy or
// t1, picked by its slots) and selects, so a warp's lanes run the same
// instructions whatever their k.
__device__ __forceinline__ void k14_round2(uint32_t* u0, uint32_t* u1, uint32_t* v0, uint32_t* v1,
                                           const uint32_t* t, int d, int k) {
  uint32_t* u[2] = {u0, u1};
  uint32_t* v[2] = {v0, v1};
  const uint32_t* kp = t + (k == 0 ? 5 : 2) * d;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    uint32_t t0[NL], t2[NL], w[NL], z[NL];
    ld_fp(t0, t + g * d);
    ld_fp(t2, t + 8 * d);
    ld_fp(w, t + 9 * d);
    if (g == 0) sub_mod<NL>(t2, t2, w); else add_mod<NL>(t2, t2, w);
    add_mod<NL>(w, t2, t2);                 // t0m = t0 - 3 t2
    add_mod<NL>(w, w, t2);
    sub_mod<NL>(w, t0, w);
#pragma unroll
    for (int j = 0; j < NL; ++j) u[g][j] = k < 2 ? w[j] : t0[j];
    add_mod<NL>(w, t0, t2);                 // y3a = t0 + t2
    fp2_coeff(z, kp, d, g);                 // xy (k = 0) or t1
#pragma unroll
    for (int j = 0; j < NL; ++j) v[g][j] = k == 1 ? w[j] : (k == 2 ? t2[j] : z[j]);
  }
}

// Component f of coordinate c of 2P from the round-2 Fp products at v
// (slot stride d): X3 = 2 A, Y3 = B + 8 C, Z3 = 8 D for the Fp2 products
// A, B, C, D; each lane forms u (A, B or D) and C and selects.
__device__ __forceinline__ void k14_combine(uint32_t* r, const uint32_t* v, int d, int c, int f) {
  uint32_t u[NL], w[NL], y[NL];
  fp2_coeff(u, v + 3 * (c == 2 ? 3 : c) * d, d, f);
  fp2_coeff(w, v + 6 * d, d, f);
#pragma unroll
  for (int j = 0; j < NL; ++j) w[j] = c == 2 ? u[j] : w[j];
  add_mod<NL>(w, w, w);                     // 8 C or 8 D
  add_mod<NL>(w, w, w);
  add_mod<NL>(w, w, w);
  add_mod<NL>(y, u, w);                     // Y3
  add_mod<NL>(u, u, u);                     // X3
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = c == 0 ? u[j] : (c == 1 ? y[j] : w[j]);
}

// Phase `ph` of K14 for thread `tid` of block `blk`: stage, round 1,
// round 2, combine (written to device memory).
template <int R>
__device__ __forceinline__ void g2_dbl_phase(int ph, uint32_t* sm, const uint32_t* p,
                                             uint32_t* out, int64_t n, int64_t blk, int tid) {
  using L = K14<R>;
  const int64_t row0 = blk * R;
  const int rows = block_rows(n, blk, R);
  const int e = tid / R, i = tid % R;
  if (ph == 0) {                            // stage
    stage_in<G2P, S6, L::BLOCK>(sm + L::P, p + row0 * G2P, rows, tid);
  } else if (ph == 1) {                     // round-1 Fp product e of instance i
    if (e < 10 && i < rows) {
      uint32_t x[NL], y[NL];
      k14_round1(x, y, sm + L::P + i * S6, e);
      mont_mul<NL>(x, x, y);
      st_fp(sm + L::T + tid * NL, x);
    }
  } else if (ph == 2) {                     // piece e % 3 of round-2 Fp2 product e / 3
    if (i < rows) {
      uint32_t u0[NL], u1[NL], v0[NL], v1[NL];
      k14_round2(u0, u1, v0, v1, sm + L::T + i * NL, L::D, e / 3);
      kara_pick(u0, u0, u1, e % 3);
      kara_pick(v0, v0, v1, e % 3);
      mont_mul<NL>(u0, u0, v0);
      st_fp(sm + L::V + tid * NL, u0);
    }
  } else if (e < 6 && i < rows) {           // component e % 2 of coordinate e / 2
    uint32_t r[NL];
    k14_combine(r, sm + L::V + i * NL, L::D, e / 2, e % 2);
    st_fp(out + (row0 + i) * G2P + e / 2 * F2 + e % 2 * NL, r);
  }
}

template <int R>
__global__ void __launch_bounds__(K14<R>::BLOCK, 5)
g2_dbl_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t sm[K14<R>::SMEM];
#pragma unroll
  for (int ph = 0; ph < K14<R>::PHASES; ++ph) {
    g2_dbl_phase<R>(ph, sm, p, out, n, blockIdx.x, threadIdx.x);
    if (ph + 1 < K14<R>::PHASES) __syncthreads();
  }
}

extern "C" int g2_add(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      g2_add_kernel<R><<<grid_of(n, R), K12<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int g2_madd(const void* p, const void* q, void* out, int64_t n, void* stream) {
  if (n >= K13_PIECES_ROWS) {
    g2_madd_kernel<8, false><<<grid_of(n, 8), K13<8, false>::BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  } else if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      g2_madd_kernel<R, true><<<grid_of(n, R), K13<R, true>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int g2_dbl(const void* p, void* out, int64_t n, void* stream) {
  if (n > 0) {
    with_rows(n, [&](auto rc) {
      constexpr int R = decltype(rc)::value;
      g2_dbl_kernel<R><<<grid_of(n, R), K14<R>::BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)p, (uint32_t*)out, n);
    });
  }
  return (int)cudaGetLastError();
}
