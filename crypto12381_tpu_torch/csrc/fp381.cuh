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
// product with 64-bit accumulators, a template over the limb count that
// selects the field.  Every loop is unrolled; the limbs live in registers.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace fp381 {

constexpr int NL = 12;

__constant__ uint32_t FP_P[NL] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// -p^-1 mod 2^32
constexpr uint32_t FP_N0 = 0xfffcfffdu;

constexpr int FR_NL = 8;

__constant__ uint32_t FR_R[FR_NL] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// -r^-1 mod 2^32 (r = 1 mod 2^32)
constexpr uint32_t FR_N0 = 0xffffffffu;

// Modulus traits: the limb count selects the field.
template <int N>
struct Field;

template <>
struct Field<NL> {
  static __device__ __forceinline__ uint32_t p(int j) { return FP_P[j]; }
  static constexpr uint32_t n0 = FP_N0;
};

template <>
struct Field<FR_NL> {
  static __device__ __forceinline__ uint32_t p(int j) { return FR_R[j]; }
  static constexpr uint32_t n0 = FR_N0;
};

// r = t - p if t >= p (t given as N limbs plus a top word), else t.
template <int N>
__device__ __forceinline__ void cond_sub_p(uint32_t* r, const uint32_t* t, uint32_t top) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - Field<N>::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  const bool keep = borrow && !top;  // t < p
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = keep ? t[j] : d[j];
}

// r = a * b * 2^(-32N) mod p, canonical.  a, b < 2p for Fp, canonical for
// Fr.  r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * Field<N>::n0;
    c = ((uint64_t)m * Field<N>::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * Field<N>::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  cond_sub_p<N>(r, t, t[N]);
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
// (fp12.cu K9-K11 and the power, g2.cu K14) at n rows: the largest of 8,
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

__device__ __forceinline__ bool exp_bit(const Exponent& e, int k) {
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
