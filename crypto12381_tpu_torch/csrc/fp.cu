// K1: batched Montgomery product REDC(a * b) over Fp and Fr, and the
// fixed-exponent power chain built on it.
//
// Replaces the TPU kernel `_mm_kernel` of crypto12381_tpu/fields/fp32.py
// (reached through `_mm_pallas` and `mont_mul`, for the contexts "fp8" and
// "fr8").  There, 50 (Fp) or 36 (Fr) signed 8-bit digits in float32 went
// through lane-shifted FMAs on the vector unit and two bf16 matrix
// products for the reduction, because the TPU has no wide integer
// multiply.  Hopper has a 32x32 -> 64-bit integer multiply, so here a row
// is 12 (Fp) or 8 (Fr) uint32 limbs and the product is a CIOS loop
// (fp381.cuh), ending canonical.
//
// mont_mul_kernel: one product per row, one row per thread.  Bound on the
// card: an Fp row reads 96 bytes and writes 48, and does 588 32-bit
// multiply-adds (288 wide products counted twice, plus 12 low products);
// an Fr row 64 and 32 bytes, 264 multiply-adds.  At a few thousand rows
// either bound is well under a microsecond, so the launch itself
// dominates; the product stays in registers.
//
// pow_fixed_kernel: x^e for a public exponent e shared by all rows, the
// JAX package's `pow_fixed` scan (fields/fp32.py) as ONE launch instead of
// one launch per step.  Square-and-multiply from the top bit, multiplying
// only on set bits; the exponent is a kernel parameter, so the branch is
// uniform over the warp.  A row is a chain of dependent products (608 for
// p - 2, 417 for r - 2), so the time is each row's latency through the
// chain, not the card's throughput (at 2,048 rows the least work of
// x^(p-2), a 5-bit sliding window of 378 squarings and 82 products, would
// take 0.027 ms at the card's integer rate); acc and x stay in registers.  A
// lane-cooperative chain (2 or 4 lanes per row, each holding N / TPI limbs,
// b_i and m broadcast by warp shuffles and carries resolved by ballots, as
// NVlabs' CGBN does) was slower on an H100 at 512 to 8,192 rows: the
// shuffles on each step's dependent path cost more than the shorter rows
// save (PERF.md, PR 6).

#include "fp381.cuh"

using namespace fp381;

template <int N>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
  load<N>(x, a + i * N);
  load<N>(y, b + i * N);
  mont_mul<N>(x, x, y);
  store<N>(out + i * N, x);
}

template <int N>
__global__ void __launch_bounds__(THREADS)
pow_fixed_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const __grid_constant__ Exponent e, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t xv[N], acc[N];
  load<N>(xv, x + i * N);
  load<N>(acc, x + i * N);
#pragma unroll 1
  for (int k = e.bits - 2; k >= 0; --k) {
    mont_mul<N>(acc, acc, acc);
    if (exp_bit(e, k)) mont_mul<N>(acc, acc, xv);
  }
  store<N>(out + i * N, acc);
}

extern "C" int fp_mont_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    mont_mul_kernel<NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fr_mont_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    mont_mul_kernel<FR_NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// x, out: (n, N) rows; words: the (bits + 31) / 32 host words of e >= 1;
// bits: e's bit length.  An e past the limit launches nothing and returns
// cudaErrorInvalidValue.
extern "C" int fp_pow_fixed(const void* x, void* out, const uint32_t* words, int bits, int64_t n,
                            void* stream) {
  Exponent e;
  if (!exponent_of(words, bits, &e)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    pow_fixed_kernel<NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, e, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fr_pow_fixed(const void* x, void* out, const uint32_t* words, int bits, int64_t n,
                            void* stream) {
  Exponent e;
  if (!exponent_of(words, bits, &e)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    pow_fixed_kernel<FR_NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, e, n);
  }
  return (int)cudaGetLastError();
}
