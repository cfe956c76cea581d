// K1: batched Montgomery product REDC(a * b) over Fp, one row per thread.
//
// Replaces the TPU kernel `_mm_kernel` of crypto12381_tpu/fields/fp32.py
// (reached through `_mm_pallas` and `mont_mul`).  There, 50 signed 8-bit
// digits in float32 went through lane-shifted FMAs on the vector unit and
// two bf16 matrix products for the reduction, because the TPU has no wide
// integer multiply.  Hopper has a 32x32 -> 64-bit integer multiply, so
// here a row is 12 uint32 limbs and the product is a 12-limb CIOS loop
// (fp381.cuh), ending canonical in [0, p).
//
// Bound on the card: the row reads 96 bytes and writes 48, and does 288
// 32x32 -> 64-bit products plus 12 low products (588 32-bit multiply-adds,
// counting each wide product as two).  At 4096 rows either bound is well
// under a microsecond, so the launch itself dominates; the design keeps the
// whole product in registers, with no shared memory and no second pass.
//
// The kernel is a template over the limb count; only the 12-limb base
// field instance is built.  a, b: (n, 12) operands below 2p; out: (n, 12).

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

extern "C" int fp_mont_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    mont_mul_kernel<NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
