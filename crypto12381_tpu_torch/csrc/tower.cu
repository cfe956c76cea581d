// K2, K3, K4: whole tower products per thread, one instance per thread.
//
// Replace the TPU programs of crypto12381_tpu/fields/fp32k.py run through
// `_fused_pallas`: `prog_fp2_mul` (K2), `prog_fp2_sqr` (K3) and
// `prog_fp6_mul` (K4).  On the TPU a program normalized its signed digits,
// ran every product's lane-shifted FMAs, reduced all products together in
// two stacked bf16 matrix products and combined them in registers.  Here
// each thread does the same work for one instance on 32-bit limbs with the
// CIOS product of fp381.cuh: Karatsuba pre-sums, products, combines and the
// final reduction to [0, p) stay in registers, and only the canonical
// operands and results touch device memory.
//
// Bound on the card: per instance K2 reads 192 bytes and writes 96 for 3
// products, K3 96 and 96 for 2, K4 576 and 288 for 18 (588 32-bit
// multiply-adds per product).  At the pairing's row counts the integer
// multiply rate bounds K4 and memory bounds K2 and K3, both far below the
// launch time; what costs is the register pressure of K4's 18 products,
// which the design limits by reading each Fp2 operand from device memory
// right before its product and folding each product into three running
// sums at once, so that at most six Fp2 values are live.
//
// Layouts (int32 limbs, row-major, contiguous): Fp2 (n, 2, 12),
// Fp6 (n, 3, 2, 12).  Operands are canonical; outputs are canonical.

#include "fp381.cuh"

using namespace fp381;

constexpr int F2 = 2 * NL;   // limbs of one Fp2 value
constexpr int F6 = 3 * F2;   // limbs of one Fp6 value

__global__ void __launch_bounds__(THREADS)
fp2_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F2], y[F2], r[F2];
  load<F2>(x, a + i * F2);
  load<F2>(y, b + i * F2);
  fp381::fp2_mul(r, x, y);
  store<F2>(out + i * F2, r);
}

__global__ void __launch_bounds__(THREADS)
fp2_sqr_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[F2], r[F2];
  load<F2>(x, a + i * F2);
  fp381::fp2_sqr(r, x);
  store<F2>(out + i * F2, r);
}

// The Fp2 operand of one Karatsuba product: coefficient j, or the sum of
// coefficients j and k (k < 0: none), read from an Fp6 in device memory.
__device__ __forceinline__ void fp6_operand(uint32_t* r, const uint32_t* g, int j, int k) {
  load<F2>(r, g + j * F2);
  if (k >= 0) {
    uint32_t s[F2];
    load<F2>(s, g + k * F2);
    fp2_add(r, r, s);
  }
}

// t = (a_j [+ a_k]) * (b_j [+ b_k])
__device__ __forceinline__ void fp6_product(uint32_t* t, const uint32_t* a, const uint32_t* b,
                                            int j, int k) {
  uint32_t x[F2], y[F2];
  fp6_operand(x, a, j, k);
  fp6_operand(y, b, j, k);
  fp381::fp2_mul(t, x, y);
}

// Fp6 product c = a * b with v^3 = xi, Karatsuba over the coefficients:
//   c0 = t0 + xi (m12 - t1 - t2)
//   c1 = m01 - t0 - t1 + xi t2
//   c2 = m02 - t0 - t2 + t1
// with t_j = a_j b_j and m_jk = (a_j + a_k)(b_j + b_k).
__global__ void __launch_bounds__(THREADS)
fp6_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* A = a + i * F6;
  const uint32_t* B = b + i * F6;
  uint32_t c0[F2], c1[F2], c2[F2], t[F2], u[F2];

  fp6_product(t, A, B, 0, -1);               // t0
  load<F2>(c0, t);
#pragma unroll
  for (int j = 0; j < F2; ++j) c1[j] = 0;
  fp2_sub(c1, c1, t);                        // c1 = -t0
  load<F2>(c2, c1);                          // c2 = -t0

  fp6_product(t, A, B, 1, -1);               // t1
  fp2_mul_xi(u, t);
  fp2_sub(c0, c0, u);
  fp2_sub(c1, c1, t);
  fp2_add(c2, c2, t);

  fp6_product(t, A, B, 2, -1);               // t2
  fp2_mul_xi(u, t);
  fp2_sub(c0, c0, u);
  fp2_add(c1, c1, u);
  fp2_sub(c2, c2, t);

  fp6_product(t, A, B, 0, 1);                // m01
  fp2_add(c1, c1, t);

  fp6_product(t, A, B, 1, 2);                // m12
  fp2_mul_xi(u, t);
  fp2_add(c0, c0, u);

  fp6_product(t, A, B, 0, 2);                // m02
  fp2_add(c2, c2, t);

  uint32_t* o = out + i * F6;
  store<F2>(o, c0);
  store<F2>(o + F2, c1);
  store<F2>(o + 2 * F2, c2);
}

extern "C" int fp2_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp2_mul_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp2_sqr(const void* a, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp2_sqr_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fp6_mul(const void* a, const void* b, void* out, int64_t n, void* stream) {
  if (n > 0) {
    fp6_mul_kernel<<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
