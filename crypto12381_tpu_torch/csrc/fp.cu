// K1: batched Montgomery product REDC(a * b) over Fp and Fr, and the
// fixed-exponent power chain built on it.
//
// Replaces the TPU kernel `_mm_kernel` of crypto12381_tpu/fields/fp32.py
// (reached through `_mm_pallas` and `mont_mul`, for the contexts "fp8" and
// "fr8").  There, 50 (Fp) or 36 (Fr) signed 8-bit digits in float32 went
// through lane-shifted FMAs on the vector unit and two bf16 matrix
// products for the reduction, because the TPU has no wide integer
// multiply.  Hopper has a 32x32 -> 64-bit integer multiply, so here a row
// is 12 (Fp) or 8 (Fr) uint32 limbs and the product is a CIOS on PTX carry
// chains (fp381.cuh `mont_mul`), ending canonical; the tensor cores have no
// 32-bit integer product, and 8-bit digits would take many more passes.
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
// one launch per step.  A row is a chain of dependent products, so the
// time is each row's latency through the chain, not the card's throughput:
// at 2,048 rows the launch is 16 blocks on 132 SMs, one warp per
// scheduler, and nothing hides a product's latency.  So the chain is made
// short and its steps cheap.  It is a left-to-right sliding window of 4
// bits over e: each row first makes its odd powers x, x^3, ..., up to the
// largest window of e (the paths' exponents use all of x^15: one squaring,
// 7 products; e = 1 none), then squares once per bit below the first window
// and multiplies by the table entry of each later window (its odd value,
// at the window's last bit).  Every squaring is `mont_sqr` (456 Fp
// multiply-adds against the product's 588).  x^(p-2) takes 378 squarings
// and 85 products (608 products in the binary chain before), x^((p+1)/4)
// and x^((p-3)/4) 376 and 85, x^(r-2) 253 and 60 (417 before); the 5-bit
// window would save 3 products of 463 on x^(p-2) at twice the table.  The
// least work of x^(p-2), 378 squarings and 82 products at the card's
// integer rate, would take 0.027 ms at 2,048 rows.  The exponent is a
// kernel parameter, so every window decision is uniform over the warp.
// The table lives in shared memory as [entry][limb][thread]: 8 entries of
// 12 limbs are 384 bytes a row, 48 KB for a block of 128 (Fr 32 KB), each
// thread reads and writes only its own column, so the 32 threads of a warp
// hit 32 distinct banks and no barrier is needed; an entry is read about
// 85 times a chain against some 460 products in registers, and the table
// never leaves the SM (local memory indexed by the window was not tried).
// The accumulator stays in registers.  On an H100 x^(p-2) at 2,048 rows
// takes 0.392 ms, 0.468 with its squarings as mont_mul, 0.90 as the binary
// chain (PERF.md).  A lane-cooperative chain (2 or 4 lanes
// per row, each holding N / TPI limbs, b_i and m broadcast by warp
// shuffles and carries resolved by ballots, as NVlabs' CGBN does) was
// slower on an H100 at 512 to 8,192 rows: the shuffles on each step's
// dependent path cost more than the shorter rows save (PERF.md).

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

// Window width of the chain and its table of odd powers x, x^3, ..., x^15.
constexpr int WINDOW = 4;
constexpr int TABLE = 1 << (WINDOW - 1);

// The window of e that starts at its set bit k: its lowest bit lo (the
// lowest set bit of bits k..max(k - WINDOW + 1, 0)) and its odd value.
__host__ __device__ __forceinline__ int exp_window(const Exponent& e, int k, int* value) {
  int lo = k - WINDOW + 1 < 0 ? 0 : k - WINDOW + 1;
  while (!exp_bit(e, lo)) ++lo;
  int v = 0;
  for (int b = k; b >= lo; --b) v = 2 * v + (int)exp_bit(e, b);
  *value = v;
  return lo;
}

// The table entries x, x^3, ..., x^(2t - 1) that e's windows use: t = (v + 1) / 2
// for the largest window value v (1 for e = 1: no squaring, no product).
inline int table_entries(const Exponent& e) {
  int top = 1, v;
  for (int k = e.bits - 1; k >= 0; --k) {
    if (!exp_bit(e, k)) continue;
    k = exp_window(e, k, &v);
    top = v > top ? v : top;
  }
  return (top + 1) / 2;
}

// x^e on n rows; `entries` = table_entries(e), so that a short e builds only
// the part of the table it reads, and an e whose windows are all 1 (1, 17,
// 2^64 + 1, ...) keeps x in registers and touches no shared memory.
template <int N>
__global__ void __launch_bounds__(THREADS)
pow_fixed_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const __grid_constant__ Exponent e, int entries, int64_t n) {
  __shared__ uint32_t table[TABLE * N * THREADS];
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t* col = table + threadIdx.x;      // entry t, limb j at col[(t N + j) THREADS]
  uint32_t acc[N], sq[N];
  load<N>(acc, x + i * N);
#pragma unroll
  for (int j = 0; j < N; ++j) sq[j] = acc[j];  // x, the one entry if entries == 1
  if (entries > 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) col[j * THREADS] = acc[j];
    mont_sqr<N>(sq, acc);                   // x^2
#pragma unroll 1
    for (int t = 1; t < entries; ++t) {     // x^(2t + 1) = x^(2t - 1) x^2
      mont_mul<N>(acc, acc, sq);
#pragma unroll
      for (int j = 0; j < N; ++j) col[(t * N + j) * THREADS] = acc[j];
    }
  }
  int v;
  int k = exp_window(e, e.bits - 1, &v) - 1;  // the top window: acc = x^v
  if (entries > 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = col[((v >> 1) * N + j) * THREADS];
  }
  int end = -1;                             // the open window's lowest bit
#pragma unroll 1
  for (; k >= 0; --k) {
    if (end < 0 && exp_bit(e, k)) end = exp_window(e, k, &v);
    mont_sqr<N>(acc, acc);
    if (k == end) {                         // the window's last squaring: times x^v
      if (entries > 1) {
#pragma unroll
        for (int j = 0; j < N; ++j) sq[j] = col[((v >> 1) * N + j) * THREADS];
      }
      mont_mul<N>(acc, acc, sq);
      end = -1;
    }
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
        (const uint32_t*)x, (uint32_t*)out, e, table_entries(e), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fr_pow_fixed(const void* x, void* out, const uint32_t* words, int bits, int64_t n,
                            void* stream) {
  Exponent e;
  if (!exponent_of(words, bits, &e)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    pow_fixed_kernel<FR_NL><<<(unsigned)blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, e, table_entries(e), n);
  }
  return (int)cudaGetLastError();
}
