"""The CUDA kernels' arithmetic, run on the host.

The device functions and kernel bodies of crypto12381_tpu_torch/csrc/
are plain C++ once the CUDA keywords are defined away, so a host C++
compiler can build them into a small program. It runs the one-thread-
per-row kernel bodies of K1 (the Fp and Fr products and the power chain
x^e of one launch) once per thread, and K1's squaring mont_sqr row by row.
The products run their carry chains on the host twin of the PTX carry
flag (csrc/fp381.cuh): the same schedule, carry for carry; the PTX itself
is checked only on the card. K2-K14 are block-cooperative:
their threads share operands and products through shared memory, with
barriers between phases. The program runs each of their blocks phase by
phase, every thread of a phase before the next, with the block's shared
memory a fresh array of junk; it runs every block a second time with the
threads of each phase in reverse order, and fails if the outputs differ
(threads that race within a phase) or if a write lands past the last row.
The outputs must equal the plain PyTorch versions bit for bit: on
canonical operands with the edge values 0, 1 and p-1; for K1 on pre-sums
up to 2p-2; for the chain x^e (a 4-bit sliding window) at the paths'
exponents x^(p-2), x^((p+1)/4), x^((p-3)/4) and x^(r-2), at the window's
edges e = 1, 2, 3, 15, 16, 17, 31, 2^64 + 1 and at random 384-bit e, and
for the Fp and Fr products and squares on carry-heavy operands (raw sums
up to 2p - 1, 2^381 - 1, p, p + 1, limbs all 0xffffffff below the top;
r - 1) and random ones, over a whole grid (one ragged block, and full
blocks before a ragged one) with edge rows at both ends and a guard after
the output, the exponent passed as the C entry points pass it, also
against the host's integers; for K2-K4 at row
counts below, at and between multiples of a block's instances, with rows
of all-0, all-1 and all-(p-1) operands at both ends of the launch (all
p-1 gives the largest pre-sums); for the curve kernels K5-K7 on curve points with
the identity, P = Q and P = -Q among them, also at row counts below, at
and between multiples of a block, with those rows at both ends of the
launch; for the Fp12 kernels K8-K11 (csrc/fp12.cu), K11 over 1-5
lines and the cyclotomic power x^e of one launch (run through the
kernel's own schedule of phases) likewise at row counts below, at and
between multiples of their blocks, K8-K11 and the power at every
instantiation of instances per block, with rows of all-0, all-1 and
all-(p-1) operands at both ends; and for the G2 curve
kernels K12-K14 (csrc/g2.cu, at every instantiation) at row counts
below, at, between and on multiples of their block, on G2 points with
the identity, P = Q and P = -Q at both ends of the launch, against the
plain versions and, made affine, the host's P + Q and 2P. The header's
copies of p, r and their n0' must equal params.py's, and the combine
tables of csrc/fp12.cu what tools/fp12_tables.py generates.
The launch code (the `<<<...>>>` wrappers) and the card itself are
exercised only by chip_smoke.py.
"""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from crypto12381_tpu.params import P

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "crypto12381_tpu_torch" / "csrc"
R_INV = pow(1 << 384, -1, P)        # the port's Montgomery R = 2^384

torch = FP = FK = C = G1C = G2C = params = None    # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's test runs, not when the
    file is collected (every test worker collects every file)."""
    global torch, FP, FK, C, G1C, G2C, params
    import torch
    from crypto12381_tpu_torch import params
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.curves import g2 as G2C
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.host import curve as C

SHIM = """#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __grid_constant__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
inline void __syncthreads() {}
struct Dim3 { unsigned x; };
static Dim3 blockIdx, threadIdx;
typedef void* cudaStream_t;
"""

MAIN = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
// A one-row-per-thread kernel over n threads (n may run past the rows).
template <class K> void rows(K k, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    blockIdx.x = (unsigned)(i / THREADS); threadIdx.x = (unsigned)(i % THREADS); k();
  }
}
// A block-cooperative kernel: each block runs every phase over all its
// threads (in order, or reversed) before the next phase, on a fresh junk
// shared-memory array; out gets `width` words per row and a guard after.
constexpr int GUARD = 64;
template <class Ph>
std::vector<uint32_t> blocks(Ph phase, int64_t n, int per, int threads, int phases, int smem,
                             int width, bool reverse) {
  std::vector<uint32_t> out(n * width + GUARD, 0xa5a5a5a5u), sm(smem);
  for (int64_t blk = 0; blk * per < n; ++blk) {
    std::fill(sm.begin(), sm.end(), 0xdeadbeefu);
    for (int ph = 0; ph < phases; ++ph)
      for (int k = 0; k < threads; ++k)
        phase(ph, sm.data(), out.data(), blk, reverse ? threads - 1 - k : k);
  }
  return out;
}
// Both thread orders must agree and leave the guard untouched.
template <class Ph>
bool coop(std::vector<uint32_t>& o, Ph phase, int64_t n, int per, int threads, int phases,
          int smem, int width) {
  std::vector<uint32_t> f = blocks(phase, n, per, threads, phases, smem, width, false);
  std::vector<uint32_t> r = blocks(phase, n, per, threads, phases, smem, width, true);
  if (f != r) { fprintf(stderr, "thread order changes the result\n"); return false; }
  if (std::any_of(f.begin() + n * width, f.end(), [](uint32_t w) { return w != 0xa5a5a5a5u; })) {
    fprintf(stderr, "write past the last row\n");
    return false;
  }
  o.assign(f.begin(), f.begin() + n * width);
  return true;
}
// The chain kernel x^e, the product a b and the square a^2 of an N-limb
// field on n rows: the kernels one row per thread over the whole grid, with
// a guard after each output, and mont_sqr (launched by no kernel of its
// own) row by row.  The exponent comes as the C entry points get it: its
// bit length, then its (bits + 31) / 32 words; `exponent_of` must refuse
// the lengths 0 and 32 EXP_WORDS + 1.
template <int N>
int chains(const char* in, const char* outp) {
  FILE* f = fopen(in, "rb");
  int64_t n;
  int bits;
  Exponent e;
  if (fread(&n, 8, 1, f) != 1 || fread(&bits, 4, 1, f) != 1 || bits < 1) return 1;
  std::vector<uint32_t> words((bits + 31) / 32);
  if (fread(words.data(), 4, words.size(), f) != words.size()) return 1;
  if (exponent_of(words.data(), 0, &e) || exponent_of(words.data(), 32 * EXP_WORDS + 1, &e) ||
      !exponent_of(words.data(), bits, &e))
    return 3;
  std::vector<uint32_t> x(n * N), a(n * N), b(n * N), sq(n * N);
  for (auto* v : {&x, &a, &b})
    if (fread(v->data(), 4, n * N, f) != (size_t)(n * N)) return 1;
  fclose(f);
  std::vector<uint32_t> pw(n * N + GUARD, 0xa5a5a5a5u), mul(n * N + GUARD, 0xa5a5a5a5u);
  rows([&] { pow_fixed_kernel<N>(x.data(), pw.data(), e, table_entries(e), n); },
       blocks_for(n) * THREADS);
  rows([&] { mont_mul_kernel<N>(a.data(), b.data(), mul.data(), n); }, blocks_for(n) * THREADS);
  for (int64_t i = 0; i < n; ++i) mont_sqr<N>(sq.data() + i * N, a.data() + i * N);
  for (auto* o : {&pw, &mul})
    if (std::any_of(o->begin() + n * N, o->end(), [](uint32_t w) { return w != 0xa5a5a5a5u; })) {
      fprintf(stderr, "write past the last row\n");
      return 2;
    }
  FILE* g = fopen(outp, "wb");
  fwrite(pw.data(), 4, n * N, g);
  fwrite(mul.data(), 4, n * N, g);
  fwrite(sq.data(), 4, n * N, g);
  fclose(g);
  return 0;
}
// K10 (single step), K11 over k lines and, given e, the power x^e at R
// instances per block, on n rows of x (144 words a row) and the lines
// (k rows of n rows of 72 words).
template <int R>
bool fp12_r(std::vector<uint32_t>& o10, std::vector<uint32_t>& o11, std::vector<uint32_t>& opw,
            const uint32_t* x, const uint32_t* l, int k, const Exponent* e, int64_t n) {
  if (!coop(o10, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_usqr_phase<R>(ph, sm, x, out, n, blk, t); },
      n, R, K10<R>::BLOCK, K10<R>::PHASES, K10<R>::SMEM, 144)) return false;
  if (!coop(o11, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_sparse_mul_phase<R>(ph, sm, x, l, out, k, n, blk, t); },
      n, R, K11<R>::BLOCK, 2 * k + 2, K11<R>::SMEM, 144)) return false;
  if (e == nullptr) return true;
  std::vector<int> sched;                 // the kernel's own phase sequence
  cyc_pow_schedule(*e, [&](int ph) { sched.push_back(ph); });
  return coop(opw, [&](int s, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_cyc_pow_phase<R>(sched[s], sm, x, out, n, blk, t); },
      n, R, CycPow<R>::BLOCK, (int)sched.size(), CycPow<R>::SMEM, 144);
}
// Calls go(std::integral_constant<int, R>()) for R = r, one of 8, 4, 2.
template <class Go>
int with_r(int r, Go go) {
  if (r == 8) return go(std::integral_constant<int, 8>());
  if (r == 4) return go(std::integral_constant<int, 4>());
  if (r == 2) return go(std::integral_constant<int, 2>());
  return 1;
}
// K8-K11 on n rows at R instances per block, K8 in both its layouts (K8
// and K8Step): Fp12 operands x and y (144 words a row) and the sparse line
// (72 words a row); the five outputs one after another.
template <int R>
int fp12s(const char* in, const char* outp) {
  FILE* f = fopen(in, "rb");
  int64_t n;
  if (fread(&n, 8, 1, f) != 1) return 1;
  std::vector<uint32_t> x(n * 144), y(n * 144), l(n * 72), o8, o8s, o9, o10, o11, unused;
  if (fread(x.data(), 4, n * 144, f) != (size_t)(n * 144)) return 1;
  if (fread(y.data(), 4, n * 144, f) != (size_t)(n * 144)) return 1;
  if (fread(l.data(), 4, n * 72, f) != (size_t)(n * 72)) return 1;
  fclose(f);
  if (!coop(o8, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_mul_phase<R>(ph, sm, x.data(), y.data(), out, n, blk, t); },
      n, R, K8<R>::BLOCK, K8<R>::PHASES, K8<R>::SMEM, 144)) return 2;
  if (!coop(o8s, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_mul_step_phase<R>(ph, sm, x.data(), y.data(), out, n, blk, t); },
      n, R, K8Step<R>::BLOCK, K8Step<R>::PHASES, K8Step<R>::SMEM, 144)) return 2;
  if (!coop(o9, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp12_sqr_phase<R>(ph, sm, x.data(), out, n, blk, t); },
      n, R, K9<R>::BLOCK, K9<R>::PHASES, K9<R>::SMEM, 144)) return 2;
  if (!fp12_r<R>(o10, o11, unused, x.data(), l.data(), 1, nullptr, n)) return 2;
  FILE* g = fopen(outp, "wb");
  for (auto* o : {&o8, &o8s, &o9, &o10, &o11}) fwrite(o->data(), 4, n * 144, g);
  fclose(g);
  return 0;
}
// The power x^e and K11 over k lines on n rows at 8, 4 and 2 instances per
// block: input n, e's bit length and (bits + 31) / 32 words, k, x (144
// words a row), the lines (k n rows of 72 words); output the three powers,
// then the three products.
int fp12pow(const char* in, const char* outp) {
  FILE* f = fopen(in, "rb");
  int64_t n;
  int bits, k;
  Exponent e;
  if (fread(&n, 8, 1, f) != 1 || fread(&bits, 4, 1, f) != 1 || bits < 1) return 1;
  std::vector<uint32_t> words((bits + 31) / 32);
  if (fread(words.data(), 4, words.size(), f) != words.size()) return 1;
  if (fread(&k, 4, 1, f) != 1 || k < 1 || !exponent_of(words.data(), bits, &e)) return 1;
  std::vector<uint32_t> x(n * 144), l(k * n * 72), o10, o11[3], opw[3];
  if (fread(x.data(), 4, n * 144, f) != (size_t)(n * 144)) return 1;
  if (fread(l.data(), 4, k * n * 72, f) != (size_t)(k * n * 72)) return 1;
  fclose(f);
  if (!fp12_r<8>(o10, o11[0], opw[0], x.data(), l.data(), k, &e, n) ||
      !fp12_r<4>(o10, o11[1], opw[1], x.data(), l.data(), k, &e, n) ||
      !fp12_r<2>(o10, o11[2], opw[2], x.data(), l.data(), k, &e, n)) return 2;
  FILE* g = fopen(outp, "wb");
  for (auto* o : {&opw[0], &opw[1], &opw[2], &o11[0], &o11[1], &o11[2]})
    fwrite(o->data(), 4, n * 144, g);
  fclose(g);
  return 0;
}
// K12-K14 on n rows at R instances per block, K13 in both its layouts
// (K13<R, true>, and K13<8, false>, which runs at 8 only): projective P
// and Q (72 words a row) and affine Q' (48 words a row); the outputs K12
// P + Q, K13 P + Q' (pieces, then components), K14 2P one after another.
template <int R>
int g2s(const char* in, const char* outp) {
  FILE* f = fopen(in, "rb");
  int64_t n;
  if (fread(&n, 8, 1, f) != 1) return 1;
  std::vector<uint32_t> p(n * 72), q(n * 72), qa(n * 48), o12, o13, o13c, o14;
  if (fread(p.data(), 4, n * 72, f) != (size_t)(n * 72)) return 1;
  if (fread(q.data(), 4, n * 72, f) != (size_t)(n * 72)) return 1;
  if (fread(qa.data(), 4, n * 48, f) != (size_t)(n * 48)) return 1;
  fclose(f);
  if (!coop(o12, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g2_add_phase<R>(ph, sm, p.data(), q.data(), out, n, blk, t); },
      n, R, K12<R>::BLOCK, K12<R>::PHASES, K12<R>::SMEM, 72)) return 2;
  if (!coop(o13, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g2_madd_phase<R, true>(ph, sm, p.data(), qa.data(), out, n, blk, t); },
      n, R, K13<R, true>::BLOCK, K13<R, true>::PHASES, K13<R, true>::SMEM, 72)) return 2;
  if (!coop(o13c, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g2_madd_phase<8, false>(ph, sm, p.data(), qa.data(), out, n, blk, t); },
      n, 8, K13<8, false>::BLOCK, K13<8, false>::PHASES, K13<8, false>::SMEM, 72)) return 2;
  if (!coop(o14, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g2_dbl_phase<R>(ph, sm, p.data(), out, n, blk, t); },
      n, R, K14<R>::BLOCK, K14<R>::PHASES, K14<R>::SMEM, 72)) return 2;
  FILE* g = fopen(outp, "wb");
  for (auto* o : {&o12, &o13, &o13c, &o14}) fwrite(o->data(), 4, n * 72, g);
  fclose(g);
  return 0;
}
int main(int argc, char** argv) {
  if (argc == 5 && !strcmp(argv[1], "fp12"))
    return with_r(atoi(argv[2]), [&](auto rc) { return fp12s<decltype(rc)::value>(argv[3], argv[4]); });
  if (argc == 4 && !strcmp(argv[1], "fp12pow")) return fp12pow(argv[2], argv[3]);
  if (argc == 5 && !strcmp(argv[1], "g2"))
    return with_r(atoi(argv[2]), [&](auto rc) { return g2s<decltype(rc)::value>(argv[3], argv[4]); });
  if (argc == 5 && !strcmp(argv[1], "chain"))
    return argv[2][0] == '8' ? chains<8>(argv[3], argv[4]) : chains<12>(argv[3], argv[4]);
  FILE* f = fopen(argv[1], "rb");
  int64_t n;
  if (fread(&n, 8, 1, f) != 1) return 1;
  std::vector<uint32_t> a(n * 72), b(n * 72);
  if (fread(a.data(), 4, n * 72, f) != (size_t)(n * 72)) return 1;
  if (fread(b.data(), 4, n * 72, f) != (size_t)(n * 72)) return 1;
  fclose(f);
  std::vector<uint32_t> o1(n * 12), o2, o3, o4, o5, o6, o7;
  rows([&] { mont_mul_kernel<12>(a.data(), b.data(), o1.data(), n); }, n);
  if (!coop(o2, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp2_mul_phase(ph, sm, a.data(), b.data(), out, n, blk, t); },
      n, K2_ROWS, K2_BLOCK, K2_PHASES, K2_SMEM, 24)) return 2;
  if (!coop(o3, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp2_sqr_phase(ph, sm, a.data(), out, n, blk, t); },
      n, K3_ROWS, K3_BLOCK, K3_PHASES, K3_SMEM, 24)) return 2;
  if (!coop(o4, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        fp6_mul_phase(ph, sm, a.data(), b.data(), out, n, blk, t); },
      n, K4_ROWS, K4_BLOCK, K4_PHASES, K4_SMEM, 72)) return 2;
  // curve kernels: points a[0, 36n), b[0, 36n); affine points b[36n, 60n)
  if (!coop(o5, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g1_madd_phase(ph, sm, a.data(), b.data() + n * 36, out, n, blk, t); },
      n, K5_ROWS, K5_BLOCK, K5_PHASES, K5_SMEM, 36)) return 2;
  if (!coop(o6, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g1_add_phase(ph, sm, a.data(), b.data(), out, n, blk, t); },
      n, K6_ROWS, K6_BLOCK, K6_PHASES, K6_SMEM, 36)) return 2;
  if (!coop(o7, [&](int ph, uint32_t* sm, uint32_t* out, int64_t blk, int t) {
        g1_dbl_phase(ph, sm, a.data(), out, n, blk, t); },
      n, K7_ROWS, K7_BLOCK, K7_PHASES, K7_SMEM, 36)) return 2;
  FILE* g = fopen(argv[2], "wb");
  fwrite(o1.data(), 4, n * 12, g); fwrite(o2.data(), 4, n * 24, g);
  fwrite(o3.data(), 4, n * 24, g); fwrite(o4.data(), 4, n * 72, g);
  fwrite(o5.data(), 4, n * 36, g); fwrite(o6.data(), 4, n * 36, g);
  fwrite(o7.data(), 4, n * 36, g);
  fclose(g);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Compile the kernel bodies and MAIN with g++, once per test process."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel bodies with")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "inc").mkdir()
    (d / "inc" / "cuda_runtime.h").write_text(SHIM)
    bodies = []
    headers = ("fp381.cuh", "tower.cuh", "curve.cuh")
    for name in ("fp.cu", "tower.cu", "g1.cu", "fp12.cu", "g2.cu"):
        text = (CSRC / name).read_text()
        text = text[: text.index('extern "C"')]
        for line in [f'#include "{h}"' for h in headers] + ["using namespace fp381;"]:
            text = text.replace(line, "")
        bodies.append(text)
    src = ("".join(f'#include "{CSRC / h}"\n' for h in headers)
           + "using namespace fp381;\n" + "\n".join(bodies) + MAIN)
    (d / "harness.cpp").write_text(src)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{d / 'inc'}",
                    "-o", str(exe), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=300)
    return d, exe


def run(harness, av, bv):
    d, exe = harness
    n = len(av) // 6
    a = np.stack([FP.limbs_of(v) for v in av])
    b = np.stack([FP.limbs_of(v) for v in bv])
    with open(d / "in.bin", "wb") as f:
        f.write(np.int64(n).tobytes() + a.tobytes() + b.tobytes())
    subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")], check=True, timeout=300)
    o = torch.from_numpy(np.fromfile(d / "out.bin", np.int32))
    widths = ((12,), (2, 12), (2, 12), (3, 2, 12), (3, 12), (3, 12), (3, 12))
    sizes = [n * int(np.prod(w)) for w in widths]
    outs = tuple(part.reshape((n,) + w) for part, w in zip(o.split(sizes), widths))
    return torch.from_numpy(a), torch.from_numpy(b), n, outs


def rand_ints(seed, k, bound):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % bound for _ in range(k)]


def header_constants():
    """p's and r's limbs and n0' as written in fp381.cuh."""
    text = (CSRC / "fp381.cuh").read_text()
    out = []
    for arr, n0 in (("FP_P\\[NL\\]", "FP_N0"), ("FR_R\\[FR_NL\\]", "FR_N0")):
        body = re.search(arr + r" = \{([^}]*)\}", text).group(1)
        limbs = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        out.append((limbs, int(re.search(n0 + r" = (0x[0-9a-f]+)u", text).group(1), 16)))
    return tuple(out)


def run_chain(harness, F, e, xv, av, bv):
    """The chain kernel x^e, the product REDC(a b) and the square REDC(a a)
    of the field F on the host, for Montgomery-form values xv, av, bv (the
    raw limb values): (x, a, b, x^e, REDC(a b), REDC(a a))."""
    d, exe = harness
    n = len(xv)
    x, a, b = (np.stack([F.limbs_of(v) for v in vals]) for vals in (xv, av, bv))
    words = np.array([(e >> (32 * k)) & 0xFFFFFFFF for k in range((e.bit_length() + 31) // 32)],
                     np.uint32)
    with open(d / "chain.bin", "wb") as f:
        f.write(np.int64(n).tobytes() + np.int32(e.bit_length()).tobytes() + words.tobytes()
                + x.tobytes() + a.tobytes() + b.tobytes())
    subprocess.run([str(exe), "chain", str(F.limbs), str(d / "chain.bin"), str(d / "chain.out")],
                   check=True, timeout=600)
    o = torch.from_numpy(np.fromfile(d / "chain.out", np.int32)).reshape(3, n, F.limbs)
    return (*(torch.from_numpy(v) for v in (x, a, b)), o[0], o[1], o[2])


def curve_inputs(n):
    """Montgomery-form coordinate values of n projective points P, n
    projective Q and n affine Q' (the harness's K5-K7 inputs): curve points
    [k]G with random Z, the first rows the identity, P = Q (another Z) and
    P = -Q, the last rows random field values off the curve."""
    rng = np.random.default_rng(3)
    R_MOD = (1 << 384) % P

    def proj(k, z, negate=False):
        x, y = C.g1_mul(C.G1_GEN, k)
        y = P - y if negate else y
        return [x * z % P * R_MOD % P, y * z % P * R_MOD % P, z * R_MOD % P]

    def aff(k, negate=False):
        return proj(k, 1, negate)[:2]

    ks = [int(v) for v in rng.integers(2, 1 << 62, size=n)]
    zs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    ident = [0, R_MOD, 0]
    pv = ident + proj(ks[1], zs[1]) + proj(ks[2], zs[2]) + proj(ks[3], zs[3])
    qv = proj(ks[0], zs[0]) + ident + proj(ks[2], zs[5]) + proj(ks[3], zs[6], True)
    av = aff(ks[0]) + aff(ks[1]) + aff(ks[2]) + aff(ks[3], True)
    for i in range(4, n - 2):
        pv += proj(ks[i], zs[i])
        qv += proj(ks[i] + 1, zs[i - 1])
        av += aff(ks[i] * 3)
    tail = rand_ints(4, 8 * 2, P)
    pv += tail[:6]
    qv += tail[6:12]
    av += tail[12:16]
    return pv, qv, av


def test_kernel_bodies_match_plain_versions(harness):
    from crypto12381_tpu_torch import params

    assert header_constants() == ((params.P_LIMBS, params.N0),
                                  (params.FR_P_LIMBS, params.FR_N0))
    assert params.N0 * P % (1 << 32) == (1 << 32) - 1       # n0' = -p^-1 mod 2^32
    assert params.FR_N0 * params.R % (1 << 32) == (1 << 32) - 1
    n = 40
    for presum in (False, True):
        edge = [0, 1, P - 1] + ([2 * P - 2, P] if presum else [])
        bound = 2 * P - 1 if presum else P
        av = edge + rand_ints(1, 6 * n - len(edge), bound)
        bv = edge[::-1] + rand_ints(2, 6 * n - len(edge), bound)
        a, b, n, (k1, k2, k3, k4, _, _, _) = run(harness, av, bv)
        assert torch.equal(k1, FP.mont_mul_plain(a[:n], b[:n]))
        assert [FP.int_of(r) for r in k1.numpy()] == [
            x * y * R_INV % P for x, y in zip(av[:n], bv[:n])]
        if not presum:           # K2-K4 take canonical operands only
            assert torch.equal(k2, FK.fp2_mul_plain(a[: 2 * n].reshape(n, 2, 12),
                                                    b[: 2 * n].reshape(n, 2, 12)))
            assert torch.equal(k3, FK.fp2_sqr_plain(a[: 2 * n].reshape(n, 2, 12)))
            assert torch.equal(k4, FK.fp6_mul_plain(a.reshape(n, 3, 2, 12),
                                                    b.reshape(n, 3, 2, 12)))
    # K5-K7 on points: the first rows are the identity, P = Q and P = -Q
    pv, qv, affv = curve_inputs(n)
    a, b, n, (_, _, _, _, k5, k6, k7) = run(harness, pv + [0] * (3 * n),
                                             qv + affv + [0] * n)
    p, q, qa = a[: 3 * n].reshape(n, 3, 12), b[: 3 * n].reshape(n, 3, 12), b[3 * n: 5 * n]
    assert torch.equal(k5, FK.g1_madd_plain(p, qa.reshape(n, 2, 12)))
    assert torch.equal(k6, FK.g1_add_plain(p, q))
    assert torch.equal(k7, FK.g1_dbl_plain(p))
    for k in (k5, k6):                  # identity + Q = Q; P + (-P) = O
        assert FP.int_of(k[3, 2].numpy()) == 0 and FP.int_of(k[3, 0].numpy()) == 0
    assert FP.int_of(k7[0, 2].numpy()) == 0                   # 2 O = O


@pytest.mark.parametrize("n", [1, 16, 33, 47, 64, 65, 96, 130])
def test_cooperative_tower_kernels(harness, n):
    """K2 (32 instances per block), K3 (64) and K4 (16) at row counts
    below, at, between and on multiples of a block: random canonical
    operands, with rows of all p-1 (the largest pre-sums: 2p-2 raw, p-2
    reduced), all 0 and all 1 at the start of the launch, and rows of 0, 1
    and p-1 against p-1, and of p-1 against 0, 1 and p-1, at the end of
    each kernel's rows, so in its ragged last block."""
    rng = np.random.default_rng(100 + n)
    av = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(6 * n)]
    bv = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(6 * n)]
    tail = {n - 2: (P - 1, 1), n - 1: (P - 1, P - 1)}
    # K4 reads rows of 6 Fp values from av, bv; K2 rows of 2 from their first
    # 2n values, whose first 9 rows are K4's first 3 (the edges at the
    # start), and K3 the same rows of av
    for width, edges in ((6, {0: (P - 1, P - 1), 1: (0, P - 1), 2: (1, P - 1), **tail}),
                         (2, {n - 5: (0, P - 1), n - 4: (1, P - 1), n - 3: (P - 1, 0),
                              **tail})):
        for r, (x, y) in edges.items():
            if 0 <= r < n:
                av[width * r: width * r + width] = [x] * width
                bv[width * r: width * r + width] = [y] * width
    a, b, n, (_, k2, k3, k4, _, _, _) = run(harness, av, bv)
    a2 = a[: 2 * n].reshape(n, 2, 12)
    assert torch.equal(k2, FK.fp2_mul_plain(a2, b[: 2 * n].reshape(n, 2, 12)))
    assert torch.equal(k3, FK.fp2_sqr_plain(a2))
    assert torch.equal(k4, FK.fp6_mul_plain(a.reshape(n, 3, 2, 12), b.reshape(n, 3, 2, 12)))


def run_fp12(harness, x, y, line, rows):
    """K8-K11 on the host over the rows of the Fp12 operands x, y and the
    sparse line, at `rows` instances per block: (fp12_mul(x, y) in K8's
    layout and in K8Step's, fp12_sqr(x), fp12_usqr(x),
    fp12_sparse_mul(x, line))."""
    d, exe = harness
    n = x.shape[0]
    with open(d / "fp12.bin", "wb") as f:
        f.write(np.int64(n).tobytes() + x.numpy().tobytes() + y.numpy().tobytes()
                + line.numpy().tobytes())
    subprocess.run([str(exe), "fp12", str(rows), str(d / "fp12.bin"), str(d / "fp12.out")],
                   check=True, timeout=300)
    o = torch.from_numpy(np.fromfile(d / "fp12.out", np.int32))
    return o.reshape(5, n, 2, 3, 2, 12).unbind(0)


def rand_fp12(rng, shape):
    """Random canonical Fp values of `shape`: uniform words, the top one
    below p's."""
    w = rng.integers(0, 1 << 32, size=shape + (12,), dtype=np.uint64)
    w[..., 11] %= params.P_LIMBS[11]
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


#: rows of all p-1 against all p-1 (the largest pre-sums), all 0 and all 1
#: against p-1 at the start of a launch, and p-1 against 1 and against p-1
#: at its end, so in its ragged last block
def fp12_edges(n):
    return {0: (P - 1, P - 1), 1: (0, P - 1), 2: (1, P - 1), n - 2: (P - 1, 1),
            n - 1: (P - 1, P - 1)}


@pytest.mark.parametrize("rows", [8, 4, 2])
@pytest.mark.parametrize("n", [1, 7, 8, 13, 16, 17, 40])
def test_cooperative_fp12_kernels(harness, n, rows):
    """K8 (both its layouts), K9, K10 and K11 at `rows` instances per block
    (every instantiation) at row counts below, at, between and on
    multiples of a block: random canonical operands, with the edge rows of
    `fp12_edges` (the line of a row takes the second operand's value), so
    all-0, all-1 and all-(p-1) rows at both ends. Each output equals the
    plain version bit for bit; K10 as a polynomial, on inputs outside the
    cyclotomic subgroup."""
    rng = np.random.default_rng(400 + n)
    x, y, line = (rand_fp12(rng, s) for s in ((n, 2, 3, 2), (n, 2, 3, 2), (n, 3, 2)))
    for r, (u, v) in fp12_edges(n).items():
        if 0 <= r < n:
            x[r] = torch.from_numpy(FP.limbs_of(u))
            y[r] = line[r] = torch.from_numpy(FP.limbs_of(v))
    k8, k8_step, k9, k10, k11 = run_fp12(harness, x, y, line, rows)
    assert torch.equal(k8, FK.fp12_mul_plain(x, y))
    assert torch.equal(k8_step, FK.fp12_mul_plain(x, y))
    assert torch.equal(k9, FK.fp12_sqr_plain(x))
    assert torch.equal(k10, FK.fp12_usqr_plain(x))
    assert torch.equal(k11, FK.fp12_sparse_mul_plain(x, line))


def run_fp12_power(harness, x, lines, e):
    """The power x^e and K11 over the k lines (k, n, 3, 2, 12) on the host
    at 8, 4 and 2 instances per block: (the three powers, the three
    products)."""
    d, exe = harness
    n, k = x.shape[0], lines.shape[0]
    words = np.array([(e >> (32 * j)) & 0xFFFFFFFF for j in range((e.bit_length() + 31) // 32)],
                     np.uint32)
    with open(d / "pow.bin", "wb") as f:
        f.write(np.int64(n).tobytes() + np.int32(e.bit_length()).tobytes() + words.tobytes()
                + np.int32(k).tobytes() + x.numpy().tobytes() + lines.numpy().tobytes())
    subprocess.run([str(exe), "fp12pow", str(d / "pow.bin"), str(d / "pow.out")], check=True,
                   timeout=600)
    o = torch.from_numpy(np.fromfile(d / "pow.out", np.int32)).reshape(2, 3, n, 2, 3, 2, 12)
    return o[0].unbind(0), o[1].unbind(0)


@pytest.mark.parametrize("e,k", [("|x|", 1), ("0b1011", 2), ("|x|", 3), ("0b1011", 4),
                                 ("|x|", 5)])
@pytest.mark.parametrize("n", [1, 7, 8, 13, 16, 17, 40])
def test_cooperative_fp12_power_and_lines(harness, n, e, k):
    """The cyclotomic power x^e of one launch (the schedule of squares and
    products the kernel runs, through its own phase functions) and K11
    over k = 1 to 5 lines (k = 4 and 5: a third and fourth turn of its
    two-slot cp.async ring, and an odd k), each at 8, 4 and 2 instances per
    block, at the row counts of the single-step kernels, both thread
    orders, a guard after the output: at e = |x| and at 0b1011 (a square
    and a product at each of two adjacent set bits), on random canonical
    operands with the edge rows of `fp12_edges` in x and in every line.
    Each output equals the plain version bit for bit (the power as a
    polynomial, on inputs outside the cyclotomic subgroup)."""
    rng = np.random.default_rng(600 + 8 * n + k)
    e = params.X_ABS if e == "|x|" else int(e, 2)
    x = rand_fp12(rng, (n, 2, 3, 2))
    lines = rand_fp12(rng, (k, n, 3, 2))
    for r, (u, v) in fp12_edges(n).items():
        if 0 <= r < n:
            x[r] = torch.from_numpy(FP.limbs_of(u))
            lines[:, r] = torch.from_numpy(FP.limbs_of(v))
    powers, products = run_fp12_power(harness, x, lines, e)
    want_pow = FK.fp12_cyc_pow_fixed_plain(x, e)
    want_mul = FK.fp12_sparse_mul_plain(x, lines)
    for rows, got_pow, got_mul in zip((8, 4, 2), powers, products):
        assert torch.equal(got_pow, want_pow), (e, rows)
        assert torch.equal(got_mul, want_mul), (k, rows)


@pytest.mark.parametrize("n", [1, 15, 16, 33, 47, 96])
def test_cooperative_curve_kernels(harness, n):
    """K5, K6 (16 instances per block) and K7 (32) at row counts below,
    at, between and on multiples of a block: P + Q and 2P for projective P
    (random Z), affine Q (K5) and projective Q (K6, another random Z), with
    the rows O + B, A + A, (-A) + A and O + B (K5) or O + O (K6) at the
    start of the launch and again at its end, so in its ragged last block,
    and random curve points between. Each output equals the plain version
    bit for bit and, made affine, the host's P + Q and 2P."""
    rng = np.random.default_rng(200 + n)
    r_mod = (1 << 384) % P
    k_a, k_b = (int(k) for k in rng.integers(2, 1 << 62, size=2))
    # scalars of (P, K5's Q, K6's Q): O + B, A + A, (-A) + A, O + B or O + O
    edges = [(0, k_b, k_b), (k_a, k_a, k_a), (-k_a, k_a, k_a), (0, k_b, 0)]
    mid = [tuple(int(k) for k in row)
           for row in rng.integers(2, 1 << 62, size=(max(n - 8, 0), 3))]
    scalars = (edges + mid + edges)[:n] if n >= 8 else (edges + edges)[:n]

    def proj(k):                          # [k]G with a random Z
        pt = C.g1_mul(C.G1_GEN, k)
        z = int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1
        return [0, r_mod, 0] if pt is None else [pt[0] * z % P * r_mod % P,
                                                 pt[1] * z % P * r_mod % P, z * r_mod % P]

    pv, qv, av = [], [], []
    for sp, s5, s6 in scalars:
        q = C.g1_mul(C.G1_GEN, s5)
        pv += proj(sp)
        qv += proj(s6)
        av += [q[0] * r_mod % P, q[1] * r_mod % P]
    a, b, n, (_, _, _, _, k5, k6, k7) = run(harness, pv + [0] * (3 * n), qv + av + [0] * n)
    p, q = a[: 3 * n].reshape(n, 3, 12), b[: 3 * n].reshape(n, 3, 12)
    qa = b[3 * n: 5 * n].reshape(n, 2, 12)
    assert torch.equal(k5, FK.g1_madd_plain(p, qa))
    assert torch.equal(k6, FK.g1_add_plain(p, q))
    assert torch.equal(k7, FK.g1_dbl_plain(p))
    for got, want in ((k5, [sp + s5 for sp, s5, _ in scalars]),
                      (k6, [sp + s6 for sp, _, s6 in scalars]),
                      (k7, [2 * sp for sp, _, _ in scalars])):
        assert list(G1C.to_affine_ints(tuple(got.unbind(-2)))) == [
            C.g1_mul(C.G1_GEN, k) for k in want]


def run_g2(harness, p, q, qa, rows):
    """K12-K14 on the host over the rows of projective P, Q (n, 3, 2, 12)
    and affine Q' (n, 2, 2, 12), at `rows` instances per block:
    (g2_add(P, Q), g2_madd(P, Q') in K13's pieces layout and in its
    components layout (at 8 instances per block), g2_dbl(P))."""
    d, exe = harness
    n = p.shape[0]
    with open(d / "g2.bin", "wb") as f:
        f.write(np.int64(n).tobytes() + p.numpy().tobytes() + q.numpy().tobytes()
                + qa.numpy().tobytes())
    subprocess.run([str(exe), "g2", str(rows), str(d / "g2.bin"), str(d / "g2.out")],
                   check=True, timeout=300)
    o = torch.from_numpy(np.fromfile(d / "g2.out", np.int32))
    return o.reshape(4, n, 3, 2, 12).unbind(0)


@pytest.mark.parametrize("rows", [8, 4, 2])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 16, 17, 40])
def test_cooperative_g2_kernels(harness, n, rows):
    """K12, K13 and K14 at `rows` instances per block (every
    instantiation; K13 also in its components layout, at 8) at row counts
    below, at, between and on
    multiples of a block: P + Q and 2P for projective P
    (random Z), affine Q (K13) and projective Q (K12, another random Z) on
    G2, with the rows O + B, A + A, (-A) + A and O + O (K12) or O + B (K13)
    at the start of the launch and again at its end, so in its ragged last
    block, and random G2 points between. Each output equals the plain
    version bit for bit and, made affine, the host's P + Q and 2P."""
    from crypto12381_tpu_torch.host import field as HF

    rng = np.random.default_rng(500 + n)
    k_a, k_b = (int(k) for k in rng.integers(2, 1 << 62, size=2))
    # scalars of (P, K13's Q, K12's Q): O + B, A + A, (-A) + A, O + O or O + B
    edges = [(0, k_b, k_b), (k_a, k_a, k_a), (-k_a, k_a, k_a), (0, k_b, 0)]
    mid = [tuple(int(k) for k in row)
           for row in rng.integers(2, 1 << 62, size=(max(n - 8, 0), 3))]
    scalars = (edges + mid + edges)[:n] if n >= 8 else (edges + edges)[:n]

    def fp2(v):
        return [v[0], v[1]]

    def proj(k):                          # [k]G2 with a random Z in Fp2
        pt = C.g2_mul(C.G2_GEN, k % params.R)
        if pt is None:
            return [[0, 0], [1, 0], [0, 0]]
        z = tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2))
        return [fp2(HF.fp2_mul(pt[0], z)), fp2(HF.fp2_mul(pt[1], z)), fp2(z)]

    pv, qv, av = [], [], []
    for sp, s13, s12 in scalars:
        pv.append(proj(sp))
        qv.append(proj(s12))
        av.append([fp2(c) for c in C.g2_mul(C.G2_GEN, s13 % params.R)])
    p, q, qa = FP.from_int(pv), FP.from_int(qv), FP.from_int(av)
    k12, k13, k13c, k14 = run_g2(harness, p, q, qa, rows)
    assert torch.equal(k12, FK.g2_add_plain(p, q))
    assert torch.equal(k13, FK.g2_madd_plain(p, qa))
    assert torch.equal(k13c, FK.g2_madd_plain(p, qa))
    assert torch.equal(k14, FK.g2_dbl_plain(p))
    for got, want in ((k12, [sp + s12 for sp, _, s12 in scalars]),
                      (k13, [sp + s13 for sp, s13, _ in scalars]),
                      (k13c, [sp + s13 for sp, s13, _ in scalars]),
                      (k14, [2 * sp for sp, _, _ in scalars])):
        assert list(G2C.to_affine_ints(tuple(got.unbind(-3)))) == [
            C.g2_mul(C.G2_GEN, k % params.R) for k in want]


def carry_heavy(F):
    """Operand values that drive long carries through the product and the
    square: for Fp (whose product takes operands below 2p, raw sums) 0, 1,
    p - 1, p, p + 1, 2p - 2 (the largest raw sum), 2p - 1, 2^381 - 1 (below
    2p), and limbs all 0xffffffff below a top limb of 0 (below p) or of p's
    (in (p, 2p)); for Fr (canonical operands only) 0, 1, r - 1, r - 2, and
    limbs all 0xffffffff below a top limb of 0 or of r's less one."""
    m = F.modulus
    top = 32 * (F.limbs - 1)
    below = (1 << top) - 1
    if F.limbs == 8:
        return [0, 1, m - 1, m - 2, below, (m >> top << top) - 1]
    return [0, 1, m - 1, m, m + 1, 2 * m - 2, 2 * m - 1, (1 << 381) - 1, below,
            (m >> top << top) | below]


#: exponents of the chain: the paths' own (the Fermat inverse, the square
#: root, the hash to G1's inverse square root), then the window's edges: the
#: top window alone (1, 2, 3, 15), a window and squarings after it (16, 17,
#: 31), a window, 63 squarings and a window of one bit (2^64 + 1), and
#: random exponents of the longest length the kernel takes (384 bits)
CHAIN_EXPONENTS = ["p-2", "(p+1)/4", "(p-3)/4", "1", "2", "3", "15", "16", "17", "31",
                   "2^64+1", "e384"]


@pytest.mark.parametrize("n", [37, 261])
@pytest.mark.parametrize("field,exponent", [("fp", e) for e in CHAIN_EXPONENTS]
                         + [("fr", "r-2"), ("fr", "17"), ("fr", "e384")])
def test_chain_kernels(harness, field, exponent, n):
    """The power chain of one launch x^e (a 4-bit sliding window), the
    product of the same field and mont_sqr, run over the whole grid with a
    guard after the output: 37 rows (one ragged block of 128 threads) and
    261 (two full blocks and a ragged one).  The chain at each exponent of
    CHAIN_EXPONENTS (Fr: r - 2, 17, a random 384-bit e) on rows of 0, 1
    and m - 1 at both ends and random canonical values between.  The
    product and the square on the carry-heavy values at both ends (pairs
    of `carry_heavy` values in the first rows, the reverse pairs in the
    last; every pair at 261 rows), and between them random operands,
    for Fp below 2p (raw sums), for Fr canonical.  Each equals the plain
    version (the square: mont_mul_plain(a, a)) bit for bit and the host's
    integers."""
    F = FP.FP_CTX if field == "fp" else FP.FR_CTX
    m = F.modulus
    seed = 300 + len(exponent) + F.limbs + n
    if exponent not in ("p-2", "(p+1)/4", "(p-3)/4", "r-2"):     # the window's edges
        seed += 1000 * (1 + CHAIN_EXPONENTS.index(exponent))
    rng = np.random.default_rng(seed)
    e = {"p-2": m - 2, "(p+1)/4": (m + 1) // 4, "(p-3)/4": (m - 3) // 4, "r-2": m - 2,
         "2^64+1": (1 << 64) + 1,
         "e384": int.from_bytes(rng.bytes(48), "little") | (1 << 383)}.get(exponent)
    e = int(exponent) if e is None else e
    edge = [0, 1, m - 1]
    xv = edge + rand_ints(seed, n - 6, m) + edge[::-1]
    heavy = carry_heavy(F)
    pairs = [(u, heavy[-1 - i]) for i, u in enumerate(heavy)]
    pairs += [(u, v) for u in heavy for v in heavy if (u, v) not in pairs]
    pairs = pairs[: (n - 1) // 2]
    bound = 2 * m - 1 if field == "fp" else m
    mid = n - 2 * len(pairs)
    av = [u for u, _ in pairs] + rand_ints(seed + 1, mid, bound) + [v for _, v in pairs[::-1]]
    bv = [v for _, v in pairs] + rand_ints(seed + 2, mid, bound) + [u for u, _ in pairs[::-1]]
    x, a, b, pw, mul, sq = run_chain(harness, F, e, xv, av, bv)
    assert torch.equal(pw, F.pow_fixed_plain(x, e))
    r_inv, r_mod = F.r_inv, F.r_mod
    assert [F.int_of(r) for r in pw.numpy()] == [
        pow(v * r_inv % m, e, m) * r_mod % m for v in xv]
    assert torch.equal(mul, F.mont_mul_plain(a, b))
    assert [F.int_of(r) for r in mul.numpy()] == [u * v * r_inv % m for u, v in zip(av, bv)]
    assert torch.equal(sq, F.mont_mul_plain(a, a))
    assert [F.int_of(r) for r in sq.numpy()] == [u * u * r_inv % m for u in av]


@pytest.mark.parametrize("name", ["SQR", "SQR3", "USQR", "CYCMUL", "SPARSE", "MUL3"])
def test_combine_tables_match_generator(name):
    """Each combine table of csrc/fp12.cu (K9's SQR and SQR3, K10's USQR,
    the power's and K8Step's CYCMUL, K11's SPARSE, K8's MUL3) is, size
    constants and rows alike, what tools/fp12_tables.py generates from the
    algebra."""
    gen = subprocess.run([sys.executable, str(ROOT / "tools" / "fp12_tables.py")],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    pattern = re.compile(rf"// {name}: .*?\n}};\n.*?{name}_SUB\[.*?\n}};", re.S)
    want = pattern.search(gen)
    got = pattern.search((CSRC / "fp12.cu").read_text())
    assert want is not None and got is not None
    assert got.group(0) == want.group(0)
