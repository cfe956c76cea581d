#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its batched pairing,
G1 scalar multiplication, G1 MSM (scan, dense rounds and sorted), G1 point
parsing, scalar arithmetic, Pointcheval-Sanders, BBS and BBS+ batch
signing and verification, Shamir secret sharing, G2 scalar
multiplication and MSM, GT powers and pairing products, the SHA3-512
sponge and hash to Zp, BBS04 group signatures, the AC-BBS, AC-RBBS and
AC-RPS credential verifiers, multi-message PS, MHAC-BBS presentations and
their verification, the SSWU hash to G1, and the sharded MSM, pairings
and PS verification on a world of one, on one CUDA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --trace    # and one profiled call of each path

Phases, one line each; any failure raises and ends the run non-zero:
  device   card name and count, nvidia-smi's name and power limit
  build    nvcc seconds; registers, spills and shared memory per kernel
  kernels  K1-K14 at the row counts their paths give them (K1: the
           pairing's products at 2B, its power chain x^(p-2) at 512, 1024
           (PS signing's affine), 2048 and 8192 rows, x^((p+1)/4)
           (G1Vec.parse's square root) at 512 (PS verification) and 8192,
           x^((p-3)/4) (the hash to G1's inverse and square root) at 2048,
           the Fr product and the Fr chain x^(r-2) at 8192; the chain
           also at e = 1, 3, 17 and a random 384-bit e (512 rows), and the
           Fp product also on 2^20 random rows, half with an operand raised
           into [p, 2p), between rows of every pair of carry-heavy values
           (p, p + 1, 2p - 2, 2^381 - 1, limbs all 0xffffffff below the
           top, ...) at both ends, held in blocks of PLAIN_ROWS rows;
           K3 at 9B, K2 at B to 6B and 15B, K4 at 2B and 3B (the counts
           the pairing gave them before K8-K11; since then no path launches
           K3, and K4 only in the final exponentiation's inverse); K5: one
           MSM bucket step, 64 lanes x 33 windows; K6, K7: one GLV ladder
           step at B = 8192; K8-K10 at B = 2048, K8 and K9 also at 13, 512,
           519 and 1,024 rows (2, 4, 4 and 8 instances per block, random
           rows between the edge rows), K8 at 4,096 (its second layout);
           K10's cyclotomic
           power x^|x| of one launch (the final exponentiation's g^|x|) at
           B = 2048 and 512, and at 2048 also x^(2^63) (its 63 squares
           alone); K11 over k stacked lines, k = 1 at B = 2048, k = 2 and
           3 at 512 (the verifies' shared Miller loops), k = 4 at 512 (a
           product of four pairs); K12-K14, the G2 group law, at B = 2048
           (the pairing's Miller loop, the G2 ladder), each also at 13,
           512, 519 and 1,024 rows, K13 at 2,112 (the G2 MSM's bucket
           steps), K13 and K14 at 4,096; the chains, the
           power and K2-K14 each also at a row count that leaves its last
           block ragged), each held bit for bit against its plain PyTorch
           version on the card (the chains, the
           Fr product, K2-K4 and K8-K11 with edge rows at both ends, K5-K7
           and K12-K14 with the identity, P = Q and P = -Q in their first
           and last rows, checked against host points); device time of both
           (CUDA graph replays timed with CUDA events) and the kernel's time
           when issued eagerly from Python.  A chain's bound counts the
           least work of x^e: the sliding-window chain with the fewest
           multiply-adds, squarings at their own count; a doubling's bound
           (K7, K14) prices its Y^2 and Z^2 as squarings (an Fp2 one as
           the complex squaring's two products)
  ceiling  the Fp chain x^(p-2) with the card full: one launch at 2^18
           rows (its first and last 2,048 rows against the plain chain),
           products/s over the card at the least chain's 463 products a
           row, and at 1 row the ns per dependent step of the kernel's own
           chain
  pairing  `pair_batch` at B = 2048 (32 distinct pairs, tiled; counted,
           then 2 timed): GT bytes against tests/vectors/reference.json,
           bilinearity, infinity masks, 4 rows recomputed on the CPU,
           pairings/s, launches of each kernel in one batch (K2, K4, K8,
           K9, the power, K11, K13 and K14 also by row count), torch ops
           of one batch, peak device memory
  g1       `G1Vec.generator((8192,)) ** ZpVec`: 8 rows against the host
           ladder, their bytes against the host codec, 4 rows recomputed on
           the CPU, scalar multiplications/s, launches per call
  parse    `G1Vec.parse` of those 8192 points' bytes (one square-root
           chain) gives the points back; launches per call
  msm      `G1Vec.msm` at n = 2^16 (the g1 phase's 8192 points, affine,
           tiled; an identity row with a nonzero scalar, some zero scalars)
           against the host integer oracle [sum a_i s_i mod r]G; points/s,
           launches and torch ops per call, peak device memory
  msm_rounds `G1Vec.msm` at n = 2^20 (the dense-rounds route, c = 16; the
           JAX bench's size): the g1 phase's 8192 points, affine, tiled
           128 times, scalars uniform mod r from a seed, an identity row
           under a nonzero scalar and zero scalars, against the host
           oracle; a counted first call and 3 timed ones; points/s, the
           rounds R and the ladder (K5's launches by row count), launches
           by row count, torch ops, peak device memory; then one
           projective call (Z != 1 on every 7th row: the Z-inversion
           front) and one at n = 2^17 with 1,024 equal scalars (runs longer
           than 512: the scan MSM takes it), both against the oracle
  msm_sorted msm/sorted.py's MSMs, called directly (G1Vec.msm does not
           route to them): `msm_g1_sorted_staged` (every pass
           batched-affine: K1 products and one chain per pass; K6, K7 in
           the finish) on the msm_rounds projective 2^20 vector (tiled
           points: a merge pair with equal x switches to the GENERAL pass),
           a counted first call and 2 timed ones beside 2 of G1Vec.msm's
           rounds route on it; on 2^16 distinct points from one GLV call,
           FAST throughout, against [sum a_i s_i mod r]G, beside
           G1Vec.msm's scan route on them; `msm_g1_sorted` (per window, K6
           merge passes) on them; and the staged MSM, the scan and the
           rounds MSM on the msm_rounds phase's first 2^17 rows.  Passes,
           the pass at which GENERAL took over, launches, torch ops, peak
           device memory, first-call and per-call seconds, points/s
  zp       `ZpVec` + - * neg inverse at 8192 rows (0, 1 and r-1 among
           them): every row against host integers mod r, 4 rows against
           the CPU plain path; launches per call and per operation
  ps       PS on the card: the flow of tests/vectors/ps_flow.json (seed
           "seed", B = 1) byte for byte; then the JAX bench's configuration
           (seed "bench-ps", B = 512 messages b"bench-%06d"): `sign_batch`
           (the counted first call, then 3 timed ones on the same stream),
           8 signatures' s2 against the host ladder s1^(x + y m), 4 against
           the CPU path; `verify_batch` of the 512 (counted, then 2 timed),
           rotated messages (all rejected; the call whose torch ops are
           tallied), one swapped s2 (that row rejected), an x off the curve
           (raises); signs/s, verifies/s, first-call seconds, peak device
           memory, launches per sign and per verify call, and the torch ops
           of one verify call
  bbs      BBS on the card: the flow of tests/vectors/bbs_flow.json (seed
           "seed", B = 1) byte for byte; then seed "bench-bbs", setup(16),
           B = 512 messages of 112 bytes (4 Zp blocks), the last one of a
           single block: `sign_batch` (the counted first call, then 3
           timed ones on the same stream), 4 signatures against the CPU
           path and the host signer, 8 rows' A^(gamma + x) = g1 prod
           h_i^m_i in host integers; `verify_batch` of the 512 (counted,
           then 2 timed), one call with the first half's messages rotated
           (all rejected) and a swapped x in the valid second half (that
           row alone rejected), an A off the curve (raises); signs/s,
           verifies/s, first-call seconds, peak device memory, launches of
           each kernel per call and by row count, the torch ops of one
           verify call (the rejections' call)
  bbs_plus BBS+ likewise (seed "bench-bbs-plus", raw 112-byte messages,
           the last one b"bench-bbs-plus-short"; the host equation with
           h0^r)
  sss      Shamir on the card: the flow of tests/vectors/sss_flow.json
           byte for byte; then seed "bench-sss", `share_batch` at
           t = 1,000, n = 10,000 (counted, then 3 timed), 8 shares against
           the host polynomial; `reconstruct_batch` from 1,000 shares at
           indices spread over 1..10,000 (counted, then 3 timed) gives the
           secret back, 999 of them do not, and on a 16-share subset it
           equals the host reconstruction; shares/s, reconstructs/s,
           first-call seconds, peak device memory, launches per call and
           by row count, the torch ops of one reconstruct call
  g2       `G2Vec.generator((2048,)) ** ZpVec` (the GS ladder, K12 and
           K14): 8 rows against the host ladder and codec, 4 against the
           CPU path;
           `in_subgroup` true on all 2048, false on a point of E'(Fp2)
           outside G2, `clear_cofactor` of it in G2; scalar
           multiplications/s; `G2Vec.msm` at n = 4096 (the ladder's points,
           affine, tiled, two zero scalars; K12-K14) against the host
           oracle
  algebra  at B = 2048, P = g1^x, Q = g2^y: `pair_vec(P, Q)` equals
           `pair_vec(g1, g2) ** (x y)` on every row and is not one,
           `pair_prod((P, Q), (g1, g2))` equals the product of the two
           pair_vecs, `GTVec.parse(serialize())` round-trips, e(G1, G2)'s
           bytes equal tests/vectors/reference.json; pairs/s of
           `pair_vec`, GT powers/s, launches per call
  keccak   the SHA3-512 sponge (plain PyTorch) at SCHEME_B = 512 rows of 0
           to 1,100 bytes (0, 71, 72, 143, 144 and 575 among them) against
           hashlib, the same rows framed on the card (frame_device) with junk
           past each length, hash_to_zp of the digests against
           ZpNumber.from_hash; digests/s, launches and torch ops per call
  bbs04    BBS04: the bbs04_flow.json vector on the host (key_gen(4), sign,
           the host verify, open_signature) byte for byte; then seed
           "bench-bbs04", key_gen(16), one host signature per member on
           messages of 0-300 bytes, tiled to 512 rows: `verify_batch`
           (device Fiat-Shamir; counted, then 2 timed, the second with one
           row's sx + 1) 512 of 512, 4 rows against the host verify, the
           row with sx + 1 rejected alone, rotated messages all rejected
           (the call whose torch ops are tallied); `open_batch` gives each
           row's member A (its ops tallied too); verifies/s, opens/s
  ac_bbs   AC-BBS: the flow vector at n = 32, I = {0, 3}, m = 0x00; 16 more
  ac_rbbs  host presentations of its credential tiled to 512 rows:
           `verify_batch` (counted, then 2 timed, the second with one row
           tampered: AC-BBS another row's u list, AC-RBBS its t + 1) 512
           of 512, 4 rows against the host verify, the tampered row
           rejected alone, another m all rejected (the tallied call);
           verifies/s
  ac_rps   AC-RPS: the flow vector at n = 64, I = {0, 1, 3}, its verify, t1
           and t2 False (reference fault F6); 8 more host presentations
           tiled to 512 rows: `verify_batch` equals the host verify on 4
           rows, and the four GT terms of t1 and t2 of the 8 equal the host
           GT elements' bytes; verifies/s
  ps_n     the host sign and verify of PS, BBS and BBS+ on their flow
           vectors (the host pairing); multi-message PS, seed "bench-ps-n",
           key_gen_n(4), 512 messages of 1-4 units signed on the host:
           `verify_n_batch` 512 of 512, rotated messages all rejected, 4
           rows against the host verify_n; verifies/s
  mhac_bbs MHAC-BBS: the mhac_bbs_flow.json vector through the host
           functions (iss_setup(4), Prv = {0, 2}, t = 3, n = 6,
           S = {0, 2, 5}, Rev = {1}); seed "bench-mhac": `cred_pres_batch`
           of 512 presentations of the flow's credential (counted, then 2
           timed), its first 4 equal to the host cred_pres on a second
           engine of the same seed; `verify_pres_batch` of them (counted,
           then 2 timed, the second with one row carrying another row's z)
           512 of 512, 4 rows against the host verify_pres, the tampered
           row rejected alone, other public attributes all rejected (the
           tallied call); presentations/s, verifies/s
  hash_g1  `hash_to_g1` of 2,048 SHA3-512 digests, three of them 0, 1 and
           p - 1 mod p (counted, then 2 timed): 8 rows, the edges among
           them, against the host G1Element.from_hash, SHA3-512("abc")
           against reference.json, on_curve and in_subgroup on the card
           true on every row but the digest 0 mod p (the reference's
           off-curve point, F7 in ROADMAP.md); digests/s
  sharding parallel/sharding.py on a world of ONE rank (NCCL, a file://
           store in a temporary directory): `sharded_msm` at 2^16 points,
           `sharded_multi_pairing` and `sharded_batched_pairing` over 2,048
           pairs (8 tiled), `ps.verify_batch(..., mesh=...)` at B = 512 with
           a tampered message, each equal to its unsharded call on the card and each
           making one collective (D > 1 is proved on the CPU only, by
           tests/test_torch_parallel.py)
  rows     every kernel at each row count the paths launched it at that the
           kernels phase did not time, on random canonical operands: held
           bit for bit against its plain version (given at most PLAIN_ROWS
           rows at once), device time

Each path runs with the launch counts set to 0 just before it and read
just after; every kernel of the path must have launched (a scheme's
signing and verification, Shamir's sharing and reconstruction, are two
paths each; the rounds MSM's affine, projective and fallback calls three;
the msm_sorted phase's staged MSM at 2^20, 2^16 and 2^17, per-window
MSM, scans at 2^16 and 2^17 and rounds MSM at 2^17 seven;
each sharded call one;
the G2 ladder and MSM two; pair_vec, gt_pow and pair_prod three).  With
--trace, each of the pairing, g1, msm, msm_rounds, ps, bbs, bbs_plus, g2
and algebra lines also gives one call (the schemes: one verify call;
algebra: pair_vec) under torch.profiler: the summed device time of its kernels against the host
clock, and its top kernels.

Then the wall seconds of each phase, per path the kernel ms of one call
and its three largest losses (`per_call`), a JSON line of per-kernel numbers
(with each kernel's device ms at each row count it was timed at, and per
path the launch-weighted device ms and bound of one call, every launch at
its own measured row count; a power chain has an entry per exponent, and
a path's chain launches count only under the entry of their exponent;
K11 likewise an entry per line count k),
nvidia-smi's line, and as the last line {"ok": true, "device": {...}}.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import time

import numpy as np

B = 2048
DISTINCT = 32
ARGS = argparse.ArgumentParser(description="Drive the port's kernels and paths on one card.")
ARGS.add_argument("--trace", action="store_true", help="one torch.profiler call of each path")
G1_B = 8192                    # GLV batch, and the MSM's distinct points
PS_B = 512                     # the JAX bench's PS batch (bench.py:228-268)
BBS_B = 512                    # BBS and BBS+ batches: 112-byte messages, 4 Zp blocks
BBS_MSG_BYTES = 112
SSS_T, SSS_N = 1000, 10_000    # Shamir: 10,000 shares (BASELINE.json), threshold 1,000
MSM_N = 1 << 16
MSM_LANES, MSM_WINDOWS = 64, 33     # G1Vec.msm's defaults at c = 8
MSMR_N = 1 << 20               # the rounds MSM: the JAX bench's 2^20 points (bench.py:155-196)
MSMR_FALLBACK_N = 1 << 17      # the smallest rounds size, with 1,024 equal scalars: the scan
MSMR_EQUAL = 1024
MSMS_FAST_N = 1 << 16          # the sorted MSM's distinct points (FAST passes only)
SHARD_MSM_N = MSM_N            # sharding on a world of one, at the msm,
SHARD_PAIRS = B                # pairing (8 host pairs tiled)
SHARD_PS_B = PS_B              # and PS phases' sizes
G2_B = 2048                    # G2 ladder batch
G2_MSM_N = 4096
ALG_B = 2048                   # pair_vec, pair_prod and GT powers
SCHEME_B = 512                 # BBS04, AC-*, PS-N and the sponge: the PS/BBS batch
KECCAK_MAX = 1100              # the sponge phase's longest row, in bytes
BBS04_MEMBERS = 16             # key_gen(16): one host signature per member
BBS04_MAX_MSG = 300
AC_N = 32                      # AC-BBS, AC-RBBS: the reference tests' n (and I = {0, 3})
AC_PRES = 16                   # distinct host presentations, tiled to SCHEME_B
RPS_N = 64                     # AC-RPS: the reference test's n (and I = {0, 1, 3})
RPS_PRES = 8
PS_N_UNITS = 4                 # multi-message PS: key_gen_n(4), messages of 1-4 units
#: MHAC-BBS: the reference test's parameters (iss_setup(4), Prv = {0, 2},
#: t = 3, n = 6, S = {0, 2, 5}, Rev = {1}), presentations of one credential
MHAC_M, MHAC_PRV, MHAC_T, MHAC_N, MHAC_S, MHAC_REV = 4, [0, 2], 3, 6, [0, 2, 5], [1]
HASH_G1_B = 2048               # hash to G1: digests per call (the pairing's batch)
SEED = 20261016
#: 32-bit multiply-adds of one 12-limb CIOS product: 288 wide products
#: counted twice (low and high halves) plus 12 low products for m
MULADDS_PER_PRODUCT = 2 * (144 + 144) + 12
#: the same for one 8-limb Fr product
FR_MULADDS_PER_PRODUCT = 2 * (64 + 64) + 8
#: 32-bit multiply-adds of one Montgomery squaring: the 78 (Fp) or 36 (Fr)
#: distinct wide products of a*a and the reduction's 144 or 64, each counted
#: twice, plus the low products for m
SQR_MULADDS = 2 * (78 + 144) + 12
FR_SQR_MULADDS = 2 * (36 + 64) + 8
#: the least multiply-adds of one Fp2 squaring: the complex squaring's two
#: products (a0 + a1)(a0 - a1) and a0 a1, fewer than three squarings or
#: two squarings and a product
FP2_SQR_MULADDS = min(2 * MULADDS_PER_PRODUCT, 3 * SQR_MULADDS,
                      2 * SQR_MULADDS + MULADDS_PER_PRODUCT)
#: K2 and K4's row counts per pairing row: every count the pairing launches
#: them at; the first is the headline
K2_ROWS_PER_PAIR = (15, 1, 2, 3, 4, 5, 6)
K4_ROWS_PER_PAIR = (3, 2)
#: added to a headline row count, leaves the last block of K2 (32 rows per
#: block), K3 (64), K4 (16), K5 (16), K6 (16), K7 (32), K8-K11 and the
#: power (8 from 1,024 rows on, 4 from 512, else 2) and K12-K14 (as K8)
#: ragged
RAGGED = 7
#: row counts at which K8, K9 and K12-K14 run at each of their instances
#: per block (csrc/fp381.cuh `rows_per_block`), every one with random rows
#: between the edge rows: 2 at 13 rows (the last block ragged), 4 at 512 and 519
#: (ragged), 8 at 1,024 (the pairing's B and B + RAGGED add 8 at 2,048 and
#: ragged); the paths' launches below 13 rows are left to the rows phase's
#: random draws
R_COUNTS = (13, SCHEME_B, SCHEME_B + RAGGED, 1024)
#: the largest row block a plain version is given at once in the rows phase
PLAIN_ROWS = 32768
#: K1's Fp product is also held on this many random rows, half of them with
#: an operand raised into [p, 2p) (a raw sum, as K2-K14's pre-sums give it),
#: besides every pair of carry-heavy values at both ends
PRODUCT_ROWS = 1 << 20
#: the full-occupancy chain: x^(p-2) at this many rows (2,048 blocks, some
#: 15 per SM), its first and last CEILING_CHECK rows held against the plain
#: chain
CEILING_ROWS = 1 << 18
CEILING_CHECK = 2048
#: kernels of a pairing path: K1 and its chain, K2, K4 (the final
#: exponentiation's inverse), K8, K9, the cyclotomic power (the final
#: exponentiation's g^|x|), K11, and the Miller loop's G2 steps K13 (mixed
#: add) and K14 (doubling)
PAIRING = ("fp_mont_mul", "fp_pow_fixed", "fp2_mul", "fp6_mul", "fp12_mul", "fp12_sqr",
           "fp12_cyc_pow_fixed", "fp12_sparse_mul", "g2_madd", "g2_dbl")
#: kernels of a verify path with G1 ladders (GLV: K6, K7) and pairings
G1_PAIRING = PAIRING + ("g1_add", "g1_dbl")
#: kernels of a pairing path with G2 ladders (GS: K12 and K14)
G2_PAIRING = PAIRING + ("g2_add",)
#: kernel -> launches per path and row count, read right after each path
ROWS_BY_PATH: dict[str, dict[str, dict[int, int]]] = {}
#: power chain -> launches per path and (row count, exponent), read alike
EXPS_BY_PATH: dict[str, dict[str, dict[tuple[int, int], int]]] = {}
#: stacked kernel (K11) -> launches per path and (row count, k), read alike
STACKS_BY_PATH: dict[str, dict[str, dict[tuple[int, int], int]]] = {}
#: aten ops that only make a view (no kernel launch)
_VIEW_OPS = {"select", "slice", "unsqueeze", "view", "expand", "unbind", "alias",
             "as_strided", "_unsafe_view", "t", "transpose", "permute", "squeeze",
             "detach", "_reshape_alias", "split", "chunk"}


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel from nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {}).update(spill_st=int(m.group(1)), spill_ld=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["regs"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur:
            out.setdefault(cur, {})["smem"] = int(m.group(1))
    named = {}
    for mangled, v in out.items():
        for k in ("mont_mul_kernel", "pow_fixed_kernel", "fp2_mul_kernel", "fp2_sqr_kernel", "fp6_mul_kernel",
                  "g1_madd_kernel", "g1_add_kernel", "g1_dbl_kernel", "fp12_mul_kernel",
                  "fp12_mul_step_kernel",
                  "fp12_sqr_kernel", "fp12_usqr_kernel", "fp12_sparse_mul_kernel",
                  "fp12_cyc_pow_kernel",
                  "g2_madd_kernel", "g2_add_kernel", "g2_dbl_kernel"):
            if k in mangled:
                # template arguments: an int (limbs or instances per block)
                # and a bool (K13's layout), as in g2_madd_kernel<8, false>
                args = re.search(r"ILi(\d+)E(?:Lb([01])E)?", mangled)
                name = k
                if args:
                    flag = {None: "", "0": ", false", "1": ", true"}[args.group(2)]
                    name = f"{k}<{args.group(1)}{flag}>"
                named[name] = v
    return named


def _rand_fp(rng, n, k):
    """(n, k, 12) canonical limbs: uniform words, top word below p's."""
    from crypto12381_tpu_torch.params import P_LIMBS

    w = rng.integers(0, 1 << 32, size=(n, k, 12), dtype=np.uint64)
    w[..., 11] %= P_LIMBS[11]
    return w.astype(np.uint32).view(np.int32)


def _rand_fr(rng, n):
    """(n, 1, 8) canonical Fr limbs: uniform words, top word below r's."""
    from crypto12381_tpu_torch.params import FR_P_LIMBS

    w = rng.integers(0, 1 << 32, size=(n, 1, 8), dtype=np.uint64)
    w[..., 7] %= FR_P_LIMBS[7]
    return w.astype(np.uint32).view(np.int32)


def _sliding_window(e: int, w: int) -> tuple[int, int]:
    """(squarings, products) of x^e (e >= 1) by a sliding window of w bits:
    the odd powers x^3, x^5, ... up to the largest window, from x and x^2,
    then a squaring per bit after the first window and a product per later
    window."""
    bits, i, sq, mul, top = bin(e)[2:], 0, 0, 0, 1
    while i < len(bits):
        if bits[i] == "0":
            sq, i = sq + 1, i + 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        if i:
            sq, mul = sq + j - i, mul + 1
        top, i = max(top, int(bits[i:j], 2)), j
    return (sq + 1, mul + (top - 1) // 2) if top > 1 else (sq, mul)


def _least_chain(e: int, sqr_ops: int, mul_ops: int) -> dict:
    """The least work of x^e: of the sliding windows of 1 to 8 bits, the
    one whose squarings and products take the fewest 32-bit multiply-adds.
    The kernel's own chain (binary, a product per set bit) does more."""
    return min(({"window": w, "squarings": sq, "products": m, "ops": sq * sqr_ops + m * mul_ops}
                for w in range(1, 9) for sq, m in [_sliding_window(e, w)]),
               key=lambda c: c["ops"])


def _edges(x, vals, last=False):
    """Put the edge values into the first rows (every component), and with
    last=True into the last rows too (row -1 the first value); x holds Fp
    (12) or Fr (8) limbs, and keeps at least one random row between."""
    from crypto12381_tpu_torch.fields import fp as FP

    if len(x) <= len(vals) * (2 if last else 1):
        raise ValueError(f"{len(x)} rows leave no random row beside {len(vals)} edge values")
    F = FP.FP_CTX if x.shape[-1] == FP.FP_CTX.limbs else FP.FR_CTX
    for r, v in enumerate(vals):
        x[r, :, :] = F.limbs_of(v)
        if last:
            x[-1 - r, :, :] = F.limbs_of(v)
    return x


def _curve_inputs(rng, kind: str, rows: int, dev):
    """Operands of K5 (projective, affine), K6 (projective, projective) or
    K7 (projective): random canonical coordinates, with curve points in
    the first 4 rows and again in the last 4, and the host's affine
    results for those 8 rows. Rows: O + B, A + A (the two A with different
    Z), (-A) + A, O + O (K5: O + B in the fourth row); K7 doubles the
    first operand."""
    import torch
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import P

    k_a, k_b = (int(k) for k in rng.integers(2, 1 << 62, size=2))
    A, B = C.g1_mul(C.G1_GEN, k_a), C.g1_mul(C.G1_GEN, k_b)
    z1, z2 = (int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
    A2 = C.g1_mul(A, 2)

    def proj(pt, z):
        return [pt[0] * z % P, pt[1] * z % P, z]

    neg_a = (A[0], P - A[1])
    O = [0, 1, 0]
    def fill(k, pts):
        x = torch.from_numpy(_rand_fp(rng, rows, k))
        x[:4] = x[-4:] = FP.from_int(pts)
        return x.to(dev)

    p = fill(3, [O, proj(A, z1), proj(neg_a, z1), O])
    if kind == "g1_dbl":
        return (p,), [None, A2, (A2[0], P - A2[1]), None] * 2
    if kind == "g1_madd":
        return (p, fill(2, [list(B), list(A), list(A), list(B)])), [B, A2, None, B] * 2
    return (p, fill(3, [proj(B, z2), proj(A, z2), proj(A, z2), O])), [B, A2, None, None] * 2


def _curve2_inputs(rng, kind: str, rows: int, dev):
    """_curve_inputs on G2: operands of K13 (projective, affine), K12
    (projective, projective) or K14 (projective), random canonical
    coordinates with G2 points in the first 4 rows and again in the last 4,
    and the host's affine results for those 8 rows: O + B, A + A (the two A
    with different Z), (-A) + A, O + O (K13: O + B in the fourth row); K14
    doubles the first operand; more than 8 rows, so that some are random."""
    import torch
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.host import field as HF
    from crypto12381_tpu_torch.params import P

    k_a, k_b = (int(k) for k in rng.integers(2, 1 << 62, size=2))
    A, B = C.g2_mul(C.G2_GEN, k_a), C.g2_mul(C.G2_GEN, k_b)
    z1, z2 = (tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
              for _ in range(2))
    A2 = C.g2_add(A, A)

    def proj(pt, z):
        return [list(HF.fp2_mul(pt[0], z)), list(HF.fp2_mul(pt[1], z)), list(z)]

    def aff(pt):
        return [list(pt[0]), list(pt[1])]

    O = [[0, 0], [1, 0], [0, 0]]

    def fill(k, pts):
        x = torch.from_numpy(_rand_fp(rng, rows, 2 * k)).reshape(rows, k, 2, 12)
        x[:4] = x[-4:] = FP.from_int(pts)
        return x.to(dev)

    if rows <= 8:
        raise ValueError(f"{rows} rows leave no random row beside the 8 edge rows")
    p = fill(3, [O, proj(A, z1), proj(C.g2_neg(A), z1), O])
    if kind == "g2_dbl":
        return (p,), [None, A2, C.g2_neg(A2), None] * 2
    if kind == "g2_madd":
        return (p, fill(2, [aff(B), aff(A), aff(A), aff(B)])), [B, A2, None, B] * 2
    return (p, fill(3, [proj(B, z2), proj(A, z2), proj(A, z2), O])), [B, A2, None, None] * 2


def _eager_ms(fn, reps: int = 20) -> float:
    """CUDA-event time per call of fn issued from Python, after a warm-up:
    at these sizes the rate at which the host issues the launches."""
    import torch

    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """CUDA-event time per call of fn on the card alone: reps calls are
    captured once in a CUDA graph, and the graph's replays are timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def _carry_heavy(p: int) -> list[int]:
    """Fp operand values that drive long carries through the product: 0,
    1, p - 1, p, p + 1, 2p - 2, 2^381 - 1 (below 2p), and limbs all
    0xffffffff below a top limb of 0 (below p) or of p's (in (p, 2p))."""
    below = (1 << 352) - 1
    return [0, 1, p - 1, p, p + 1, 2 * p - 2, (1 << 381) - 1, below, (p >> 352 << 352) | below]


def _check_product(dev) -> dict:
    """K1's Fp product on PRODUCT_ROWS random rows between the carry-heavy
    rows: every pair of `_carry_heavy` values in the first rows and again,
    reversed, in the last; random canonical operands between, a raised into
    [p, 2p) on even rows and b on rows 0 and 3 mod 4.  Held bit for bit
    against mont_mul_plain, PLAIN_ROWS rows at a time (the plain version's
    int64 columns over all rows at once would not fit the card)."""
    import torch
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.params import P

    rng = np.random.default_rng(SEED + 7)
    heavy = _carry_heavy(P)
    pairs = np.array([[FP.limbs_of(u), FP.limbs_of(v)] for u in heavy for v in heavy])
    n = PRODUCT_ROWS + 2 * len(pairs)
    a, b = (torch.from_numpy(_rand_fp(rng, n, 1)[:, 0]).to(dev) for _ in range(2))
    p = torch.from_numpy(FP.limbs_of(P)).to(dev).expand_as(a)
    row = torch.arange(n, device=dev)[:, None]
    a = torch.where(row % 2 == 0, FP.add_raw(a, p), a)
    b = torch.where(row % 4 % 3 == 0, FP.add_raw(b, p), b)
    ends = torch.from_numpy(pairs).to(dev)
    a[: len(pairs)], b[: len(pairs)] = ends[:, 0], ends[:, 1]
    a[-len(pairs):], b[-len(pairs):] = ends.flip(0)[:, 0], ends.flip(0)[:, 1]
    got = FP.mont_mul(a, b)
    torch.cuda.synchronize()
    for i in range(0, n, PLAIN_ROWS):
        j = min(i + PLAIN_ROWS, n)
        if not torch.equal(got[i:j], FP.mont_mul_plain(a[i:j], b[i:j])):
            raise SystemExit(f"kernels: K1 mont_mul (Fp) disagrees with its plain version on "
                             f"the random rows {i}-{j} of {n}")
    return {"rows": n, "carry_heavy_rows": 2 * len(pairs),
            "ms": _device_ms(lambda: FP.mont_mul(a, b))}


def phase_kernels(dev):
    import torch
    from crypto12381_tpu_torch import _build
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.curves import g2 as G2C
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.params import X_ABS, P

    rng = np.random.default_rng(SEED)
    edge = [0, 1, P - 1]
    specs = []
    # K1: 2 rows per pairing row; a quarter of the operands are pre-sums
    n = 2 * B
    a = _edges(_rand_fp(rng, n, 1), edge)
    b = _edges(_rand_fp(rng, n, 1), edge[::-1])
    a, b = torch.from_numpy(a[:, 0]).to(dev), torch.from_numpy(b[:, 0]).to(dev)
    q = n // 4
    a[3:q] = FP.add_raw(a[3:q], b[3:q])                    # pre-sums below 2p
    top = torch.from_numpy(FP.limbs_of(2 * P - 2)).to(dev)
    a[q] = b[q] = a[q + 1] = top                          # (2p-2)^2, (2p-2)*0
    b[q + 1] = 0
    k1 = ("crypto12381_tpu_torch/csrc/fp.cu", "crypto12381_tpu/fields/fp32.py:354")
    specs.append(("K1 mont_mul (Fp)", "fp_mont_mul", *k1, FP.mont_mul, FP.mont_mul_plain,
                  {n: (a, b)}, n, MULADDS_PER_PRODUCT, None, {}))

    def field_rows(F, r, vals):
        """r random canonical rows of F, the values vals at both ends."""
        x = _rand_fp(rng, r, 1) if F is FP.FP_CTX else _rand_fr(rng, r)
        return torch.from_numpy(_edges(x, vals, last=True)[:, 0]).to(dev)

    # The Fr product at the zp phase's 8,192 rows and a ragged count.  K1's
    # power chain, one launch per chain, an entry per exponent: the Fermat
    # inversion x^(p-2) at the row counts of the MSM (512) and the pairing
    # (2,048) and at 8,192, the square root x^((p+1)/4) of G1Vec.parse at
    # 8,192 and the Fr inversion x^(r-2) of the zp phase at 8,192, each also
    # at a ragged count; the PS phase's chains, x^(p-2) at 1,024 (the
    # affine of sign's 2B-row ladder) and x^((p+1)/4) at 512 (verify's
    # parse), each with a ragged count; and the hash to G1's x^((p-3)/4)
    # (invsqrt) at its 2,048 rows and a ragged count.  Edge rows 0, 1 and
    # m-1 at both ends.
    fr = FP.FR_CTX
    r_edge = [0, 1, fr.modulus - 1]
    fr_counts = (G1_B, G1_B + RAGGED)
    specs.append(("K1 mont_mul (Fr)", "fr_mont_mul", *k1, fr.mont_mul, fr.mont_mul_plain,
                  {r: (field_rows(fr, r, r_edge), field_rows(fr, r, r_edge[::-1]))
                   for r in fr_counts}, G1_B, FR_MULADDS_PER_PRODUCT, None, {}))
    # Besides the exponents the paths launch, the chain at e = 1 (the top
    # window alone), 3, 17 (a window, a run of squarings, a window of one
    # bit) and a random 384-bit e (the longest the kernel takes), at 512 rows
    e384 = int.from_bytes(rng.bytes(48), "little") | (1 << 383)
    for F, label, e, counts, headline in (
        (FP.FP_CTX, "p-2", P - 2, (B // 4, 2 * PS_B, B, G1_B, B + RAGGED, 2 * PS_B + RAGGED), B),
        (FP.FP_CTX, "(p+1)/4", (P + 1) // 4, (PS_B, G1_B, PS_B + RAGGED, G1_B + RAGGED), G1_B),
        (FP.FP_CTX, "(p-3)/4", (P - 3) // 4, (HASH_G1_B, HASH_G1_B + RAGGED), HASH_G1_B),
        (fr, "r-2", fr.modulus - 2, fr_counts, G1_B),
        *((FP.FP_CTX, label, e, (SCHEME_B,), SCHEME_B)
          for label, e in (("1", 1), ("3", 3), ("17", 17), ("e384", e384))),
    ):
        costs = ((SQR_MULADDS, MULADDS_PER_PRODUCT) if F is FP.FP_CTX
                 else (FR_SQR_MULADDS, FR_MULADDS_PER_PRODUCT))
        least = _least_chain(e, *costs)
        specs.append((f"K1 pow_fixed ({F.name.capitalize()}) x^({label})", f"{F.name}_pow_fixed",
                      *k1, (lambda F, e: lambda x: F.pow_fixed(x, e))(F, e),
                      (lambda F, e: lambda x: F.pow_fixed_plain(x, e))(F, e),
                      {r: (field_rows(F, r, [0, 1, F.modulus - 1]),) for r in counts}, headline,
                      least.pop("ops"), None, {"exponent": e, "least_chain": least}))
    # K2: B to 6B (the line coefficients, G2 steps and Frobenius maps) and
    # 15B (the sparse product's rows before K11); K3: 9B (the cyclotomic
    # square's before K10); K4: 3B and 2B (the Fp12 product's and square's
    # before K8 and K9), each also at a ragged count.  Each carries edge rows
    # at both ends, all p-1 against all p-1 among them (the largest pre-sums).
    tower_edge = ([0, 1, P - 1, P - 1], [P - 1, 1, 0, P - 1])
    for name, per_pair, shape, prod, n_in, kern, plain, line in (
        ("K2 fp2_mul", K2_ROWS_PER_PAIR, (2,), 3, 2, FK.fp2_mul, FK.fp2_mul_plain, 379),
        ("K3 fp2_sqr", (9,), (2,), 2, 1, FK.fp2_sqr, FK.fp2_sqr_plain, 790),
        ("K4 fp6_mul", K4_ROWS_PER_PAIR, (3, 2), 18, 2, FK.fp6_mul, FK.fp6_mul_plain, 387),
    ):
        k = int(np.prod(shape))
        counts = [m * B for m in per_pair] + [per_pair[0] * B + RAGGED]
        ins = {}
        for rows in counts:
            ins[rows] = tuple(
                torch.from_numpy(_edges(_rand_fp(rng, rows, k), tower_edge[i], last=True)
                                 .reshape((rows,) + shape + (12,))).to(dev)
                for i in range(n_in))
        specs.append((name, name.split()[1], "crypto12381_tpu_torch/csrc/tower.cu",
                      f"crypto12381_tpu/fields/fp32k.py:{line}", kern, plain, ins, counts[0],
                      prod * MULADDS_PER_PRODUCT, None, {}))
    # K8-K10: the pairing's B rows (the Miller loop's squares, the final
    # exponentiation's products, the GT power's cyclotomic squares) and a
    # ragged count, K8 and K9 also at R_COUNTS, K8 at 4,096 (its layout from
    # 4,096 rows on, csrc/fp12.cu K8_STEP_ROWS); edge rows at both ends as
    # K2-K4's, all p-1 against all p-1 among them (the largest pre-sums).
    # The rows phase adds every other count the paths launch them at.
    def fp12_ins(rows, shapes, k=None):
        """Operands of these row shapes at `rows` rows with tower_edge's
        edge rows at both ends; with k, the second is a stack of k such
        operands (K11's lines, (k, rows, 3, 2, 12))."""
        def one(i, shape):
            return _edges(_rand_fp(rng, rows, int(np.prod(shape))), tower_edge[i],
                          last=True).reshape((rows,) + shape + (12,))
        return tuple(torch.from_numpy(np.stack([one(i, shape) for _ in range(k)])
                                      if k and i == 1 else one(i, shape)).to(dev)
                     for i, shape in enumerate(shapes))

    fp12 = ("crypto12381_tpu_torch/csrc/fp12.cu", "crypto12381_tpu/fields/fp32k.py:")
    for name, shapes, prod, kern, plain, line, counts in (
        ("K8 fp12_mul", ((2, 3, 2), (2, 3, 2)), 54, FK.fp12_mul, FK.fp12_mul_plain, 394,
         R_COUNTS + (2 * B,)),
        ("K9 fp12_sqr", ((2, 3, 2),), 36, FK.fp12_sqr, FK.fp12_sqr_plain, 410, R_COUNTS),
        ("K10 fp12_usqr", ((2, 3, 2),), 18, FK.fp12_usqr, FK.fp12_usqr_plain, 424, ()),
    ):
        specs.append((name, name.split()[1], fp12[0], f"{fp12[1]}{line}", kern, plain,
                      {rows: fp12_ins(rows, shapes) for rows in (B, B + RAGGED, *counts)}, B,
                      prod * MULADDS_PER_PRODUCT, None, {}))
    # K10's power x^|x| of one launch (the final exponentiation's g^|x|; it
    # replaces 63 K10 and 5 K8 launches): at the pairing's B rows, the
    # verifies' 512 and a ragged count; its bound the chain's own products,
    # (bits - 1) squares of 18 and (set bits - 1) products of 54
    e = X_ABS
    specs.append(("K10 fp12_cyc_pow_fixed x^|x|", "fp12_cyc_pow_fixed", fp12[0],
                  f"{fp12[1]}424", (lambda x: FK.fp12_cyc_pow_fixed(x, e)),
                  (lambda x: FK.fp12_cyc_pow_fixed_plain(x, e)),
                  {rows: fp12_ins(rows, ((2, 3, 2),)) for rows in (B, SCHEME_B, B + RAGGED)}, B,
                  ((e.bit_length() - 1) * 18 + (bin(e).count("1") - 1) * 54)
                  * MULADDS_PER_PRODUCT, None, {"exponent": e}))
    # K11 over k stacked lines (one launch per Miller digit step): k = 1 at
    # the pairing's B rows, k = 2 and 3 at the verifies' 512 (BBS and PS),
    # each also at a ragged count, and k = 4 (a product of four or more
    # pairs: a third turn of the line ring) at 512; every line with the
    # edge rows
    for k, rows, counts in ((1, B, (B + RAGGED,)), (2, SCHEME_B, (SCHEME_B + RAGGED,)),
                            (3, SCHEME_B, (SCHEME_B + RAGGED,)), (4, SCHEME_B, ())):
        specs.append((f"K11 fp12_sparse_mul k={k}", "fp12_sparse_mul", fp12[0], f"{fp12[1]}464",
                      FK.fp12_sparse_mul, FK.fp12_sparse_mul_plain,
                      {r: fp12_ins(r, ((2, 3, 2), (3, 2)), k) for r in (rows, *counts)},
                      rows, k * 45 * MULADDS_PER_PRODUCT, None, {"stack": k, "row_dims": (0, 1)}))
    # K5: one MSM bucket step (lanes x windows rows); K6, K7: one GLV ladder
    # step of the g1 phase's batch; each also at a ragged row count (blocks
    # of 16, 16 and 32 instances), with the edge rows in the last block.
    # The bound's work: the Fp products, a doubling's Y^2 and Z^2 (K7, K14)
    # at a squaring's least count
    M = MULADDS_PER_PRODUCT
    for name, rows, muladds, kern, plain, line in (
        ("K5 g1_madd", MSM_LANES * MSM_WINDOWS, 11 * M, FK.g1_madd, FK.g1_madd_plain, 660),
        ("K6 g1_add", G1_B, 12 * M, FK.g1_add, FK.g1_add_plain, 771),
        ("K7 g1_dbl", G1_B, 6 * M + 2 * SQR_MULADDS, FK.g1_dbl, FK.g1_dbl_plain, 734),
    ):
        ins, edge_want = {}, {}
        for r in (rows, rows + RAGGED):
            ins[r], edge_want[r] = _curve_inputs(rng, name.split()[1], r, dev)
        specs.append((name, name.split()[1], "crypto12381_tpu_torch/csrc/g1.cu",
                      f"crypto12381_tpu/fields/fp32k.py:{line}", kern, plain, ins, rows,
                      muladds, edge_want, {}))
    # K12-K14: the G2 group law at the pairing's and the G2 ladder's 2,048
    # rows and at a ragged count, the edge rows in the first and the last
    # block; each also at R_COUNTS, K13 at the G2 MSM's bucket steps (lanes x
    # windows rows) and K13 and K14 at its 4,096; the rows phase adds the
    # other counts (the Miller loops' fixed points at 1 row, the MSM's trees)
    for name, muladds, kern, plain, line, counts in (
        ("K12 g2_add", 36 * M, FK.g2_add, FK.g2_add_plain, 781, R_COUNTS),
        ("K13 g2_madd", 33 * M, FK.g2_madd, FK.g2_madd_plain, 667,
         R_COUNTS + (MSM_LANES * MSM_WINDOWS, 2 * B)),
        ("K14 g2_dbl", 18 * M + 2 * FP2_SQR_MULADDS, FK.g2_dbl, FK.g2_dbl_plain, 741,
         R_COUNTS + (2 * B,)),
    ):
        ins, edge_want = {}, {}
        for r in (B, B + RAGGED, *counts):
            ins[r], edge_want[r] = _curve2_inputs(rng, name.split()[1], r, dev)
        specs.append((name, name.split()[1], "crypto12381_tpu_torch/csrc/g2.cu",
                      f"crypto12381_tpu/fields/fp32k.py:{line}", kern, plain, ins, B,
                      muladds, edge_want, {}))
    results = []
    product_rows = _check_product(dev)
    for (name, fn_c, src, repl, kern, plain, ins_by_rows, rows, ops_per_row, edge_want,
         extra) in specs:
        ms_by_rows, outs, err = {}, {}, 0.0
        for r, ins in sorted(ins_by_rows.items()):
            got = outs[r] = kern(*ins)
            want = plain(*ins)
            torch.cuda.synchronize()
            if got.dtype != torch.int32 or not torch.equal(got, want):
                bad = (got != want).reshape(r, -1).any(-1).nonzero()[:5].flatten().tolist()
                raise SystemExit(f"kernels: {name} disagrees with its plain version at "
                                 f"{r} rows, rows {bad}")
            err = max(err, float((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()))
            if edge_want is not None:
                ends = torch.cat([got[:4], got[-4:]])
                g2 = fn_c.startswith("g2_")
                edge_got = list((G2C if g2 else G1C).to_affine_ints(
                    tuple(ends.unbind(-3 if g2 else -2))))
                if edge_got != edge_want[r]:
                    raise SystemExit(f"kernels: {name} gives wrong points at the identity, "
                                     f"P = Q or P = -Q at {r} rows: {edge_got} != "
                                     f"{edge_want[r]}")
            ms_by_rows[r] = _device_ms(lambda: kern(*ins))
        ins, got = ins_by_rows[rows], outs[rows]
        more = {}
        if fn_c == "fp12_cyc_pow_fixed":
            # the power's squares alone, x^(2^(bits - 1)): what its product steps cost
            sq = 1 << (extra["exponent"].bit_length() - 1)
            if not torch.equal(FK.fp12_cyc_pow_fixed(ins[0], sq),
                               FK.fp12_cyc_pow_fixed_plain(ins[0], sq)):
                raise SystemExit(f"kernels: {name} disagrees with its plain version at "
                                 f"e = 2^{sq.bit_length() - 1}")
            more["ms_squares_only"] = _device_ms(lambda: FK.fp12_cyc_pow_fixed(ins[0], sq))
        eager_ms = _eager_ms(lambda: kern(*ins))
        # a plain chain is hundreds of plain products: one per graph
        plain_ms = _device_ms(lambda: plain(*ins),
                              reps=1 if fn_c in _build.EXPONENT_FNS else 20)
        bytes_per_row = 4 * (sum(t.numel() for t in ins) + got.numel()) // rows
        bound_ms, bound_by = _bound(bytes_per_row, ops_per_row, rows)
        row_dims = extra.get("row_dims", (0,) * len(ins))
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "c_function": fn_c, "rows": rows, "max_abs_err": err, "ms": ms_by_rows[rows],
            "ms_by_rows": ms_by_rows, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bytes_per_row": bytes_per_row, "ops_per_row": ops_per_row,
            "fns": (kern, plain), "row_dims": row_dims,
            "row_shapes": [tuple(t.shape[:d] + t.shape[d + 1:]) for t, d in zip(ins, row_dims)],
            "exponent": extra.get("exponent"), "stack": extra.get("stack"),
            **({"least_chain": extra["least_chain"]} if "least_chain" in extra else {}),
            **({"random_rows": product_rows} if fn_c == "fp_mont_mul" else {}),
            **more,
        })
    line = "; ".join(
        f"{r['name']} rows={r['rows']} equal=True ms={r['ms']:.6f} eager_ms={r['eager_ms']:.6f} "
        f"plain_ms={r['plain_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']})"
        + (f" least_chain={r['least_chain']}" if "least_chain" in r else "")
        + (f" random_rows={r['random_rows']}" if "random_rows" in r else "")
        + (f" ms_squares_only={r['ms_squares_only']:.6f}" if "ms_squares_only" in r else "")
        + (f" ms_by_rows={ {k: round(v, 6) for k, v in r['ms_by_rows'].items()} }"
           if len(r["ms_by_rows"]) > 1 else "")
        for r in results)
    print(f"kernels: {line}", flush=True)
    return results


def _bound(bytes_per_row: int, ops_per_row: int, rows: int):
    """The least time of a launch over `rows` rows: the larger of its bytes
    over the memory rate and its 32-bit multiply-adds over the integer
    rate (utils/profiling.py `bound`: the H100 SXM5's peaks at 700 W), in
    ms, and which of the two it is."""
    from crypto12381_tpu_torch.utils.profiling import bound

    t, by = bound(rows * bytes_per_row, rows * ops_per_row)
    return t * 1e3, by


def phase_ceiling(dev, steps: int | None = None) -> dict:
    """The product's rate with the card full: one `fp_pow_fixed` x^(p-2)
    launch at CEILING_ROWS rows (2,048 blocks), its first and last
    CEILING_CHECK rows held against the plain chain, timed; and the same
    launch at 1 row, its time per dependent step.  products_per_s counts the
    least chain, 378 squarings + 85 products a row, whatever chain the
    kernel runs; ns_per_step divides by `steps`, the kernel's own steps
    (default: its 4-bit sliding window, whose table holds the odd powers
    up to e's largest window, as `_sliding_window` counts them)."""
    import torch
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.params import P

    e = P - 2
    work = sum(_sliding_window(e, 4))     # 378 + 85, csrc/fp.cu's chain
    steps = steps or work
    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy(_edges(_rand_fp(rng, CEILING_ROWS, 1), [0, 1, P - 1], last=True)[:, 0])
    x = x.to(dev)
    got = FP.pow_fixed(x, e)
    torch.cuda.synchronize()
    for part in (slice(0, CEILING_CHECK), slice(CEILING_ROWS - CEILING_CHECK, CEILING_ROWS)):
        if not torch.equal(got[part], FP.pow_fixed_plain(x[part], e)):
            raise SystemExit(f"ceiling: x^(p-2) disagrees with the plain chain on rows {part}")
    ms = _device_ms(lambda: FP.pow_fixed(x, e), reps=5)
    one = x[1000:1001].contiguous()
    ms_1 = _device_ms(lambda: FP.pow_fixed(one, e))
    out = {"rows": CEILING_ROWS, "ms": ms, "products_per_s": work * CEILING_ROWS / ms * 1e3,
           "ms_1row": ms_1, "steps": steps, "ns_per_step_1row": ms_1 * 1e6 / steps}
    print(f"ceiling: equal=True {json.dumps(out)}", flush=True)
    return out


def phase_rows(dev, kernels) -> None:
    """Each kernel at every row count the paths launched it at that the
    kernels phase did not time: random canonical operands of the kernel's
    row shapes, held bit for bit against the plain version, then timed.
    The operands at r rows are the first r rows of one draw at the
    kernel's largest such count, and the plain version, which computes
    each row from that row alone, runs once on the whole draw: its first
    r rows are its result at r rows (a plain chain is some 600 plain
    products, so it runs once per kernel, not once per count).  The
    smallest count is also held on a draw of its own, so that a kernel
    that read past its rows would disagree there."""
    import torch

    rng = np.random.default_rng(SEED + 4)
    done = []
    for k in kernels:
        t0 = time.perf_counter()
        kern, plain = k["fns"]
        rows = sorted({r for per in _launch_rows(k).values() for r in per}
                      - set(k["ms_by_rows"]))

        def draw(r):
            # each operand's rows along its row dim (K11's lines: dim 1)
            return tuple(torch.from_numpy(
                _rand_fr(rng, r) if shape == (8,)
                else _rand_fp(rng, r * int(np.prod(shape[:d])), int(np.prod(shape[d:-1])))
            ).reshape(shape[:d] + (r,) + shape[d:]).to(dev)
                for shape, d in zip(k["row_shapes"], k["row_dims"]))

        def rows_of(ins, i, j):
            return tuple(t.narrow(d, i, j - i).contiguous() for t, d in zip(ins, k["row_dims"]))

        def plain_of(ins):
            # row block by row block: the plain version's int64 columns at
            # the largest counts would not fit the card at once
            r = ins[0].shape[0]
            return torch.cat([plain(*rows_of(ins, i, min(i + PLAIN_ROWS, r)))
                              for i in range(0, r, PLAIN_ROWS)])

        if rows:
            whole = draw(rows[-1])
            want = plain_of(whole)
            own = draw(rows[0])
            if not torch.equal(kern(*own), plain_of(own)):
                raise SystemExit(f"rows: {k['name']} disagrees with its plain version at "
                                 f"{rows[0]} rows on a draw of its own")
        for r in rows:
            ins = rows_of(whole, 0, r)
            got = kern(*ins)
            torch.cuda.synchronize()
            if not torch.equal(got, want[:r]):
                raise SystemExit(f"rows: {k['name']} disagrees with its plain version at {r} rows")
            k["ms_by_rows"][r] = _device_ms(lambda: kern(*ins))
        k["ms_by_rows"] = dict(sorted(k["ms_by_rows"].items()))
        done.append(f"{k['name']} timed_rows={rows} s={time.perf_counter() - t0:.1f}")
    print(f"rows: equal=True {'; '.join(done)}", flush=True)


def _launch_rows(k: dict) -> dict:
    """Per path, the kernel's launches in one call by row count; a power
    chain's only those at its own exponent, K11's those at its own k."""
    fn, e, st = k["c_function"], k["exponent"], k["stack"]
    if e is None and st is None:
        return {path: rows[fn] for path, rows in ROWS_BY_PATH.items() if fn in rows}
    key, by_path = (e, EXPS_BY_PATH) if e is not None else (st, STACKS_BY_PATH)
    out = {}
    for path, keyed in by_path.items():
        rows = {r: c for (r, kk), c in sorted(keyed.get(fn, {}).items()) if kk == key}
        if rows:
            out[path] = rows
    return out


def _check_chains_timed(kernels) -> None:
    """Fails if a path launched a power chain at an exponent, or K11 at a
    line count k, that has no entry in the kernels phase (then it was never
    held against its plain version, nor timed)."""
    for field, by_path in (("exponent", EXPS_BY_PATH), ("stack", STACKS_BY_PATH)):
        have = {(k["c_function"], k[field]) for k in kernels}
        for path, keyed in by_path.items():
            for fn, counts in keyed.items():
                for _, key in counts:
                    if (fn, key) not in have:
                        raise SystemExit(f"{path}: {fn} launched at {field} {key:#x}, which "
                                         f"the kernels phase did not check")


def _weighted(k: dict) -> None:
    """Per path: the kernel's launch-weighted device ms and bound of one
    call, each launch at its own row count, every one of which was timed."""
    ms = k["ms_by_rows"]
    out = {}
    for path, rows in k.pop("launch_rows_by_path").items():
        out[path] = {
            "launch_rows": rows,
            "ms": sum(c * ms[r] for r, c in rows.items()),
            "bound_ms": sum(c * _bound(k["bytes_per_row"], k["ops_per_row"], r)[0]
                            for r, c in rows.items()),
        }
    k["weighted_by_path"] = out


def _per_call(kernels) -> dict:
    """Per path: the launch-weighted device ms of one call summed over its
    kernels, and the three kernel entries that lose the most to their
    bounds (launches x (ms - bound), each launch at its own row count)."""
    out = {}
    for k in kernels:
        for path, w in k["weighted_by_path"].items():
            p = out.setdefault(path, {"ms": 0.0, "loss": {}})
            p["ms"] += w["ms"]
            p["loss"][k["name"]] = w["ms"] - w["bound_ms"]
    return {path: {"ms": round(p["ms"], 6),
                   "top_loss": sorted(((n, round(v, 6)) for n, v in p["loss"].items()),
                                      key=lambda t: -t[1])[:3]}
            for path, p in sorted(out.items())}


def _path_launches(path: str, kernels) -> dict:
    """The launch counts since the last reset (and, in ROWS_BY_PATH, per
    row count; in EXPS_BY_PATH, a power chain's per row count and
    exponent); fails if a kernel of the path never launched."""
    import crypto12381_tpu_torch as T

    launches = {k: T.LAUNCHES[k] for k in kernels}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"{path}: kernels never launched on the path: {missing}")
    ROWS_BY_PATH[path] = {k: dict(sorted(T.LAUNCH_ROWS[k].items())) for k in kernels}
    EXPS_BY_PATH[path] = {k: dict(T.LAUNCH_EXPONENTS[k]) for k in kernels
                          if k in T.LAUNCH_EXPONENTS}
    STACKS_BY_PATH[path] = {k: dict(T.LAUNCH_STACKS[k]) for k in kernels
                            if k in T.LAUNCH_STACKS}
    return launches


def _op_tally(fn) -> str:
    """The torch ops one call of fn dispatches (all but the views launch a
    kernel), as 'torch_ops_per_call=... non_view_ops_per_call=... top_ops=...'."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        ops = collections.Counter()

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            _Count.ops[func.__name__.split(".")[0]] += 1
            return func(*a, **(kw or {}))

    with _Count():
        fn()
    torch.cuda.synchronize()
    ops = _Count.ops
    views = sum(v for k, v in ops.items() if k in _VIEW_OPS)
    return (f"torch_ops_per_call={sum(ops.values())} "
            f"non_view_ops_per_call={sum(ops.values()) - views} top_ops={ops.most_common(6)}")


def _trace(fn) -> str:
    """One call of fn under torch.profiler: the device time of the kernels
    it ran (summed; one stream, so they do not overlap) against the host
    clock of the same call, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType

    from crypto12381_tpu_torch.utils.profiling import device_trace

    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_kernel[ev.name[:40]] += ev.time_range.elapsed_us()
    busy = sum(per_kernel.values()) / 1e6
    top = [(k, round(v / 1e3, 3)) for k, v in per_kernel.most_common(5)]
    return (f"traced_wall_s={wall:.4f} device_busy_s={busy:.4f} "
            f"device_busy_share={busy / wall:.4f} top_kernels_ms={top}")


def phase_pairing(dev, trace: bool):
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R

    vec = json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                      / "reference.json").read_text())
    rng = np.random.default_rng(SEED + 1)

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % R

    sa, sb = scalar(), scalar()
    g1 = [C.G1_GEN, C.g1_mul(C.G1_GEN, 7), C.g1_mul(C.G1_GEN, sa), C.g1_mul(C.G1_GEN, sa * sb)]
    g2 = [C.G2_GEN, C.g2_mul(C.G2_GEN, 11), C.g2_mul(C.G2_GEN, sb), C.G2_GEN]
    while len(g1) < DISTINCT:
        g1.append(C.g1_mul(C.G1_GEN, scalar()))
        g2.append(C.g2_mul(C.G2_GEN, scalar()))
    p_inf = [False] * DISTINCT
    q_inf = [False] * DISTINCT
    p_inf[4] = q_inf[5] = True
    reps_tile = B // DISTINCT
    args = (g1 * reps_tile, g2 * reps_tile, p_inf * reps_tile, q_inf * reps_tile)

    # the main path, counted: every kernel of the path must launch
    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = T.pair_batch(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _path_launches("pairing", PAIRING)

    fc = f.cpu()
    if tuple(fc.shape) != (B, 2, 3, 2, 12):
        raise SystemExit(f"pairing: output shape {tuple(fc.shape)}")
    tiles = fc.reshape((reps_tile, DISTINCT) + tuple(fc.shape[1:]))
    if not all(torch.equal(tiles[k], tiles[0]) for k in range(reps_tile)):
        raise SystemExit("pairing: tiled copies of one input pair disagree")
    host = TW.fp12_to_host(fc[:DISTINCT])
    checks = {
        "gt_e_g1_g2": codec.gt_serialize(host[0]).hex() == vec["gt_e_g1_g2"],
        "gt_e_7g_11h": codec.gt_serialize(host[1]).hex() == vec["gt_e_7g_11h"],
        "bilinear": host[2] == host[3] and not bool(TW.fp12_is_one(fc[2])),
        "masks": bool(TW.fp12_is_one(fc[4])) and bool(TW.fp12_is_one(fc[5])),
    }
    cpu = T.pair_batch(g1[2:6], g2[2:6], p_inf[2:6], q_inf[2:6], device="cpu")
    checks["cpu_rows"] = torch.equal(cpu, fc[2:6])
    if not all(checks.values()):
        raise SystemExit(f"pairing: checks failed: {checks}")

    # steady state: host clock around synchronized batches
    torch.cuda.reset_peak_memory_stats()
    times = _timed_calls(lambda: T.pair_batch(*args), 2)
    rate = B * len(times) / sum(times)
    peak = torch.cuda.max_memory_allocated()

    ops = _op_tally(lambda: T.pair_batch(*args))
    traced = _trace(lambda: T.pair_batch(*args)) if trace else ""
    print(f"pairing: B={B} distinct={DISTINCT} checks={checks} first_s={first_s:.3f} "
          f"batch_s={[round(t, 4) for t in times]} pairings_per_s={rate:.1f} "
          f"launches_per_batch={launches} launch_rows="
          f"{ {k: ROWS_BY_PATH['pairing'][k] for k in PAIRING if k.startswith(('fp2', 'fp6', 'fp12', 'g2'))} } "
          f"{ops} max_memory_allocated={peak} {traced}",
          flush=True)


def phase_g1(dev, trace: bool):
    """G1Vec ** ZpVec at G1_B: the GLV ladder (K1 for phi, K6, K7)."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R

    rng = np.random.default_rng(SEED + 2)
    a = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(G1_B)]
    gen = T.G1Vec.generator((G1_B,))
    e = T.ZpVec.from_ints(a)

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = gen ** e
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _path_launches("g1", ("fp_mont_mul", "g1_add", "g1_dbl"))

    rows = [0, 1, 2, 3, G1_B // 8, G1_B // 2 + 1, G1_B - 2, G1_B - 1]
    sub = T.G1Vec(tuple(c[rows] for c in pts.p))
    host = [C.g1_mul(C.G1_GEN, a[i]) for i in rows]
    cpu = T.G1Vec.generator((4,), device="cpu") ** T.ZpVec.from_ints(a[:4], device="cpu")
    checks = {
        "host_rows": list(G1C.to_affine_ints(sub.p)) == host,
        "bytes": sub.serialize() == [codec.g1_serialize(h) for h in host],
        "cpu_rows": all(torch.equal(c.cpu(), g[:4].cpu()) for c, g in zip(cpu.p, pts.p)),
    }
    if not all(checks.values()):
        raise SystemExit(f"g1: checks failed: {checks}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        gen ** e
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = G1_B * len(times) / sum(times)
    ops = _op_tally(lambda: gen ** e)
    traced = _trace(lambda: gen ** e) if trace else ""

    # G1Vec.parse of the batch's own bytes, counted as a path of its own:
    # one square-root chain for the 8,192 points (none is the identity)
    blobs = pts.serialize()
    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = T.G1Vec.parse(blobs)
    torch.cuda.synchronize()
    parse_s = time.perf_counter() - t0
    parse_launches = _path_launches("parse", ("fp_mont_mul", "fp_pow_fixed"))
    if not bool((back == pts).all()):
        raise SystemExit("g1: G1Vec.parse does not give back the serialized points")
    print(f"g1: B={G1_B} checks={checks} first_s={first_s:.3f} "
          f"call_s={[round(t, 4) for t in times]} scalar_muls_per_s={rate:.1f} "
          f"launches_per_call={launches} {ops} {traced}", flush=True)
    print(f"parse: B={G1_B} round_trip=True parse_s={parse_s:.4f} "
          f"launches_per_call={parse_launches} launch_rows={ROWS_BY_PATH['parse']}", flush=True)
    return pts, a


def phase_msm(dev, pts, a, trace: bool):
    """G1Vec.msm at MSM_N: the scan Pippenger (K1, K5, K6, K7) on the g1
    phase's points, affine and tiled, against the host integer oracle."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R

    rng = np.random.default_rng(SEED + 3)
    m = len(a)
    x, y, _ = pts.affine()
    X, Y = x.repeat(MSM_N // m, 1), y.repeat(MSM_N // m, 1)
    Z = FP.one((MSM_N,), dev).clone()
    ident = MSM_N // 5                              # an identity row ...
    X[ident], Z[ident] = 0, 0
    s = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(MSM_N)]
    zero_rows = [7, m - 1, m, MSM_N // 2, MSM_N - 1]   # ... and zero scalars
    for i in zero_rows:
        s[i] = 0
    assert s[ident] != 0
    vec = T.G1Vec((X, Y, Z), z_is_one=True)
    e = T.ZpVec.from_ints(s)
    expect = C.g1_mul(C.G1_GEN, sum(a[i % m] * s[i] for i in range(MSM_N) if i != ident) % R)

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = vec.msm(e)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _path_launches("msm", ("fp_mont_mul", "fp_pow_fixed", "g1_madd", "g1_add",
                                      "g1_dbl"))
    got = G1C.to_affine_ints(res.p)
    if got != expect:
        raise SystemExit(f"msm: result {got} != host oracle {expect}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        vec.msm(e)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = MSM_N * len(times) / sum(times)
    peak = torch.cuda.max_memory_allocated()
    ops = _op_tally(lambda: vec.msm(e))
    traced = _trace(lambda: vec.msm(e)) if trace else ""
    print(f"msm: n={MSM_N} distinct={m} oracle=True first_s={first_s:.3f} "
          f"call_s={[round(t, 4) for t in times]} points_per_s={rate:.1f} "
          f"launches_per_call={launches} {ops} max_memory_allocated={peak} {traced}",
          flush=True)


def uniform_scalars(rng, n: int) -> np.ndarray:
    """(n, 18) int32 limbs of 16 bits of scalars uniform below r: 255-bit
    draws, those >= r drawn again (numpy, no host big ints)."""
    from crypto12381_tpu_torch.params import R

    r_top = np.array([(R >> (16 * i)) & 0xFFFF for i in range(15, -1, -1)])
    out = np.zeros((n, 18), np.int32)
    todo = np.arange(n)
    while todo.size:
        w = rng.integers(0, 1 << 16, size=(todo.size, 16), dtype=np.int64)
        w[:, 15] &= 0x7FFF
        diff = w[:, ::-1] - r_top
        first = (diff != 0).argmax(1)
        below = diff[np.arange(todo.size), first] < 0
        out[todo[below], :16] = w[below]
        todo = todo[~below]
    return out


def limb_ints(limbs: np.ndarray) -> list[int]:
    """(n, 18) 16-bit limbs -> Python ints."""
    raw = np.ascontiguousarray(limbs[:, :16].astype("<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


def msm_rounds_scalars(n: int) -> tuple[np.ndarray, int, list[int]]:
    """The rounds MSM's scalars (limbs), its identity row, and its zero
    rows: uniform mod r from a fixed seed."""
    limbs = uniform_scalars(np.random.default_rng(SEED + 8), n)
    zero_rows = [5, G1_B, n // 2 + 1, n - 1]
    limbs[zero_rows] = 0
    return limbs, n // 3, zero_rows


def phase_msm_rounds(dev, pts, a, trace: bool):
    """G1Vec.msm at MSMR_N, the dense-rounds route (K5 per round, K6 and K7
    in the finish), on the g1 phase's points, affine and tiled, an
    identity row under a nonzero scalar and zero scalars; a projective
    call (K1 front); and at MSMR_FALLBACK_N with MSMR_EQUAL equal scalars,
    which takes the scan MSM.  Each against the host integer oracle.
    Returns the projective 2^20 vector, its scalars and oracle, and the
    first 2^17 rows with theirs, for the msm_sorted phase."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R

    m = len(a)
    x, y, _ = pts.affine()
    X, Y = x.repeat(MSMR_N // m, 1), y.repeat(MSMR_N // m, 1)
    Z = FP.one((MSMR_N,), dev).clone()
    t0 = time.perf_counter()
    limbs, ident, _ = msm_rounds_scalars(MSMR_N)
    X[ident], Z[ident] = 0, 0                       # an identity row ...
    s_int = limb_ints(limbs)
    assert s_int[ident] != 0                        # ... under a nonzero scalar
    vec = T.G1Vec((X, Y, Z), z_is_one=True)
    e = T.ZpVec(torch.from_numpy(limbs).to(dev))

    def oracle(scal, n):
        per_point = [0] * m
        for i in range(n):
            if i != ident:
                per_point[i % m] += scal[i]
        return C.g1_mul(C.G1_GEN, sum(u * v for u, v in zip(a, per_point)) % R)

    expect = oracle(s_int, MSMR_N)
    setup_s = time.perf_counter() - t0
    kernels = ("g1_madd", "g1_add", "g1_dbl")
    res, first_s, launches = _counted("msm_rounds", kernels, lambda: vec.msm(e))
    checks = {"oracle": G1C.to_affine_ints(res.p) == expect}
    k5 = ROWS_BY_PATH["msm_rounds"]["g1_madd"]       # one launch per round
    rounds = sum(k5.values())
    torch.cuda.reset_peak_memory_stats()
    times = _timed_calls(lambda: vec.msm(e), 3)
    peak = torch.cuda.max_memory_allocated()
    ops = _op_tally(lambda: vec.msm(e))
    traced = _trace(lambda: vec.msm(e)) if trace else ""

    # projective: Z != 1 on every 7th row (the identity row keeps Z = 0),
    # through the Z-inversion front
    rng = np.random.default_rng(SEED + 11)
    rows = torch.arange(0, MSMR_N, 7, device=dev)
    rows = rows[rows != ident]
    z = torch.from_numpy(_rand_fp(rng, rows.numel(), 1)[:, 0]).to(dev)
    Xp, Yp, Zp = X.clone(), Y.clone(), Z.clone()
    Xp[rows], Yp[rows], Zp[rows] = FP.mont_mul(X[rows], z), FP.mont_mul(Y[rows], z), z
    proj = T.G1Vec((Xp, Yp, Zp))
    res, proj_s, proj_launches = _counted(
        "msm_rounds_proj", ("fp_mont_mul", "fp_pow_fixed") + kernels, lambda: proj.msm(e))
    checks["projective_oracle"] = G1C.to_affine_ints(res.p) == expect

    # MSMR_EQUAL equal scalars make runs longer than 512: the scan MSM
    nf = MSMR_FALLBACK_N
    eq_limbs = limbs[:nf].copy()
    eq_limbs[:MSMR_EQUAL] = limbs[1]
    few = T.G1Vec((X[:nf], Y[:nf], Z[:nf]), z_is_one=True)
    res, fb_s, fb_launches = _counted(
        "msm_rounds_fallback", ("fp_mont_mul", "fp_pow_fixed") + kernels,
        lambda: few.msm(T.ZpVec(torch.from_numpy(eq_limbs).to(dev))))
    checks["fallback_oracle"] = G1C.to_affine_ints(res.p) == oracle(limb_ints(eq_limbs), nf)
    fb_k5 = ROWS_BY_PATH["msm_rounds_fallback"]["g1_madd"]
    checks["fallback_is_scan"] = set(fb_k5) == {MSM_LANES * MSM_WINDOWS}
    if not all(checks.values()):
        raise SystemExit(f"msm_rounds: checks failed: {checks}")
    print(f"msm_rounds: n={MSMR_N} distinct={m} identity_row={ident} checks={checks} "
          f"setup_s={setup_s:.2f} first_s={first_s:.3f} call_s={[round(t, 4) for t in times]} "
          f"points_per_s={MSMR_N * len(times) / sum(times):.1f} rounds={rounds} "
          f"ladder={sorted(k5, reverse=True)} launches_per_call={launches} "
          f"launch_rows={ROWS_BY_PATH['msm_rounds']} {ops} max_memory_allocated={peak} "
          f"projective_s={proj_s:.3f} projective_launches={proj_launches} "
          f"fallback_n={nf} fallback_s={fb_s:.3f} fallback_launches={fb_launches} {traced}",
          flush=True)
    few_e = T.ZpVec(torch.from_numpy(limbs[:nf].copy()).to(dev))
    return {"proj": proj, "e": e, "expect": expect, "few": few, "few_e": few_e,
            "few_expect": oracle(s_int[:nf], nf)}


def phase_msm_sorted(dev, rounds: dict, trace: bool):
    """The sorted batched-affine MSMs of msm/sorted.py, called directly
    (G1Vec.msm does not route to them), each against the host integer
    oracle: (a) `msm_g1_sorted_staged` (K1 products and one chain per
    pass, K6 and K7 in the finish) on the msm_rounds phase's projective
    2^20 vector (tiled points: equal x in a merge pair switches to
    GENERAL), timed beside G1Vec.msm's rounds route on it; (b) on
    MSMS_FAST_N distinct points from one GLV call (FAST throughout), timed
    beside G1Vec.msm's scan route on them; (c) `msm_g1_sorted` (per
    window, K6 merge passes) on (b)'s points; (d) the staged MSM, the scan
    and the rounds MSM timed on the msm_rounds phase's first 2^17 rows."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import pippenger as MSM
    from crypto12381_tpu_torch.msm import sorted as MSORT
    from crypto12381_tpu_torch.params import R

    kernels = ("fp_mont_mul", "fp_pow_fixed", "g1_add", "g1_dbl")
    scan_kernels = ("fp_mont_mul", "fp_pow_fixed", "g1_madd", "g1_add", "g1_dbl")

    def c_of(n):
        """The JAX package's window width of the sorted MSM at n points."""
        return max(6, min(16, n.bit_length() - 5))

    def rate(n, times):
        return round(n * len(times) / sum(times), 1)

    def secs(times):
        return [round(t, 4) for t in times]

    # (a) 2^20 projective, GENERAL
    proj, e = rounds["proj"], rounds["e"]
    run = {}
    res, first_s, launches = _counted(
        "msm_sorted", kernels,
        lambda: MSORT.msm_g1_sorted_staged(proj.p, e.std, c=c_of(MSMR_N), record=run))
    checks = {"oracle": G1C.to_affine_ints(res) == rounds["expect"],
              "general": run["general_from"] is not None}
    torch.cuda.reset_peak_memory_stats()
    times = _timed_calls(lambda: MSORT.msm_g1_sorted_staged(proj.p, e.std, c=c_of(MSMR_N)), 2)
    peak = torch.cuda.max_memory_allocated()
    rounds_times = _timed_calls(lambda: proj.msm(e), 2)
    ops = _op_tally(lambda: MSORT.msm_g1_sorted_staged(proj.p, e.std, c=c_of(MSMR_N)))
    traced = (_trace(lambda: MSORT.msm_g1_sorted_staged(proj.p, e.std, c=c_of(MSMR_N)))
              if trace else "")

    # (b) distinct points, FAST throughout, and the scan on them
    rng = np.random.default_rng(SEED + 12)
    a_limbs = uniform_scalars(rng, MSMS_FAST_N)
    a = limb_ints(a_limbs)
    s_limbs = uniform_scalars(rng, MSMS_FAST_N)
    s = limb_ints(s_limbs)
    if len(set(a)) != MSMS_FAST_N:
        raise SystemExit("msm_sorted: the GLV scalars are not distinct")
    pts = T.G1Vec.generator((MSMS_FAST_N,)) ** T.ZpVec(torch.from_numpy(a_limbs).to(dev))
    es = T.ZpVec(torch.from_numpy(s_limbs).to(dev))
    fast_expect = C.g1_mul(C.G1_GEN, sum(u * v for u, v in zip(a, s)) % R)
    c_fast, fast_run = c_of(MSMS_FAST_N), {}
    fres, fast_s, fast_launches = _counted(
        "msm_sorted_fast", kernels,
        lambda: MSORT.msm_g1_sorted_staged(pts.p, es.std, c=c_fast, record=fast_run))
    checks["fast_oracle"] = G1C.to_affine_ints(fres) == fast_expect
    checks["fast_throughout"] = fast_run["general_from"] is None
    fast_times = _timed_calls(lambda: MSORT.msm_g1_sorted_staged(pts.p, es.std, c=c_fast), 2)
    sres, scan16_s, scan16_launches = _counted("msm_scan_16", scan_kernels, lambda: pts.msm(es))
    checks["scan_16_oracle"] = G1C.to_affine_ints(sres.p) == fast_expect
    scan16_times = _timed_calls(lambda: pts.msm(es), 2)

    # (c) the per-window version, its passes 2+ on K6
    wres, win_s, win_launches = _counted(
        "msm_sorted_window", kernels,
        lambda: MSORT.msm_g1_sorted(pts.p, es.std, c=c_fast))
    checks["window_oracle"] = G1C.to_affine_ints(wres) == fast_expect

    # (d) 2^17 tiled points: the staged MSM, the scan and the rounds MSM
    few, few_e, nf = rounds["few"], rounds["few_e"], MSMR_FALLBACK_N
    mid_run = {}
    mres, mid_s, mid_launches = _counted(
        "msm_sorted_17", kernels,
        lambda: MSORT.msm_g1_sorted_staged(few.p, few_e.std, c=c_of(nf), record=mid_run))
    checks["sorted_17_oracle"] = G1C.to_affine_ints(mres) == rounds["few_expect"]
    mid_times = _timed_calls(lambda: MSORT.msm_g1_sorted_staged(few.p, few_e.std, c=c_of(nf)), 2)

    def scan17():
        return MSM.msm_g1(few.p, few_e.std, c=8, lanes=MSM_LANES)

    sres, scan17_s, scan17_launches = _counted("msm_scan_17", scan_kernels, scan17)
    checks["scan_17_oracle"] = G1C.to_affine_ints(sres) == rounds["few_expect"]
    scan17_times = _timed_calls(scan17, 2)
    rres, _, _ = _counted("msm_rounds_17", ("g1_madd", "g1_add", "g1_dbl"),
                          lambda: few.msm(few_e))
    checks["rounds_17_oracle"] = G1C.to_affine_ints(rres.p) == rounds["few_expect"]
    checks["rounds_17_route"] = set(ROWS_BY_PATH["msm_rounds_17"]["g1_madd"]) != {
        MSM_LANES * MSM_WINDOWS}
    rounds17_times = _timed_calls(lambda: few.msm(few_e), 2)
    _fail("msm_sorted", checks)
    print(f"msm_sorted: n={MSMR_N} c={c_of(MSMR_N)} checks={checks} passes={run['passes']} "
          f"general_from_pass={run['general_from']} pass_sizes={run['sizes']} "
          f"first_s={first_s:.3f} call_s={secs(times)} points_per_s={rate(MSMR_N, times)} "
          f"rounds_call_s={secs(rounds_times)} rounds_points_per_s={rate(MSMR_N, rounds_times)} "
          f"launches_per_call={launches} launch_rows={ROWS_BY_PATH['msm_sorted']} {ops} "
          f"max_memory_allocated={peak} "
          f"fast_n={MSMS_FAST_N} fast_c={c_fast} fast_passes={fast_run['passes']} "
          f"fast_general_from_pass={fast_run['general_from']} fast_first_s={fast_s:.3f} "
          f"fast_call_s={secs(fast_times)} fast_points_per_s={rate(MSMS_FAST_N, fast_times)} "
          f"fast_launches={fast_launches} scan_16_first_s={scan16_s:.3f} "
          f"scan_16_call_s={secs(scan16_times)} "
          f"scan_16_points_per_s={rate(MSMS_FAST_N, scan16_times)} "
          f"scan_16_launches={scan16_launches} window_s={win_s:.3f} "
          f"window_launches={win_launches} n17={nf} c17={c_of(nf)} "
          f"sorted_17_passes={mid_run['passes']} "
          f"sorted_17_general_from_pass={mid_run['general_from']} sorted_17_first_s={mid_s:.3f} "
          f"sorted_17_call_s={secs(mid_times)} sorted_17_points_per_s={rate(nf, mid_times)} "
          f"sorted_17_launches={mid_launches} scan_17_first_s={scan17_s:.3f} "
          f"scan_17_call_s={secs(scan17_times)} scan_17_points_per_s={rate(nf, scan17_times)} "
          f"scan_17_launches={scan17_launches} rounds_17_call_s={secs(rounds17_times)} "
          f"rounds_17_points_per_s={rate(nf, rounds17_times)} {traced}", flush=True)


def phase_sharding(dev):
    """parallel/sharding.py on a world of ONE rank with NCCL (one card; a
    world of D > 1 is proved on the CPU only, by tests/test_torch_parallel.py):
    sharded_msm, sharded_multi_pairing, sharded_batched_pairing and
    ps.verify_batch(..., mesh=...) at the msm, pairing and ps phases'
    sizes, each equal to its unsharded call on the card, each making
    exactly one collective."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import pippenger as MSM
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    from crypto12381_tpu_torch.parallel import sharding as SH
    from crypto12381_tpu_torch.params import R
    from crypto12381_tpu_torch.schemes import ps

    rng = np.random.default_rng(SEED + 13)
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = SH.default_mesh()
        checks, colls, secs, launches = {}, {}, {}, {}

        def both(name, kernels, sharded, plain):
            before = SH.COLLECTIVES
            out, secs[name], launches[name] = _counted(f"sharding_{name}", kernels, sharded)
            colls[name] = SH.COLLECTIVES - before
            return out, plain()

        # the MSM: the JAX function's defaults (c = 6, 256 lanes)
        ks = uniform_scalars(rng, SHARD_MSM_N)
        pts = T.G1Vec.generator((SHARD_MSM_N,)) ** T.ZpVec(torch.from_numpy(ks).to(dev))
        sc = uniform_scalars(rng, SHARD_MSM_N)
        s = torch.from_numpy(sc).to(dev)
        got, want = both("msm", ("fp_mont_mul", "fp_pow_fixed", "g1_madd", "g1_add", "g1_dbl"),
                         lambda: SH.sharded_msm(mesh, pts.p, s),
                         lambda: MSM.msm(pts.p, s, G1C.ops(), c=6, lanes=256,
                                         gen_affine=MSM._gen_affine_g1(dev)))
        expect = C.g1_mul(C.G1_GEN, sum(u * v for u, v in zip(limb_ints(ks), limb_ints(sc))) % R)
        checks["msm"] = all(torch.equal(g, w) for g, w in zip(got, want)) and \
            G1C.to_affine_ints(got) == expect

        # the pairings over SHARD_PAIRS pairs: 8 host pairs tiled
        g1 = [C.g1_mul(C.G1_GEN, int(k)) for k in rng.integers(2, 1 << 62, 8)]
        g2 = [C.g2_mul(C.G2_GEN, int(k)) for k in rng.integers(2, 1 << 62, 8)]
        g1, g2 = g1 * (SHARD_PAIRS // 8), g2 * (SHARD_PAIRS // 8)
        p_aff = T.G1Vec.from_affine(g1).p[:2]
        q_aff = T.G2Vec.from_affine(g2).p[:2]
        got, want = both("multi_pairing", PAIRING,
                         lambda: SH.sharded_multi_pairing(mesh, p_aff, q_aff),
                         lambda: PAIR.multi_pairing(p_aff, q_aff))
        checks["multi_pairing"] = torch.equal(got, want)
        got, want = both("batched_pairing", PAIRING,
                         lambda: SH.sharded_batched_pairing(mesh, p_aff, q_aff),
                         lambda: PAIR.pairing_affine(p_aff, q_aff))
        checks["batched_pairing"] = torch.equal(got, want) and got.shape[0] == SHARD_PAIRS

        # PS verification: B signatures, one message tampered
        r = create_random_engine("bench-ps-sharded")
        keys = ps.key_gen(r)
        msgs = [b"shard-%04d" % i for i in range(SHARD_PS_B)]
        sigs = ps.sign_batch(keys.sk, msgs, r)
        msgs[3] = b"tampered"
        got, want = both("ps_verify", G2_PAIRING,
                         lambda: ps.verify_batch(keys.pk, msgs, sigs, mesh=mesh),
                         lambda: ps.verify_batch(keys.pk, msgs, sigs))
        checks["ps_verify"] = (got.tolist() == want.tolist()
                               == [i != 3 for i in range(SHARD_PS_B)])
        checks["one_collective_each"] = set(colls.values()) == {1}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    _fail("sharding", checks)
    print(f"sharding: world=1 backend=nccl device={mesh.device} (D > 1 is proved on the CPU "
          f"only: tests/test_torch_parallel.py, gloo worlds of 2 and 3) msm_n={SHARD_MSM_N} "
          f"pairs={SHARD_PAIRS} ps_B={SHARD_PS_B} checks={checks} collectives={colls} "
          f"sharded_s={ {k: round(v, 3) for k, v in secs.items()} } launches={launches}",
          flush=True)


def _off_g2_point():
    """A point of E'(Fp2) outside G2: the least x = (t, 1) on the twist."""
    from crypto12381_tpu_torch.host import field as HF
    from crypto12381_tpu_torch.params import B_G2

    t = 1
    while True:
        x = (t, 1)
        y = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(x), x), B_G2))
        if y is not None:
            return (x, y)
        t += 1


def phase_g2(dev, trace: bool):
    """G2Vec ** ZpVec at G2_B (the GS ladder: K12, K14 and K2 for psi), its
    checks, membership and cofactor clearing, and G2Vec.msm at G2_MSM_N
    (K1, K2, K12-K14)."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g2 as G2C
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.params import R

    rng = np.random.default_rng(SEED + 9)
    a = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(G2_B)]
    gen = T.G2Vec.generator((G2_B,))
    e = T.ZpVec.from_ints(a)
    pts, first_s, launches = _counted("g2", ("fp2_mul", "g2_add", "g2_dbl"), lambda: gen ** e)

    rows = [0, 1, 2, 3, G2_B // 8, G2_B // 2 + 1, G2_B - 2, G2_B - 1]
    sub = T.G2Vec(tuple(c[rows] for c in pts.p))
    host = [C.g2_mul(C.G2_GEN, a[i]) for i in rows]
    cpu = T.G2Vec.generator((4,), device="cpu") ** T.ZpVec.from_ints(a[:4], device="cpu")
    off = T.G2Vec.from_affine([_off_g2_point(), host[0]])
    cleared = G2C.clear_cofactor(off.p)
    checks = {
        "host_rows": list(G2C.to_affine_ints(sub.p)) == host,
        "bytes": sub.serialize() == [codec.g2_serialize(h) for h in host],
        "cpu_rows": all(torch.equal(c.cpu(), g[:4].cpu()) for c, g in zip(cpu.p, pts.p)),
        "in_subgroup": bool(G2C.in_subgroup(pts.p).all()),
        "off_g2_rejected": G2C.in_subgroup(off.p).tolist() == [False, True],
        "cleared_in_g2": (G2C.in_subgroup(cleared).tolist() == [True, True]
                          and not bool(G2C.is_identity(cleared).any())),
    }
    times = _timed_calls(lambda: gen ** e, 3)
    traced = _trace(lambda: gen ** e) if trace else ""

    # G2Vec.msm over the ladder's points, affine and tiled
    x, y, _ = pts.affine()
    k = G2_MSM_N // G2_B
    mv = T.G2Vec((x.repeat(k, 1, 1), y.repeat(k, 1, 1), TW.fp2_one((G2_MSM_N,), dev).clone()),
                 z_is_one=True)
    s = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(G2_MSM_N)]
    s[3] = s[G2_MSM_N - 1] = 0
    se = T.ZpVec.from_ints(s)
    expect = C.g2_mul(C.G2_GEN, sum(a[i % G2_B] * s[i] for i in range(G2_MSM_N)) % R)
    res, msm_first_s, msm_launches = _counted(
        "g2_msm", ("fp_mont_mul", "fp_pow_fixed", "fp2_mul", "g2_madd", "g2_add", "g2_dbl"),
        lambda: mv.msm(se))
    checks["msm_oracle"] = G2C.to_affine_ints(res.p) == expect
    if not all(checks.values()):
        raise SystemExit(f"g2: checks failed: {checks}")
    torch.cuda.reset_peak_memory_stats()
    msm_times = _timed_calls(lambda: mv.msm(se), 2)
    msm_peak = torch.cuda.max_memory_allocated()
    print(f"g2: B={G2_B} checks={checks} first_s={first_s:.3f} "
          f"call_s={[round(t, 4) for t in times]} "
          f"scalar_muls_per_s={G2_B * len(times) / sum(times):.1f} launches_per_call={launches} "
          f"launch_rows={ROWS_BY_PATH['g2']} msm_n={G2_MSM_N} msm_first_s={msm_first_s:.3f} "
          f"msm_call_s={[round(t, 4) for t in msm_times]} "
          f"msm_points_per_s={G2_MSM_N * len(msm_times) / sum(msm_times):.1f} "
          f"msm_launches_per_call={msm_launches} msm_max_memory_allocated={msm_peak} {traced}",
          flush=True)


def phase_algebra(dev, trace: bool):
    """pair_vec, GT powers and pair_prod at ALG_B (K1, K2, K4, K8-K11, K13,
    K14): bilinearity e(g1^x, g2^y) = e(g1, g2)^(x y) on every row,
    pair_prod as the product of pair_vecs, GTVec.parse of serialize, and
    e(G1, G2)'s bytes."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.params import R

    vec = json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                      / "reference.json").read_text())
    rng = np.random.default_rng(SEED + 10)
    xs, ys = ([int.from_bytes(rng.bytes(32), "big") % R for _ in range(ALG_B)] for _ in range(2))
    X, Y = T.ZpVec.from_ints(xs), T.ZpVec.from_ints(ys)
    g1, g2 = T.G1Vec.generator((ALG_B,)), T.G2Vec.generator((ALG_B,))
    P, Q = g1 ** X, g2 ** Y
    lhs, pv_first_s, pv_launches = _counted("pair_vec", PAIRING, lambda: T.pair_vec(P, Q))
    base1 = T.pair_vec(T.G1Vec.generator((1,)), T.G2Vec.generator((1,)))
    base = T.GTVec(base1.f.expand((ALG_B,) + tuple(base1.f.shape[1:])))
    xy = X * Y
    rhs, pow_first_s, pow_launches = _counted("gt_pow", ("fp2_mul", "fp12_mul", "fp12_usqr"),
                                              lambda: base ** xy)
    prod, pp_first_s, pp_launches = _counted("pair_prod", PAIRING,
                                             lambda: T.pair_prod((P, Q), (g1, g2)))
    blobs = lhs.serialize()
    checks = {
        "bilinear": bool((lhs == rhs).all()),
        "not_one": not bool(lhs.is_one().any()),
        "pair_prod": bool((prod == lhs * base).all()),
        "parse_round_trip": torch.equal(T.GTVec.parse(blobs).f, lhs.f),
        "gt_e_g1_g2": base1.serialize()[0].hex() == vec["gt_e_g1_g2"],
    }
    if not all(checks.values()):
        raise SystemExit(f"algebra: checks failed: {checks}")
    torch.cuda.reset_peak_memory_stats()
    pv_times = _timed_calls(lambda: T.pair_vec(P, Q), 2)
    pv_peak = torch.cuda.max_memory_allocated()
    pow_times = _timed_calls(lambda: base ** xy, 3)
    traced = _trace(lambda: T.pair_vec(P, Q)) if trace else ""
    print(f"algebra: B={ALG_B} checks={checks} pair_vec_first_s={pv_first_s:.3f} "
          f"pair_vec_call_s={[round(t, 4) for t in pv_times]} "
          f"pairs_per_s={ALG_B * len(pv_times) / sum(pv_times):.1f} "
          f"gt_pow_first_s={pow_first_s:.3f} gt_pow_call_s={[round(t, 4) for t in pow_times]} "
          f"gt_powers_per_s={ALG_B * len(pow_times) / sum(pow_times):.1f} "
          f"pair_prod_s={pp_first_s:.3f} pair_vec_max_memory_allocated={pv_peak} "
          f"launches_per_call={{'pair_vec': {pv_launches}, 'gt_pow': {pow_launches}, "
          f"'pair_prod': {pp_launches}}} {traced}", flush=True)


def phase_zp(dev):
    """ZpVec + - * neg inverse at G1_B rows (K1's Fr instance): every row
    against host integers mod r, 4 rows against the CPU plain path."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.params import R

    rng = np.random.default_rng(SEED + 5)
    a = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "big") % R for _ in range(G1_B - 6)]
    a += [R - 1, 1, 0]
    b = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(G1_B - 3)] + [R - 1, 1, 0]
    A, Bv = T.ZpVec.from_ints(a), T.ZpVec.from_ints(b)
    ops = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y,
           "neg": lambda x, y: -x, "inverse": lambda x, y: x.inverse()}
    host = {"add": lambda x, y: (x + y) % R, "sub": lambda x, y: (x - y) % R,
            "mul": lambda x, y: x * y % R, "neg": lambda x, y: -x % R,
            "inverse": lambda x, y: pow(x, R - 2, R)}

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = {k: f(A, Bv) for k, f in ops.items()}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _path_launches("zp", ("fr_mont_mul", "fr_pow_fixed"))

    A4, B4 = T.ZpVec.from_ints(a[:4], device="cpu"), T.ZpVec.from_ints(b[:4], device="cpu")
    checks = {}
    for k, out in outs.items():
        got = out.to_ints()
        checks[k] = (tuple(out.std.shape) == (G1_B, 18)
                     and all(int(g) == host[k](x, y) for g, x, y in zip(got, a, b))
                     and torch.equal(ops[k](A4, B4).std, out.std[:4].cpu()))
    if not all(checks.values()):
        raise SystemExit(f"zp: checks failed: {checks}")
    per_op = {}
    for k, f in ops.items():
        T.reset_launches()
        f(A, Bv)
        per_op[k] = {fn: n for fn, n in T.LAUNCHES.items() if n}
    torch.cuda.synchronize()
    print(f"zp: B={G1_B} checks={checks} first_s={first_s:.4f} launches_per_call={launches} "
          f"launches_per_op={per_op}", flush=True)


def _off_curve_x() -> bytes:
    """A 49-byte G1 encoding whose x is not on the curve (the host codec
    refuses it): the least such x from 1 up."""
    from crypto12381_tpu_torch.compat import codec

    x = 1
    while True:
        blob = b"\x02" + codec.int_to_bytes(x)
        try:
            codec.g1_parse(blob)
        except ValueError:
            return blob
        x += 1


def phase_ps(dev, trace: bool):
    """PS batch signing and verification (K1-K4, K6, K7): the ps_flow.json
    vector, then the JAX bench's configuration at PS_B messages, with its
    checks and rejections; signing and verifying are two counted paths."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import Zp, hash_, parse
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.compat.csprng import create_random_engine
    from crypto12381_tpu_torch.host import curve as C

    vec = json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                      / "ps_flow.json").read_text())
    r = create_random_engine("seed")
    keys = T.key_gen(r)
    msg = b"\x00" * 47 + b"\x17"
    sig = T.sign_batch(keys.sk, [msg], r)[0]
    rand_sig = T.randomnize(sig, r)
    flow = {
        "keys": (keys.pk.hex() == vec["g2"] + vec["X2"] + vec["Y2"]
                 and keys.sk.hex() == vec["sk"]),
        "signature": sig.hex() == vec["signature"],
        "signature_rand": rand_sig.hex() == vec["signature_rand"],
        "verify": T.verify_batch(keys.pk, [msg], [rand_sig]).tolist() == [vec["verify"]],
    }
    if not all(flow.values()):
        raise SystemExit(f"ps: the ps_flow.json vector failed: {flow}")

    r = create_random_engine("bench-ps")
    keys = T.key_gen(r)
    msgs = [b"bench-%06d" % i for i in range(PS_B)]

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sigs = T.sign_batch(keys.sk, msgs, r)
    torch.cuda.synchronize()
    sign_first_s = time.perf_counter() - t0
    sign_launches = _path_launches("ps_sign", ("fp_mont_mul", "fp_pow_fixed", "g1_add", "g1_dbl"))

    # s2 = s1^(x + y m) by the host ladder and codec, for 8 rows; 4 rows
    # again on the CPU path, from the same seed
    x, y = (z.value for z in parse(Zp ** 2, keys.sk))
    rows = [0, 1, 2, 3, PS_B // 2, PS_B // 2 + 1, PS_B - 2, PS_B - 1]
    host = [codec.g1_serialize(C.g1_mul(codec.g1_parse(sigs[i][:49]),
                                        x + y * hash_(msgs[i]).to(Zp).value)) for i in rows]
    t0 = time.perf_counter()
    r_cpu = create_random_engine("bench-ps")
    keys_cpu = T.key_gen(r_cpu)
    checks = {
        "host_rows": [sigs[i][49:] for i in rows] == host,
        "cpu_rows": T.sign_batch(keys_cpu.sk, msgs[:4], r_cpu, device="cpu") == sigs[:4],
    }
    if not all(checks.values()):
        raise SystemExit(f"ps: sign checks failed: {checks}")
    sign_checks_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sign_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        T.sign_batch(keys.sk, msgs, r)
        torch.cuda.synchronize()
        sign_times.append(time.perf_counter() - t0)
    sign_peak = torch.cuda.max_memory_allocated()

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = T.verify_batch(keys.pk, msgs, sigs)
    torch.cuda.synchronize()
    verify_first_s = time.perf_counter() - t0
    verify_launches = _path_launches("ps_verify", G1_PAIRING)
    checks["verified"] = int(ok.sum())
    if ok.shape != (PS_B,) or checks["verified"] != PS_B:
        raise SystemExit(f"ps: {checks['verified']} of {PS_B} signatures verified")
    torch.cuda.reset_peak_memory_stats()
    verify_times = _timed_calls(lambda: T.verify_batch(keys.pk, msgs, sigs), 2)
    verify_peak = torch.cuda.max_memory_allocated()

    # rejections: rotated messages (every row rejected; the call whose torch
    # ops are tallied, since a verify call's ops do not depend on the
    # verdicts), one swapped s2 (that row alone rejected), an x off the
    # curve (raises)
    t0 = time.perf_counter()
    out = []
    ops = _op_tally(lambda: out.append(T.verify_batch(keys.pk, msgs[1:] + msgs[:1], sigs)))
    checks["rotated_rejected"] = not out[0].any()
    swapped, j = list(sigs), PS_B // 2
    swapped[j] = sigs[j][:49] + sigs[j + 1][49:]
    got = T.verify_batch(keys.pk, msgs, swapped)
    checks["swapped_s2_rejected"] = not got[j] and bool(np.delete(got, j).all())
    off = list(sigs)
    off[3] = _off_curve_x() + sigs[3][49:]
    try:
        T.verify_batch(keys.pk, msgs, off)
        checks["off_curve_raises"] = False
    except ValueError as e:
        checks["off_curve_raises"] = "not on curve" in str(e)
    if not all(checks.values()):
        raise SystemExit(f"ps: checks failed: {checks}")
    rejections_s = time.perf_counter() - t0
    traced = _trace(lambda: T.verify_batch(keys.pk, msgs, sigs)) if trace else ""
    rows_of = {p: {k: ROWS_BY_PATH[p][k] for k in ("fp2_mul", "fp6_mul") if k in ROWS_BY_PATH[p]}
               for p in ("ps_sign", "ps_verify")}
    print(f"ps: B={PS_B} flow={flow} checks={checks} sign_first_s={sign_first_s:.3f} "
          f"sign_call_s={[round(t, 4) for t in sign_times]} "
          f"signs_per_s={PS_B * len(sign_times) / sum(sign_times):.1f} "
          f"verify_first_s={verify_first_s:.3f} "
          f"verify_call_s={[round(t, 4) for t in verify_times]} "
          f"verifies_per_s={PS_B * len(verify_times) / sum(verify_times):.1f} "
          f"sign_max_memory_allocated={sign_peak} verify_max_memory_allocated={verify_peak} "
          f"launches_per_sign_call={sign_launches} launches_per_verify_call={verify_launches} "
          f"launch_rows={rows_of} verify_{ops} sign_checks_s={sign_checks_s:.1f} "
          f"rejections_and_op_tally_s={rejections_s:.1f} {traced}", flush=True)


def _timed_calls(fn, reps: int) -> list[float]:
    """Host seconds of reps calls of fn, each ended by a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _counted(path: str, kernels, fn):
    """One call of fn with the launch counts set to 0 just before it and
    read just after: (result, host seconds, launches per kernel)."""
    import torch

    import crypto12381_tpu_torch as T

    T.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _path_launches(path, kernels)


def phase_bbs(dev, name: str, trace: bool):
    """BBS or BBS+ batch signing and verification (K1-K4, K6, K7): the flow
    vector, then BBS_B messages of 4 Zp blocks (the last one a single
    block, so that short messages pad with h^0), with their checks and
    rejections; signing and verifying are two counted paths."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import G1, Zp, create_random_engine, encode_to, parse
    from crypto12381_tpu_torch.host import curve as C

    mod, plus = getattr(T, name), name == "bbs_plus"
    vec = json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                      / f"{name}_flow.json").read_text())

    def blocks(m):
        """A message's exponents: encoded Zp blocks as ints."""
        return [z.value for z in encode_to(Zp, m)]

    def keyed(seed):
        r = create_random_engine(seed)
        pp = mod.setup(16, r)
        return r, pp, mod.key_gen(pp, r)

    r, pp, keys = keyed("seed")
    raw = b"Hello, BBS+!" if plus else b"Hello, BBS!"
    msg = raw if plus else mod.encode_message(raw)
    sig = mod.sign_batch(pp, keys.sk, [msg], r)[0]
    flow = {
        "pp": ((pp.g1_g2_h0 if plus else pp.g1_g2).hex() == vec["g1"] + vec["g2"]
               + vec.get("h0", "") and [h.hex() for h in pp.h] == vec["h"]),
        "keys": (keys.sk.hex(), keys.pk.hex()) == (vec["sk"], vec["pk"]),
        "signature": sig.hex() == (vec["signature_A"] + vec["signature_x"]
                                   + vec.get("signature_r", "")),
        "verify": mod.verify_batch(pp, keys.pk, [msg], [sig]).tolist() == [vec["verify"]],
    }
    if not all(flow.values()):
        raise SystemExit(f"{name}: the {name}_flow.json vector failed: {flow}")

    seed = b"bench-bbs-plus" if plus else b"bench-bbs"
    r, pp, keys = keyed(seed)
    raws = ([((seed + b"-%06d" % i) * 7)[:BBS_MSG_BYTES] for i in range(BBS_B - 1)]
            + [seed + b"-short"])
    msgs = raws if plus else [mod.encode_message(m) for m in raws]
    sign_kernels = ("fp_mont_mul", "fp_pow_fixed", "g1_add", "g1_dbl")
    sigs, sign_first_s, sign_launches = _counted(
        f"{name}_sign", sign_kernels, lambda: mod.sign_batch(pp, keys.sk, msgs, r))

    # 4 signatures again on the CPU path and by the host signer, from the
    # same seed; 8 rows' A^(gamma + x) = g1 (h0^r) prod h_i^m_i in host
    # integers
    t0 = time.perf_counter()
    r_cpu, pp_cpu, keys_cpu = keyed(seed)
    r_host, pp_host, keys_host = keyed(seed)
    checks = {
        "cpu_rows": mod.sign_batch(pp_cpu, keys_cpu.sk, msgs[:4], r_cpu, device="cpu") == sigs[:4],
        "host_sign": [mod.sign(pp_host, keys_host.sk, m, r_host) for m in msgs[:4]] == sigs[:4],
    }
    g1 = parse(G1, pp.g1_g2_h0[:49] if plus else pp.g1_g2[:49]).pt
    bases = ([parse(G1, pp.g1_g2_h0[146:]).pt] if plus else []) + [parse(G1, h).pt for h in pp.h]
    gamma = parse(Zp, keys.sk).value
    rows = [0, 1, 2, 3, BBS_B // 2, BBS_B // 2 + 1, BBS_B - 2, BBS_B - 1]
    eq_ok = []
    for i in rows:
        A, x = parse(G1, sigs[i][:49]).pt, parse(Zp, sigs[i][49:97]).value
        exps = ([parse(Zp, sigs[i][97:]).value] if plus else []) + blocks(raws[i])
        eq_ok.append(C.g1_mul(A, gamma + x) == C.g1_add(g1, C.g1_msm(bases, exps)))
    checks["host_equation_rows"] = all(eq_ok)
    if not all(checks.values()):
        raise SystemExit(f"{name}: sign checks failed: {checks}")
    sign_checks_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sign_times = _timed_calls(lambda: mod.sign_batch(pp, keys.sk, msgs, r), 3)
    sign_peak = torch.cuda.max_memory_allocated()

    ok, verify_first_s, verify_launches = _counted(
        f"{name}_verify", G1_PAIRING, lambda: mod.verify_batch(pp, keys.pk, msgs, sigs))
    checks["verified"] = int(ok.sum())
    if ok.shape != (BBS_B,) or checks["verified"] != BBS_B:
        raise SystemExit(f"{name}: {checks['verified']} of {BBS_B} signatures verified")
    torch.cuda.reset_peak_memory_stats()
    verify_times = _timed_calls(lambda: mod.verify_batch(pp, keys.pk, msgs, sigs), 2)
    verify_peak = torch.cuda.max_memory_allocated()

    # rejections in one call, whose torch ops are tallied (a verify call's
    # ops do not depend on the verdicts): the first half's messages rotated
    # among themselves (every row rejected), and in the valid second half
    # one row's x swapped with the next row's (that row alone rejected);
    # then an A whose x is off the curve raises
    t0 = time.perf_counter()
    half, j = BBS_B // 2, BBS_B // 2 + 5
    bad_msgs = msgs[1:half] + msgs[:1] + msgs[half:]
    bad = list(sigs)
    bad[j] = sigs[j][:49] + sigs[j + 1][49:97] + sigs[j][97:]
    out = []
    ops = _op_tally(lambda: out.append(mod.verify_batch(pp, keys.pk, bad_msgs, bad)))
    got = out[0]
    checks["rotated_rejected"] = not got[:half].any()
    checks["swapped_x_rejected"] = not got[j] and bool(np.delete(got[half:], j - half).all())
    off = list(sigs)
    off[3] = _off_curve_x() + sigs[3][49:]
    try:
        mod.verify_batch(pp, keys.pk, msgs, off)
        checks["off_curve_raises"] = False
    except ValueError as e:
        checks["off_curve_raises"] = "not on curve" in str(e)
    if not all(checks.values()):
        raise SystemExit(f"{name}: checks failed: {checks}")
    rejections_s = time.perf_counter() - t0
    traced = _trace(lambda: mod.verify_batch(pp, keys.pk, msgs, sigs)) if trace else ""
    launch_rows = {p: ROWS_BY_PATH[p] for p in (f"{name}_sign", f"{name}_verify")}
    print(f"{name}: B={BBS_B} blocks={len(blocks(raws[0]))} flow={flow} checks={checks} "
          f"sign_first_s={sign_first_s:.3f} sign_call_s={[round(t, 4) for t in sign_times]} "
          f"signs_per_s={BBS_B * len(sign_times) / sum(sign_times):.1f} "
          f"verify_first_s={verify_first_s:.3f} "
          f"verify_call_s={[round(t, 4) for t in verify_times]} "
          f"verifies_per_s={BBS_B * len(verify_times) / sum(verify_times):.1f} "
          f"sign_max_memory_allocated={sign_peak} verify_max_memory_allocated={verify_peak} "
          f"launches_per_sign_call={sign_launches} launches_per_verify_call={verify_launches} "
          f"launch_rows={launch_rows} verify_{ops} sign_checks_s={sign_checks_s:.1f} "
          f"rejections_and_op_tally_s={rejections_s:.1f} {traced}", flush=True)


def phase_sss(dev):
    """Shamir sharing and reconstruction (K1's Fr product and chain): the
    sss_flow.json vector, then SSS_N shares at threshold SSS_T and the
    secret back from SSS_T of them spread over 1..SSS_N; sharing and
    reconstructing are two counted paths."""
    import torch

    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import Zp, create_random_engine, polynomial, select_in

    sss = T.sss
    vec = json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                      / "sss_flow.json").read_text())
    r = create_random_engine("seed")
    secret = select_in(Zp, r).serialize()
    shares = sss.share_batch(4, 6, secret, r)
    rec = sss.reconstruct_batch([1, 3, 4, 6], [shares[i - 1] for i in (1, 3, 4, 6)])
    flow = {"secret": secret.hex() == vec["secret"],
            "shares": [s.hex() for s in shares] == vec["shares"],
            "reconstructed": rec.hex() == vec["reconstructed"] and (rec == secret) == vec["match"]}
    if not all(flow.values()):
        raise SystemExit(f"sss: the sss_flow.json vector failed: {flow}")

    r = create_random_engine("bench-sss")
    secret = select_in(Zp, r).serialize()
    shares, share_first_s, share_launches = _counted(
        "sss_share", ("fr_mont_mul",), lambda: sss.share_batch(SSS_T, SSS_N, secret, r))
    # the same draws on the host: 8 shares by the host polynomial
    r_host = create_random_engine("bench-sss")
    s0 = select_in(Zp, r_host)
    coeffs = select_in(Zp, r_host, SSS_T - 1)
    pts = [1, 2, 3, SSS_N // 2, SSS_N // 2 + 1, SSS_N - 2, SSS_N - 1, SSS_N]
    checks = {"host_rows": [shares[x - 1] for x in pts]
              == [polynomial(x, s0, coeffs).serialize() for x in pts]}
    torch.cuda.reset_peak_memory_stats()
    share_times = _timed_calls(lambda: sss.share_batch(SSS_T, SSS_N, secret, r), 3)
    share_peak = torch.cuda.max_memory_allocated()

    idx = [1 + (i * SSS_N) // SSS_T for i in range(SSS_T)]
    picked = [shares[i - 1] for i in idx]
    rec, rec_first_s, rec_launches = _counted(
        "sss_reconstruct", ("fr_mont_mul", "fr_pow_fixed"),
        lambda: sss.reconstruct_batch(idx, picked))
    checks["secret_back"] = rec == secret
    checks["t_minus_1_not_secret"] = sss.reconstruct_batch(idx[1:], picked[1:]) != secret
    sub = idx[::SSS_T // 16][:16]
    sub_shares = [shares[i - 1] for i in sub]
    checks["host_reconstruct_16"] = (sss.reconstruct_batch(sub, sub_shares)
                                     == sss.reconstruct(sub, sub_shares))
    if not all(checks.values()):
        raise SystemExit(f"sss: checks failed: {checks}")
    torch.cuda.reset_peak_memory_stats()
    rec_times = _timed_calls(lambda: sss.reconstruct_batch(idx, picked), 3)
    rec_peak = torch.cuda.max_memory_allocated()
    ops = _op_tally(lambda: sss.reconstruct_batch(idx, picked))
    launch_rows = {p: ROWS_BY_PATH[p] for p in ("sss_share", "sss_reconstruct")}
    print(f"sss: t={SSS_T} n={SSS_N} flow={flow} checks={checks} "
          f"share_first_s={share_first_s:.3f} share_call_s={[round(t, 4) for t in share_times]} "
          f"shares_per_s={SSS_N * len(share_times) / sum(share_times):.1f} "
          f"reconstruct_first_s={rec_first_s:.4f} "
          f"reconstruct_call_s={[round(t, 4) for t in rec_times]} "
          f"reconstructs_per_s={len(rec_times) / sum(rec_times):.2f} "
          f"share_max_memory_allocated={share_peak} reconstruct_max_memory_allocated={rec_peak} "
          f"launches_per_share_call={share_launches} "
          f"launches_per_reconstruct_call={rec_launches} launch_rows={launch_rows} "
          f"reconstruct_{ops}", flush=True)


def _flow(name: str) -> dict:
    return json.loads((pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
                       / f"{name}_flow.json").read_text())


def _timed_path(path: str, kernels, fn, timed):
    """A counted first call of fn (the path's launches), then each call of
    `timed` (the same work, some on tampered rows) on the host clock, with
    the peak device memory over them: (first result, timed results, report
    fields)."""
    import torch

    out, first_s, launches = _counted(path, kernels, fn)
    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    for f in timed:
        t0 = time.perf_counter()
        outs.append(f())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    return out, outs, {"first_s": round(first_s, 3), "call_s": [round(t, 4) for t in times],
                       "mean_s": sum(times) / len(times), "max_memory_allocated": peak,
                       "launches_per_call": launches}


def _report(name: str, rows: int, unit: str, rep: dict) -> str:
    """'<name>_first_s=... <name>_call_s=[...] <unit>_per_s=... ...'."""
    return (f"{name}_first_s={rep['first_s']} {name}_call_s={rep['call_s']} "
            f"{unit}_per_s={rows / rep['mean_s']:.1f} "
            f"{name}_max_memory_allocated={rep['max_memory_allocated']} "
            f"launches_per_{name}_call={rep['launches_per_call']}")


def _fail(name: str, checks: dict) -> None:
    if not all(checks.values()):
        raise SystemExit(f"{name}: checks failed: {checks}")


def phase_keccak(dev, trace: bool):
    """The device SHA3-512 sponge (plain PyTorch) and hash_to_zp (K1's Fr
    product): SCHEME_B ragged rows of 0 to 1,100 bytes, the framing edges
    among them, against hashlib; the same rows framed on the device with
    junk past each length; the digests mod r against ZpNumber.from_hash."""
    import hashlib

    import torch

    from crypto12381_tpu_torch.api.batch import hash_to_zp
    from crypto12381_tpu_torch.api.elements import ZpNumber
    from crypto12381_tpu_torch.hashing import keccak as KC

    rng = np.random.default_rng(SEED + 11)
    edges = [0, 71, 72, 143, 144, 575, KECCAK_MAX]
    lens = np.array(edges + list(rng.integers(0, KECCAK_MAX + 1, SCHEME_B - len(edges))))
    rows = [rng.bytes(int(n)) for n in lens]
    data = np.zeros((SCHEME_B, KECCAK_MAX), np.uint8)
    data[np.arange(KECCAK_MAX)[None, :] < lens[:, None]] = np.frombuffer(b"".join(rows), np.uint8)
    want = [hashlib.sha3_512(r).digest() for r in rows]

    def run():
        d = KC.sha3_512_batch(data, lens)
        return d, hash_to_zp(d)

    (dig, z), _, rep = _timed_path("keccak", ("fr_mont_mul",), run, [run] * 3)
    junk = torch.from_numpy(np.where(np.arange(KECCAK_MAX)[None, :] < lens[:, None], data,
                                     0xA5).astype(np.uint8)).to(dev)
    framed = KC.sha3_512_blocks(*KC.frame_device(junk, torch.from_numpy(lens).to(dev)))
    checks = {
        "sha3_512_batch": [bytes(r) for r in dig.cpu().numpy()] == want,
        "frame_device": torch.equal(framed, dig),
        "hash_to_zp": list(z.to_ints()) == [ZpNumber.from_hash(d).value for d in want],
    }
    _fail("keccak", checks)
    ops = _op_tally(run)
    traced = _trace(run) if trace else ""
    print(f"keccak: B={SCHEME_B} bytes={int(lens.sum())} max_len={KECCAK_MAX} checks={checks} "
          f"{_report('sponge', SCHEME_B, 'digests', rep)} sponge_{ops} {traced}", flush=True)


def phase_bbs04(dev, trace: bool):
    """BBS04 group signatures: the bbs04_flow.json vector on the host (key
    generation, signing, the host verify and opening); then key_gen(16),
    one host signature per member on messages of 0 to 300 bytes, tiled to
    SCHEME_B rows: verify_batch (device Fiat-Shamir) and open_batch with
    their gates; two counted paths."""
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine
    from crypto12381_tpu_torch.params import R

    mod, vec = T.bbs04, _flow("bbs04")
    r = create_random_engine("seed")
    keys = mod.key_gen(4, r)
    msg = b"hello bbs\x00"
    sig = mod.sign(keys.gpk, keys.gsk[2], msg, r)
    opened = mod.open_signature(keys.gmsk, sig)
    flow = {
        "keys": (keys.gpk.hex(), keys.gmsk.hex(), [g.hex() for g in keys.gsk])
                == (vec["gpk"], vec["gmsk"], vec["gsk"]),
        "signature": sig.hex() == vec["signature"],
        "verify": mod.verify(keys.gpk, msg, sig) == vec["verify"],
        "opened": opened.hex() == vec["opened"] and keys.gsk[vec["opened_index"]][:49] == opened,
    }
    _fail("bbs04 flow", flow)

    t0 = time.perf_counter()
    r = create_random_engine("bench-bbs04")
    keys = mod.key_gen(BBS04_MEMBERS, r)
    rng = np.random.default_rng(SEED + 12)
    lens = [0, BBS04_MAX_MSG] + list(rng.integers(1, BBS04_MAX_MSG, BBS04_MEMBERS - 2))
    msgs16 = [rng.bytes(int(n)) for n in lens]
    sigs16 = [mod.sign(keys.gpk, keys.gsk[i], msgs16[i], r) for i in range(BBS04_MEMBERS)]
    host_sign_s = time.perf_counter() - t0
    msgs = [msgs16[i % BBS04_MEMBERS] for i in range(SCHEME_B)]
    sigs = [sigs16[i % BBS04_MEMBERS] for i in range(SCHEME_B)]
    j, off = SCHEME_B // 3, 147 + 3 * 48          # row j's sx + 1 mod r
    sx = (int.from_bytes(sigs[j][off:off + 48], "big") + 1) % R
    bad = list(sigs)
    bad[j] = sigs[j][:off] + sx.to_bytes(48, "big") + sigs[j][off + 48:]
    ok, (_, got), vrep = _timed_path(
        "bbs04_verify", G1_PAIRING + ("fr_mont_mul",),
        lambda: mod.verify_batch(keys.gpk, msgs, sigs),
        [lambda: mod.verify_batch(keys.gpk, msgs, sigs),
         lambda: mod.verify_batch(keys.gpk, msgs, bad)])
    host_rows = [0, 1, SCHEME_B // 2 + 1, SCHEME_B - 1]
    checks = {"verified": int(ok.sum()) == SCHEME_B and ok.shape == (SCHEME_B,),
              "host_rows": [mod.verify(keys.gpk, msgs[i], sigs[i]) for i in host_rows]
              == ok[host_rows].tolist(),
              "changed_sx_rejected_alone": not got[j] and bool(np.delete(got, j).all())}
    out = []
    ops = _op_tally(lambda: out.append(mod.verify_batch(keys.gpk, msgs[1:] + msgs[:1], sigs)))
    checks["rotated_rejected"] = not out[0].any()
    opened, _, orep = _timed_path("bbs04_open", ("fp_mont_mul", "fp_pow_fixed", "g1_add",
                                                 "g1_dbl"),
                                  lambda: mod.open_batch(keys.gmsk, sigs),
                                  [lambda: mod.open_batch(keys.gmsk, sigs)] * 2)
    checks["open_batch"] = opened == [keys.gsk[i % BBS04_MEMBERS][:49] for i in range(SCHEME_B)]
    _fail("bbs04", checks)
    open_ops = _op_tally(lambda: mod.open_batch(keys.gmsk, sigs))
    traced = _trace(lambda: mod.verify_batch(keys.gpk, msgs, sigs)) if trace else ""
    print(f"bbs04: B={SCHEME_B} members={BBS04_MEMBERS} flow={flow} checks={checks} "
          f"host_sign_s={host_sign_s:.1f} {_report('verify', SCHEME_B, 'verifies', vrep)} "
          f"{_report('open', SCHEME_B, 'opens', orep)} "
          f"launch_rows={ {p: ROWS_BY_PATH[p] for p in ('bbs04_verify', 'bbs04_open')} } "
          f"verify_{ops} open_{open_ops} {traced}", flush=True)


def phase_ac(dev, name: str, trace: bool):
    """AC-BBS or AC-RBBS: the flow vector at n = 32, I = {0, 3}, m = 0x00;
    then AC_PRES host presentations of the flow's credential tiled to
    SCHEME_B rows: verify_batch with its gates; one counted path."""
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine
    from crypto12381_tpu_torch.params import R

    mod, vec, rbbs = getattr(T, name), _flow(name), name == "ac_rbbs"
    I, m = [0, 3], b"\x00"
    r = create_random_engine("seed")
    keys = mod.keygen(AC_N, r)
    attr = mod.generate_attributes(keys.pk, AC_N, r)
    sig = mod.issue(keys, attr, r)
    flow = {"keys": (keys.sk.hex(), keys.pk.fixed_part.hex(), [y.hex() for y in keys.pk.Y])
            == (vec["sk"], vec["pk_fixed"], vec["Y"]),
            "attr": [a.hex() for a in attr] == vec["attr"],
            "sig": sig.hex() == vec["sig_A"] + vec["sig_w"]}
    t0 = time.perf_counter()
    if rbbs:
        rc = mod.redact(attr, sig, I, keys.pk)
        flow["tilde_Y"] = [y.hex() for y in keys.pk.tilde_Y] == vec["tilde_Y"]
        flow["redact"] = rc.hex() == vec["redact"]
        pres = [mod.pres(m, sig, rc, r) for _ in range(AC_PRES + 1)]
        flow["pres"] = pres[0].hex() == vec["pres"]
    else:
        pres = [mod.pres(m, attr, sig, I, keys.pk, r) for _ in range(AC_PRES + 1)]
        flow["pres"] = (pres[0].fixed_part.hex() == vec["pres_fixed"]
                        and [u.hex() for u in pres[0].u] == vec["pres_u"])
    flow["verify"] = mod.verify(m, attr, I, pres[0], keys.pk) == vec["verify"]
    _fail(f"{name} flow", flow)
    host_pres_s = time.perf_counter() - t0
    rows = [pres[1 + i % AC_PRES] for i in range(SCHEME_B)]
    j, bad = SCHEME_B // 3, list(rows)
    if rbbs:       # row j's last scalar t + 1 mod r
        t = (int.from_bytes(rows[j][-48:], "big") + 1) % R
        bad[j] = rows[j][:-48] + t.to_bytes(48, "big")
        what = "t_plus_1_rejected_alone"
    else:          # row j with row j + 1's u list
        bad[j] = mod.PresInfo(rows[j].fixed_part, rows[j + 1].u)
        what = "other_u_rejected_alone"
    ok, (_, got), rep = _timed_path(f"{name}_verify", G1_PAIRING,
                                    lambda: mod.verify_batch(m, attr, I, rows, keys.pk),
                                    [lambda: mod.verify_batch(m, attr, I, rows, keys.pk),
                                     lambda: mod.verify_batch(m, attr, I, bad, keys.pk)])
    host_rows = [0, 1, SCHEME_B // 2 + 1, SCHEME_B - 1]
    checks = {"verified": int(ok.sum()) == SCHEME_B and ok.shape == (SCHEME_B,),
              "host_rows": [mod.verify(m, attr, I, rows[i], keys.pk) for i in host_rows]
              == ok[host_rows].tolist(),
              what: not got[j] and bool(np.delete(got, j).all())}
    out = []
    ops = _op_tally(lambda: out.append(mod.verify_batch(b"\x01", attr, I, rows, keys.pk)))
    checks["other_m_rejected"] = not out[0].any()
    _fail(name, checks)
    traced = _trace(lambda: mod.verify_batch(m, attr, I, rows, keys.pk)) if trace else ""
    print(f"{name}: B={SCHEME_B} n={AC_N} I={I} presentations={AC_PRES} flow={flow} "
          f"checks={checks} host_pres_s={host_pres_s:.1f} "
          f"{_report('verify', SCHEME_B, 'verifies', rep)} "
          f"launch_rows={ROWS_BY_PATH[f'{name}_verify']} verify_{ops} {traced}", flush=True)


def _ac_rps_host_terms(m, attr, I, presinfo, pk):
    """The four GT sides of AC-RPS's t1 and t2 on the host (schemes/ac_rps.py
    `verify`), as host GT elements."""
    from crypto12381_tpu_torch.api.sets import G1, G2, GT, Zp, hash_, inverse, pair, parse
    from crypto12381_tpu_torch.schemes import ac_rps

    tg, tY0, tXc, CYq = ac_rps._verify_constants(attr, I, pk)
    A_, B_, D_, tCJ_, U, s = parse(G1 ** 3, G2, GT, Zp, presinfo)
    c = hash_(m, A_, B_, tCJ_, D_, U).to(Zp)
    return (pair(A_, tY0 ** s) * inverse(U),
            (pair(inverse(A_), tXc * tCJ_) * pair(B_, tg)) ** c,
            pair(CYq, tCJ_).value(), pair(D_, tg).value())


def phase_ac_rps(dev, trace: bool):
    """AC-RPS: the ac_rps_flow.json vector at n = 64, I = {0, 1, 3}, with
    verify, t1 and t2 False (reference fault F6); then RPS_PRES host
    presentations tiled to SCHEME_B rows: verify_batch equals the host
    verify, and the device GT terms of t1 and t2 equal the host ones byte
    for byte; one counted path."""
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine

    mod, vec = T.ac_rps, _flow("ac_rps")
    I, m = [0, 1, 3], b"\x00"
    r = create_random_engine("seed")
    keys = mod.keygen(RPS_N, r)
    attr = mod.generate_attributes(keys.pk, RPS_N, r)
    sig = mod.issue(keys, attr, r)
    rc = mod.redact(attr, sig, I, keys.pk)
    t0 = time.perf_counter()
    pres = [mod.pres(m, attr, sig, I, rc, keys.pk, r) for _ in range(RPS_PRES + 1)]
    host_pres_s = time.perf_counter() - t0
    l1, r1, l2, r2 = _ac_rps_host_terms(m, attr, I, pres[0], keys.pk)
    flow = {"keys": (keys.sk.hex(), keys.pk.fixed_part.hex(), [y.hex() for y in keys.pk.Y],
                     [y.hex() for y in keys.pk.tilde_Y])
            == (vec["sk"], vec["pk_fixed"], vec["Y"], vec["tilde_Y"]),
            "attr": [a.hex() for a in attr] == vec["attr"],
            "sig": sig.hex() == vec["sig"], "redact": rc.hex() == vec["redact"],
            "pres": pres[0].hex() == vec["pres"],
            "verify": mod.verify(m, attr, I, pres[0], keys.pk) is vec["verify"] is False,
            "t1": (l1 == r1) is vec["verify_t1"] is False,
            "t2": (l2 == r2) is vec["verify_t2"] is False}
    _fail("ac_rps flow", flow)
    rows = [pres[1 + i % RPS_PRES] for i in range(SCHEME_B)]
    ok, _, rep = _timed_path("ac_rps_verify", G2_PAIRING + ("fp12_usqr",),
                             lambda: mod.verify_batch(m, attr, I, rows, keys.pk),
                             [lambda: mod.verify_batch(m, attr, I, rows, keys.pk)] * 2)
    host_rows = [0, 1, SCHEME_B // 2 + 1, SCHEME_B - 1]
    checks = {"shape": ok.shape == (SCHEME_B,),
              "host_rows": [mod.verify(m, attr, I, rows[i], keys.pk) for i in host_rows]
              == ok[host_rows].tolist()}
    t0 = time.perf_counter()
    dev_terms = mod._gt_terms(m, attr, I, pres[1:], keys.pk, dev)
    host_terms = [_ac_rps_host_terms(m, attr, I, p, keys.pk) for p in pres[1:]]
    checks["gt_terms_bytes"] = all(
        t.serialize() == [h[k].serialize() for h in host_terms] for k, t in enumerate(dev_terms))
    terms_s = time.perf_counter() - t0
    _fail("ac_rps", checks)
    ops = _op_tally(lambda: mod.verify_batch(m, attr, I, rows, keys.pk))
    traced = _trace(lambda: mod.verify_batch(m, attr, I, rows, keys.pk)) if trace else ""
    print(f"ac_rps: B={SCHEME_B} n={RPS_N} I={I} presentations={RPS_PRES} flow={flow} "
          f"checks={checks} verdicts_false={int((~ok).sum())} host_pres_s={host_pres_s:.1f} "
          f"gt_terms_check_s={terms_s:.1f} {_report('verify', SCHEME_B, 'verifies', rep)} "
          f"launch_rows={ROWS_BY_PATH['ac_rps_verify']} verify_{ops} {traced}", flush=True)


def phase_ps_n(dev, trace: bool):
    """Multi-message PS: key_gen_n(PS_N_UNITS), SCHEME_B messages of 1 to 4
    encode_to units signed on the host, verify_n_batch with its gates (one
    counted path); and the host sign and verify of PS, BBS and BBS+ on their
    flow vectors (the host pairing)."""
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine

    ps, bbs, bbs_plus = T.ps, T.bbs, T.bbs_plus
    flows = {}
    vec = _flow("ps")
    r = create_random_engine("seed")
    keys = ps.key_gen(r)
    msg = b"\x00" * 47 + b"\x17"
    sig = ps.sign(keys.sk, msg, r)
    rand_sig = ps.randomnize(sig, r)
    flows["ps"] = (sig.hex() == vec["signature"] and rand_sig.hex() == vec["signature_rand"]
                   and ps.verify(keys.pk, msg, rand_sig) is vec["verify"] is True)
    for name, mod, raw in (("bbs", bbs, b"Hello, BBS!"), ("bbs_plus", bbs_plus, b"Hello, BBS+!")):
        vec = _flow(name)
        r = create_random_engine("seed")
        pp = mod.setup(16, r)
        k = mod.key_gen(pp, r)
        msg = mod.encode_message(raw) if name == "bbs" else raw
        sig = mod.sign(pp, k.sk, msg, r)
        flows[name] = (sig.hex() == vec["signature_A"] + vec["signature_x"]
                       + vec.get("signature_r", "")
                       and mod.verify(pp, k.pk, msg, sig) is vec["verify"] is True)
    _fail("ps_n flows", flows)

    t0 = time.perf_counter()
    r = create_random_engine("bench-ps-n")
    keys = ps.key_gen_n(PS_N_UNITS, r)
    msgs = [((b"ps-n-%06d-" % i) * 12)[:1 + (37 * i) % (31 * PS_N_UNITS)]
            for i in range(SCHEME_B)]
    sigs = [ps.sign_n(keys, mm, r) for mm in msgs]
    host_sign_s = time.perf_counter() - t0
    ok, _, rep = _timed_path("ps_n_verify", G2_PAIRING, lambda: ps.verify_n_batch(keys, msgs, sigs),
                             [lambda: ps.verify_n_batch(keys, msgs, sigs)] * 2)
    host_rows = [0, 1, SCHEME_B // 2 + 1, SCHEME_B - 1]
    checks = {"verified": int(ok.sum()) == SCHEME_B and ok.shape == (SCHEME_B,),
              "host_rows": [ps.verify_n(keys, msgs[i], sigs[i]) for i in host_rows]
              == ok[host_rows].tolist()}
    out = []
    ops = _op_tally(lambda: out.append(ps.verify_n_batch(keys, msgs[1:] + msgs[:1], sigs)))
    checks["rotated_rejected"] = not out[0].any()
    _fail("ps_n", checks)
    traced = _trace(lambda: ps.verify_n_batch(keys, msgs, sigs)) if trace else ""
    print(f"ps_n: B={SCHEME_B} units={PS_N_UNITS} host_flows={flows} checks={checks} "
          f"host_sign_s={host_sign_s:.1f} {_report('verify', SCHEME_B, 'verifies', rep)} "
          f"launch_rows={ROWS_BY_PATH['ps_n_verify']} verify_{ops} {traced}", flush=True)


def phase_mhac(dev, trace: bool):
    """MHAC-BBS: the mhac_bbs_flow.json vector through the host functions;
    then cred_pres_batch of SCHEME_B presentations of the flow's credential
    (its first rows against the host cred_pres on a second engine of the
    same seed) and verify_pres_batch of them with their gates; two counted
    paths."""
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api.sets import create_random_engine

    mh, vec = T.mhac_bbs, _flow("mhac_bbs")
    r = create_random_engine("seed")
    st = mh.iss_setup(MHAC_M, r)
    pp, keys = st.pp, st.keys
    Pub = [i for i in range(MHAC_M) if i not in MHAC_PRV]
    ai = mh.generate_attributes(pp, MHAC_T, MHAC_N, MHAC_PRV, r)
    creds = mh.cred_iss(pp, keys.sk, MHAC_T, ai.commitments, Pub, ai.public_attributes, r)
    grp = mh.make_pres_group(creds, MHAC_S)
    ptype = mh.make_pres_type(pp, MHAC_REV, MHAC_PRV, ai.public_attributes)
    pres = mh.cred_pres(pp, creds, grp, ptype, MHAC_PRV, ai.public_attributes,
                        ai.private_attributes_share, r)
    flow = {
        "setup": (pp.g1_g2.hex(), [x.hex() for x in pp.h], keys.sk.hex(), keys.pk.hex())
                 == (vec["g1g2"], vec["h"], vec["sk"], vec["pk"]),
        "attributes": ([a.hex() for a in ai.public_attributes],
                       [[x.hex() for x in row_] for row_ in ai.private_attributes_share],
                       [c.hex() for c in ai.commitments]) == (vec["pub_attrs"], vec["shares"],
                                                              vec["C"]),
        "creds": (creds.A.hex(), [x.hex() for x in creds.e_share], [d.hex() for d in creds.D])
                 == (vec["cred_A"], vec["e_share"], vec["D"]),
        "group_type": ([x.hex() for x in grp.lam], grp.D.hex(), ptype.C_rev.hex(),
                       ptype.C_pub.hex()) == (vec["group_lam"], vec["group_D"], vec["C_rev"],
                                              vec["C_pub"]),
        "pres": (pres.fixed_part.hex(), [z.hex() for z in pres.z],
                 [z.hex() for z in pres.z_hid_pub]) == (vec["pres_fixed"], vec["pres_z"],
                                                        vec["pres_z_hid_pub"]),
        "verify": mh.verify_pres(pp, keys.pk, ptype, MHAC_PRV, ai.public_attributes, pres)
                  is vec["verify"] is True,
    }
    _fail("mhac_bbs flow", flow)

    args = (pp, [creds] * SCHEME_B, [grp] * SCHEME_B, [ptype] * SCHEME_B, MHAC_PRV,
            [ai.public_attributes] * SCHEME_B, [ai.private_attributes_share] * SCHEME_B)
    draws = create_random_engine("bench-mhac")
    rows, _, prep = _timed_path("mhac_pres", ("fp_mont_mul", "fp_pow_fixed", "g1_add", "g1_dbl"),
                                lambda: mh.cred_pres_batch(*args, draws),
                                [lambda: mh.cred_pres_batch(*args, draws)] * 2)
    t0 = time.perf_counter()
    host_draws = create_random_engine("bench-mhac")
    host = [mh.cred_pres(pp, creds, grp, ptype, MHAC_PRV, ai.public_attributes,
                         ai.private_attributes_share, host_draws) for _ in range(4)]
    host_pres_s = time.perf_counter() - t0
    checks = {"host_cred_pres": rows[:4] == host}
    j = SCHEME_B // 3                       # row j with row j + 1's z
    bad = list(rows)
    bad[j] = mh.Pres(rows[j].fixed_part, list(rows[j + 1].z), list(rows[j].z_hid_pub))

    def verify(prs, attrs=ai.public_attributes):
        return mh.verify_pres_batch(pp, keys.pk, ptype, MHAC_PRV, attrs, prs)

    ok, (_, got), vrep = _timed_path("mhac_verify", G1_PAIRING + ("fr_mont_mul",),
                                     lambda: verify(rows),
                                     [lambda: verify(rows), lambda: verify(bad)])
    host_rows = [0, 1, SCHEME_B // 2 + 1, SCHEME_B - 1]
    checks.update({
        "verified": int(ok.sum()) == SCHEME_B and ok.shape == (SCHEME_B,),
        "host_rows": [mh.verify_pres(pp, keys.pk, ptype, MHAC_PRV, ai.public_attributes, rows[i])
                      for i in host_rows] == ok[host_rows].tolist(),
        "other_z_rejected_alone": not got[j] and bool(np.delete(got, j).all())})
    out = []
    ops = _op_tally(lambda: out.append(verify(rows, ai.public_attributes[::-1])))
    checks["other_attributes_rejected"] = not out[0].any()
    _fail("mhac_bbs", checks)
    traced = _trace(lambda: verify(rows)) if trace else ""
    print(f"mhac_bbs: B={SCHEME_B} m={MHAC_M} Prv={MHAC_PRV} t={MHAC_T} n={MHAC_N} S={MHAC_S} "
          f"Rev={MHAC_REV} flow={flow} checks={checks} host_pres_s_4={host_pres_s:.2f} "
          f"{_report('pres', SCHEME_B, 'presentations', prep)} "
          f"{_report('verify', SCHEME_B, 'verifies', vrep)} "
          f"launch_rows={ {p: ROWS_BY_PATH[p] for p in ('mhac_pres', 'mhac_verify')} } "
          f"verify_{ops} {traced}", flush=True)


def phase_hash_g1(dev, trace: bool):
    """The hash to G1 on the card: HASH_G1_B SHA3-512 digests of seeded
    bytes, three of them replaced by digests whose value mod p is 0, 1 and
    p - 1; 8 rows, the edges among them, against the host
    G1Element.from_hash; SHA3-512("abc") against reference.json; on the
    card, every row on the curve and in G1 but the digest 0 mod p, which
    gives the reference's degenerate point (x0, 0) off the curve (F7);
    one counted path."""
    import hashlib

    import torch

    from crypto12381_tpu_torch.api.batch import G1Vec, hash_to_g1
    from crypto12381_tpu_torch.api.elements import G1Element
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.params import P

    rng = np.random.default_rng(SEED + 13)
    digests = [hashlib.sha3_512(rng.bytes(32)).digest() for _ in range(HASH_G1_B)]
    edge_rows = {1: 0, HASH_G1_B // 2: 1, HASH_G1_B - 1: P - 1}
    for i, e in edge_rows.items():
        digests[i] = (int(rng.integers(1, 1 << 40)) * P + e).to_bytes(64, "big")
    d = torch.from_numpy(np.frombuffer(b"".join(digests), np.uint8).reshape(-1, 64).copy()).to(dev)
    pts, _, rep = _timed_path("hash_g1", ("fp_mont_mul", "fp_pow_fixed", "g1_add", "g1_dbl"),
                              lambda: hash_to_g1(d), [lambda: hash_to_g1(d)] * 2)
    host_rows = sorted(set(edge_rows) | {0, 2, 3, HASH_G1_B // 3, HASH_G1_B - 2})
    idx = torch.tensor(host_rows, device=dev)
    sub = G1Vec(tuple(c.index_select(0, idx) for c in pts.p))
    member = torch.ones(HASH_G1_B, dtype=torch.bool)
    member[1] = False                                 # the digest 0 mod p (F7)
    abc = hashlib.sha3_512(b"abc").digest()
    abc_dev = torch.from_numpy(np.frombuffer(abc, np.uint8)[None].copy()).to(dev)
    checks = {
        "host_rows": [e.pt for e in sub.to_elements()]
                     == [G1Element.from_hash(digests[i]).pt for i in host_rows],
        "hash_g1_abc": hash_to_g1(abc_dev).serialize()[0].hex()
                       == json.loads((pathlib.Path(__file__).resolve().parent / "tests"
                                      / "vectors" / "reference.json").read_text())["hash_g1_abc"],
        "on_curve": torch.equal(G1C.on_curve(pts.p).cpu(), member),
        "in_subgroup": torch.equal(G1C.in_subgroup(pts.p).cpu(), member),
        "f7_row_is_host_point": G1Element.from_hash(digests[1]).pt[1] == 0,
    }
    _fail("hash_g1", checks)
    ops = _op_tally(lambda: hash_to_g1(d))
    traced = _trace(lambda: hash_to_g1(d)) if trace else ""
    print(f"hash_g1: B={HASH_G1_B} edges_mod_p={sorted(edge_rows.values())} checks={checks} "
          f"{_report('hash', HASH_G1_B, 'digests', rep)} "
          f"launch_rows={ROWS_BY_PATH['hash_g1']} hash_{ops} {traced}", flush=True)


def main() -> None:
    import torch

    args = ARGS.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from crypto12381_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _smi_line()
    print(f"device: {kind} count={count} nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    regs = {}
    for log in _build.BUILD_LOG.values():
        regs.update(_ptxas_report(log))
    print(f"build: {build_s:.1f}s ptxas={regs}", flush=True)

    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    kernels = timed("kernels", phase_kernels, dev)
    timed("ceiling", phase_ceiling, dev)
    timed("pairing", phase_pairing, dev, args.trace)
    pts, a = timed("g1", phase_g1, dev, args.trace)
    timed("msm", phase_msm, dev, pts, a, args.trace)
    rounds = timed("msm_rounds", phase_msm_rounds, dev, pts, a, args.trace)
    timed("msm_sorted", phase_msm_sorted, dev, rounds, args.trace)
    del rounds
    timed("zp", phase_zp, dev)
    timed("ps", phase_ps, dev, args.trace)
    timed("bbs", phase_bbs, dev, "bbs", args.trace)
    timed("bbs_plus", phase_bbs, dev, "bbs_plus", args.trace)
    timed("sss", phase_sss, dev)
    timed("g2", phase_g2, dev, args.trace)
    timed("algebra", phase_algebra, dev, args.trace)
    timed("keccak", phase_keccak, dev, args.trace)
    timed("bbs04", phase_bbs04, dev, args.trace)
    timed("ac_bbs", phase_ac, dev, "ac_bbs", args.trace)
    timed("ac_rbbs", phase_ac, dev, "ac_rbbs", args.trace)
    timed("ac_rps", phase_ac_rps, dev, args.trace)
    timed("ps_n", phase_ps_n, dev, args.trace)
    timed("mhac_bbs", phase_mhac, dev, args.trace)
    timed("hash_g1", phase_hash_g1, dev, args.trace)
    timed("sharding", phase_sharding, dev)
    _check_chains_timed(kernels)
    timed("rows", phase_rows, dev, kernels)
    print(f"phases_s: {phase_s}", flush=True)
    for k in kernels:
        k["launch_rows_by_path"] = _launch_rows(k)
        k["launches_by_path"] = {path: sum(rows.values())
                                 for path, rows in k["launch_rows_by_path"].items()}
        k["launches"] = sum(k["launches_by_path"].values())
        _weighted(k)
        for key in ("c_function", "exponent", "stack", "rows", "bytes_per_row", "ops_per_row",
                    "fns", "row_shapes", "row_dims"):
            k.pop(key)
    print(f"per_call: {json.dumps(_per_call(kernels))}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
