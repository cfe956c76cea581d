#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its batched pairing on
one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and ends the run non-zero:
  device   card name and count, nvidia-smi's name and power limit
  build    nvcc seconds, registers and spills per kernel
  kernels  K1-K4 at the row counts the pairing gives them at B = 2048,
           each held bit for bit against its plain PyTorch version on the
           card; device time of both (CUDA graph replays timed with CUDA
           events) and the kernel's time when issued eagerly from Python
  pairing  `pair_batch` at B = 2048 (32 distinct pairs, tiled): GT bytes
           against tests/vectors/reference.json, bilinearity, infinity
           masks, 4 rows recomputed on the CPU, pairings/s, launches of
           each kernel in one batch, peak device memory

Then a JSON line of per-kernel numbers, nvidia-smi's line, and as the last
line {"ok": true, "device": {...}}.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import subprocess
import time

import numpy as np

B = 2048
DISTINCT = 32
SEED = 20261016
#: H100 SXM5: HBM3 at 3.35 TB/s; 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#: = 1.673e13 32-bit integer multiply-adds/s (NVIDIA H100 data sheet and
#: Hopper architecture white paper).  Both assume the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: 32-bit multiply-adds of one 12-limb CIOS product: 288 wide products
#: counted twice (low and high halves) plus 12 low products for m
MULADDS_PER_PRODUCT = 2 * (144 + 144) + 12
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
    named = {}
    for mangled, v in out.items():
        for k in ("mont_mul_kernel", "fp2_mul_kernel", "fp2_sqr_kernel", "fp6_mul_kernel"):
            if k in mangled:
                named[k] = v
    return named


def _rand_fp(rng, n, k):
    """(n, k, 12) canonical limbs: uniform words, top word below p's."""
    from crypto12381_tpu_torch.params import P_LIMBS

    w = rng.integers(0, 1 << 32, size=(n, k, 12), dtype=np.uint64)
    w[..., 11] %= P_LIMBS[11]
    return w.astype(np.uint32).view(np.int32)


def _edges(x, vals):
    """Put the edge values into the first rows (every component)."""
    from crypto12381_tpu_torch.fields import fp as FP

    for r, v in enumerate(vals):
        x[r, :, :] = FP.limbs_of(v)
    return x


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


def phase_kernels(dev):
    import torch
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.params import P

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
    specs.append(("K1 mont_mul", "fp_mont_mul", "crypto12381_tpu_torch/csrc/fp.cu",
                  "crypto12381_tpu/fields/fp32.py:354", FP.mont_mul, FP.mont_mul_plain,
                  (a, b), n, 1, 3))
    # K2: 15 rows per pairing row (sparse multiply); K3: 9 (cyclotomic
    # square); K4: 3 (Fp12 product)
    for name, rows, shape, prod, n_in, kern, plain, line in (
        ("K2 fp2_mul", 15 * B, (2,), 3, 2, FK.fp2_mul, FK.fp2_mul_plain, 379),
        ("K3 fp2_sqr", 9 * B, (2,), 2, 1, FK.fp2_sqr, FK.fp2_sqr_plain, 790),
        ("K4 fp6_mul", 3 * B, (3, 2), 18, 2, FK.fp6_mul, FK.fp6_mul_plain, 387),
    ):
        k = int(np.prod(shape))
        ins = tuple(
            torch.from_numpy(_edges(_rand_fp(rng, rows, k), edge if i == 0 else edge[::-1])
                             .reshape((rows,) + shape + (12,))).to(dev)
            for i in range(n_in))
        specs.append((name, name.split()[1], "crypto12381_tpu_torch/csrc/tower.cu",
                      f"crypto12381_tpu/fields/fp32k.py:{line}", kern, plain, ins, rows, prod,
                      n_in + 1))
    results = []
    for name, fn_c, src, repl, kern, plain, ins, rows, prod, n_arrays in specs:
        got = kern(*ins)
        want = plain(*ins)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or not torch.equal(got, want):
            bad = (got != want).reshape(rows, -1).any(-1).nonzero()[:5].flatten().tolist()
            raise SystemExit(f"kernels: {name} disagrees with its plain version at rows {bad}")
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        eager_ms = _eager_ms(lambda: kern(*ins))
        ms = _device_ms(lambda: kern(*ins))
        plain_ms = _device_ms(lambda: plain(*ins))
        nbytes = rows * (got[0].numel() * 4) * n_arrays
        ops = rows * prod * MULADDS_PER_PRODUCT
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "c_function": fn_c, "rows": rows, "max_abs_err": err, "ms": ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        })
    line = "; ".join(
        f"{r['name']} rows={r['rows']} equal=True ms={r['ms']:.6f} eager_ms={r['eager_ms']:.6f} "
        f"plain_ms={r['plain_ms']:.6f} "
        f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})" for r in results)
    print(f"kernels: {line}", flush=True)
    return results


def phase_pairing(dev):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

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
    launches = dict(T.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"pairing: kernels never launched on the main path: {missing}")

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
    reps = 3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        T.pair_batch(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = B * reps / sum(times)
    peak = torch.cuda.max_memory_allocated()

    # torch ops one batch dispatches; all but the views launch a kernel
    class _Count(TorchDispatchMode):
        ops = collections.Counter()

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            _Count.ops[func.__name__.split(".")[0]] += 1
            return func(*a, **(kw or {}))

    with _Count():
        T.pair_batch(*args)
    torch.cuda.synchronize()
    ops = _Count.ops
    views = sum(v for k, v in ops.items() if k in _VIEW_OPS)
    print(f"pairing: B={B} distinct={DISTINCT} checks={checks} first_s={first_s:.3f} "
          f"batch_s={[round(t, 4) for t in times]} pairings_per_s={rate:.1f} "
          f"launches_per_batch={launches} torch_ops_per_batch={sum(ops.values())} "
          f"non_view_ops_per_batch={sum(ops.values()) - views} "
          f"top_ops={ops.most_common(6)} max_memory_allocated={peak}", flush=True)
    return launches


def main() -> None:
    import torch

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

    kernels = phase_kernels(dev)
    launches = phase_pairing(dev)
    for k in kernels:
        k["launches"] = launches[k.pop("c_function")]
        k.pop("rows")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
