#!/usr/bin/env python3
"""Time K8, K12 and K13 in several checkouts of the port, in turns, on one card.

    python3 tools/kernel_turns.py CHECKOUT [CHECKOUT ...] [--k8 1,13,512,2048]
                                  [--k12 13,512,2048,136224] [--k13 2,13,512,2048]

Each checkout in the order given runs in a process of its own, with its
working directory and import path in that checkout, so that it builds and
imports that checkout's kernels (name a checkout twice to time it twice,
e.g. parent, tree, variant, variant, tree, parent).  The process prints
nvcc's registers, spills and shared memory of `fp12_mul`, `g2_add` and
`g2_madd`; then at each row count it holds the kernel bit for bit against
its plain version (K8 on random Fp12 rows with 0, 1 and p - 1 rows at both
ends, K12 and K13 on chip_smoke.py's G2 edge rows and random rows, the
first r of 9 such rows below 9 rows, the plain
version in blocks of 32,768 rows) and times it as chip_smoke.py does (CUDA
graph replays timed with CUDA events).  Prints one JSON line per
checkout, then a table: per kernel and row count its ms in every pass.
A variant is a copy of the tree with one layout changed, unpacked under
`build/`.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

WORKER = r'''
import importlib.util, json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("S", sys.argv[1])
S = importlib.util.module_from_spec(spec); spec.loader.exec_module(S)
from crypto12381_tpu_torch import _build
from crypto12381_tpu_torch.fields import fused as FK
from crypto12381_tpu_torch.params import P
counts = json.loads(sys.argv[2])
t0 = time.time(); _build.build(); build_s = round(time.time() - t0, 1)
rep = {}
for log in _build.BUILD_LOG.values():
    rep.update(S._ptxas_report(log))
rep = {k: v for k, v in rep.items() if any(n in k for n in ("fp12_mul", "g2_add", "g2_madd"))}
dev = torch.device("cuda", 0)
rng = np.random.default_rng(5)

def blocks(plain, *ins):
    r = ins[0].shape[0]
    return torch.cat([plain(*(t[i:i + 32768] for t in ins)) for i in range(0, r, 32768)])

def fp12(r):
    x = S._rand_fp(rng, r, 12)
    if r > 6:
        x = S._edges(x, [0, 1, P - 1], last=True)
    return torch.from_numpy(x.reshape(r, 2, 3, 2, 12)).to(dev)

ms = {}
for r in counts["K8"]:
    ins = (fp12(r), fp12(r))
    assert torch.equal(FK.fp12_mul(*ins), blocks(FK.fp12_mul_plain, *ins)), ("K8", r)
    ms[f"K8 {r}"] = S._device_ms(lambda: FK.fp12_mul(*ins))
for name, kind, kern, plain in (("K12", "g2_add", FK.g2_add, FK.g2_add_plain),
                                ("K13", "g2_madd", FK.g2_madd, FK.g2_madd_plain)):
    for r in counts[name]:
        # below 9 rows the first r rows of chip_smoke.py's 9-row inputs
        ins, _ = S._curve2_inputs(rng, kind, max(r, 9), dev)
        ins = tuple(t[:r] for t in ins)
        assert torch.equal(kern(*ins), blocks(plain, *ins)), (name, r)
        ms[f"{name} {r}"] = S._device_ms(lambda: kern(*ins))
print(json.dumps({"build_s": build_s, "ptxas": rep, "ms": ms}))
'''


def rows(text: str) -> list[int]:
    return [int(c) for c in text.split(",") if c]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--k8", type=rows, default=rows("1,13,512,1024,2048,4096,16384"))
    ap.add_argument("--k12", type=rows, default=rows("9,13,33,512,1024,2048,4257,136224"))
    ap.add_argument("--k13", type=rows, default=rows("2,13,512,519,1024,2048,2055,2112,4096"))
    args = ap.parse_args()
    counts = json.dumps({"K8": args.k8, "K12": args.k12, "K13": args.k13})
    recs = []
    for co in args.checkouts:
        r = subprocess.run([sys.executable, "-c", WORKER, str(ROOT / "chip_smoke.py"), counts],
                           cwd=co, capture_output=True, text=True, timeout=1500)
        if r.returncode:
            raise SystemExit(f"kernel_turns: {co} failed:\n{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        rec["checkout"] = co
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    print("checkouts:", " | ".join(pathlib.Path(r["checkout"]).name for r in recs))
    for k in recs[0]["ms"]:
        print(k, " ".join(f"{r['ms'][k]:.6f}" for r in recs))


if __name__ == "__main__":
    main()
