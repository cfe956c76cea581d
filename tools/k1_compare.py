#!/usr/bin/env python3
"""Compare the kernels of two checkouts of the port on one card, in turns.

    python3 tools/k1_compare.py OTHER_CHECKOUT [--other-binary-chain] [--order otto]
                                [--variant DIR] [--rows K8,K12] [--out DIR]

Runs one process per pass, in the order given (o: the other checkout, t:
this one, v: a third checkout given by --variant, e.g. this tree with one
change; default other, this, this, other), each with its working
directory and import path in that checkout, so that it imports that
checkout's `crypto12381_tpu_torch` and builds that checkout's kernels into
its own `build/`.  Every pass runs THIS checkout's chip_smoke.py (loaded by
path): `phase_kernels` (every kernel held bit for bit against its plain
version at the kernels phase's row counts, and timed) and `phase_ceiling`
(x^(p-2) at 2^18 rows and at 1 row).  With --rows, every pass then runs
`phase_rows` for the kernels named there (the first word of a kernels-phase
entry: K8, K12, ...) at the row counts the paths launch them at above the
kernels phase's, as chip_smoke.py's rows phase found them (PATH_ROWS: K8's
GT-power table launches up to 8 x 2,048 rows, K12's G2 MSM bucket launches
up to 136,224), each held bit for bit against the plain version and timed;
a name may bring its own counts, K12=4257:136224.  The first pass of each
checkout also records nvcc's register and spill report.  `--other-binary-chain` says that
the other checkout's chain kernel is the binary square-and-multiply (608
steps for x^(p-2)), for the ceiling's ns per step.

Writes each pass to <out>/<n>_<label>.json (default build/k1_compare), and
prints per kernel entry its ms at the headline row count in every pass,
with --rows also its ms at every row count it was timed at, then the
ceiling lines and the registers and spills of both builds.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: per kernel, the row counts the paths launch it at above the kernels
#: phase's (chip_smoke.py's rows phase, NVIDIA H100 80GB HBM3): K8 in the GT
#: power's table (gt_pow at B = 2,048), K12 in the G2 MSM's bucket sums
#: (n = 4,096)
PATH_ROWS = {"K8": (4096, 8192, 16384),
             "K12": (4257, 8514, 17028, 34056, 68112, 136224)}


def rows_spec(text: str | None) -> dict:
    """--rows K8,K12=4257:136224 -> {"K8": PATH_ROWS["K8"], "K12": (4257, 136224)}."""
    out = {}
    for item in filter(None, (text or "").split(",")):
        name, _, counts = item.partition("=")
        out[name] = tuple(int(c) for c in counts.split(":")) if counts else PATH_ROWS[name]
    return out


def worker(checkout: str, label: str, out: str, steps: int | None, rows: dict) -> None:
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    spec = importlib.util.spec_from_file_location("chip_smoke_compare", ROOT / "chip_smoke.py")
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device")
    from crypto12381_tpu_torch import _build

    _build.build()
    ptxas = {}
    for log in _build.BUILD_LOG.values():
        ptxas.update(S._ptxas_report(log))
    dev = torch.device("cuda", 0)
    kernels = S.phase_kernels(dev)
    ceiling = S.phase_ceiling(dev, steps)
    if rows:
        # the rows phase times a kernel at the counts its paths launched
        # it at: here the named kernels at the given counts
        S.ROWS_BY_PATH.clear()
        named = [k for k in kernels if k["name"].split()[0] in rows]
        for k in named:
            S.ROWS_BY_PATH[f"compare {k['name']}"] = {
                k["c_function"]: {r: 1 for r in rows[k["name"].split()[0]]}}
        S.phase_rows(dev, named)
    keep = ("name", "rows", "ms", "ms_by_rows", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "least_chain", "random_rows", "ms_squares_only")
    rec = {"label": label, "checkout": checkout, "device": torch.cuda.get_device_name(0),
           "smi": S._smi_line(), "ptxas": ptxas, "ceiling": ceiling,
           "kernels": [{k: v for k, v in r.items() if k in keep} for r in kernels]}
    pathlib.Path(out).write_text(json.dumps(rec, default=str))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout (e.g. the parent commit, unpacked)")
    ap.add_argument("--other-binary-chain", action="store_true")
    ap.add_argument("--order", default="otto")
    ap.add_argument("--variant", help="a third checkout, the letter v in --order")
    ap.add_argument("--worker", nargs=3, metavar=("CHECKOUT", "LABEL", "OUT"))
    ap.add_argument("--steps", type=int)
    ap.add_argument("--rows", help="kernels to time at their paths' larger row counts too")
    ap.add_argument("--out", default=str(ROOT / "build" / "k1_compare"))
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.steps, rows_spec(args.rows))
        return
    out_dir = pathlib.Path(args.out).resolve()     # each worker runs in its own checkout
    out_dir.mkdir(parents=True, exist_ok=True)
    other = str(pathlib.Path(args.other).resolve())
    recs = []
    for i, c in enumerate(args.order):
        label, path = {"o": ("other", other), "t": ("this", str(ROOT)),
                       "v": ("variant", str(pathlib.Path(args.variant or ".").resolve()))}[c]
        out = out_dir / f"{i}_{label}.json"
        steps = ["--steps", "608"] if c == "o" and args.other_binary_chain else []
        rows = ["--rows", args.rows] if args.rows else []
        subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "unused",
                        "--worker", path, label, str(out), *steps, *rows], check=True,
                       timeout=1500)
        recs.append(json.loads(out.read_text()))
    print("device:", recs[0]["device"], "|", recs[0]["smi"])
    print("order:", " ".join(r["label"] for r in recs))
    for j, k in enumerate(recs[0]["kernels"]):
        cells = " / ".join(f"{r['kernels'][j]['ms']:.6f}" for r in recs)
        print(f"{k['name']} at {k['rows']}: ms {cells}")
        if k["name"].split()[0] in rows_spec(args.rows):
            for r in k["ms_by_rows"]:
                cells = " / ".join(f"{x['kernels'][j]['ms_by_rows'][r]:.6f}" for x in recs)
                print(f"  {k['name']} at {r}: ms {cells}")
    for r in recs:
        print(f"ceiling {r['label']}: {json.dumps(r['ceiling'])}")
    for r in recs:
        if r["ptxas"]:
            print(f"ptxas {r['label']}: {json.dumps(r['ptxas'])}")


if __name__ == "__main__":
    main()
