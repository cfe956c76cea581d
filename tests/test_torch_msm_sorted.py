"""The port's sorted batched-affine MSM (msm/sorted.py) against the host
integer oracle and the JAX package.

Every case of tests/test_msm_sorted.py runs through the port's three
MSMs, `msm_g1_sorted` (per window, projective passes 2+),
`msm_g1_sorted_staged_v1` (one inversion for every window's pass 1) and
`msm_g1_sorted_staged` (every pass batched-affine, FAST and GENERAL), on
the CPU: distinct random points (FAST throughout), equal points under
equal scalars in one bucket with odd n (doubling, every pass), P/-P pairs
(infinity flags carried forward), an identity point and zero scalars
through the projective front, and one mixed input on which the three and
the scan MSM agree.  Each result is held against the oracle as canonical
affine integers (intermediate pairings may differ from the JAX package's,
so only final points are compared).  The FAST case and the GENERAL switch
are also held against the JAX `msm_g1_sorted_staged`, and
`block_batch_inv` (with a 0) against the JAX one, all in one child
process; `pass_sizes` against the JAX one over a grid of (n, nbuck); and
`G1Vec.msm`'s routing through stand-ins of its two routes, which depend
on n alone (CRYPTO12381_MSM, the JAX package's override, changes nothing
here).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from crypto12381_tpu.msm import sorted as MSJ
from crypto12381_tpu.params import P, R

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch = T = convert = FP = G1 = MS = MSM = C = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's tests run, not when the
    file is collected (every test worker collects every file)."""
    global torch, T, convert, FP, G1, MS, MSM, C
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import pippenger as MSM
    from crypto12381_tpu_torch.msm import sorted as MS
    # the plain versions run many small ops: one thread per worker keeps
    # the test workers and their child processes from crowding the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = ("random", "duplicates", "opposite", "identity_zero")


def ints(rng, n, mod=R):
    return [int.from_bytes(rng.bytes(48), "big") % mod for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


def case_inputs(name):
    """(host points, None for an identity; scalars; c) of one case of
    tests/test_msm_sorted.py."""
    rng = np.random.default_rng(["random", "duplicates", "opposite", "identity_zero",
                                 "mixed"].index(name) + 21)
    gen = C.G1_GEN
    if name == "random":
        ks = [int(k) for k in rng.choice(np.arange(1, 10_000), 70, replace=False)]
        return [C.g1_mul(gen, k) for k in ks], ints(rng, 70), 8
    if name == "duplicates":                       # one run per window, odd n
        s = ints(rng, 1)[0]
        return [C.g1_mul(gen, 7)] * 33, [s] * 33, 6
    if name == "opposite":                         # P and -P in one bucket
        pts, sc = [], []
        s = ints(rng, 1)[0]
        for k in (3, 11, 29):
            p = C.g1_mul(gen, k)
            pts += [p, C.g1_neg(p)]
            sc += [s, s]
        return pts + [C.g1_mul(gen, 5)], sc + ints(rng, 1), 5
    if name == "identity_zero":
        pts = [C.g1_mul(gen, k) for k in ints(rng, 8)] + [None]
        return pts, ints(rng, 7) + [0] + ints(rng, 1), 6
    # mixed: a duplicate pair (the GENERAL switch) and a zero scalar
    pts = [C.g1_mul(gen, k) for k in ints(rng, 22) + [77, 77]]
    return pts, ints(rng, 23) + [0], 7


def projective(pts, seed=99):
    """(X, Y, Z) Montgomery tensors with a random Z per point; an identity
    is (0, 1, 0)."""
    rng = np.random.default_rng(seed)
    rows = []
    for pt in pts:
        z = int.from_bytes(rng.bytes(48), "big") % P
        rows.append([0, 1, 0] if pt is None else [pt[0] * z % P, pt[1] * z % P, z])
    return tuple(FP.from_int(rows).unbind(-2))


def oracle(pts, sc):
    return C.g1_msm([q for q in pts if q is not None], [x for q, x in zip(pts, sc) if q])


def check_staged(name, run):
    """The staged MSM's pass record: distinct points stay FAST; equal x
    forces GENERAL from pass 1 (the identity row and the odd-n pad are
    both the generator, scalar 0); the passes run at pass_sizes' sizes."""
    pts, _, c = case_inputs(name)
    assert run["general_from"] == (None if name == "random" else 1)
    sizes = MS.pass_sizes(len(pts) + len(pts) % 2, (1 << (c - 1)) + 1)
    assert run["sizes"] == sizes[:run["passes"]]


#: every (case, MSM) of the matrix; the staged MSM's random and duplicates
#: cases run in test_staged_and_block_inverse_match_jax, against the oracle
#: and the JAX package
MATRIX = [(name, fn) for name in CASES
          for fn in ("msm_g1_sorted", "msm_g1_sorted_staged_v1", "msm_g1_sorted_staged")
          if not (fn == "msm_g1_sorted_staged" and name in ("random", "duplicates"))]


@pytest.mark.parametrize("name,fn", MATRIX)
def test_sorted_msm_matches_oracle(name, fn):
    pts, sc, c = case_inputs(name)
    kw = {"record": {}} if fn == "msm_g1_sorted_staged" else {}
    got = getattr(MS, fn)(projective(pts), torch.from_numpy(limbs16(sc)), c=c, **kw)
    assert G1.to_affine_ints(got) == oracle(pts, sc)
    if kw:
        check_staged(name, kw["record"])


@pytest.mark.parametrize("fn", ["msm_g1_sorted_staged", "msm_g1_sorted",
                                "msm_g1_sorted_staged_v1", "scan"])
def test_mixed_input_all_msms_agree(fn):
    """The sorted, staged, v1 and scan MSMs on one mixed input (a duplicate
    pair, a zero scalar): each equal to the oracle, so all four agree."""
    pts, sc, c = case_inputs("mixed")
    p, s = projective(pts), torch.from_numpy(limbs16(sc))
    run = {}
    if fn == "scan":
        got = MSM.msm_g1(p, s, c=4, lanes=8)
    elif fn == "msm_g1_sorted_staged":
        got = MS.msm_g1_sorted_staged(p, s, c=c, record=run)
    else:
        got = getattr(MS, fn)(p, s, c=c)
    assert G1.to_affine_ints(got) == oracle(pts, sc)
    if fn == "msm_g1_sorted_staged":
        assert run["general_from"] == 1


def test_pass_sizes_match_jax():
    for n in (2, 3, 9, 33, 70, 1000, 2048, 4097, 1 << 16, 1 << 20, (1 << 20) + 2):
        for nbuck in (2, 17, 33, 65, 2049, 32769):
            assert MS.pass_sizes(n, nbuck) == MSJ.pass_sizes(n, nbuck), (n, nbuck)


#: The JAX msm_g1_sorted_staged on the FAST and the GENERAL case, and the
#: JAX block_batch_inv, in a child process.
JAX_SORTED = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.msm import sorted as MS
d = np.load(sys.argv[1])
out = {}
for name in ("random", "duplicates"):
    p = tuple(jnp.asarray(d[name + k]) for k in ("X", "Y", "Z"))
    res = MS.msm_g1_sorted_staged(p, jnp.asarray(d[name + "s"]), c=int(d[name + "c"]))
    out[name] = np.stack([np.asarray(c) for c in res], 0)
out["inv"] = np.asarray(jax.jit(MS.block_batch_inv)(jnp.asarray(d["inv"])))
np.savez(sys.argv[2], **out)
"""


def test_staged_and_block_inverse_match_jax(tmp_path):
    """The FAST case and the GENERAL switch of the staged MSM against the
    oracle and the JAX staged MSM, as canonical affine integers;
    block_batch_inv (a 0 among the values, and an m that is no multiple of
    the block) against the JAX one, exactly, at two block lengths."""
    rng = np.random.default_rng(5)
    vals = ints(rng, 7, P) + [0] + ints(rng, 3, P)
    v = FP.from_int(vals)
    arrays = {"inv": convert.to_jax_fp(v)}
    inputs = {}
    for name in ("random", "duplicates"):
        pts, sc, c = case_inputs(name)
        inputs[name] = (projective(pts), limbs16(sc), c)
        arrays.update({name + k: a for k, a in zip("XYZ", convert.to_jax_point(inputs[name][0]))})
        arrays.update({name + "s": inputs[name][1], name + "c": c})
    np.savez(tmp_path / "in.npz", **arrays)
    child = subprocess.Popen([sys.executable, "-c", JAX_SORTED, str(tmp_path / "in.npz"),
                              str(tmp_path / "out.npz")], cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        mine = {}
        for name, (p, s, c) in inputs.items():          # while the child runs
            run = {}
            got = MS.msm_g1_sorted_staged(p, torch.from_numpy(s), c=c, record=run)
            check_staged(name, run)
            pts, sc, _ = case_inputs(name)
            mine[name] = G1.to_affine_ints(got)
            assert mine[name] == oracle(pts, sc), name
        _, err = child.communicate(timeout=1200)
    finally:
        child.kill()
    assert child.returncode == 0, err[-2000:]
    want = np.load(tmp_path / "out.npz")
    for name in ("random", "duplicates"):
        assert mine[name] == G1.to_affine_ints(convert.from_jax_point(want[name])), name
    expect = convert.from_jax_fp(want["inv"])
    for B in (128, 4):
        got = MS.block_batch_inv(v, B=B)
        assert torch.equal(got, expect), B
        assert FP.to_int(got).tolist() == [pow(x, P - 2, P) for x in vals]


def test_g1vec_msm_routes_by_environment(monkeypatch):
    """G1Vec.msm routes by n alone: the scan below 2^17, the rounds MSM
    (c = 16) from 2^17, whatever CRYPTO12381_MSM holds (the JAX package's
    override; the sorted MSMs are called directly).  Recorded by stand-ins
    of the routes."""
    from crypto12381_tpu_torch.api import batch

    seen = []

    def stand_in(route):
        def f(points, scalars_std, c=None, **kw):
            seen.append((route, points[0].shape[0], c))
            return G1.identity((), "cpu")
        return f

    monkeypatch.setattr(batch.MR, "msm_g1_rounds", stand_in("rounds"))
    monkeypatch.setattr(batch.MSM, "msm_g1", stand_in("scan"))
    monkeypatch.setattr(MS, "msm_g1_sorted_staged", stand_in("sorted"))
    vecs = {n: T.G1Vec.generator((n,), device="cpu") for n in (2047, 2048, 1 << 17)}
    e = {n: T.ZpVec(torch.ones((n, 18), dtype=torch.int32)) for n in vecs}
    cases = [(n, c, ("rounds", n, 16) if n >= 1 << 17 else ("scan", n, c or 8))
             for n in vecs for c in (None, 9)]
    for env in (None, "rounds", "sorted", "scan", "other"):
        if env is None:
            monkeypatch.delenv("CRYPTO12381_MSM", raising=False)
        else:
            monkeypatch.setenv("CRYPTO12381_MSM", env)
        for n, c, want in cases:
            vecs[n].msm(e[n], c=c)
            assert seen.pop() == want, (env, n, c)
        assert not seen
