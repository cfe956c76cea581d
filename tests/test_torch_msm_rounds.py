"""The port's dense-rounds MSM (msm/rounds.py) against the JAX package's
`msm_g1_rounds` and the host integer oracle.

The cases are those of tests/test_msm_rounds.py: random points at c = 8,
equal points and scalars (one run per window, a doubling every round) at
c = 6 with odd n, P/-P pairs cancelling mid-run at c = 5, an identity
point and zero scalars through the projective front, unreduced 256-bit
scalars (routed to the scan MSM), and the affine front.  Each case runs
the JAX function in a child process (its compiled graphs die with it) and
the port on the CPU with the module's compaction ladder and, where the
rounds run, again with a short ladder that compacts at these sizes; each
must equal the JAX result as canonical projective values, and the
oracle.  The F1 case runs `G1Vec.msm`'s rounds route at a small n: an
identity row of a vector built from affine data, under a nonzero scalar,
against the oracle only (the JAX package reads that row as the point
(0, 1)).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from crypto12381_tpu.params import P, R

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch = T = convert = FP = G1 = MR = C = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's tests run, not when the
    file is collected (every test worker collects every file)."""
    global torch, T, convert, FP, G1, MR, C
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import rounds as MR
    yield


def ints(rng, n, bits=256, mod=R):
    return [int.from_bytes(rng.bytes(bits // 8), "big") % mod for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


#: The JAX msm_g1_rounds (host-driven, its pieces under jax.jit), in a
#: child process.
JAX_ROUNDS = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.msm import rounds as MR
d = np.load(sys.argv[1])
p = tuple(jnp.asarray(d[k]) for k in ("X", "Y", "Z"))
out = MR.msm_g1_rounds(p, jnp.asarray(d["s"]), c=int(d["c"]), affine=bool(d["affine"]))
np.save(sys.argv[2], np.stack([np.asarray(c) for c in out], 0))
"""


def case_inputs(name):
    """(host points, None for an identity; scalars (ints, maybe >= r); c;
    affine) of one case of tests/test_msm_rounds.py."""
    rng = np.random.default_rng(["random", "duplicates", "opposite", "identity_zero",
                                 "unreduced", "unreduced_c16", "affine"].index(name) + 1)
    gen = C.G1_GEN
    if name in ("random", "affine"):
        n = 70 if name == "random" else 40
        ks = [int(k) for k in rng.choice(np.arange(1, 10_000), n, replace=False)]
        return [C.g1_mul(gen, k) for k in ks], ints(rng, n), 8, name == "affine"
    if name == "duplicates":
        s = ints(rng, 1)[0]
        return [C.g1_mul(gen, 7)] * 33, [s] * 33, 6, False
    if name == "opposite":
        pts, sc = [], []
        s = ints(rng, 1)[0]
        for k in (3, 11, 29):
            p = C.g1_mul(gen, k)
            pts += [p, C.g1_neg(p)]
            sc += [s, s]
        return pts + [C.g1_mul(gen, 5)], sc + ints(rng, 1), 5, False
    if name == "identity_zero":
        pts = [C.g1_mul(gen, k) for k in ints(rng, 8)] + [None]
        sc = ints(rng, 7) + [0] + ints(rng, 1)
        return pts, sc, 6, False
    # unreduced 256-bit scalars: the range check sends the call to the scan
    pts = [C.g1_mul(gen, k) for k in ints(rng, 12)]
    sc = ints(rng, 12, mod=1 << 256)
    assert any(x >= R for x in sc)
    return pts, sc, 7 if name == "unreduced" else 16, False


def projective(pts, rng, affine):
    """(n, 3, 12) Montgomery rows: Z = 1 for the affine front, else a random
    Z per point; an identity is (0, 1, 0)."""
    rows = []
    for pt in pts:
        z = 1 if affine else int.from_bytes(rng.bytes(48), "big") % P
        rows.append([0, 1, 0] if pt is None else [pt[0] * z % P, pt[1] * z % P, z])
    return tuple(FP.from_int(rows).unbind(-2))


@pytest.mark.parametrize("name", ["random", "duplicates", "opposite", "identity_zero",
                                  "unreduced", "unreduced_c16", "affine"])
def test_msm_g1_rounds_matches_jax_and_oracle(name, tmp_path, monkeypatch):
    pts, sc, c, affine = case_inputs(name)
    p = projective(pts, np.random.default_rng(99), affine)
    s = limbs16(sc)
    expect = C.g1_msm([q for q in pts if q is not None], [x for q, x in zip(pts, sc) if q])
    np.savez(tmp_path / "in.npz", s=s, c=c, affine=affine,
             **dict(zip(("X", "Y", "Z"), convert.to_jax_point(p))))
    out = subprocess.run([sys.executable, "-c", JAX_ROUNDS, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npy")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    want = convert.from_jax_point(np.load(tmp_path / "out.npy"))
    # the short ladder compacts at these sizes; the scan takes the
    # unreduced cases before any round
    for ladder in (MR._LADDER,) + (((2048, 256, 64, 16),) if "unreduced" not in name else ()):
        monkeypatch.setattr(MR, "_LADDER", ladder)
        got = MR.msm_g1_rounds(p, convert.from_jax_fr(s), c=c, affine=affine)
        assert G1.to_affine_ints(got) == expect, ladder
        assert all(torch.equal(g, w) for g, w in zip(got, want)), ladder


def test_g1vec_rounds_route_guards_identity_rows(monkeypatch):
    """F1: on a vector built from affine data, an identity row under a
    nonzero scalar adds nothing on the rounds route (here at n = 24,
    c = 5, with a short ladder)."""
    from crypto12381_tpu_torch.api import batch

    monkeypatch.setattr(batch, "ROUNDS_MSM_MIN", 16)
    monkeypatch.setattr(batch, "ROUNDS_MSM_C", 5)
    monkeypatch.setattr(MR, "_LADDER", (256, 64))
    rng = np.random.default_rng(11)
    pts = [C.g1_mul(C.G1_GEN, k) for k in ints(rng, 24)]
    pts[5] = pts[17] = None
    sc = ints(rng, 24)
    sc[9] = 0
    vec = T.G1Vec.from_affine(pts, device="cpu")
    assert vec.z_is_one
    got = vec.msm(T.ZpVec.from_ints(sc, device="cpu"))
    expect = C.g1_msm([q for q in pts if q], [x for q, x in zip(pts, sc) if q])
    assert G1.to_affine_ints(got.p) == expect
