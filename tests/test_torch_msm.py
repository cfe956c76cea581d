"""The port's scan Pippenger MSM against the JAX package and the host
oracle.

The signed window digits are held against `pippenger.signed_window_digits`
on reduced and unreduced 256-bit scalars; `msm_g1` at c = 4, 8 lanes and
n = 16 (as tests/test_msm.py), with an identity point under a nonzero
scalar and zero scalars, against the JAX `msm_g1` under jax.jit (in a
child process), exactly as canonical projective values, and against the
host integer oracle; `G1Vec.msm` on the CPU against the oracle, and its
route at n >= 2^17 to the port's msm/rounds.py (at c = 16, identity rows of
an affine-built vector under the scalar 0), seen through a stand-in.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.msm import pippenger as MSMJ
from crypto12381_tpu.params import P, R

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch = T = convert = FP = G1 = MSM = C = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's test runs, not when the
    file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's test."""
    global torch, T, convert, FP, G1, MSM, C
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.msm import pippenger as MSM
    yield
    jax.clear_caches()


def ints(seed, n, bits=256, mod=R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(bits // 8), "big") % mod for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


def _check_signed_window_digits_match_jax():
    vals = [0, 1, R - 1, (1 << 256) - 1] + ints(1, 4) + ints(2, 4, mod=1 << 256)
    e = limbs16(vals)
    for c in (4, 8, 12, 13):
        got = MSM.signed_window_digits(torch.from_numpy(e), c)
        assert np.array_equal(got.numpy(), np.asarray(MSMJ.signed_window_digits(jnp.asarray(e), c)))
        assert [sum(int(d) << (c * i) for i, d in enumerate(row)) for row in got.numpy()] == vals
        assert np.array_equal(MSM.window_digits(torch.from_numpy(e), c).numpy(),
                              np.asarray(MSMJ.window_digits(jnp.asarray(e), c)))


#: The JAX scan Pippenger under jax.jit, in a child process.
JAX_MSM = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.msm import pippenger as MSM
d = np.load(sys.argv[1])
p = tuple(jnp.asarray(d[k]) for k in ("X", "Y", "Z"))
out = jax.jit(lambda p, s: MSM.msm_g1(p, s, c=4, lanes=8))(p, jnp.asarray(d["s"]))
np.save(sys.argv[2], np.stack([np.asarray(c) for c in out], 0))
"""


def msm_inputs(n=16):
    """n distinct points with random Z, point 5 the identity under a
    nonzero scalar, scalars 3 and 9 zero; and the oracle's answer."""
    ks, ss, zs = ints(3, n), ints(4, n), ints(5, n, 384, P)
    ss[3] = ss[9] = 0
    pts = [C.g1_mul(C.G1_GEN, k) for k in ks]
    rows = [[x * z % P, y * z % P, z] for (x, y), z in zip(pts, zs)]
    rows[5] = [0, 1, 0]
    expect = C.g1_mul(C.G1_GEN, sum(k * s for i, (k, s) in enumerate(zip(ks, ss)) if i != 5))
    return tuple(FP.from_int(rows).unbind(-2)), limbs16(ss), expect


def _check_msm_g1_matches_jax_jit_and_oracle(tmp_path):
    p, s, expect = msm_inputs()
    got = MSM.msm_g1(p, convert.from_jax_fr(s), c=4, lanes=8)
    assert G1.to_affine_ints(got) == expect
    np.savez(tmp_path / "in.npz", s=s, **dict(zip(("X", "Y", "Z"), convert.to_jax_point(p))))
    out = subprocess.run([sys.executable, "-c", JAX_MSM, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npy")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    want = np.load(tmp_path / "out.npy")
    assert all(torch.equal(g, w) for g, w in zip(got, convert.from_jax_point(want)))


def _check_g1vec_msm_routes(monkeypatch):
    p, s, expect = msm_inputs()
    v = T.G1Vec(p)
    assert G1.to_affine_ints(v.msm(T.ZpVec(convert.from_jax_fr(s)), c=4).p) == expect
    # n >= 2^17 reaches msm_g1_rounds at c = 16 whatever c is given (a real
    # call at this size takes minutes on the CPU, so a stand-in records it)
    from crypto12381_tpu_torch.api import batch

    seen = []

    def rounds(points, scalars_std, c=16, affine=False):
        seen.append((points, scalars_std, c, affine))
        return G1.identity((), "cpu")

    monkeypatch.setattr(batch.MR, "msm_g1_rounds", rounds)
    n = 1 << 17
    big = tuple(c.clone() for c in T.G1Vec.generator((n,), device="cpu").p)
    ident = [3, n - 1]
    for i in ident:
        big[0][i], big[2][i] = 0, 0
    e = torch.from_numpy(np.random.default_rng(7).integers(0, 1 << 16, (n, 18), np.int32))
    e[:, 15:] = 0
    out = T.G1Vec(big, z_is_one=True).msm(T.ZpVec(e), c=4)
    assert bool(G1.is_identity(out.p))
    (pts, got_e, c, affine), = seen
    assert (pts[0].shape[0], c, affine) == (n, 16, True)
    keep = torch.ones(n, dtype=torch.bool)
    keep[ident] = False
    assert torch.equal(got_e[keep], e[keep]) and not bool(got_e[~keep].any())
    T.G1Vec(big).msm(T.ZpVec(e))                 # projective: the Z inversion front
    assert seen[1][3] is False and torch.equal(seen[1][1], e)


def test_msm_layer_matches_jax(tmp_path, monkeypatch):
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_signed_window_digits_match_jax()
    _check_msm_g1_matches_jax_jit_and_oracle(tmp_path)
    _check_g1vec_msm_routes(monkeypatch)
