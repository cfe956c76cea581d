"""The port's G2 layer against the JAX package and the host oracle.

The GS split against `scalar_decomp.gs_split`; psi, the group law (add,
neg, eq, on_curve, is_identity) and `to_affine` against the JAX package's
eager functions, as canonical values; and, each in a child process under
jax.jit, the GS ladder `scalar_mul` and `scalar_mul_plain` at B = 2,
`mul_int`, `in_subgroup` and `clear_cofactor` on G2 points, the identity
and a point of E'(Fp2) outside G2, and `msm_g2` (c = 4, 4 lanes, an
identity row under a nonzero scalar and a zero scalar) with its host
oracle.  `G2Vec` ** * / serialize and msm on the CPU against the host
ladder and codec.  Inputs come from numpy seeds.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.curves import endo as ENDOJ
from crypto12381_tpu.curves import g2 as G2J
from crypto12381_tpu.ops import scalar_decomp as SDJ
from crypto12381_tpu.params import P, R, X_ABS

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch = T = convert = FP = TW = G2 = ENDO = SD = C = HF = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's tests run, not when the
    file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's tests."""
    global torch, T, convert, FP, TW, G2, ENDO, SD, C, HF
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.curves import endo as ENDO
    from crypto12381_tpu_torch.curves import g2 as G2
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.host import field as HF
    from crypto12381_tpu_torch.ops import scalar_decomp as SD
    yield
    jax.clear_caches()


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(coords):
    """A JAX point (coordinate arrays) -> tuple of port tensors."""
    return convert.from_jax_point([np.asarray(c) for c in coords])


def same(got, want_jax):
    return all(torch.equal(g, w) for g, w in zip(got, port_of(want_jax)))


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


def off_g2_point():
    """A point of E'(Fp2) outside G2: the least x = (t, 1) on the twist."""
    t = 1
    while True:
        x = (t, 1)
        y = HF.fp2_sqrt(HF.fp2_add(HF.fp2_mul(HF.fp2_sqr(x), x), (4, 4)))
        if y is not None:
            return (x, y)
        t += 1


def projective(pts, seed):
    """Host G2 points (None: the identity) -> projective tensors with a
    random Fp2 Z per point."""
    rng = np.random.default_rng(seed)
    rows = []
    for pt in pts:
        z = tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
        if pt is None:
            rows.append([(0, 0), (1, 0), (0, 0)])
        else:
            rows.append([HF.fp2_mul(pt[0], z), HF.fp2_mul(pt[1], z), z])
    return tuple(FP.from_int([list(r[k]) for r in rows]) for k in range(3))


# ------------------------------------------------------------ eager checks


def test_g2_split_psi_group_law_and_codec_match_jax():
    vals = [0, 1, R - 1, X_ABS, X_ABS - 1, X_ABS**2, X_ABS**3 - 1, X_ABS**3] + scalars(1, 8)
    e = limbs16(vals)
    got = SD.gs_split(convert.from_jax_fr(e))
    assert np.array_equal(got.numpy(), np.asarray(SDJ.gs_split(jnp.asarray(e))))
    ints = [[sum(int(w) << (16 * i) for i, w in enumerate(d)) for d in row] for row in got.numpy()]
    assert [sum(d * X_ABS**i for i, d in enumerate(row)) for row in ints] == vals
    assert max(max(row) for row in ints) < X_ABS and SD.GS_BITS == SDJ.GS_BITS

    for got_c, want_c in zip(ENDO._psi_consts(), ENDOJ._psi_consts()):
        assert torch.equal(torch.from_numpy(got_c), convert.from_jax_fp(want_c))
    pts = [C.g2_mul(C.G2_GEN, k) for k in scalars(2, 4)]
    a = projective(pts[:2] + [None, pts[2]], 3)
    b = projective([pts[2], None, pts[3], pts[2]], 4)
    aj, bj = tuple(J(c) for c in a), tuple(J(c) for c in b)
    assert same(ENDO.psi_g2(a), ENDOJ.psi_g2(aj))
    assert same(G2.add(a, b), G2J.add(aj, bj))
    assert same(G2.neg(a), G2J.neg(aj))
    assert G2.eq(a, b).tolist() == np.asarray(G2J.eq(aj, bj)).tolist() == [False] * 3 + [True]
    assert G2.is_identity(a).tolist() == [False, False, True, False]
    assert G2.on_curve(a).tolist() == np.asarray(G2J.on_curve(aj)).tolist() == [True] * 4
    bad = (a[0], TW.fp2_add(a[1], TW.fp2_one((4,))), a[2])
    assert G2.on_curve(bad).tolist() == [False, False, True, False]
    x, y, inf = G2.to_affine(a)
    xj, yj, infj = G2J.to_affine(aj)
    assert torch.equal(x, convert.from_jax_fp(np.asarray(xj)))
    assert torch.equal(y, convert.from_jax_fp(np.asarray(yj)))
    assert inf.tolist() == np.asarray(infj).tolist()
    assert list(G2.to_affine_ints(a)) == pts[:2] + [None, pts[2]]

    # G2Vec: the group operation, its inverse, bytes, the power and the MSM
    v = T.G2Vec(a)
    w = T.G2Vec.from_affine(pts[:2] + [None, pts[2]], device="cpu")
    assert (v == w).tolist() == [True] * 4
    assert v.serialize() == [CODECJ.g2_serialize(p) for p in pts[:2] + [None, pts[2]]]
    assert list(G2.to_affine_ints((v / w).p)) == [None] * 4
    assert list(G2.to_affine_ints((v * v.inverse()).p)) == [None] * 4
    s = scalars(5, 4)
    got = v ** T.ZpVec.from_ints(s, device="cpu")
    want = [None if p is None else C.g2_mul(p, k) for p, k in zip(pts[:2] + [None, pts[2]], s)]
    assert list(G2.to_affine_ints(got.p)) == want
    m = w.msm(T.ZpVec.from_ints(s, device="cpu"))
    expect = None
    for p, k in zip(pts[:2] + [None, pts[2]], s):
        expect = C.g2_add(expect, None if p is None else C.g2_mul(p, k))
    assert G2.to_affine_ints(m.p) == expect
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.G2Vec.generator((2,))


# ----------------------------------------------------- jitted, in a child

#: The JAX G2 functions under jax.jit, in a child process (its compiled
#: graphs die with it): argv[1] the case, argv[2] the inputs, argv[3] the
#: outputs.
JAX_G2 = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.curves import g2 as G2
from crypto12381_tpu.msm import pippenger as MSM
from crypto12381_tpu.params import X_ABS
case = sys.argv[1]
d = np.load(sys.argv[2])
p = tuple(jnp.asarray(d[k]) for k in ("X", "Y", "Z"))
e = jnp.asarray(d["e"])
st = lambda q: np.stack([np.asarray(c) for c in q], 0)
if case == "ladder":
    out = {"gs": st(jax.jit(G2.scalar_mul)(p, e)),
           "plain": st(jax.jit(G2.scalar_mul_plain)(p, e))}
elif case == "cofactor":
    out = {"mul_int": st(jax.jit(lambda q: G2.mul_int(q, X_ABS))(p)),
           "cleared": st(jax.jit(G2.clear_cofactor)(p)),
           "member": np.asarray(jax.jit(G2.in_subgroup)(p))}
else:
    out = {"msm": st(jax.jit(lambda q, s: MSM.msm_g2(q, s, c=4, lanes=4))(p, e))}
np.savez(sys.argv[3], **out)
"""


@pytest.mark.parametrize("case", ["ladder", "cofactor", "msm"])
def test_g2_ladders_cofactor_msm_match_jax_jit(case, tmp_path):
    pts = [C.g2_mul(C.G2_GEN, k) for k in scalars(10, 6)]
    if case == "ladder":
        pts = pts[:2]
        s = scalars(11, 1) + [R - 1]
    elif case == "cofactor":
        pts = [pts[0], None, off_g2_point()]
        s = [0] * 3
    else:
        pts[2] = None
        s = scalars(12, 6)
        s[4] = 0
    p = projective(pts, 13)
    e = convert.from_jax_fr(limbs16(s))
    np.savez(tmp_path / "in.npz", e=convert.to_jax_fr(e),
             **dict(zip(("X", "Y", "Z"), convert.to_jax_point(p))))
    out = subprocess.run([sys.executable, "-c", JAX_G2, case, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    if case == "ladder":
        got = G2.scalar_mul(p, e)
        assert same(got, want["gs"])
        assert same(G2.scalar_mul_plain(p, e), want["plain"])
        assert list(G2.to_affine_ints(got)) == [C.g2_mul(q, k) for q, k in zip(pts, s)]
    elif case == "cofactor":
        assert same(G2.mul_int(p, X_ABS), want["mul_int"])
        cleared = G2.clear_cofactor(p)
        assert same(cleared, want["cleared"])
        member = G2.in_subgroup(p)
        assert member.tolist() == want["member"].tolist() == [True, True, False]
        assert G2.in_subgroup(cleared).tolist() == [True] * 3
        assert G2.is_identity(cleared).tolist() == [False, True, False]
        assert G2.is_identity(G2.mul_int(p, 0)).tolist() == [True] * 3
    else:
        got = T.G2Vec(p).msm(T.ZpVec(e), c=4, lanes=4)
        assert same(got.p, want["msm"])
        expect = None
        for q, k in zip(pts, s):
            expect = C.g2_add(expect, None if q is None else C.g2_mul(q, k))
        assert G2.to_affine_ints(got.p) == expect
