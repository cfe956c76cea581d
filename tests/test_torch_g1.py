"""The port's G1 layer against the JAX package and the host oracle.

The plain versions of K5, K6 and K7 are held exactly (as canonical values)
against the JAX package's generic formulas (`weierstrass.add`, `madd`,
`double` over `g1.ops()`) and against its TPU programs run as XLA
(`fp32k._fused_xla`), on curve points with the identity, P = Q and P = -Q
among them; the GLV split against `scalar_decomp.glv_split`; the GLV
scalar multiplication against the JAX `G1.scalar_mul` under jax.jit at
B = 2 (in a child process); the G1 and Zp byte codecs against
`compat.codec`; and the subgroup check and cofactor clearing against
host integer arithmetic.  Inputs come from numpy seeds.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.curves import g1 as G1J
from crypto12381_tpu.curves import weierstrass as WJ
from crypto12381_tpu.fields import fp32k as FKJ
from crypto12381_tpu.ops import scalar_decomp as SDJ
from crypto12381_tpu.params import H_EFF_G1, P, R

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch = T = convert = FP = FK = G1 = SD = C = codec = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's test runs, not when the
    file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's test."""
    global torch, T, convert, FP, FK, G1, SD, C, codec
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g1 as G1
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.ops import scalar_decomp as SD
    yield
    jax.clear_caches()


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(coords):
    """A JAX point (coordinate arrays) -> stacked port tensor (..., 3, 12)."""
    return torch.stack(convert.from_jax_point([np.asarray(c) for c in coords]), -2)


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


def projective(pts, seed):
    """Host affine points (None: the identity) -> (n, 3, 12) Montgomery
    tensor with a random Z per point."""
    rng = np.random.default_rng(seed)
    rows = []
    for pt in pts:
        z = int.from_bytes(rng.bytes(48), "big") % P
        rows.append([0, 1, 0] if pt is None else [pt[0] * z % P, pt[1] * z % P, z])
    return FP.from_int(rows)


def edge_operands(seed, n=8):
    """P (n, 3, 12), Q (n, 3, 12), Q affine (n, 2, 12), and the host points:
    row 0 P = O, row 1 Q = O, row 2 P = Q (another Z), row 3 P = -Q, the
    rest distinct points."""
    ks = scalars(seed, 2 * n)
    a = [C.g1_mul(C.G1_GEN, k) for k in ks[:n]]
    b = [C.g1_mul(C.G1_GEN, k) for k in ks[n:]]
    a[0] = None
    b[2] = a[2]
    b[3] = (a[3][0], P - a[3][1])
    q_aff = FP.from_int([list(pt) for pt in b])
    qs = list(b)
    qs[1] = None
    return projective(a, seed + 1), projective(qs, seed + 2), q_aff, a, qs, b


def host_add(p, q):
    return C._j_to_affine(C._j_add(*(None if x is None else (x[0], x[1], 1) for x in (p, q)),
                                   C._Fp), C._Fp)


def _check_curve_kernels_match_jax():
    ops = G1J.ops()
    p, q, qa, a, qs, b = edge_operands(1)
    pj = [J(c) for c in p.unbind(-2)]
    qj = [J(c) for c in q.unbind(-2)]
    qaj = [J(c) for c in qa.unbind(-2)]

    got = FK.g1_add_plain(p, q)
    assert torch.equal(FK.g1_add(p, q), got)
    assert torch.equal(got, port_of(WJ.add(ops, tuple(pj), tuple(qj))))
    assert torch.equal(got, port_of(FKJ._fused_xla("g1_add", pj + qj)))
    assert list(G1.to_affine_ints(tuple(got.unbind(-2)))) == [
        host_add(x, y) for x, y in zip(a, qs)]

    got = FK.g1_madd_plain(p, qa)
    assert torch.equal(FK.g1_madd(p, qa), got)
    assert torch.equal(got, port_of(WJ.madd(ops, tuple(pj), tuple(qaj))))
    assert torch.equal(got, port_of(FKJ._fused_xla("g1_madd", pj + qaj)))
    assert list(G1.to_affine_ints(tuple(got.unbind(-2)))) == [
        host_add(x, y) for x, y in zip(a, b)]

    got = FK.g1_dbl_plain(p)
    assert torch.equal(FK.g1_dbl(p), got)
    assert torch.equal(got, port_of(WJ.double(ops, tuple(pj))))
    assert torch.equal(got, port_of(FKJ._fused_xla("g1_dbl", pj)))
    assert list(G1.to_affine_ints(tuple(got.unbind(-2)))) == [host_add(x, x) for x in a]

    # off the curve too: the formulas as algebra, on random canonical values
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, size=(2, 4, 3, 12), dtype=np.uint64)
    w[..., 11] %= 0x1A0111EA
    r1, r2 = torch.from_numpy(w.astype(np.uint32).view(np.int32))
    r1j, r2j = ([J(c) for c in r.unbind(-2)] for r in (r1, r2))
    assert torch.equal(FK.g1_add_plain(r1, r2), port_of(FKJ._fused_xla("g1_add", r1j + r2j)))
    assert torch.equal(FK.g1_madd_plain(r1, r2[:, :2]),
                       port_of(FKJ._fused_xla("g1_madd", r1j + r2j[:2])))
    assert torch.equal(FK.g1_dbl_plain(r1), port_of(FKJ._fused_xla("g1_dbl", r1j)))


def _check_glv_split_matches_jax():
    lam = SDJ.GLV_LAMBDA
    vals = [0, 1, R - 1, lam, lam - 1, lam + 1, lam * lam] + scalars(2, 9)
    e = limbs16(vals)
    k1, k2 = SD.glv_split(convert.from_jax_fr(e))
    j1, j2 = SDJ.glv_split(jnp.asarray(e))
    assert np.array_equal(k1.numpy(), np.asarray(j1))
    assert np.array_equal(k2.numpy(), np.asarray(j2))
    ints = [sum(int(w) << (16 * i) for i, w in enumerate(row)) for row in k1.numpy()]
    ints2 = [sum(int(w) << (16 * i) for i, w in enumerate(row)) for row in k2.numpy()]
    assert [x + lam * y for x, y in zip(ints, ints2)] == vals
    bits = SD.bits_msb_first(k1, SD.GLV_BITS)
    assert np.array_equal(bits.numpy(), np.asarray(SDJ.bits_msb_first(j1, SDJ.GLV_BITS)))
    m = np.array([0xFFFF, 0, 0x1234, 0xFFFF], np.int32)       # a host constant
    assert np.array_equal(SD.mul_const(convert.from_jax_fr(e), m).numpy(),
                          np.asarray(SDJ.mul_const(jnp.asarray(e), m)))
    for got, want in zip(SD.divmod_const(convert.from_jax_fr(e), SDJ.X_ABS, lq=15, lr=4),
                         SDJ.divmod_const(jnp.asarray(e), SDJ.X_ABS, lq=15, lr=4)):
        assert np.array_equal(got.numpy(), np.asarray(want))


#: The JAX GLV ladder under jax.jit, in a child process, so that the test
#: worker does not keep the compile.
JAX_SCALAR_MUL = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.curves import g1 as G1
d = np.load(sys.argv[1])
p = tuple(jnp.asarray(d[k]) for k in ("X", "Y", "Z"))
out = jax.jit(G1.scalar_mul)(p, jnp.asarray(d["e"]))
np.save(sys.argv[2], np.stack([np.asarray(c) for c in out], 0))
"""


def _check_scalar_mul_matches_jax_jit(tmp_path):
    ks = scalars(3, 2)
    es = [scalars(4, 1)[0], R - 1]
    pts = [C.g1_mul(C.G1_GEN, k) for k in ks]
    p = tuple(projective(pts, 6).unbind(-2))
    e = convert.from_jax_fr(limbs16(es))
    got = G1.scalar_mul(p, e)
    assert list(G1.to_affine_ints(got)) == [C.g1_mul(pt, s) for pt, s in zip(pts, es)]
    assert bool(G1.eq(G1.scalar_mul_plain(p, e), got).all())
    np.savez(tmp_path / "in.npz", e=convert.to_jax_fr(e),
             **dict(zip(("X", "Y", "Z"), convert.to_jax_point(p))))
    out = subprocess.run([sys.executable, "-c", JAX_SCALAR_MUL, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npy")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert torch.equal(torch.stack(got, -2), port_of(np.load(tmp_path / "out.npy")))


def _check_codecs_match_jax():
    pts = [C.g1_mul(C.G1_GEN, k) for k in scalars(7, 5)] + [None]
    blobs = [CODECJ.g1_serialize(pt) for pt in pts]
    assert [codec.g1_serialize(pt) for pt in pts] == blobs
    assert [codec.g1_parse(b) for b in blobs[:5]] == [CODECJ.g1_parse(b) for b in blobs[:5]]
    v = T.G1Vec.from_affine(pts, device="cpu")
    assert v.serialize() == blobs
    parsed = T.G1Vec.parse(blobs[:5], device="cpu")
    assert parsed.serialize() == blobs[:5]
    assert list(G1.to_affine_ints(parsed.p)) == pts[:5]
    assert bool((parsed == T.G1Vec.from_affine(pts[:5], device="cpu")).all())
    with pytest.raises(ValueError, match="prefix"):
        T.G1Vec.parse([b"\x04" + blobs[0][1:]], device="cpu")
    x = next(x for x in range(1, 50) if CODECJ.F.fp_sqrt((x**3 + 4) % P) is None)
    with pytest.raises(ValueError, match="not on curve"):
        T.G1Vec.parse([b"\x02" + x.to_bytes(48, "big")], device="cpu")
    # the group operation, its inverse and the product along an axis
    g = T.G1Vec.from_affine(pts[:4], device="cpu")
    assert list(G1.to_affine_ints((g * g.inverse()).p)) == [None] * 4
    assert list(G1.to_affine_ints((g / g).p)) == [None] * 4
    total = None
    for pt in pts[:4]:
        total = host_add(total, pt)
    assert G1.to_affine_ints(g.product().p) == total
    zs = scalars(8, 4) + [0, R - 1]
    z = T.ZpVec.from_ints(zs, device="cpu")
    assert z.serialize() == [CODECJ.zp_serialize(v) for v in zs]
    assert [codec.zp_parse(b) for b in z.serialize()] == zs
    assert list(T.ZpVec.parse(z.serialize(), device="cpu").to_ints()) == zs
    with pytest.raises(ValueError, match="over range"):
        T.ZpVec.parse([R.to_bytes(48, "big")], device="cpu")


def _check_in_subgroup_and_cofactor():
    x = next(x for x in range(1, 50) if CODECJ.F.fp_sqrt((x**3 + 4) % P) is not None)
    off = (x, CODECJ.F.fp_sqrt((x**3 + 4) % P))      # on E(Fp), not of order r
    pts = [C.g1_mul(C.G1_GEN, k) for k in scalars(9, 2)] + [off, None]
    p = tuple(projective(pts, 10).unbind(-2))
    assert G1.in_subgroup(p).tolist() == [True, True, False, True]
    assert G1.on_curve(p).tolist() == [True] * 4
    bad = (p[0], FP.add(p[1], FP.one((4,))), p[2])
    assert G1.on_curve(bad).tolist() == [False, False, False, True]
    cleared = G1.clear_cofactor(p)
    want = [C._j_to_affine(C._j_mul(pt, H_EFF_G1, C._Fp), C._Fp) if pt else None for pt in pts]
    assert list(G1.to_affine_ints(cleared)) == want
    assert G1.in_subgroup(cleared).tolist() == [True] * 4


def _check_g1vec_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.G1Vec.generator((2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ZpVec.from_ints([1, 2])


def test_g1_layer_matches_jax(tmp_path):
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_curve_kernels_match_jax()
    _check_glv_split_matches_jax()
    _check_scalar_mul_matches_jax_jit(tmp_path)
    _check_codecs_match_jax()
    _check_in_subgroup_and_cofactor()
    if not torch.cuda.is_available():    # the no-card behaviour, checked here
        _check_g1vec_needs_a_card_by_default()
