"""The port's G2 curve kernels K12-K14 (fields/fused.py, csrc/g2.cu)
against the JAX package.

Each plain version (`g2_add_plain`, `g2_madd_plain`, `g2_dbl_plain`) is
held exactly, as canonical values, against the TPU program of the same
name run as XLA on the CPU (`fp32k._fused_xla`), the JAX composite of three
stacked Fp2 rounds (`fp32k.g2_*_c`), the port's CPU group law
(`curves/g2.py` `add`, `madd`, `double`, which run the plain versions),
also at a (4, 4) batch and with a broadcast operand, and the generic
formulas of `curves/weierstrass.py` over a G2 table without kernels (three
rounds, 3b' as a product).  The 16 rows, made from a numpy seed: all 0,
all 1 and all p-1 at both ends (all p-1 gives the largest pre-sums), G2
points with the identity, P = Q (another Z) and P = -Q between them (each
made affine against the host group law), and random canonical values
(the programs are polynomials).  Then `pair_batch(..., device="cpu")` at
B = 2 gives the JAX package's GT bytes, and `G2Vec ** ZpVec` on the CPU
gives the JAX package's points and bytes (its integer oracle `pyref` and
its codec), now that the Miller loop's G2 steps and the GS ladder run
through the plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.fields import fp32k as FKJ
from crypto12381_tpu.params import P, R
from crypto12381_tpu.pyref import curve as CJ
from crypto12381_tpu.pyref import pairing as PYREF

N = 16

torch = T = convert = codec = FP = FK = TW = G2 = W = C = HF = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's tests."""
    global torch, T, convert, codec, FP, FK, TW, G2, W, C, HF
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g2 as G2
    from crypto12381_tpu_torch.curves import weierstrass as W
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.host import field as HF
    yield
    jax.clear_caches()


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def comps(t):
    """(n, k, 2, 12) port point -> its k coordinates as [re, im] pairs of
    (n, 50) JAX digit arrays."""
    return [[J(t[:, c, f]) for f in range(2)] for c in range(t.shape[1])]


def from_comps(cs):
    """JAX coordinates ([re, im] pairs, or a flat list of components) ->
    (n, 3, 2, 12) port tensor."""
    flat = [np.asarray(x) for c in cs for x in (c if isinstance(c, (list, tuple)) else [c])]
    n = flat[0].shape[0]
    return convert.from_jax_fp(np.stack(flat, 1)).reshape(n, 3, 2, 12)


def operands():
    """P, Q projective (N, 3, 2, 12), Q' affine (N, 2, 2, 12), and the host
    points of rows 3-6: P = O, Q = B; P = A, Q = A (another Z);
    P = -A, Q = A; P = O, Q = O (Q' = B, never the identity)."""
    rng = np.random.default_rng(14)

    def rand(k):
        w = rng.integers(0, 1 << 32, size=(N, k, 2, 12), dtype=np.uint64)
        w[..., 11] %= 0x1A0111EA                  # below p's top limb
        return torch.from_numpy(w.astype(np.uint32).view(np.int32))

    def z_of():
        return tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))

    def proj(pt):
        if pt is None:
            return FP.from_int([[0, 0], [1, 0], [0, 0]])
        z = z_of()
        return FP.from_int([list(HF.fp2_mul(pt[0], z)), list(HF.fp2_mul(pt[1], z)), list(z)])

    p, q, qa = rand(3), rand(3), rand(2)
    k_a, k_b = (int.from_bytes(rng.bytes(32), "big") % R for _ in range(2))
    A, B = C.g2_mul(C.G2_GEN, k_a), C.g2_mul(C.G2_GEN, k_b)
    rows = [(None, B, B), (A, A, A), (C.g2_neg(A), A, A), (None, None, B)]
    for r, (pp, qq, aa) in enumerate(rows, 3):
        p[r], q[r] = proj(pp), proj(qq)
        qa[r] = FP.from_int([list(aa[0]), list(aa[1])])
    for r, v in enumerate([0, 1, P - 1]):
        for t in (p, q, qa):
            t[r] = t[N - 1 - r] = torch.from_numpy(FP.limbs_of(v))
    return p, q, qa, rows


def jax_program(name, p, q, qa):
    ins = {"g2_add": (p, q), "g2_madd": (p, qa), "g2_dbl": (p,)}[name]
    return FKJ._fused_xla(name, [x for t in ins for c in comps(t) for x in c])


def jax_composite(name, p, q, qa):
    if name == "g2_add":
        return FKJ.g2_add_c(comps(p), comps(q))
    if name == "g2_madd":
        return FKJ.g2_madd_c(comps(p), comps(qa))
    return FKJ.g2_dbl_c(comps(p))


def port_op(name, o, p, q, qa):
    """The group law of ops table o on stacked points, stacked back."""
    pt = tuple(p.unbind(-3))
    if name == "g2_add":
        out = W.add(o, pt, tuple(q.unbind(-3)))
    elif name == "g2_madd":
        out = W.madd(o, pt, tuple(qa.unbind(-3)))
    else:
        out = W.double(o, pt)
    return W.stack_point(o, out)


@pytest.mark.parametrize("name", ["g2_add", "g2_madd", "g2_dbl"])
def test_g2_plain_versions_match_jax(name):
    """The plain version equals the JAX program run as XLA, the JAX
    composite, the port's CPU group law (also at a (4, 4) batch and with a
    broadcast operand) and the generic formulas without kernels; its point
    rows equal the host's sums and doubles."""
    p, q, qa = operands()[:3]
    plain = getattr(FK, name + "_plain")
    got = plain(*{"g2_add": (p, q), "g2_madd": (p, qa), "g2_dbl": (p,)}[name])
    assert got.shape == p.shape and got.dtype == torch.int32
    assert torch.equal(got, from_comps(jax_program(name, p, q, qa)))
    assert torch.equal(got, from_comps(jax_composite(name, p, q, qa)))

    o = G2.ops()
    generic = dataclasses.replace(o, fused_add=None, fused_madd=None, fused_dbl=None)
    assert torch.equal(port_op(name, generic, p, q, qa), got)
    assert torch.equal(port_op(name, o, p, q, qa), got)
    wide = port_op(name, o, *(t.reshape((4, 4) + t.shape[1:]) for t in (p, q, qa)))
    assert torch.equal(wide.reshape(got.shape), got)
    # row 5's P broadcast against every row's second operand
    one = port_op(name, o, p[5:6], q, qa)
    want = plain(*{"g2_add": (p[5:6].expand_as(q), q), "g2_madd": (p[5:6].expand_as(p), qa),
                   "g2_dbl": (p[5:6],)}[name])
    assert torch.equal(one, want)

    rows = operands()[3]
    affine = G2.to_affine_ints(tuple(got[3:7].unbind(-3)))
    for r, (pp, qq, aa) in enumerate(rows):
        second = {"g2_add": qq, "g2_madd": aa, "g2_dbl": pp}[name]
        assert affine[r] == C.g2_add(pp, second)


def test_pair_batch_and_g2_ladder_cpu_match_jax():
    """pair_batch on the CPU at B = 2 (the Miller loop's doublings and mixed
    additions through the plain K14 and K13) gives the JAX package's GT
    bytes, and G2Vec ** ZpVec on the CPU at B = 2 (the GS ladder's
    doublings and complete additions through the plain K14 and K12) gives
    the JAX package's points and their bytes."""
    rng = np.random.default_rng(140)
    ks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4)]
    g1 = [C.g1_mul(C.G1_GEN, ks[0]), C.g1_mul(C.G1_GEN, ks[1])]
    g2 = [C.g2_mul(C.G2_GEN, ks[2]), C.g2_mul(C.G2_GEN, ks[3])]
    f = T.pair_batch(g1, g2, device="cpu")
    got = [codec.gt_serialize(h) for h in TW.fp12_to_host(f)]
    want = [CODECJ.gt_serialize(PYREF.pairing(CJ.g1_mul(CJ.G1_GEN, ks[i]),
                                              CJ.g2_mul(CJ.G2_GEN, ks[2 + i])))
            for i in range(2)]
    assert got == want

    e = [ks[0], R - 1]
    pts = T.G2Vec.generator((2,), device="cpu") ** T.ZpVec.from_ints(e, device="cpu")
    jax_pts = [CJ.g2_mul(CJ.G2_GEN, k) for k in e]
    assert list(G2.to_affine_ints(pts.p)) == jax_pts
    assert pts.serialize() == [CODECJ.g2_serialize(pt) for pt in jax_pts]
