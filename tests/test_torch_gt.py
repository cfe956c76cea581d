"""The port's GT layer and pairing products against the JAX package, the
golden vectors and the host codec.

On reduced-pairing values at B = 2 (the port's `pair_batch` on the CPU):
`gt_pow` and the `GTVec` operations (* / ** inverse inverse_unitary
product) against the JAX package's under jax.jit; `multi_miller_shared`
with a masked pair, its final exponentiation (`pair_prod`) and
`multi_pairing` against the JAX functions; `pair_vec` with identity rows
against the JAX `pair_vec`; each JAX side in a child process, its compiled
graphs dying with it.  Then the algebra on the port alone: bilinearity
pair_vec(g1^x, g2^y) == pair_vec(g1, g2)^(x y), pair_prod as the product
of pair_vecs, multi_miller beyond 4 pairs as the shared chain, and
`GTVec.parse`/`serialize` against the JAX package's and the reference's
bytes of e(G1, G2).
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.api import batch as BJ
from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.params import R

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "reference.json").read_text())

torch = T = convert = codec = FP = TW = C = PAIR = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's tests run, not when the
    file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's tests."""
    global torch, T, convert, codec, FP, TW, C, PAIR
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    yield
    jax.clear_caches()


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def limbs16(vals):
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(18)] for v in vals], np.int32)


def g2_tensors(pts):
    v = T.G2Vec.from_affine(pts, device="cpu")
    return v.p[0], v.p[1]


#: The JAX functions under jax.jit, in a child process: argv[1] the case,
#: argv[2] the inputs, argv[3] the outputs.
JAX_GT = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.api import batch as B
from crypto12381_tpu.pairing import pairing as PAIR
case = sys.argv[1]
d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[2]).items()}
if case == "pow":
    def ops(f, g, e):
        a, b = B.GTVec(f), B.GTVec(g)
        return ((a ** B.ZpVec(e)).f, (a * b).f, (a / b).f, b.inverse().f,
                b.inverse_unitary().f, a.product().f)
    out = dict(zip(("pow", "mul", "div", "inv", "conj", "prod"),
                   jax.jit(ops)(d["f"], d["g"], d["e"])))
elif case == "miller":
    mm = jax.jit(lambda px, py, qx, qy, inf: PAIR.multi_miller_shared(
        (px, py), (qx, qy), inf=inf))
    fe = jax.jit(PAIR.final_exp)
    args = [d[k] for k in ("px", "py", "qx", "qy")]
    masked = mm(*args, d["inf"])
    plain = mm(*args, jnp.zeros_like(d["inf"]))
    out = {"masked": masked, "prod": fe(masked), "multi_pairing": fe(plain)}
else:
    def pv(px, py, pz, qx, qy, qz):
        return B.pair_vec(B.G1Vec((px, py, pz)), B.G2Vec((qx, qy, qz))).f
    out = {"pair_vec": jax.jit(pv)(*[d[k] for k in ("px", "py", "pz", "qx", "qy", "qz")])}
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
"""


def run_jax(case, tmp_path, **arrays):
    np.savez(tmp_path / "in.npz", **arrays)
    out = subprocess.run([sys.executable, "-c", JAX_GT, case, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    return {k: convert.from_jax_fp(v) for k, v in np.load(tmp_path / "out.npz").items()}


@pytest.mark.parametrize("case", ["pow", "miller", "pair_vec"])
def test_gt_and_pairing_products_match_jax_jit(case, tmp_path):
    ks = scalars(20 + len(case), 8)
    g1 = [C.g1_mul(C.G1_GEN, k) for k in ks[:4]]
    g2 = [C.g2_mul(C.G2_GEN, k) for k in ks[4:]]
    J = convert.to_jax_fp
    if case == "pow":
        fg = T.pair_batch(g1, g2, device="cpu")
        f, g = fg[:2], fg[2:]
        e = limbs16([ks[0], R - 1])
        want = run_jax(case, tmp_path, f=J(f), g=J(g), e=e)
        a, b = T.GTVec(f), T.GTVec(g)
        got = {"pow": PAIR.gt_pow(f, torch.from_numpy(e)), "mul": (a * b).f,
               "div": (a / b).f, "inv": b.inverse().f, "conj": b.inverse_unitary().f,
               "prod": a.product().f}
        for k, v in got.items():
            assert torch.equal(v, want[k]), k
        assert torch.equal((a ** T.ZpVec(torch.from_numpy(e))).f, got["pow"])
    elif case == "miller":
        px = FP.from_int([[p[0] for p in g1[:2]], [p[0] for p in g1[2:]]])
        py = FP.from_int([[p[1] for p in g1[:2]], [p[1] for p in g1[2:]]])
        qx, qy = (t.reshape(2, 2, 2, 12) for t in g2_tensors(g2))
        inf = torch.tensor([[False, True], [False, False]])
        want = run_jax(case, tmp_path, px=J(px), py=J(py), qx=J(qx), qy=J(qy),
                       inf=inf.numpy())
        masked = PAIR.multi_miller_shared((px, py), (qx, qy), inf=inf)
        assert torch.equal(masked, want["masked"])
        assert torch.equal(PAIR.final_exp(masked), want["prod"])
        assert torch.equal(PAIR.multi_pairing((px, py), (qx, qy)), want["multi_pairing"])
        vecs = [(T.G1Vec((px[i], py[i], FP.one((2,)))),
                 T.G2Vec((qx[i], qy[i], TW.fp2_one((2,))))) for i in range(2)]
        vecs[0] = (T.G1Vec((px[0], py[0], torch.stack([FP.one(()), FP.zero(())]))), vecs[0][1])
        assert torch.equal(T.pair_prod(*vecs).f, want["prod"])
    else:
        # projective points (Z != 1), and an identity row on each side
        p1 = T.G1Vec.from_affine(g1, device="cpu") * T.G1Vec.generator((4,), device="cpu")
        p2 = T.G2Vec.from_affine(g2, device="cpu") * T.G2Vec.generator((4,), device="cpu")
        p1.p[2][3] = 0
        p2.p[2][1] = 0
        want = run_jax(case, tmp_path, **{k: J(t) for k, t in zip(
            ("px", "py", "pz", "qx", "qy", "qz"), p1.p + p2.p)})
        got = T.pair_vec(p1, p2)
        assert torch.equal(got.f, want["pair_vec"])
        assert got.is_one().tolist() == [False, True, False, True]


def test_gt_algebra_and_bytes():
    """Bilinearity, pair_prod as the product of pair_vecs with identity
    rows, multi_miller beyond 4 pairs, and the GT codec."""
    x, y = scalars(30, 2), scalars(31, 2)
    g1 = T.G1Vec.generator((2,), device="cpu")
    g2 = T.G2Vec.generator((2,), device="cpu")
    P = g1 ** T.ZpVec.from_ints(x, device="cpu")
    Q = g2 ** T.ZpVec.from_ints(y, device="cpu")
    lhs = T.pair_vec(P, Q)
    base = T.pair_vec(g1, g2)
    xy = T.ZpVec.from_ints(x, device="cpu") * T.ZpVec.from_ints(y, device="cpu")
    assert (lhs == base ** xy).tolist() == [True, True]
    blobs = base.serialize()
    assert [b.hex() for b in blobs] == [VEC["gt_e_g1_g2"]] * 2
    assert blobs == BJ.GTVec(jnp.asarray(convert.to_jax_fp(base.f))).serialize()
    host = TW.fp12_to_host(lhs.f)
    assert lhs.serialize() == [codec.gt_serialize(h) for h in host]
    assert [codec.gt_parse(b) for b in lhs.serialize()] == [CODECJ.gt_parse(b)
                                                             for b in lhs.serialize()]
    back = T.GTVec.parse(lhs.serialize(), device="cpu")
    assert torch.equal(back.f, lhs.f)
    want = BJ.GTVec.parse(lhs.serialize()).f
    assert torch.equal(back.f, convert.from_jax_fp(np.asarray(want)))
    assert back.shape == (2,)

    # a pair with an identity G1 row contributes 1 on that row
    P2 = T.G1Vec.from_affine([None, C.g1_mul(C.G1_GEN, 5)], device="cpu")
    prod = T.pair_prod((P, Q), (P2, g2))
    assert torch.equal(prod.f, (lhs * T.pair_vec(P2, g2)).f)
    assert torch.equal(prod.f[0], lhs.f[0])
    assert (T.pair_prod((P, Q), (P.inverse(), Q)).is_one()).tolist() == [True, True]

    # more than 4 pairs: one batched Miller loop and a tree of products
    pts1 = [C.g1_mul(C.G1_GEN, k) for k in scalars(32, 5)]
    pts2 = [C.g2_mul(C.G2_GEN, k) for k in scalars(33, 5)]
    px, py = FP.from_int([p[0] for p in pts1]), FP.from_int([p[1] for p in pts1])
    qx, qy = g2_tensors(pts2)
    assert torch.equal(PAIR.multi_miller((px, py), (qx, qy)),
                       PAIR.multi_miller_shared((px, py), (qx, qy)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.GTVec.parse(blobs)
