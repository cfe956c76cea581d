"""The port's Shamir slice and host scalar helpers against the JAX package.

Held exactly (bytes, or canonical integers) against the JAX package on the
same inputs, made from seeds: `share`/`share_batch` and `reconstruct`/
`reconstruct_batch` against the JAX host `sss.share`/`sss.reconstruct`
and tests/vectors/sss_flow.json; the port's `batch_inv` (every element's
inverse, 0 for 0) against the JAX `batch_inv` of the int16 engine's
FR_CTX and of the fp32 engine's FP_CTX; and the host helpers of
api/sets.py and api/elements.py that BBS, BBS+ and Shamir use.
"""

import json
import operator
import pathlib

import numpy as np
import pytest

from crypto12381_tpu.api import elements as ELJ
from crypto12381_tpu.api import sets as SETJ
from crypto12381_tpu.fields import fp as FPJ
from crypto12381_tpu.fields import fp32 as FP32J
from crypto12381_tpu.params import P, R
from crypto12381_tpu.schemes import sss as SSSJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "sss_flow.json").read_text())

torch = T = S = EL = FP = SSS = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected."""
    global torch, T, S, EL, FP, SSS
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.api import elements as EL
    from crypto12381_tpu_torch.api import sets as S
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.schemes import sss as SSS
    yield


def _secret(seed: str) -> bytes:
    return (int.from_bytes(seed.encode() * 8, "big") % R).to_bytes(48, "big")


@pytest.mark.parametrize("t, n, subsets", [
    (4, 6, [[1, 3, 4, 6], [2, 3, 5, 6]]),
    (5, 37, [[2, 9, 17, 23, 36], [1, 2, 3, 4, 37]]),
    (1, 3, [[2], [3]]),
])
def test_share_and_reconstruct_match_jax(t, n, subsets):
    """The shares of the host and batched paths are the JAX host shares
    (the same draws); both reconstructions give the secret back and equal
    the JAX host reconstruction; t - 1 shares (t > 1) do not give it.  The
    4-of-6 case also runs sss_flow.json's draws and bytes."""
    seed = f"sss-{t}-{n}"
    secret = _secret(seed)
    want = SSSJ.share(t, n, secret, SETJ.create_random_engine(seed))
    r = S.create_random_engine(seed)
    assert SSS.share(t, n, secret, r) == want
    rb = S.create_random_engine(seed)
    assert SSS.share_batch(t, n, secret, rb, device="cpu") == want
    assert r.rand_bytes(16) == rb.rand_bytes(16)           # the same draws were used
    for idx in subsets:
        picked = [want[i - 1] for i in idx]
        rec = SSSJ.reconstruct(idx, picked)
        assert rec == secret
        assert SSS.reconstruct(idx, picked) == rec
        assert SSS.reconstruct_batch(idx, picked, device="cpu") == rec
    if t > 1:
        short = subsets[0][:-1]
        assert SSS.reconstruct_batch(short, [want[i - 1] for i in short], device="cpu") != secret

    if (t, n) == (4, 6):
        r = S.create_random_engine("seed")
        secret = S.serialize(S.select_in(S.Zp, r))
        assert secret.hex() == VEC["secret"]
        shares = SSS.share_batch(4, 6, secret, r, device="cpu")
        assert [s.hex() for s in shares] == VEC["shares"]
        idx = [1, 3, 4, 6]
        for rec_fn in (SSS.reconstruct, lambda i, s: SSS.reconstruct_batch(i, s, device="cpu")):
            rec = rec_fn(idx, [shares[i - 1] for i in idx])
            assert rec.hex() == VEC["reconstructed"] and (rec == secret) == VEC["match"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="share_batch runs on a CUDA card"):
                SSS.share_batch(4, 6, secret, r)
            with pytest.raises(RuntimeError, match="reconstruct_batch runs on a CUDA card"):
                SSS.reconstruct_batch(idx, shares[:4])


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_batch_inv_matches_jax(field):
    """batch_inv on random rows and on 0, 1 and m - 1, a (2, 7) batch: the
    same canonical integers as the JAX package's batch_inv (the int16
    engine's FR_CTX, the fp32 engine's FP_CTX), and the inverses mod m."""
    F, m = (FP.FR_CTX, R) if field == "fr" else (FP.FP_CTX, P)
    rng = np.random.default_rng(11)
    vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(48), "big") % m for _ in range(10)] + [0]
    got = F.to_int(F.batch_inv(F.from_int(np.array(vals, object).reshape(2, 7))))
    if field == "fr":
        want = FPJ.to_int(FPJ.FR_CTX, FPJ.batch_inv(FPJ.FR_CTX, FPJ.from_int(FPJ.FR_CTX, vals)))
    else:
        want = FP32J.to_int(FP32J.FP_CTX,
                            FP32J.batch_inv(FP32J.FP_CTX, FP32J.from_int(FP32J.FP_CTX, vals)))
    assert [int(v) for v in got.reshape(-1)] == [int(v) for v in want]
    assert [int(v) for v in want] == [pow(v, -1, m) if v else 0 for v in vals]


def test_host_helpers_and_broadcasts_match_jax():
    """encode_to, polynomial, make_Zp, the count form of select_in,
    ZpNumber's operators, the G1 host group law and product_ against the
    JAX package's; ZpVec + - * with a (1,) operand against (n,), and
    G1Vec.broadcast_to / from_elements."""
    for size in (0, 1, 30, 31, 32, 62, 112):
        msg = bytes((7 * i + size) % 256 for i in range(size))
        got = [z.value for z in S.encode_to(S.Zp, msg)]
        assert got == [z.value for z in SETJ.encode_to(SETJ.Zp, msg)]
        assert len(got) == -(-size // 31)
    assert S.encode_to(S.Zp, "ab")[0].value == SETJ.encode_to(SETJ.Zp, b"ab")[0].value

    r, rj = S.create_random_engine("helpers"), SETJ.create_random_engine("helpers")
    a, aj = S.select_in(S.Zp, r, 5), SETJ.select_in(SETJ.Zp, rj, 5)
    assert isinstance(a, list) and [z.value for z in a] == [z.value for z in aj]
    for x in (0, 1, 7, -3, R + 5):
        assert S.make_Zp(x).value == SETJ.make_Zp(x).value
        assert S.polynomial(x, a[0], a[1:]).value == SETJ.polynomial(x, aj[0], aj[1:]).value
    z, w = a[1], a[2]
    zj, wj = aj[1], aj[2]
    for op in (lambda u, v: u / v, lambda u, v: u - v, lambda u, v: 5 - u,
               lambda u, v: 3 / u, lambda u, v: -u, lambda u, v: u ** 5, lambda u, v: 2 + u,
               lambda u, v: 4 * u, lambda u, v: u.inverse(), lambda u, v: EL.inverse(u) * v):
        assert op(z, w).value == op(zj, wj).value
    assert z == zj.value and hash(z) == hash(S.make_Zp(z.value)) and z != w

    g = EL.G1Element.generator()
    gj = ELJ.G1Element.generator()
    pts = [g ** k for k in (3, 5, R - 3)]
    ptsj = [gj ** k for k in (3, 5, R - 3)]
    assert S.product_(pts).pt == SETJ.product_(ptsj).pt                     # [5]G
    assert S.product_(pts[:2]).pt == SETJ.product_(ptsj[:2]).pt
    assert S.product_([g, pts[0], g]).pt == SETJ.product_([gj, ptsj[0], gj]).pt
    assert (pts[0] * pts[1]).pt == (ptsj[0] * ptsj[1]).pt
    assert (pts[0] / g).pt == (ptsj[0] / gj).pt
    assert (g * pts[2]).pt == (gj * ptsj[2]).pt
    assert (pts[0] * pts[2]).pt is None and (ptsj[0] * ptsj[2]).pt is None
    assert (pts[0] ** 2) == g ** 6 and pts[0].inverse() == pts[2]
    assert g.inverse().pt == gj.inverse().pt and (g * g).pt == (gj * gj).pt
    assert EL.G1Element.identity() * g == g and S.product_([a[0], a[1]]) == a[0] * a[1]
    with pytest.raises(ValueError, match="empty product"):
        S.product_([])

    n = 6
    xs = [int.from_bytes(np.random.default_rng(n).bytes(32), "big") % R + i for i in range(n)]
    one = T.ZpVec.from_ints([a[0].value], device="cpu")
    many = T.ZpVec.from_ints(xs, device="cpu")
    for op in (operator.mul, operator.add, operator.sub):
        assert [int(v) for v in op(one, many).to_ints()] == [op(a[0].value, x) % R for x in xs]
        assert [int(v) for v in op(many, one).to_ints()] == [op(x, a[0].value) % R for x in xs]
    v = T.G1Vec.from_elements([pts[0]], device="cpu").broadcast_to((n,))
    assert v.shape == (n,) and v.z_is_one
    assert T.G1Vec.from_elements(pts, device="cpu").serialize() == [p.serialize() for p in pts]
    q = v ** many
    want = [EL.G1Element(pts[0].point().pt) ** x for x in xs]
    assert q.serialize() == [p.serialize() for p in want]
