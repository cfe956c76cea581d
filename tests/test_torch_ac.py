"""The port's anonymous-credential schemes AC-BBS, AC-RBBS and AC-RPS
against the JAX package and the reference vectors; every test runs for
the three schemes.

Held exactly (bytes and verdicts): the flow vectors
(tests/vectors/ac_bbs_flow.json, ac_rbbs_flow.json at n = 32, I = {0, 3};
ac_rps_flow.json at n = 64, I = {0, 1, 3}) through the port's keygen,
generate_attributes, issue, redact, pres and verify, where AC-RPS's
verify, t1 and t2 are False (reference fault F6); at n = 4 on one CSPRNG
stream, keygen, issue, redact and pres against the JAX host functions,
and every row of `verify_batch` against the JAX host `verify`, on valid
rows and a tampered one (AC-BBS: another row's u list; AC-RBBS: t + 1;
AC-RPS: s + 1); for AC-RPS also the four GT terms of t1 and t2 against
the JAX host elements' values.  The JAX `verify_batch` is not run: its
CPU compile outlasts a test.  All on the CPU (`device="cpu"`).
"""

import json
import pathlib

import pytest

from crypto12381_tpu.api import sets as SJ
from crypto12381_tpu.compat.csprng import RandomEngine
from crypto12381_tpu.params import R
from crypto12381_tpu.schemes import ac_bbs as ABJ
from crypto12381_tpu.schemes import ac_rbbs as ARJ
from crypto12381_tpu.schemes import ac_rps as APJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCHEMES = ["ac_bbs", "ac_rbbs", "ac_rps"]
JAX = {"ac_bbs": ABJ, "ac_rbbs": ARJ, "ac_rps": APJ}
#: the flows' parameters: n and I
FLOW = {"ac_bbs": (32, [0, 3]), "ac_rbbs": (32, [0, 3]), "ac_rps": (64, [0, 1, 3])}

torch = S = PORT = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs."""
    global torch, S, PORT
    import torch
    from crypto12381_tpu_torch.api import sets as S
    from crypto12381_tpu_torch.schemes import ac_bbs, ac_rbbs, ac_rps
    PORT = {"ac_bbs": ac_bbs, "ac_rbbs": ac_rbbs, "ac_rps": ac_rps}
    yield


def _present(scheme, mod, keys, attr, sig, I, m, r, k):
    """k presentations of one credential on the stream r, in the scheme's
    form, and the redaction (None for AC-BBS)."""
    if scheme == "ac_bbs":
        return [mod.pres(m, attr, sig, I, keys.pk, r) for _ in range(k)], None
    rc = mod.redact(attr, sig, I, keys.pk)
    if scheme == "ac_rbbs":
        return [mod.pres(m, sig, rc, r) for _ in range(k)], rc
    return [mod.pres(m, attr, sig, I, rc, keys.pk, r) for _ in range(k)], rc


def _bytes(scheme, p):
    return (p.fixed_part + b"".join(p.u)) if scheme == "ac_bbs" else p


@pytest.mark.parametrize("scheme", SCHEMES)
def test_flow_vector_and_no_card_default(scheme):
    """The flow vector byte for byte; AC-RPS's verify, t1 and t2 are False
    (F6).  Without a card verify_batch raises."""
    vec = json.loads((ROOT / "tests" / "vectors" / f"{scheme}_flow.json").read_text())
    mod, (n, I), m = PORT[scheme], FLOW[scheme], b"\x00"
    r = S.create_random_engine("seed")
    keys = mod.keygen(n, r)
    assert keys.sk.hex() == vec["sk"] and keys.pk.fixed_part.hex() == vec["pk_fixed"]
    assert [y.hex() for y in keys.pk.Y] == vec["Y"]
    if scheme != "ac_bbs":
        assert [y.hex() for y in keys.pk.tilde_Y] == vec["tilde_Y"]
    attr = mod.generate_attributes(keys.pk, n, r)
    assert [a.hex() for a in attr] == vec["attr"]
    sig = mod.issue(keys, attr, r)
    assert sig.hex() == vec.get("sig") or sig.hex() == vec.get("sig_A", "") + vec.get("sig_w", "")
    (p,), rc = _present(scheme, mod, keys, attr, sig, I, m, r, 1)
    if scheme == "ac_bbs":
        assert p.fixed_part.hex() == vec["pres_fixed"]
        assert [u.hex() for u in p.u] == vec["pres_u"]
    else:
        assert rc.hex() == vec["redact"] and p.hex() == vec["pres"]
    assert mod.verify(m, attr, I, p, keys.pk) is vec["verify"] is (scheme != "ac_rps")
    if scheme == "ac_rps":
        l1, r1, l2, r2 = _rps_terms_jax(m, attr, I, p, keys.pk)
        assert (l1 == r1) is vec["verify_t1"] is False
        assert (l2 == r2) is vec["verify_t2"] is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="verify_batch runs on a CUDA card"):
            mod.verify_batch(m, attr, I, [p], keys.pk)


def _rps_terms_jax(m, attr, I, presinfo, pk):
    """AC-RPS's four GT sides of t1 and t2 with the JAX host elements (its
    `verify`, term by term)."""
    g, tg, tX = SJ.parse(SJ.G1, SJ.G2 ** 2, pk.fixed_part)
    tY = [SJ.parse(SJ.G2, b) for b in pk.tilde_Y]
    a = [SJ.parse(SJ.Zp, b) for b in attr]
    n = len(a)
    A_, B_, D_, tCJ_, U, s = SJ.parse(SJ.G1 ** 3, SJ.G2, SJ.GT, SJ.Zp, presinfo)
    c = SJ.hash_(m, A_, B_, tCJ_, D_, U).to(SJ.Zp)
    base = SJ.serialize(*[a[j] for j in I])
    q = [SJ.hash_(base, int(i).to_bytes(8, "little")).to(SJ.Zp) for i in range(n)]
    Y = {i: SJ.parse(SJ.G1, pk.Y[n - 1 - i]) for i in I}
    rhs = tX * tCJ_
    for i in I:
        if i != 0:
            rhs = rhs * (tY[i] ** a[i])
    return (SJ.pair(A_, tY[0] ** s) * SJ.inverse(U),
            (SJ.pair(SJ.inverse(A_), rhs) * SJ.pair(B_, tg)) ** c,
            SJ.pair(SJ.product_([Y[i] ** q[i] for i in I]), tCJ_).value(),
            SJ.pair(D_, tg).value())


def _tampered(scheme, mod, pres):
    """A row that must reject: AC-BBS the first row with the second's u
    list, AC-RBBS the first row's t + 1, AC-RPS the first row's s + 1 (its
    last scalar in both)."""
    if scheme == "ac_bbs":
        return mod.PresInfo(pres[0].fixed_part, pres[1].u)
    v = (int.from_bytes(pres[0][-48:], "big") + 1) % R
    return pres[0][:-48] + v.to_bytes(48, "big")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_functions_and_verify_batch_match_jax(scheme):
    """At n = 4: keygen, issue, redact and two presentations equal the JAX
    host functions' on one stream; verify_batch on the two valid rows and a
    tampered one equals the JAX host verify row by row (AC-RPS: False on
    every row, F6), and AC-RPS's device GT terms equal the JAX host ones."""
    mod, jmod = PORT[scheme], JAX[scheme]
    I, m = ([0, 2] if scheme == "ac_rps" else [1, 2]), b"torch-ac"
    r, rj = S.create_random_engine("torch-" + scheme), RandomEngine("torch-" + scheme)
    keys, kj = mod.keygen(4, r), jmod.keygen(4, rj)
    assert (keys.sk, keys.pk.fixed_part, keys.pk.Y) == (kj.sk, kj.pk.fixed_part, kj.pk.Y)
    attr = mod.generate_attributes(keys.pk, 4, r)
    assert attr == jmod.generate_attributes(kj.pk, 4, rj)
    sig = mod.issue(keys, attr, r)
    assert sig == jmod.issue(kj, attr, rj)
    pres, rc = _present(scheme, mod, keys, attr, sig, I, m, r, 2)
    pres_j, rc_j = _present(scheme, jmod, kj, attr, sig, I, m, rj, 2)
    assert rc == rc_j and [_bytes(scheme, p) for p in pres] == [_bytes(scheme, p) for p in pres_j]
    rows = pres + [_tampered(scheme, mod, pres)]
    if scheme == "ac_rps":
        rows = rows[1:]
        terms = mod._gt_terms(m, attr, I, rows, keys.pk, torch.device("cpu"))
        want = [_rps_terms_jax(m, attr, I, p, kj.pk) for p in rows]
        for k, t in enumerate(terms):
            assert t.serialize() == [w[k].serialize() for w in want]
    want = [jmod.verify(m, attr, I, p, kj.pk) for p in rows]
    assert want == ([False] * 2 if scheme == "ac_rps" else [True, True, False])
    got = mod.verify_batch(m, attr, I, rows, keys.pk, device="cpu")
    assert got.dtype == bool and got.tolist() == want
    assert [mod.verify(m, attr, I, p, keys.pk) for p in rows] == want
