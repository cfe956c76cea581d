"""The port's PS slice against the JAX package and the reference vectors.

Held exactly (canonical values, or bytes) against the JAX package on the
same inputs, made from seeds: the CSPRNG's streams and draws, the G2
codec and the PS keys, the fixed-G2 line tables and the shared Miller
loop of `multi_miller_precomp` (the JAX side under jax.jit in a child
process), and `sign_batch` (against the JAX `ps.sign_batch`, jitted in a
child process, and the JAX host `ps.sign`).  `verify_batch` gives the
verdicts and raises that are known by construction on the cases of
tests/test_batch.py (valid, rotated messages, a swapped s2, a flipped x
byte), and `tests/vectors/ps_flow.json` passes byte for byte.  The JAX
`verify_batch` itself is not run: its CPU compile outlasts a test.  The
pairing product closes inside the port: `multi_miller_precomp` equals
the product of the port's `miller_loop` per pair and `pair_prod_fixed`
the product of its `pair_batch` values, both held against the JAX
package in tests/test_torch_pairing.py.
"""

import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.compat import csprng as CSJ
from crypto12381_tpu.params import P, R
from crypto12381_tpu.schemes import ps as PSJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "ps_flow.json").read_text())

torch = T = convert = codec = CS = C = FP = TW = PAIR = PS = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's tests."""
    global torch, T, convert, codec, CS, C, FP, TW, PAIR, PS
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.compat import csprng as CS
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    from crypto12381_tpu_torch.schemes import ps as PS
    yield
    jax.clear_caches()


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def run_jax(script, *args, timeout=1200):
    """Run a JAX script in a child process (its compiled graphs die with
    it) and return its standard output."""
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# ------------------------------------------------------------------ CSPRNG


@pytest.mark.parametrize("seed", ["seed", "bench-ps", b""])
def test_csprng_matches_jax(seed):
    """Byte streams and draws mod r, p and small moduli, interleaved, equal
    the JAX package's engine from the same seed."""
    got, want = CS.create_random_engine(seed), CSJ.RandomEngine(seed)
    assert got.rand_bytes(77) == want.rand_bytes(77)
    for q in (R, P, (1 << 64) + 13, 7, 2):
        for _ in range(3):
            assert got.random_mod(q) == want.random_mod(q)
            assert got.random_mod_nonzero(q) == want.random_mod_nonzero(q)
    assert got.rand_bytes(41) == want.rand_bytes(41)


# ------------------------------------------------------ G2 codec and keys


def _outcome(fn, b):
    try:
        return fn(b)
    except ValueError as e:
        return ("raises", str(e))


def test_g2_codec_keys_and_g2vec_match_jax():
    pts = [C.g2_mul(C.G2_GEN, k) for k in scalars(1, 6)] + [C.G2_GEN]
    for pt in pts + [None]:
        b = codec.g2_serialize(pt)
        assert b == CODECJ.g2_serialize(pt) and len(b) == 97
        if pt is not None:
            assert codec.g2_parse(b) == CODECJ.g2_parse(b) == pt
    # other x: off the twist (raises in both), the identity's bytes, a
    # flipped prefix (the other root), x not reduced mod p
    rng = np.random.default_rng(2)
    blobs = [bytes([2 + (i & 1)]) + rng.bytes(96) for i in range(8)]
    b0 = codec.g2_serialize(pts[0])
    blobs += [codec.g2_serialize(None), bytes([b0[0] ^ 1]) + b0[1:], b"\x02" + b"\xff" * 96]
    outcomes = [(_outcome(codec.g2_parse, b), _outcome(CODECJ.g2_parse, b)) for b in blobs]
    assert all(g == w for g, w in outcomes)
    assert any(g[0] == "raises" for g, _ in outcomes) and any(g[0] != "raises" for g, _ in outcomes)

    # keys: the same draws give the same sk and pk bytes, and the pk's
    # three points parse alike
    for seed in ("keys", "seed"):
        kp, kj = PS.key_gen(CS.create_random_engine(seed)), PSJ.key_gen(CSJ.RandomEngine(seed))
        assert (kp.sk, kp.pk) == (kj.sk, kj.pk)
        for i in range(3):
            b = kp.pk[97 * i:97 * (i + 1)]
            assert codec.g2_parse(b) == CODECJ.g2_parse(b)

    # G2Vec: a z_is_one vector's infinity mask has the batch shape and
    # marks the identity rows; the coordinates are the host points'
    v = T.G2Vec.from_affine([pts[0], None, pts[1]], device="cpu")
    x, y, inf = v.affine()
    assert v.shape == (3,) and tuple(inf.shape) == (3,) and inf.tolist() == [False, True, False]
    assert [tuple(int(c) for c in FP.to_int(x[i])) for i in (0, 2)] == [pts[0][0], pts[1][0]]
    assert [tuple(int(c) for c in FP.to_int(y[i])) for i in (0, 2)] == [pts[0][1], pts[1][1]]
    assert T.G2Vec.identity((2,), device="cpu").affine()[2].tolist() == [True, True]
    g = T.G2Vec.generator((), device="cpu")
    assert g.shape == () and not bool(g.affine()[2])
    assert torch.equal(T.G2Vec.parse([codec.g2_serialize(pts[1])], device="cpu").p[0][0], x[2])


# --------------------------------------------- fixed lines and Miller loop

#: The JAX package's precompute_g2_lines and multi_miller_precomp under
#: jax.jit: the line tables of 4 fixed points (as one batch; row 0 is the
#: test's random point), and the shared Miller loop of k = 3 pairs at
#: B = 3 with the lines of rows 1-3.
JAX_LINES = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.pairing import pairing as PAIR
d = np.load(sys.argv[1])
dbl, add = jax.jit(lambda x, y: PAIR.precompute_g2_lines((x, y)))(
    jnp.asarray(d["qx"]), jnp.asarray(d["qy"]))
lines = [(dbl[:, :, i], add[:, :, i]) for i in (1, 2, 3)]
f = jax.jit(lambda px, py, ls, inf: PAIR.multi_miller_precomp((px, py), ls, inf=inf))(
    jnp.asarray(d["px"]), jnp.asarray(d["py"]), lines, jnp.asarray(d["inf"]))
np.savez(sys.argv[2], dbl=np.asarray(dbl), add=np.asarray(add), f=np.asarray(f))
"""


def _g2_tensors(pts):
    v = T.G2Vec.from_affine(pts, device="cpu")
    return v.p[0], v.p[1]


def test_fixed_lines_and_shared_miller_loop(tmp_path):
    ks = scalars(30, 16)
    qs = [C.g2_mul(C.G2_GEN, k) for k in ks[:4]]
    qx, qy = _g2_tensors(qs)
    g1 = [[C.g1_mul(C.G1_GEN, ks[4 + 3 * i + j]) for j in range(3)] for i in range(3)]
    g1[1][2] = C.G1_GEN                        # an identity row, by mask
    inf = torch.zeros(3, 3, dtype=torch.bool)
    inf[1, 2] = True
    px = FP.from_int([[p[0] for p in row] for row in g1])
    py = FP.from_int([[p[1] for p in row] for row in g1])

    dbl, add = PAIR.precompute_g2_lines((qx, qy))
    assert tuple(dbl.shape) == tuple(add.shape) == (len(PAIR._digits()), 3, 4, 2, 12)
    one = PAIR.precompute_g2_lines((qx[0], qy[0]))            # batch-free
    assert torch.equal(one[0], dbl[:, :, 0]) and torch.equal(one[1], add[:, :, 0])
    fixed = (dbl[:, :, 1:], add[:, :, 1:])
    f = PAIR.multi_miller_precomp((px, py), fixed, inf)

    np.savez(tmp_path / "in.npz", qx=convert.to_jax_fp(qx), qy=convert.to_jax_fp(qy),
             px=convert.to_jax_fp(px), py=convert.to_jax_fp(py), inf=inf.numpy())
    run_jax(JAX_LINES, tmp_path / "in.npz", tmp_path / "out.npz")
    out = np.load(tmp_path / "out.npz")
    assert torch.equal(dbl, convert.from_jax_fp(out["dbl"]))
    assert torch.equal(add, convert.from_jax_fp(out["add"]))
    assert torch.equal(f, convert.from_jax_fp(out["f"]))

    # squaring distributes: the shared loop is the product of the pairs'
    # own Miller values, a masked pair's being 1
    want = TW.fp12_one((3,))
    for i in range(3):
        qi = (qx[i + 1].expand(3, 2, 12), qy[i + 1].expand(3, 2, 12))
        fi = PAIR.miller_loop((px[i], py[i]), qi)
        want = TW.fp12_mul(want, torch.where(inf[i][:, None, None, None, None],
                                             TW.fp12_one((3,)), fi))
    assert torch.equal(f, want)


def test_pair_prod_fixed_is_the_product_of_pairings():
    """pair_prod_fixed equals the product of pair_batch's values, with an
    identity G1 row and an identity G2 point among its pairs, and is one
    exactly where the pairs cancel."""
    a, k1, k2, k3, q1, q2 = scalars(40, 6)
    Q = C.g2_mul(C.G2_GEN, q1)
    aQ = C.g2_mul(Q, a)
    S = C.g2_mul(C.G2_GEN, q2)
    P1 = [C.g1_mul(C.G1_GEN, k) for k in (k1, k2, k3)]
    aP = [C.g1_mul(p, a) for p in P1]
    negP = [(p[0], (P - p[1]) % P) for p in P1]
    negP[2] = C.g1_mul(C.G1_GEN, 5)             # this row does not cancel
    other = [None, C.g1_mul(C.G1_GEN, k2 + 1), C.G1_GEN]
    vec = [T.G1Vec.from_affine(pts, device="cpu") for pts in (aP, negP, other)]
    g2 = [T.G2Vec.from_affine([pt], device="cpu") for pt in (Q, aQ, S)]
    g2[2] = T.G2Vec.identity((1,), device="cpu")   # e(., O) = 1
    got = T.pair_prod_fixed(*zip(vec, g2))
    assert got.is_one().tolist() == [True, True, False]

    want = T.pair_batch(aP + negP + other, [Q] * 3 + [aQ] * 3 + [None] * 3, device="cpu")
    prod = TW.fp12_mul(TW.fp12_mul(want[:3], want[3:6]), want[6:])
    assert torch.equal(got.f, prod)
    # with an identity G2 point turned to S, the identity G1 row still masks
    got_s = T.pair_prod_fixed((vec[2], T.G2Vec.from_affine([S], device="cpu")))
    want_s = T.pair_batch(other, [S] * 3, device="cpu")
    assert torch.equal(got_s.f, want_s) and bool(got_s.is_one()[0])
    assert (got_s == T.GTVec(want_s)).tolist() == [True] * 3
    with pytest.raises(ValueError, match="batch-free"):
        T.pair_prod_fixed((vec[0], T.G2Vec.generator((3,), device="cpu")))


# ------------------------------------------------------------- PS scheme


def test_ps_flow_vector_and_no_card_default():
    """ps_flow.json through the port's key_gen, sign_batch (B = 1),
    randomnize and verify_batch; and without a card the batched entry
    points raise, as pair_batch does."""
    r = CS.create_random_engine("seed")
    keys = T.key_gen(r)
    assert keys.pk.hex() == VEC["g2"] + VEC["X2"] + VEC["Y2"]
    assert keys.sk.hex() == VEC["sk"]
    msg = b"\x00" * 47 + bytes([23])
    sig = T.sign_batch(keys.sk, [msg], r, device="cpu")
    assert [s.hex() for s in sig] == [VEC["signature"]]
    rand_sig = T.randomnize(sig[0], r)
    assert rand_sig.hex() == VEC["signature_rand"]
    ok = T.verify_batch(keys.pk, [msg], [rand_sig], device="cpu")
    assert isinstance(ok, np.ndarray) and ok.dtype == bool and ok.tolist() == [VEC["verify"]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sign_batch runs on a CUDA card.*device='cpu'"):
            T.sign_batch(keys.sk, [msg], r)
        with pytest.raises(RuntimeError, match="verify_batch runs on a CUDA card.*device='cpu'"):
            T.verify_batch(keys.pk, [msg], [rand_sig])


#: The JAX package's ps.sign_batch (its GLV ladder under jax.jit).
JAX_SIGN = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from crypto12381_tpu.compat.csprng import RandomEngine
from crypto12381_tpu.schemes import ps
r = RandomEngine(sys.argv[1])
keys = ps.key_gen(r)
msgs = [bytes.fromhex(m) for m in json.loads(sys.argv[2])]
print(json.dumps([s.hex() for s in ps.sign_batch(keys.sk, msgs, r)]))
"""


def test_sign_batch_matches_jax():
    """B = 3 on one stream: the port's sign_batch equals the JAX package's
    and three of its single signs, and verifies."""
    msgs = [b"alpha", b"bravo", b"charlie-" + bytes(range(40))]
    r = CS.create_random_engine("sb-seed")
    keys = T.key_gen(r)
    got = T.sign_batch(keys.sk, msgs, r, device="cpu")
    rj = CSJ.RandomEngine("sb-seed")
    kj = PSJ.key_gen(rj)
    assert kj.sk == keys.sk
    assert got == [PSJ.sign(kj.sk, m, rj) for m in msgs]
    batch = json.loads(run_jax(JAX_SIGN, "sb-seed", json.dumps([m.hex() for m in msgs])))
    assert [s.hex() for s in got] == batch
    assert all(PSJ.verify(kj.pk, m, s) for m, s in zip(msgs, got))
    assert r.rand_bytes(16) == rj.rand_bytes(16)           # the same draws were used


def _verify_case(case):
    """tests/test_batch.py's PS batch cases: signatures from the JAX host
    ps.sign, and the verdicts (or the raise) known by construction."""
    r = CSJ.RandomEngine("batch-ps")
    keys = PSJ.key_gen(r)
    msgs = [bytes([i]) * 48 for i in range(3)]
    sigs = [PSJ.sign(keys.sk, m, r) for m in msgs]
    if case == "valid":
        return keys.pk, msgs, sigs, [True] * 3
    if case == "rotated":
        return keys.pk, msgs[1:] + msgs[:1], sigs, [False] * 3
    if case == "swapped_s2":
        return keys.pk, msgs, [sigs[0][:49] + sigs[1][49:]] + sigs[1:], [False, True, True]
    bad = sigs[0][:1] + bytes([sigs[0][1] ^ 1]) + sigs[0][2:]
    try:
        CODECJ.g1_parse(bad[:49])
        want = [False, True, True]
    except ValueError:
        want = ValueError
    return keys.pk, msgs, [bad] + sigs[1:], want


@pytest.mark.parametrize("case", ["valid", "rotated", "swapped_s2", "flipped_x"])
def test_verify_batch_cases(case):
    pk, msgs, sigs, want = _verify_case(case)
    if want is ValueError:
        with pytest.raises(ValueError, match="x not on curve"):
            T.verify_batch(pk, msgs, sigs, device="cpu")
    else:
        assert T.verify_batch(pk, msgs, sigs, device="cpu").tolist() == want


# ------------------------------------------- host PS and multi-message PS


def test_host_sign_and_verify_match_jax():
    """The host sign, randomnize and verify on ps_flow.json (its `verify`
    field through the host pairing), and on another stream sign equals the
    JAX host sign and verify the JAX host verify on valid and tampered
    signatures."""
    r = CS.create_random_engine("seed")
    keys = PS.key_gen(r)
    msg = b"\x00" * 47 + bytes([23])
    sig = PS.sign(keys.sk, msg, r)
    assert sig.hex() == VEC["signature"]
    rand_sig = PS.randomnize(sig, r)
    assert PS.verify(keys.pk, msg, rand_sig) is VEC["verify"] is True

    r, rj = CS.create_random_engine("host-ps"), CSJ.RandomEngine("host-ps")
    keys, kj = PS.key_gen(r), PSJ.key_gen(rj)
    msgs = [b"one", b"", b"three" * 30]
    sigs = [PS.sign(keys.sk, m, r) for m in msgs]
    assert sigs == [PSJ.sign(kj.sk, m, rj) for m in msgs]
    rows = [(msgs[0], sigs[0]), (msgs[1], sigs[1]), (msgs[2], sigs[0]),
            (msgs[2], sigs[2][:49] + sigs[1][49:])]
    want = [PSJ.verify(kj.pk, m, s) for m, s in rows]
    assert want == [True, True, False, False]
    assert [PS.verify(keys.pk, m, s) for m, s in rows] == want


def test_multi_message_matches_jax():
    """key_gen_n(3), sign_n on messages of 1 to 3 encode_to units and an
    empty one, equal to the JAX host functions on one stream; verify_n
    equals the JAX verify_n (both raise on the empty message: an empty
    product); verify_n_batch on valid, rotated and empty rows equals the
    JAX host verify_n, or for the empty row e(s1, X2) == e(s2, g2) on the
    JAX host elements; a message longer than the key raises."""
    from crypto12381_tpu.api import sets as SJ

    r, rj = CS.create_random_engine("ps-n"), CSJ.RandomEngine("ps-n")
    keys, kj = PS.key_gen_n(3, r), PSJ.key_gen_n(3, rj)
    assert (keys.x, keys.y, keys.g2, keys.X2, keys.Y2) == (kj.x, kj.y, kj.g2, kj.X2, kj.Y2)
    msgs = [b"a", b"b" * 40, b"c" * 93, b""]
    sigs = [PS.sign_n(keys, m, r) for m in msgs]
    assert sigs == [PSJ.sign_n(kj, m, rj) for m in msgs]
    rows = [(msgs[0], sigs[0]), (msgs[1], sigs[1]), (msgs[2], sigs[2]), (msgs[2], sigs[1])]
    want = [PSJ.verify_n(kj, m, s) for m, s in rows]
    assert want == [True, True, True, False]
    assert [PS.verify_n(keys, m, s) for m, s in rows] == want
    for mod, k in ((PS, keys), (PSJ, kj)):
        with pytest.raises(ValueError, match="empty product"):
            mod.verify_n(k, msgs[3], sigs[3])
    s1, s2 = SJ.parse(SJ.G1 ** 2, sigs[3])
    empty_ok = SJ.pair(s1, SJ.parse(SJ.G2, kj.X2)) == SJ.pair(s2, SJ.parse(SJ.G2, kj.g2))
    got = PS.verify_n_batch(keys, [m for m, _ in rows] + [msgs[3]],
                            [s for _, s in rows] + [sigs[3]], device="cpu")
    assert got.dtype == bool and got.tolist() == want + [empty_ok] and empty_ok
    with pytest.raises(ValueError, match="message is too long"):
        PS.verify_n_batch(keys, [b"z" * 94], sigs[:1], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="verify_n_batch runs on a CUDA card"):
            PS.verify_n_batch(keys, msgs[:1], sigs[:1])


# --------------------------------------------------- sequential aggregate As


@pytest.mark.parametrize("seed", ["seed", "as-other"])
def test_sequential_aggregate_matches_jax(seed):
    """tests/test_api_ps.py's As flow on one stream: setup, two key pairs,
    the first and the aggregate signature equal the JAX `ps.As`'s bytes;
    verify's verdicts (in order, swapped keys, another message) and sign's
    raises (an aggregate that does not verify, a repeated pk) equal the
    JAX package's."""
    out = []
    for mod, eng in ((PS, CS.create_random_engine), (PSJ, CSJ.RandomEngine)):
        r = eng(seed)
        a = mod.As.setup(r)
        k1, k2 = a.key_gen(r), a.key_gen(r)
        m = ["message1", "m2"]
        s1 = a.sign(k1, b"message1", [], [], b"", r)
        s2 = a.sign(k2, b"m2", [k1[1]], m[:1], s1, r)
        verdicts = (a.verify([k1[1], k2[1]], m, s2), a.verify([k2[1], k1[1]], m, s2),
                    a.verify([k1[1], k2[1]], ["message1", "m3"], s2), a.verify([k1[1]], m[:1], s1))
        raises = []
        for args in ((k2, b"m2", [k1[1]], ["other"], s1), (k1, b"x", [k1[1]], m[:1], s1)):
            with pytest.raises(ValueError) as info:
                a.sign(*args, r)
            raises.append(str(info.value))
        out.append((bytes(a.pp), tuple(map(bytes, k1 + k2)), bytes(s1), bytes(s2), verdicts,
                    raises))
    assert out[0] == out[1]
    assert out[0][4] == (True, False, False, True)
    assert out[0][5] == ["invalid signature", "repetitive pk"]


def test_symbolic_verify_n_matches_list_form():
    """verify_n (the symbolic product) gives the verdicts of the product
    over a plain list, on valid, rotated and tampered signatures."""
    from crypto12381_tpu_torch.api.sets import G1, G2, Zp, encode_to, pair, parse, product_

    r = CS.create_random_engine("ps-n-symbolic")
    keys = PS.key_gen_n(4, r)
    msgs = [b"a", b"b" * 40, b"c" * 124]
    sigs = [PS.sign_n(keys, m, r) for m in msgs]
    rows = [(msgs[0], sigs[0]), (msgs[2], sigs[2]), (msgs[1], sigs[2]),
            (msgs[1], sigs[1][:49] + sigs[0][49:])]

    def listed(m, s):
        u = encode_to(Zp, m)
        Y2 = [parse(G2, b) for b in keys.Y2]
        s1, s2 = parse(G1 ** 2, s)
        acc = product_([Y2[i] ** u[i] for i in range(len(u))])
        return pair(s1, parse(G2, keys.X2) * acc) == pair(s2, parse(G2, keys.g2))

    got = [PS.verify_n(keys, m, s) for m, s in rows]
    assert got == [listed(m, s) for m, s in rows] == [True, True, False, False]
