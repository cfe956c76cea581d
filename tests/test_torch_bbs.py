"""The port's BBS and BBS+ slice against the JAX package and the reference
vectors.

Each test runs for both schemes.  Held exactly (bytes) against the JAX
package on the same seeds: the flow vectors (tests/vectors/bbs_flow.json,
bbs_plus_flow.json) through the port's setup, key_gen, host sign and
`sign_batch` at B = 1; `sign_batch` at B = 3 against the JAX host `sign`
called 3 times on one CSPRNG stream, with ragged messages and with only
empty ones.  The JAX host `sign` raises on an empty message (its empty
product); for those rows the JAX side computes the same formula with the
JAX package's host elements, without the empty product.  `verify_batch`
gives the verdicts known by construction (valid rows, rotated messages, a
swapped x, a tampered A that parses), the JAX host `verify` agrees on
the valid rows, and the cases that raise raise.
"""

import json
import pathlib

import numpy as np
import pytest

from crypto12381_tpu.api import sets as SETJ
from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.params import R
from crypto12381_tpu.schemes import bbs as BBSJ
from crypto12381_tpu.schemes import bbs_plus as BBSPJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCHEMES = ["bbs", "bbs_plus"]

torch = S = PORT = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected."""
    global torch, S, PORT
    import torch
    from crypto12381_tpu_torch.api import sets as S
    from crypto12381_tpu_torch.schemes import bbs, bbs_plus
    PORT = {"bbs": bbs, "bbs_plus": bbs_plus}
    yield


JAX = {"bbs": BBSJ, "bbs_plus": BBSPJ}


def _message(scheme, raw: bytes):
    """A message in the scheme's form: BBS signs encoded blocks, BBS+ raw
    bytes."""
    return BBSJ.encode_message(raw) if scheme == "bbs" else raw


def _jax_sign(scheme, pp, sk, message, r):
    """The JAX host sign; for an empty message, the same draws and formula
    with the JAX package's host elements, the empty product left out."""
    if message:
        return JAX[scheme].sign(pp, sk, message, r)
    gamma = SETJ.parse(SETJ.Zp, sk)
    if scheme == "bbs":
        g1, _ = SETJ.parse(SETJ.G1, SETJ.G2, pp.g1_g2)
        x = SETJ.select_in(SETJ.Zp, r)
        return SETJ.serialize(g1 ** SETJ.inverse(gamma + x), x)
    g1, _, h0 = SETJ.parse(SETJ.G1, SETJ.G2, SETJ.G1, pp.g1_g2_h0)
    x, rr = SETJ.select_in(SETJ.Zp ** 2, r)
    return SETJ.serialize((g1 * h0 ** rr) ** SETJ.inverse(gamma + x), x, rr)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_flow_vector_and_no_card_default(scheme):
    """The flow vector byte for byte through the port's setup, key_gen and
    host sign, and sign_batch at B = 1 on the same stream; verify_batch
    accepts it.  Without a card the batched entry points raise."""
    vec = json.loads((ROOT / "tests" / "vectors" / f"{scheme}_flow.json").read_text())
    mod = PORT[scheme]
    r = S.create_random_engine("seed")
    pp = mod.setup(16, r)
    keys = mod.key_gen(pp, r)
    head = pp.g1_g2 if scheme == "bbs" else pp.g1_g2_h0
    assert head.hex() == vec["g1"] + vec["g2"] + vec.get("h0", "")
    assert [h.hex() for h in pp.h] == vec["h"]
    assert (keys.sk.hex(), keys.pk.hex()) == (vec["sk"], vec["pk"])
    raw = b"Hello, BBS!" if scheme == "bbs" else b"Hello, BBS+!"
    msg = mod.encode_message(raw) if scheme == "bbs" else raw
    if scheme == "bbs":
        assert [m.hex() for m in msg] == vec["message"]
    want = vec["signature_A"] + vec["signature_x"] + vec.get("signature_r", "")
    rb = S.create_random_engine("seed")
    mod.key_gen(mod.setup(16, rb), rb)
    assert mod.sign(pp, keys.sk, msg, r).hex() == want
    sig = mod.sign_batch(pp, keys.sk, [msg], rb, device="cpu")
    assert [s.hex() for s in sig] == [want]
    ok = mod.verify_batch(pp, keys.pk, [msg], sig, device="cpu")
    assert isinstance(ok, np.ndarray) and ok.dtype == bool and ok.tolist() == [vec["verify"]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sign_batch runs on a CUDA card.*device='cpu'"):
            mod.sign_batch(pp, keys.sk, [msg], rb)
        with pytest.raises(RuntimeError, match="verify_batch runs on a CUDA card.*device='cpu'"):
            mod.verify_batch(pp, keys.pk, [msg], sig)


@pytest.mark.parametrize("case", ["ragged", "empty"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sign_batch_matches_jax_host_sign(scheme, case):
    """B = 3 on one stream, n = 4 blocks at most (ragged lengths, one
    message empty) or n = 0 (only empty messages): the port's sign_batch
    equals three JAX host signs, consumes the same draws, and the port's
    host sign raises on an empty message as the JAX one does."""
    raws = ([b"alpha" * 20, b"", b"charlie-" + bytes(range(40))] if case == "ragged"
            else [b""] * 3)
    msgs = [_message(scheme, m) for m in raws]
    seed = f"sign-{scheme}-{case}"
    mod, jmod = PORT[scheme], JAX[scheme]
    r = S.create_random_engine(seed)
    pp = mod.setup(4, r)
    keys = mod.key_gen(pp, r)
    got = mod.sign_batch(pp, keys.sk, msgs, r, device="cpu")
    rj = SETJ.create_random_engine(seed)
    ppj = jmod.setup(4, rj)
    kj = jmod.key_gen(ppj, rj)
    assert (kj.sk, kj.pk) == (keys.sk, keys.pk)
    assert got == [_jax_sign(scheme, ppj, kj.sk, m, rj) for m in msgs]
    assert r.rand_bytes(16) == rj.rand_bytes(16)           # the same draws were used
    with pytest.raises(ValueError, match="empty product"):
        mod.sign(pp, keys.sk, msgs[1], r)
    with pytest.raises(ValueError, match="empty product"):
        jmod.sign(ppj, kj.sk, msgs[1], rj)


def _off_curve_x() -> bytes:
    """The least x from 1 up whose 49-byte encoding the JAX codec refuses."""
    x = 1
    while True:
        blob = b"\x02" + x.to_bytes(48, "big")
        try:
            CODECJ.g1_parse(blob)
        except ValueError:
            return blob
        x += 1


@pytest.mark.parametrize("scheme", SCHEMES)
def test_verify_batch_verdicts(scheme):
    """One batch of 6 signatures from the JAX host sign: two valid rows, two
    rows whose messages are swapped, a swapped x, and A replaced by -A
    (which parses); the JAX host verify agrees on the valid rows.  A that
    does not parse, an x not below r and a too-long message raise."""
    mod, jmod = PORT[scheme], JAX[scheme]
    rj = SETJ.create_random_engine(f"verify-{scheme}")
    pp = jmod.setup(4, rj)
    keys = jmod.key_gen(pp, rj)
    msgs = [_message(scheme, bytes([65 + i]) * (20 + 17 * i)) for i in range(6)]
    sigs = [jmod.sign(pp, keys.sk, m, rj) for m in msgs]
    vmsgs = msgs[:2] + [msgs[3], msgs[2]] + msgs[4:]
    vsigs = list(sigs)
    vsigs[4] = sigs[4][:49] + sigs[5][49:97] + sigs[4][97:]             # x of row 5
    vsigs[5] = bytes([sigs[5][0] ^ 1]) + sigs[5][1:]                    # -A
    ok = mod.verify_batch(pp, keys.pk, vmsgs, vsigs, device="cpu")
    assert ok.tolist() == [True, True, False, False, False, False]
    assert all(jmod.verify(pp, keys.pk, m, s) for m, s in zip(msgs[:2], sigs[:2]))

    with pytest.raises(ValueError, match="not on curve"):
        mod.verify_batch(pp, keys.pk, msgs[:2], [_off_curve_x() + sigs[0][49:], sigs[1]],
                         device="cpu")
    with pytest.raises(ValueError, match="over range"):
        mod.verify_batch(pp, keys.pk, msgs[:1], [sigs[0][:49] + R.to_bytes(48, "big")
                                                  + sigs[0][97:]], device="cpu")
    with pytest.raises(ValueError, match="message is too long"):
        mod.verify_batch(pp, keys.pk, [_message(scheme, b"z" * 31 * 5)], sigs[:1],
                         device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_verify_matches_flow_and_jax(scheme):
    """The port's host verify (the host pairing) gives the flow vector's
    `verify` on its signature, and equals the JAX host verify on the rows
    of a batch from the JAX host sign: valid, swapped messages, a swapped
    x, -A; a too-long message raises in both."""
    vec = json.loads((ROOT / "tests" / "vectors" / f"{scheme}_flow.json").read_text())
    mod, jmod = PORT[scheme], JAX[scheme]
    r = S.create_random_engine("seed")
    pp = mod.setup(16, r)
    keys = mod.key_gen(pp, r)
    msg = _message(scheme, b"Hello, BBS+!" if scheme == "bbs_plus" else b"Hello, BBS!")
    sig = mod.sign(pp, keys.sk, msg, r)
    assert mod.verify(pp, keys.pk, msg, sig) is vec["verify"] is True

    rj = SETJ.create_random_engine(f"host-verify-{scheme}")
    ppj = jmod.setup(4, rj)
    kj = jmod.key_gen(ppj, rj)
    msgs = [_message(scheme, bytes([70 + i]) * (9 + 40 * i)) for i in range(3)]
    sigs = [jmod.sign(ppj, kj.sk, m, rj) for m in msgs]
    rows = [(msgs[0], sigs[0]), (msgs[2], sigs[2]), (msgs[1], sigs[0]),
            (msgs[1], sigs[1][:49] + sigs[2][49:97] + sigs[1][97:]),
            (msgs[2], bytes([sigs[2][0] ^ 1]) + sigs[2][1:])]
    want = [jmod.verify(ppj, kj.pk, m, s) for m, s in rows]
    assert want == [True, True, False, False, False]
    assert [mod.verify(ppj, kj.pk, m, s) for m, s in rows] == want
    long = _message(scheme, b"z" * 31 * 5)
    with pytest.raises(ValueError, match="message is too long"):
        mod.verify(ppj, kj.pk, long, sigs[0])
