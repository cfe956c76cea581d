"""The port's BBS04 group signatures against the JAX package and the
reference vector.

Held exactly (bytes and verdicts): tests/vectors/bbs04_flow.json through
the port's key_gen, sign, verify and open_signature; key_gen, sign (str,
empty and long messages) and open_signature against the JAX host
functions on one CSPRNG stream; every row of `verify_batch` (device
Fiat-Shamir) against the JAX host `verify`, on valid rows and on tampered
ones (a rotated message, a changed sx, a changed c); `open_batch` against
the JAX `open_signature`.  The JAX `verify_batch` is not run: its CPU
compile outlasts a test.  All on the CPU (`device="cpu"`).
"""

import json
import pathlib

import pytest

from crypto12381_tpu.compat.csprng import RandomEngine
from crypto12381_tpu.params import R
from crypto12381_tpu.schemes import bbs04 as BJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "bbs04_flow.json").read_text())

torch = B4 = S = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs."""
    global torch, B4, S
    import torch
    from crypto12381_tpu_torch.api import sets as S
    from crypto12381_tpu_torch.schemes import bbs04 as B4
    yield


def test_flow_vector_and_no_card_default():
    """bbs04_flow.json byte for byte; without a card the batched entry
    points raise."""
    r = S.create_random_engine("seed")
    keys = B4.key_gen(4, r)
    assert (keys.gpk.hex(), keys.gmsk.hex()) == (VEC["gpk"], VEC["gmsk"])
    assert [g.hex() for g in keys.gsk] == VEC["gsk"]
    msg = b"hello bbs\x00"
    sig = B4.sign(keys.gpk, keys.gsk[2], msg, r)
    assert sig.hex() == VEC["signature"]
    assert B4.verify(keys.gpk, msg, sig) is VEC["verify"] is True
    opened = B4.open_signature(keys.gmsk, sig)
    assert opened.hex() == VEC["opened"] and keys.gsk[VEC["opened_index"]][:49] == opened
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="verify_batch runs on a CUDA card"):
            B4.verify_batch(keys.gpk, [msg], [sig])
        with pytest.raises(RuntimeError, match="open_batch runs on a CUDA card"):
            B4.open_batch(keys.gmsk, [sig])


def _tamper(sig: bytes, field: int) -> bytes:
    """The signature with scalar `field` (0 = c, 3 = sx) plus 1 mod r."""
    off = 147 + 48 * field
    v = (int.from_bytes(sig[off:off + 48], "big") + 1) % R
    return sig[:off] + v.to_bytes(48, "big") + sig[off + 48:]


def test_host_functions_and_batches_match_jax():
    """key_gen(3), three signatures (a short, an empty and a 300-byte
    message) and their openings equal the JAX host functions' on one
    stream; verify_batch equals the JAX host verify on every row of a
    batch of valid and tampered rows (a message also given as str);
    open_batch equals open_signature."""
    r, rj = S.create_random_engine("torch-bbs04"), RandomEngine("torch-bbs04")
    keys, kj = B4.key_gen(3, r), BJ.key_gen(3, rj)
    assert (keys.gpk, keys.gmsk, keys.gsk) == (kj.gpk, kj.gmsk, kj.gsk)
    msgs = [b"a short message", b"", bytes(range(256)) + bytes(44)]
    sigs = [B4.sign(keys.gpk, keys.gsk[i], m, r) for i, m in enumerate(msgs)]
    assert sigs == [BJ.sign(kj.gpk, kj.gsk[i], m, rj) for i, m in enumerate(msgs)]
    opened = [B4.open_signature(keys.gmsk, s) for s in sigs]
    assert opened == [BJ.open_signature(kj.gmsk, s) for s in sigs]
    assert opened == [g[:49] for g in keys.gsk]

    rows_m = msgs + [msgs[1], msgs[0], msgs[2]]
    rows_s = sigs + [sigs[0], _tamper(sigs[1], 3), _tamper(sigs[2], 0)]
    want = [BJ.verify(kj.gpk, m, s) for m, s in zip(rows_m, rows_s)]
    assert want == [True, True, True, False, False, False]
    assert [B4.verify(keys.gpk, m, s) for m, s in zip(rows_m, rows_s)] == want
    got = B4.verify_batch(keys.gpk, ["a short message"] + rows_m[1:], rows_s, device="cpu")
    assert got.dtype == bool and got.tolist() == want
    assert B4.open_batch(keys.gmsk, rows_s[:3], device="cpu") == opened
    assert B4.verify_batch(keys.gpk, [], [], device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="differ in length"):
        B4.verify_batch(keys.gpk, rows_m[:2], rows_s, device="cpu")
