"""The port's hash to G1 and the rest of its host API against the JAX
package and the reference vectors.

Held exactly: the port's SSWU map on tensors (hashing/sswu.py,
`map2point`) and its host map (host/sswu.py) against the JAX package's
exact host map (`pyref/sswu.py`) on tests/test_sswu.py's u values plus
u = 0, 1 and p - 1; `api.batch.hash_to_g1` and `G1Element.from_hash`
against the JAX `pyref` `hash_to_g1` on digests (those of
tests/test_devhash.py, and digests whose value mod p is 0, 1 and p - 1),
every point on the curve and in G1 by `in_subgroup` on tensors and on the
host but that of the digest 0 mod p, which is pyref's degenerate point
(x0, 0) off the curve (F7 in ROADMAP.md); SHA3-512("abc") against
tests/vectors/reference.json `hash_g1_abc`; the port's isogeny table against the reference's dump `pc`; and the C
twin of the CSPRNG (`NativeRandomEngine`) against `RandomEngine` and the
JAX package's engine, with the fallback when its library is absent.  The
JAX package's jitted SSWU is not run here (tests/test_sswu.py runs it).
All on the CPU.
"""

import hashlib
import json
import pathlib
import random

import numpy as np
import pytest

from crypto12381_tpu.api.elements import G1Element as G1J
from crypto12381_tpu.compat import csprng as CSJ
from crypto12381_tpu.params import P, R
from crypto12381_tpu.pyref import sswu as PSSWU

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "reference.json").read_text())
_rng = random.Random(42)
#: tests/test_sswu.py's u values, then the edges
US = [5, 7, 123456789, _rng.randrange(P), _rng.randrange(P), 1, 0, P - 1]
#: tests/test_devhash.py's digests, then three whose value mod p is 0, 1, p - 1
DIGESTS = ([hashlib.sha3_512(bytes([i, 7])).digest() for i in range(4)]
           + [(k * P + e).to_bytes(64, "big") for k, e in ((3, 0), (5, 1), (7, P - 1))])

torch = FP = G1C = BT = E = HS = SS = CS = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs."""
    global torch, FP, G1C, BT, E, HS, SS, CS
    import torch
    from crypto12381_tpu_torch.api import batch as BT
    from crypto12381_tpu_torch.api import elements as E
    from crypto12381_tpu_torch.compat import csprng as CS
    from crypto12381_tpu_torch.curves import g1 as G1C
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.hashing import sswu as HS
    from crypto12381_tpu_torch.host import sswu as SS
    yield


@pytest.mark.parametrize("route", ["tensor", "host"])
def test_map2point_matches_pyref(route):
    """The SSWU map, before cofactor clearing, on both QR branches and the
    edges 0, 1, p - 1."""
    want = [PSSWU.map2point(u) for u in US]
    if route == "tensor":
        got = list(G1C.to_affine_ints(HS.map2point(FP.from_int(US))))
    else:
        got = [SS.map2point(u) for u in US]
    assert got == want


def _digest_tensor(ds):
    return torch.from_numpy(np.stack([np.frombuffer(d, np.uint8) for d in ds]))


@pytest.mark.parametrize("route", ["batch", "host"])
def test_hash_to_g1_matches_pyref(route):
    """hash_to_g1 on tensors (points in G1 on the curve, by the tensor
    subgroup check) and G1Element.from_hash equal pyref's hash_to_g1, the
    JAX host element's from_hash and its in_subgroup."""
    want = [PSSWU.hash_to_g1(d) for d in DIGESTS]
    assert want == [G1J.from_hash(d).pt for d in DIGESTS]
    assert [int.from_bytes(d, "big") % P for d in DIGESTS[4:]] == [0, 1, P - 1]
    # the digest = 0 mod p: the reference's map keeps the degenerate point
    # (x0, 0), off the curve (F7); every other row is in G1
    member = [True] * 4 + [False, True, True]
    assert want[4] == PSSWU.map2point(0) and want[4][1] == 0
    if route == "batch":
        v = BT.hash_to_g1(_digest_tensor(DIGESTS))
        assert G1C.on_curve(v.p).tolist() == member
        assert G1C.in_subgroup(v.p).tolist() == member
        els = v.to_elements()
    else:
        els = [E.G1Element.from_hash(d) for d in DIGESTS]
    assert [e.pt for e in els] == want
    assert [e.in_subgroup() for e in els] == [G1J(e.pt).in_subgroup() for e in els] == member


def test_hash_g1_abc_and_table():
    """SHA3-512("abc") hashed to G1 by both routes gives reference.json's
    hash_g1_abc; the isogeny table equals the reference's dump; a point
    of E(Fp) outside G1 fails in_subgroup, as the JAX host element's."""
    from crypto12381_tpu_torch.api.sets import G1, hash_
    from crypto12381_tpu_torch.iso11_data import PC

    d = hashlib.sha3_512(b"abc").digest()
    assert E.G1Element.from_hash(d).serialize().hex() == VEC["hash_g1_abc"]
    assert hash_(b"abc").to(G1).serialize().hex() == VEC["hash_g1_abc"]
    assert BT.hash_to_g1(_digest_tensor([d])).serialize()[0].hex() == VEC["hash_g1_abc"]
    assert list(PC) == [int(h, 16) for h in VEC["pc"]]
    off = SS.map2point(5)                            # on E, not cleared: outside G1
    assert E.G1Element(off).in_subgroup() is G1J(off).in_subgroup() is False


@pytest.mark.parametrize("seed", ["seed", "another"])
def test_native_csprng_matches_python_and_jax(seed):
    """The C twin's bytes and draws mod r equal RandomEngine's and the JAX
    engine's (tests/test_vectors_pyref.py's check); without its library
    create_random_engine(..., native=True) falls back to RandomEngine."""
    nat = CS.create_random_engine(seed, native=True)
    assert isinstance(nat, CS.NativeRandomEngine)
    py, jx = CS.RandomEngine(seed), CSJ.RandomEngine(seed)
    assert nat.rand_bytes(256) == py.rand_bytes(256) == jx.rand_bytes(256)
    for _ in range(3):
        assert nat.random_mod(R) == py.random_mod(R) == jx.random_mod(R)
        assert nat.random_mod_nonzero(P) == py.random_mod_nonzero(P) == jx.random_mod_nonzero(P)
    saved = list(CS._NATIVE)
    try:
        CS._NATIVE[:] = [None]
        assert type(CS.create_random_engine(seed, native=True)) is CS.RandomEngine
        with pytest.raises(OSError):
            CS.NativeRandomEngine(seed)
    finally:
        CS._NATIVE[:] = saved
