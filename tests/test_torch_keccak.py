"""The port's device SHA3-512 sponge, byte packers and hash to Zp against
hashlib, the JAX package and the reference vectors.

Held exactly: `sha3_512_batch` against hashlib.sha3_512 on ragged rows
(the framing edges 0, 71, 72, 143, 144 among them) and against the JAX
package's `sha3_512_batch` on a few short rows; `frame_device` and
`sha3_512_blocks` against hashlib on rows with junk past their lengths
(including the one-byte 0x86 close at length 71); `assemble_rows` against
the concatenation; `hash_to_zp` against the JAX host `ZpNumber.from_hash`
and reference.json's hash of "abc"; `g1_bytes`, `zp_bytes` and `gt_bytes`
against the JAX host codec.  All on the CPU (`device="cpu"`).
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from crypto12381_tpu.api.elements import ZpNumber as ZpJ
from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.params import R
from crypto12381_tpu.pyref import curve as CJ
from crypto12381_tpu.pyref import field as FJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = json.loads((ROOT / "tests" / "vectors" / "reference.json").read_text())
EDGES = [0, 71, 72, 143, 144]

torch = KC = BT = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs."""
    global torch, KC, BT
    import torch
    from crypto12381_tpu_torch.api import batch as BT
    from crypto12381_tpu_torch.hashing import keccak as KC
    yield


def _rows(seed, lens):
    """Random rows of the given lengths, and their (B, max) zero-padded array."""
    rng = np.random.default_rng(seed)
    rows = [rng.bytes(n) for n in lens]
    data = np.zeros((len(lens), max(1, max(lens))), np.uint8)
    for i, r in enumerate(rows):
        data[i, :len(r)] = np.frombuffer(r, np.uint8)
    return rows, data


@pytest.mark.parametrize("lens", [EDGES, [1, 7, 288, 575, 576, 1100], [0]],
                         ids=["edges", "long", "empty"])
def test_sponge_matches_hashlib(lens):
    """sha3_512_batch on the host framing, and frame_device +
    sha3_512_blocks on the same rows with junk after each length, equal
    hashlib on every row."""
    rows, data = _rows(len(lens), lens)
    want = [hashlib.sha3_512(r).digest() for r in rows]
    got = KC.sha3_512_batch(data, lens, device="cpu")
    assert got.dtype == torch.uint8 and [bytes(r) for r in got.numpy()] == want
    junk = np.where(np.arange(data.shape[1])[None, :] < np.array(lens)[:, None], data, 0xA5)
    blocks, nrow = KC.frame_device(torch.from_numpy(junk.astype(np.uint8)), torch.tensor(lens))
    assert nrow.tolist() == [n // 72 + 1 for n in lens]
    assert [bytes(r) for r in KC.sha3_512_blocks(blocks, nrow).numpy()] == want


def test_framing_assembly_and_jax_sponge():
    """The framed bytes at the edges (0x06 at the length, 0x80 added at the
    final block's end: one 0x86 byte at length 71), assemble_rows against
    the concatenation, and the digests against the JAX sha3_512_batch."""
    from crypto12381_tpu.hashing import keccak as KJ

    rows, data = _rows(1, EDGES)
    blocks, nrow = KC.frame_device(torch.from_numpy(data), torch.tensor(EDGES))
    jb, jn = KJ.pad_blocks(data, np.array(EDGES), 72)
    flat = blocks.reshape(len(EDGES), -1).numpy()
    assert np.array_equal(flat[:, :jb.shape[1] * 72], jb.reshape(len(EDGES), -1))
    assert not flat[:, jb.shape[1] * 72:].any() and nrow.tolist() == jn.tolist()
    assert flat[1, 71] == 0x86 and flat[2, 72] == 0x06 and flat[2, 143] == 0x80
    pb, pn = KC.pad_blocks(data, EDGES)
    assert np.array_equal(pb, jb) and pn.tolist() == jn.tolist()

    suffix = np.random.default_rng(2).integers(0, 256, (len(EDGES), 30), dtype=np.uint8)
    joined, total = KC.assemble_rows(torch.from_numpy(data), torch.tensor(EDGES),
                                     torch.from_numpy(suffix))
    assert total.tolist() == [n + 30 for n in EDGES]
    assert all(bytes(joined[i, :total[i]].numpy()) == rows[i] + suffix[i].tobytes()
               for i in range(len(EDGES)))

    short = [0, 3, 71, 72, 100]
    srows, sdata = _rows(3, short)
    jax_d = np.asarray(KJ.sha3_512_batch(sdata, np.array(short)))
    assert np.array_equal(KC.sha3_512_batch(sdata, short, device="cpu").numpy(), jax_d)


def test_hash_to_zp_matches_jax_host():
    """hash_to_zp on digests of random rows and on the edge digests (all
    ones, zero, r's bytes twice) equals ZpNumber.from_hash, and on "abc"
    the reference's hash_zp_abc; zp_bytes gives the host codec's bytes."""
    rows, _ = _rows(4, list(range(0, 200, 9)))
    digests = [hashlib.sha3_512(r).digest() for r in rows]
    digests += [b"\xff" * 64, bytes(64), R.to_bytes(32, "big") * 2,
                hashlib.sha3_512(b"abc").digest()]
    t = torch.from_numpy(np.frombuffer(b"".join(digests), np.uint8).reshape(-1, 64).copy())
    z = BT.hash_to_zp(t)
    want = [ZpJ.from_hash(d).value for d in digests]
    assert list(z.to_ints()) == want
    assert want[-1] == int(REF["hash_zp_abc"], 16)
    assert [bytes(r) for r in BT.zp_bytes(z).numpy()] == [CODECJ.zp_serialize(v) for v in want]


def test_point_and_gt_packers_match_jax_codec():
    """g1_bytes on affine and projective vectors (the identity too) and
    gt_bytes on GT values (from GTVec.from_elements) equal the JAX host
    codec's bytes."""
    from crypto12381_tpu_torch.api.elements import GTElement
    from crypto12381_tpu_torch.host import pairing as HP

    ks = [1, 2, 12345, R - 1]
    pts = [CJ.g1_mul(CJ.G1_GEN, k) for k in ks] + [None]
    aff = BT.G1Vec.from_affine(pts, device="cpu")
    want = [CODECJ.g1_serialize(p) for p in pts]
    assert [bytes(r) for r in BT.g1_bytes(aff).numpy()] == want
    proj = BT.G1Vec.generator((4,), device="cpu") ** BT.ZpVec.from_ints(ks, device="cpu")
    assert [bytes(r) for r in BT.g1_bytes(proj).numpy()] == want[:4]
    e = HP.pairing(CJ.G1_GEN, CJ.G2_GEN)
    vals = [e, FJ.fp12_pow(e, 5), FJ.FP12_ONE]
    gt = BT.GTVec.from_elements([GTElement(v) for v in vals], device="cpu")
    assert torch.equal(gt.f, BT.GTVec.parse([CODECJ.gt_serialize(v) for v in vals],
                                            device="cpu").f)
    got = [bytes(r) for r in BT.gt_bytes(gt).numpy()]
    assert got == [CODECJ.gt_serialize(v) for v in vals]
    assert got[0].hex() == REF["gt_e_g1_g2"] and got[1].hex() == REF["gt_e_pow5"]
