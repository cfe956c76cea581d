"""Pointcheval-Sanders signatures: key generation, batched signing,
re-randomization and batched verification.

Counterpart of the JAX package's `schemes/ps.py` (the reference's
src/ps.cpp): the same algorithms, CSPRNG draw order and byte formats, so
a seeded flow gives the reference's bytes.  Keys and signatures are
`bytes` in the reference's layouts: sk = x | y (Zp^2), pk = g2 | X2 | Y2
(G2^3), a signature s1 | s2 (G1^2).

The batched entry points run their group work on the CUDA card by
default (and raise without one); `device="cpu"` runs the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api import batch as BT
from ..api.sets import G1, G2, Zp, hash_, parse, select_in, serialize

__all__ = ["Keys", "key_gen", "sign_batch", "randomnize", "verify_batch"]


@dataclass
class Keys:
    sk: bytes  # Zp^2
    pk: bytes  # G2^3


def _as_bytes(m) -> bytes:
    return m.encode() if isinstance(m, str) else bytes(m)


def key_gen(random) -> Keys:
    """g2 a nonzero power of the generator, then x and y nonzero:
    sk = (x, y), pk = (g2, g2^x, g2^y)."""
    g2 = select_in(~G2, random)
    x, y = select_in(~Zp ** 2, random)
    return Keys(sk=serialize(x, y), pk=serialize(g2, g2 ** x, g2 ** y))


def sign_batch(sk: bytes, messages, random, device=None) -> list[bytes]:
    """B signatures, byte-identical to B single signs on the same CSPRNG
    stream: per message, on the host, m = H(message) mod r and ONE nonzero
    draw u, with h = g1^u; then s1 = g1^u and s2 = g1^(u (x + y m)) for
    the whole batch as one (2B,)-row GLV ladder and one batched affine
    serialize."""
    dev = BT._device(device, "sign_batch runs")
    x, y = parse(Zp ** 2, sk)
    e1, e2 = [], []
    for m in messages:
        mm = hash_(_as_bytes(m)).to(Zp)
        u = select_in(~G1, random).exp
        e1.append(u)
        e2.append(((x + y * mm) * u).value)
    B = len(e1)
    pts = BT.G1Vec.generator((2 * B,), dev) ** BT.ZpVec.from_ints(e1 + e2, dev)
    blobs = pts.serialize()
    return [blobs[i] + blobs[B + i] for i in range(B)]


def randomnize(signature: bytes, random) -> bytes:
    """(s1^t, s2^t) for a nonzero draw t, on the host."""
    s1, s2 = parse(G1 ** 2, signature)
    t = select_in(~Zp, random)
    return serialize(s1 ** t, s2 ** t)


def verify_batch(pk: bytes, messages, signatures, mesh=None, device=None) -> np.ndarray:
    """Verify B signatures under one public key: a (B,) bool array.

    e(s1, X2 Y2^m) == e(s2, g2) is rewritten by bilinearity so that every
    G2 operand is a fixed key point: e(s1, X2) e(s1^m, Y2) e(s2^-1, g2) == 1,
    three pairings with precomputed lines sharing one Miller loop
    (pair_prod_fixed), the scalar on a G1 GLV ladder.  The signatures'
    points are decompressed by one batched square-root chain each for s1
    and s2; a point that does not parse raises ValueError."""
    if mesh is not None:
        raise NotImplementedError("verify_batch over a mesh is not ported yet")
    dev = BT._device(device, "verify_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    g2e, X2e, Y2e = parse(G2 ** 3, pk)
    ms = BT.ZpVec.from_ints([hash_(_as_bytes(m)).to(Zp).value for m in messages], dev)
    s1 = BT.G1Vec.parse((bytes(s)[:49] for s in signatures), dev)
    s2 = BT.G1Vec.parse((bytes(s)[49:98] for s in signatures), dev)
    X2, Y2, g2 = (BT.G2Vec.from_affine([e.pt], dev) for e in (X2e, Y2e, g2e))
    ok = BT.pair_prod_fixed((s1, X2), (s1 ** ms, Y2), (s2.inverse(), g2)).is_one()
    return ok.cpu().numpy()
