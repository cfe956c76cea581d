"""Pointcheval-Sanders signatures, single and multi-message: key
generation, signing and verification on the host, batched signing,
re-randomization and batched verification.

Counterpart of the JAX package's `schemes/ps.py` (the reference's
src/ps.cpp): the same algorithms, CSPRNG draw order and byte formats, so
a seeded flow gives the reference's bytes.  Keys and signatures are
`bytes` in the reference's layouts: sk = x | y (Zp^2), pk = g2 | X2 | Y2
(G2^3), a signature s1 | s2 (G1^2).  The multi-message keys (`KeysN`)
hold one y_i and Y2_i = g2^y_i per 31-byte unit of `encode_to`.  `As` is
the sequential aggregate scheme, on the host: each signer in turn checks
the aggregate so far and folds its own message in.

The batched entry points run their group work on the CUDA card by
default (and raise without one); `device="cpu"` runs the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..api import batch as BT
from ..api.algebra import algebraic, symbols, transform
from ..api.sets import (G1, G2, Zp, encode_to, hash_, pair, parse, product_, select_in,
                        serialize, sum_)
from ..parallel import sharding as SH
from .bbs import parse_points, row

__all__ = ["As", "Keys", "KeysN", "key_gen", "key_gen_n", "sign", "sign_batch", "sign_n",
           "verify", "verify_n", "verify_batch", "verify_n_batch", "randomnize"]


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


def sign(sk: bytes, message: bytes, random) -> bytes:
    """(h, h^(x + y m)) for m = H(message) mod r and a draw h, on the host."""
    x, y = parse(Zp ** 2, sk)
    m = hash_(message).to(Zp)
    h = select_in(~G1, random)
    return serialize(h, h ** (x + y * m))


def verify(pk: bytes, message: bytes, signature: bytes) -> bool:
    """e(s1, X2 Y2^m) == e(s2, g2), on the host."""
    g2, X2, Y2 = parse(G2 ** 3, pk)
    m = hash_(message).to(Zp)
    s1, s2 = parse(G1 ** 2, signature)
    return pair(s1, X2 * (Y2 ** m)) == pair(s2, g2)


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
    and s2; a point that does not parse raises ValueError.

    With `mesh` (parallel/sharding.py `default_mesh`) every rank passes
    the whole batch, verifies its shard on the mesh's device
    (`sharded_ps_verify`: the GS G2 ladder X2 Y2^m and a shared Miller
    loop per row, as the JAX package's sharded path does), and returns
    every verdict."""
    dev = mesh.device if mesh is not None else BT._device(device, "verify_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    g2e, X2e, Y2e = parse(G2 ** 3, pk)
    ms = BT.ZpVec.from_ints([hash_(_as_bytes(m)).to(Zp).value for m in messages], dev)
    s1 = BT.G1Vec.parse((bytes(s)[:49] for s in signatures), dev)
    s2 = BT.G1Vec.parse((bytes(s)[49:98] for s in signatures), dev)
    if mesh is not None:
        return SH.sharded_ps_verify(mesh, s1, s2, g2e, X2e, Y2e, ms.std).cpu().numpy()
    X2, Y2, g2 = (BT.G2Vec.from_affine([e.pt], dev) for e in (X2e, Y2e, g2e))
    ok = BT.pair_prod_fixed((s1, X2), (s1 ** ms, Y2), (s2.inverse(), g2)).is_one()
    return ok.cpu().numpy()


# -- multi-message -------------------------------------------------------------


@dataclass
class KeysN:
    x: bytes          # Zp
    y: list           # [Zp bytes]
    g2: bytes         # G2
    X2: bytes         # G2
    Y2: list          # [G2 bytes]


def key_gen_n(n: int, random) -> KeysN:
    """g2, x, then each y_i, in the reference's draw order."""
    g2 = select_in(~G2, random)
    x = select_in(~Zp, random)
    ys, Y2s = [], []
    for _ in range(n):
        y = select_in(~Zp, random)
        ys.append(serialize(y))
        Y2s.append(serialize(g2 ** y))
    return KeysN(x=serialize(x), y=ys, g2=serialize(g2), X2=serialize(g2 ** x), Y2=Y2s)


def sign_n(sk: KeysN, message: bytes, random) -> bytes:
    """(h, h^(x + sum_i y_i m_i)) over the encode_to units m_i of the
    message, on the host."""
    m = encode_to(Zp, message)
    if len(m) > len(sk.y):
        raise ValueError("message is too long")
    x = parse(Zp, sk.x)
    y = [parse(Zp, b) for b in sk.y]
    h = select_in(~G1, random)
    return serialize(h, h ** (x + sum_(y[i] * m[i] for i in range(len(m)))))


def verify_n(pk: KeysN, message: bytes, signature: bytes) -> bool:
    """e(s1, X2 prod_i Y2_i^m_i) == e(s2, g2), on the host, the product
    Pi[i.in[n]](Y2_i^m_i) in the reference's symbolic notation.  An empty
    message raises (an empty product), as in the JAX package."""
    m = encode_to(Zp, message)
    n = len(m)
    if n > len(pk.Y2):
        raise ValueError("message is too long")
    g2, X2 = parse(G2, pk.g2), parse(G2, pk.X2)
    Y2 = [parse(G2, b) for b in pk.Y2]
    s1, s2 = parse(G1 ** 2, signature)
    i_, = symbols("i_")
    return pair(s1, X2 * product_(algebraic(Y2)[i_] ** algebraic(m)[i_], i_.in_[n])) == pair(
        s2, g2)


def verify_n_batch(pk: KeysN, messages, signatures, device=None) -> np.ndarray:
    """Verify B multi-message signatures under one key: a (B,) bool array.
    The powers Y2_j^m_j of every unit j and row run as ONE GS ladder of
    n B rows (a short message's missing units with the exponent 0), their
    product over j is a tree of complete adds, and e(s1, X2 prod ...)
    e(s2^-1, g2) == 1 is one pair_prod.  A point that does not parse or a
    message longer than the key raises ValueError."""
    dev = BT._device(device, "verify_n_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    g2e, X2e = parse(G2, pk.g2), parse(G2, pk.X2)
    Y2e = [parse(G2, b) for b in pk.Y2]
    ms = [encode_to(Zp, _as_bytes(m)) for m in messages]
    n = max((len(m) for m in ms), default=0)
    if n > len(Y2e):
        raise ValueError("message is too long")
    B = len(ms)
    if B == 0:
        return np.zeros(0, bool)
    s12 = parse_points([bytes(s) for s in signatures], 2, dev)
    s1, s2 = row(s12, 0), row(s12, 1)
    acc = BT.G2Vec.from_elements([X2e], dev).broadcast_to((B,))
    if n:
        Y = BT.G2Vec.from_elements(Y2e[:n], dev)
        Y = BT.G2Vec(tuple(c[:, None].expand(n, B, *c.shape[1:]) for c in Y.p))
        e = BT.ZpVec.from_ints([m[j].value if j < len(m) else 0 for j in range(n) for m in ms],
                               dev)
        acc = acc * (Y ** BT.ZpVec(e.std.reshape(n, B, BT.FR_LIMBS))).product(0)
    g2 = BT.G2Vec.from_elements([g2e], dev).broadcast_to((B,))
    return BT.pair_prod((s1, acc), (s2.inverse(), g2)).is_one().cpu().numpy()


# -- sequential aggregate ------------------------------------------------------


class As:
    """Sequential aggregate PS over one public parameter set pp = g1 | X1
    | g2 | X2 (G1^2 | G2^2); a signer's keys are (y, g2^y)."""

    def __init__(self, pp: bytes):
        self.pp = pp

    @classmethod
    def setup(cls, random) -> "As":
        g1 = select_in(~G1, random)
        g2 = select_in(~G2, random)
        x = select_in(~Zp, random)
        return cls(pp=serialize(g1, g1 ** x, g2, g2 ** x))

    def key_gen(self, random):
        """(sk, pk) = (y, g2^y) for a draw y."""
        _, _, g2, _ = parse(G1 ** 2, G2 ** 2, self.pp)
        y = select_in(Zp, random)
        return serialize(y), serialize(g2 ** y)

    def sign_no_check(self, sk: bytes, message: bytes, signature: bytes, random) -> bytes:
        """(s1^t, (s2 s1^(y m))^t) for m = H(message) mod r and a draw t."""
        m = hash_(message).to(Zp)
        y = parse(Zp, sk)
        s1, s2 = parse(G1 ** 2, signature)
        t = select_in(Zp, random)
        return serialize(s1 ** t, (s2 * (s1 ** (y * m))) ** t)

    def sign(self, keys, message: bytes, pks, messages, signature: bytes, random) -> bytes:
        """The first signer starts from pp's (g1, X1); a later one checks
        the aggregate of pks on messages first and raises if it does not
        verify or if its own pk is among pks."""
        sk, pk = keys
        if len(pks) == 0:
            return self.sign_no_check(sk, message, self.pp[:98], random)
        if not self.verify(pks, messages, signature):
            raise ValueError("invalid signature")
        if any(p == pk for p in pks):
            raise ValueError("repetitive pk")
        return self.sign_no_check(sk, message, signature, random)

    def verify(self, pks, messages, signature: bytes) -> bool:
        """e(s1, X2 prod_i Y2_i^m_i) == e(s2, g2) with m_i = H(messages[i])
        mod r: the hashes through a transform range and the product in the
        reference's symbolic notation."""
        _, _, g2, X2 = parse(G1 ** 2, G2 ** 2, self.pp)
        Y2 = [parse(G2, b) for b in pks]
        m = transform(messages, lambda mm: hash_(_as_bytes(mm)).to(Zp))
        s1, s2 = parse(G1 ** 2, signature)
        i_, = symbols("i_")
        acc = product_(algebraic(Y2)[i_] ** m[i_], i_.in_[len(messages)])
        return pair(s1, X2 * acc) == pair(s2, g2)
