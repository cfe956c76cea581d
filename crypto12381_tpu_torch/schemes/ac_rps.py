"""Redactable PS anonymous credentials: key generation, issuing,
redaction, presentation and verification on the host, and batched
verification.

Counterpart of the JAX package's `schemes/ac_rps.py` (the reference's
examples/AC-rps): the same algorithms, CSPRNG draw order and byte formats;
a presentation A_ | B_ | D_ | tCJ_ | U | s (G1^3 | G2 | GT | Zp) carries
the GT element U = e(A, tY0^k).

As in the reference and the JAX package, `pres` and `verify` derive the q
challenges over different transcripts, and U uses the unrandomized A, so
`verify` returns False on the scheme's own presentations (reference fault
F6 in ROADMAP.md); `verify_batch` gives the same verdicts.

`verify_batch` runs on the CUDA card by default (and raises without one);
`device="cpu"` runs the plain versions.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..api import batch as BT
from ..api.elements import ZpNumber
from ..api.sets import (G1, G2, GT, Zp, hash_, inverse, pair, parse, product_, select_in,
                        serialize)
from .bbs import cat_rows, parse_points, row

__all__ = ["Keys", "PublicKey", "keygen", "generate_attributes", "issue", "redact", "pres",
           "verify", "verify_batch"]


@dataclass
class PublicKey:
    fixed_part: bytes   # G1 | G2^2
    Y: list             # [G1 bytes] of length 2n (slot n is zero bytes)
    tilde_Y: list       # [G2 bytes] of length n


@dataclass
class Keys:
    sk: bytes           # Zp^2 (x, y)
    pk: PublicKey


def keygen(n: int, random) -> Keys:
    g = select_in(~G1, random)
    tg = select_in(~G2, random)
    x, y = select_in(Zp ** 2, random)
    Y = [bytes(49)] * (2 * n)
    tY = [b""] * n
    yn = y
    for i in range(2 * n):
        if i < n:
            tY[i] = serialize(tg ** yn)
        if i != n:
            Y[i] = serialize(g ** yn)
        yn = yn * y
    return Keys(sk=serialize(x, y),
                pk=PublicKey(fixed_part=serialize(g, tg, tg ** x), Y=Y, tilde_Y=tY))


def generate_attributes(pk: PublicKey, n: int, random) -> list[bytes]:
    return [serialize(a) for a in select_in(Zp, random, n)]


def issue(keys: Keys, attr: list[bytes], random) -> bytes:
    """(s1, s1^(1/(x + sum_i a_i y^(i+1)))) for a draw s1."""
    x, y = parse(Zp ** 2, keys.sk)
    a = [parse(Zp, b) for b in attr]
    s1 = select_in(~G1, random)
    ym, yn = None, y
    for ai in a:
        ym = ai * yn if ym is None else ym + ai * yn
        yn = yn * y
    return serialize(s1, s1 ** inverse(x + ym))


def redact(attr: list[bytes], sig: bytes, I, pk: PublicKey) -> bytes:
    tY = [parse(G2, b) for b in pk.tilde_Y]
    a = [parse(Zp, b) for b in attr]
    J = [i for i in range(len(a)) if i not in I]
    return serialize(product_([tY[j] ** a[j] for j in J if j != 0]))


def pres(m: bytes, attr: list[bytes], sig: bytes, I, redact_cache: bytes, pk: PublicKey,
         random) -> bytes:
    a = [parse(Zp, b) for b in attr]
    n = len(a)
    A, B = parse(G1 ** 2, sig)
    J = [i for i in range(n) if i not in I]
    tCJ = parse(G2, redact_cache)
    _, tg, _ = parse(G1, G2 ** 2, pk.fixed_part)
    tY = [parse(G2, b) for b in pk.tilde_Y]
    k, r, t = select_in(Zp ** 3, random)
    A_ = A ** r
    B_ = (B ** r) * (A_ ** t)
    tCJ_ = (tg ** t) * tCJ
    q = [hash_(A_, B_, tCJ_, int(i).to_bytes(8, "little")).to(Zp) for i in range(n)]
    cache = {}

    def Y(kk):
        if kk not in cache:
            cache[kk] = parse(G1, pk.Y[kk])
        return cache[kk]

    terms = []
    for kk in range(2 * n):
        valid_i = [i for i in I if 0 <= (kk - n + i) < n and (kk - n + i) in J]
        has_t = 0 <= (n - 1 - kk) < n and (n - 1 - kk) in I
        if not valid_i and not has_t:
            continue
        acc = t if has_t else None
        for i in valid_i:
            term = q[i] * a[kk - n + i]
            acc = term if acc is None else acc + term
        terms.append(Y(kk) ** acc)
    D_ = product_(terms)
    U = pair(A, tY[0] ** k)
    c = hash_(m, A_, B_, tCJ_, D_, U).to(Zp)
    return serialize(A_, B_, D_, tCJ_, U, k + a[0] * c)


def _verify_constants(attr, I, pk: PublicKey):
    """(tg, tY0, tX prod_{i in I, i != 0} tY_i^a_i, prod_{i in I}
    Y[n-1-i]^q_i) on the host, with the verifier's q challenges."""
    _, tg, tX = parse(G1, G2 ** 2, pk.fixed_part)
    tY = [parse(G2, b) for b in pk.tilde_Y]
    a = [parse(Zp, b) for b in attr]
    n = len(a)
    base = serialize(*[a[j] for j in I])
    q = [hash_(base, int(i).to_bytes(8, "little")).to(Zp) for i in range(n)]
    Y = {i: parse(G1, pk.Y[n - 1 - i]) for i in I}
    prod_tY = None
    for i in I:
        if i != 0:
            term = tY[i] ** a[i]
            prod_tY = term if prod_tY is None else prod_tY * term
    tXc = tX if prod_tY is None else tX * prod_tY
    return tg, tY[0], tXc, product_([Y[i] ** q[i] for i in I])


def verify(m: bytes, attr: list[bytes], I, presinfo: bytes, pk: PublicKey) -> bool:
    """t1: e(A_, tY0^s) U^-1 == (e(A_^-1, tX tCJ_ prod tY_i^a_i) e(B_, tg))^c
    and t2: e(prod Y[n-1-i]^q_i, tCJ_) == e(D_, tg)."""
    tg, tY0, tXc, CYq = _verify_constants(attr, I, pk)
    A_, B_, D_, tCJ_, U, s = parse(G1 ** 3, G2, GT, Zp, presinfo)
    c = hash_(m, A_, B_, tCJ_, D_, U).to(Zp)
    t1 = pair(A_, tY0 ** s) * inverse(U) == (pair(inverse(A_), tXc * tCJ_) * pair(B_, tg)) ** c
    t2 = pair(CYq, tCJ_) == pair(D_, tg)
    return t1 and t2


def _gt_terms(m: bytes, attr: list[bytes], I, presinfos, pk: PublicKey, dev):
    """The device part of verify_batch: the four GT sides of t1 and t2 of
    every row, (e(A_, tY0^s) U^-1, (e(A_^-1, tX tCJ_ prod tY_i^a_i)
    e(B_, tg))^c, e(prod Y^q, tCJ_), e(D_, tg)), each a (B,) GTVec.  All
    four pairings are the rows of ONE two-pair pair_prod over 4 B rows (the
    single pairings with an identity second pair), tY0^s is one GS ladder
    and the power by c one GT ladder."""
    tg, tY0, tXc, CYq = _verify_constants(attr, I, pk)
    B = len(presinfos)
    blobs = [bytes(p) for p in presinfos]
    pts = parse_points(blobs, 3, dev)
    A_, B_, D_ = (row(pts, k) for k in range(3))
    tCJ_ = BT.G2Vec.parse((b[147:244] for b in blobs), dev)
    U = BT.GTVec.parse((b[244:820] for b in blobs), dev)
    s = BT.ZpVec.parse((b[820:868] for b in blobs), dev)
    mb = bytes(m)
    c = BT.ZpVec.from_ints([ZpNumber.from_hash(hashlib.sha3_512(
        mb + b[:98] + b[147:244] + b[98:147] + b[244:820]).digest()).value for b in blobs], dev)
    tgv, tY0v, tXcv = (BT.G2Vec.from_elements([e], dev).broadcast_to((B,))
                       for e in (tg, tY0, tXc))
    CYqv = BT.G1Vec.from_elements([CYq], dev).broadcast_to((B,))
    O1, O2 = BT.G1Vec.identity((3 * B,), dev), BT.G2Vec.identity((3 * B,), dev)
    e = BT.pair_prod((cat_rows(A_, CYqv, D_, A_.inverse()),
                      cat_rows(tY0v ** s, tCJ_, tgv, tXcv * tCJ_)),
                     (cat_rows(O1, B_), cat_rows(O2, tgv))).f
    return (BT.GTVec(e[:B]) * U.inverse(), BT.GTVec(e[3 * B:]) ** c, BT.GTVec(e[B:2 * B]),
            BT.GTVec(e[2 * B:3 * B]))


def verify_batch(m: bytes, attr: list[bytes], I, presinfos, pk: PublicKey,
                 device=None) -> np.ndarray:
    """Verify B presentations under one (m, attr, I, pk): a (B,) bool
    array, t1 and t2 of `verify` on every row from the GT terms of
    `_gt_terms`.  A point or GT element that does not parse or a scalar not
    below r raises ValueError."""
    dev = BT._device(device, "verify_batch runs")
    if not presinfos:
        return np.zeros(0, bool)
    l1, r1, l2, r2 = _gt_terms(m, attr, I, presinfos, pk, dev)
    return ((l1 == r1) & (l2 == r2)).cpu().numpy()
