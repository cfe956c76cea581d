"""Redactable BBS anonymous credentials: key generation, issuing,
redaction, presentation and verification on the host, and batched
verification.

Counterpart of the JAX package's `schemes/ac_rbbs.py` (the reference's
examples/AC-rbbs): the same algorithms, CSPRNG draw order and byte formats.
Two points stay bit-compatible with the reference:
  * the q challenges hash the disclosed attributes, then the index i as
    the reference's raw size_t (8 bytes, little-endian);
  * keygen's ladder Y[k] = g^(y^(k+1)) never writes Y[n], which stays 49
    zero bytes and is never used: Y entries are parsed only where they are
    used (0x00 is not a G1 prefix).

`verify_batch` runs on the CUDA card by default (and raises without one);
`device="cpu"` runs the plain versions.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..api import batch as BT
from ..api.elements import ZpNumber
from ..api.sets import G1, G2, Zp, hash_, inverse, pair, parse, product_, select_in, serialize
from .bbs import cat_rows, fixed_bases, parse_points, row, stacked_powers

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
    x, _ = parse(Zp ** 2, keys.sk)
    g, _, _ = parse(G1, G2 ** 2, keys.pk.fixed_part)
    a = [parse(Zp, b) for b in attr]
    w = select_in(~Zp, random)
    Yp = [parse(G1, keys.pk.Y[i]) for i in range(len(a))]
    A = (g * product_([Yp[i] ** a[i] for i in range(len(a))])) ** inverse(x + w)
    return serialize(A, w)


def _q_challenges(a, I, n):
    """q[i] = H(a[j] for j in I || i as 8 bytes little-endian) mod r."""
    base = serialize(*[a[j] for j in I])
    return [hash_(base, int(i).to_bytes(8, "little")).to(Zp) for i in range(n)]


def redact(attr: list[bytes], sig: bytes, I, pk: PublicKey) -> bytes:
    g, _, _ = parse(G1, G2 ** 2, pk.fixed_part)
    a = [parse(Zp, b) for b in attr]
    n = len(a)
    A, w = parse(G1, Zp, sig)
    J = [i for i in range(n) if i not in I]
    cache = {}

    def Y(k):
        if k not in cache:
            cache[k] = parse(G1, pk.Y[k])
        return cache[k]

    C_I = g * product_([Y(i) ** a[i] for i in I])
    B = C_I * (A ** (-w))
    C_J = product_([Y(j) ** a[j] for j in J])
    q = _q_challenges(a, I, n)
    terms = []
    for k in range(2 * n):
        valid_i = [i for i in I if 0 <= (k - n + i) < n and (k - n + i) in J]
        if valid_i:
            acc = None
            for i in valid_i:
                term = q[i] * a[k - n + i]
                acc = term if acc is None else acc + term
            terms.append(Y(k) ** acc)
    return serialize(C_I, C_J, B, product_(terms))


def pres(m: bytes, sig: bytes, redact_cache: bytes, random) -> bytes:
    A, w = parse(G1, Zp, sig)
    C_I, C_J, B, D = parse(G1 ** 4, redact_cache)
    r = select_in(Zp, random)
    A_, B_, C_J_, D_ = A ** r, B ** r, C_J ** r, D ** r
    alpha, beta = select_in(Zp ** 2, random)
    U = (C_I ** alpha) * (A_ ** beta)
    c = hash_(m, A_, B_, C_J_, D_, U).to(Zp)
    return serialize(A_, B_, C_J_, D_, U, alpha + r * c, beta + (-w) * c)


def _verify_constants(attr, I, pk: PublicKey):
    """(tg, tX, C_I, prod_{i in I} tY[n-1-i]^q_i) on the host."""
    g, tg, tX = parse(G1, G2 ** 2, pk.fixed_part)
    a = [parse(Zp, b) for b in attr]
    n = len(a)
    q = _q_challenges(a, I, n)
    Y = {i: parse(G1, pk.Y[i]) for i in I}
    tY = {i: parse(G2, pk.tilde_Y[n - 1 - i]) for i in I}
    C_I = g * product_([Y[i] ** a[i] for i in I])
    return tg, tX, C_I, product_([tY[i] ** q[i] for i in I])


def verify(m: bytes, attr: list[bytes], I, presinfo: bytes, pk: PublicKey) -> bool:
    tg, tX, C_I, acc = _verify_constants(attr, I, pk)
    A_, B_, C_J_, D_, U, s, t = parse(G1 ** 5, Zp ** 2, presinfo)
    c = hash_(m, A_, B_, C_J_, D_, U).to(Zp)
    cond1 = pair(A_, tX) == pair(C_J_ * B_, tg)
    cond2 = U * (B_ ** c) == (C_I ** s) * (A_ ** t)
    cond3 = pair(C_J_, acc) == pair(D_, tg)
    return cond1 and cond2 and cond3


def verify_batch(m: bytes, attr: list[bytes], I, presinfos, pk: PublicKey,
                 device=None) -> np.ndarray:
    """Verify B presentations under one (m, attr, I, pk): a (B,) bool
    array.  The challenge of each row is hashed on the host over the
    presentation's own bytes.  Both pairing conditions, e(A_, tX)
    e((C_J_ B_)^-1, tg) == 1 and e(C_J_, prod tY^q) e(D_^-1, tg) == 1, are
    the rows of ONE pair_prod_fixed over 2 B rows on the three fixed points
    tX, prod tY^q and tg (a condition's missing pair an identity row), and
    U B_^c == C_I^s A_^t takes its three powers in ONE stacked GLV call.
    A point that does not parse or a scalar not below r raises
    ValueError."""
    dev = BT._device(device, "verify_batch runs")
    B = len(presinfos)
    if B == 0:
        return np.zeros(0, bool)
    tg, tX, C_I, acc = _verify_constants(attr, I, pk)
    blobs = [bytes(p) for p in presinfos]
    pts = parse_points(blobs, 5, dev)
    A_, B_, C_J_, D_, U = (row(pts, k) for k in range(5))
    mb = bytes(m)
    cs = [ZpNumber.from_hash(hashlib.sha3_512(mb + b[:245]).digest()).value for b in blobs]
    st = BT.ZpVec.parse([b[245 + 48 * i:293 + 48 * i] for i in range(2) for b in blobs], dev)
    exps = torch.cat([BT.ZpVec.from_ints(cs, dev).std, st.std]).reshape(3, B, BT.FR_LIMBS)
    pw = stacked_powers([B_] + fixed_bases([C_I], dev) + [A_], BT.ZpVec(exps))
    lhs = U * row(pw, 0)
    rhs = row(pw, 1) * row(pw, 2)
    O = BT.G1Vec.identity((B,), dev)
    ok = BT.pair_prod_fixed((cat_rows(A_, O), BT.G2Vec.from_elements([tX], dev)),
                            (cat_rows(O, C_J_), BT.G2Vec.from_elements([acc], dev)),
                            (cat_rows((C_J_ * B_).inverse(), D_.inverse()),
                             BT.G2Vec.from_elements([tg], dev))).is_one()
    return (ok[:B] & (lhs == rhs) & ok[B:]).cpu().numpy()
