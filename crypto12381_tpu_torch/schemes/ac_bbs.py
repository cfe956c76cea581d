"""Anonymous credentials with selective disclosure over BBS: key
generation, issuing, presentation and verification on the host, and
batched verification.

Counterpart of the JAX package's `schemes/ac_bbs.py` (the reference's
examples/AC-bbs): the same algorithms, CSPRNG draw order and byte formats.
A presentation discloses the attributes of the index set I; its fixed part
is A_ | B_ | U | s | t (G1^3 | Zp^2) and `u` holds one Zp response per
undisclosed attribute.

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
from .bbs import fixed_bases, parse_points, row, stacked_powers

__all__ = ["Keys", "PublicKey", "PresInfo", "keygen", "generate_attributes", "issue", "pres",
           "verify", "verify_batch"]


@dataclass
class PublicKey:
    fixed_part: bytes   # G1 | G2^2  (g, tilde_g, tilde_X)
    Y: list             # [G1 bytes]


@dataclass
class Keys:
    sk: bytes           # Zp (x)
    pk: PublicKey


@dataclass
class PresInfo:
    fixed_part: bytes   # G1^3 | Zp^2  (A_, B_, U, s, t)
    u: list             # [Zp bytes]


def keygen(n: int, random) -> Keys:
    g = select_in(~G1, random)
    tg = select_in(~G2, random)
    x = select_in(Zp, random)
    Y = select_in(~G1, random, n)
    return Keys(sk=serialize(x),
                pk=PublicKey(fixed_part=serialize(g, tg, tg ** x), Y=[serialize(y) for y in Y]))


def generate_attributes(pk: PublicKey, n: int, random) -> list[bytes]:
    return [serialize(a) for a in select_in(Zp, random, n)]


def issue(keys: Keys, attr: list[bytes], random) -> bytes:
    x = parse(Zp, keys.sk)
    g, _, _ = parse(G1, G2 ** 2, keys.pk.fixed_part)
    Y = [parse(G1, b) for b in keys.pk.Y]
    a = [parse(Zp, b) for b in attr]
    w = select_in(~Zp, random)
    A = (g * product_([Y[i] ** a[i] for i in range(len(a))])) ** inverse(x + w)
    return serialize(A, w)


def pres(m: bytes, attr: list[bytes], sig: bytes, I, pk: PublicKey, random) -> PresInfo:
    g, _, _ = parse(G1, G2 ** 2, pk.fixed_part)
    Y = [parse(G1, b) for b in pk.Y]
    a = [parse(Zp, b) for b in attr]
    A, w = parse(G1, Zp, sig)
    J = [i for i in range(len(a)) if i not in I]
    C_I = g * product_([Y[i] ** a[i] for i in I])
    C_J = product_([Y[j] ** a[j] for j in J])
    r = select_in(Zp, random)
    A_ = A ** r
    B_ = ((C_I * C_J) ** r) * (A_ ** (-w))
    alpha, beta = select_in(Zp ** 2, random)
    delta = select_in(Zp, random, len(J))
    U = (C_I ** alpha) * (A_ ** beta) * product_([Y[J[j]] ** delta[j] for j in range(len(J))])
    c = hash_(m, A_, B_, U).to(Zp)
    u = [delta[j] + r * c * a[J[j]] for j in range(len(J))]
    return PresInfo(fixed_part=serialize(A_, B_, U, alpha + r * c, beta + (-w) * c),
                    u=[serialize(x) for x in u])


def verify(m: bytes, attr: list[bytes], I, presinfo: PresInfo, pk: PublicKey) -> bool:
    g, tg, tX = parse(G1, G2 ** 2, pk.fixed_part)
    Y = [parse(G1, b) for b in pk.Y]
    a = [parse(Zp, b) for b in attr]
    A_, B_, U, s, t = parse(G1 ** 3, Zp ** 2, presinfo.fixed_part)
    u = [parse(Zp, b) for b in presinfo.u]
    J = [i for i in range(len(a)) if i not in I]
    c = hash_(m, A_, B_, U).to(Zp)
    cond1 = pair(A_, tX) == pair(B_, tg)
    lhs = U * (B_ ** c)
    rhs = ((g * product_([Y[i] ** a[i] for i in I])) ** s) * (A_ ** t) * product_(
        [Y[J[j]] ** u[j] for j in range(len(J))])
    return cond1 and lhs == rhs


def verify_batch(m: bytes, attr: list[bytes], I, presinfos, pk: PublicKey,
                 device=None) -> np.ndarray:
    """Verify B presentations under one (m, attr, I, pk): a (B,) bool
    array.  The challenge c = H(m || A_ || B_ || U) of each row is hashed on
    the host over the presentation's own bytes; e(A_, tX) == e(B_, tg) is a
    two-pair pair_prod_fixed, and U B_^c == C_I^s A_^t prod_j Y_j^u_j takes
    the powers B_^c, C_I^s, A_^t and one per undisclosed attribute in ONE
    stacked GLV call.  A point that does not parse or a scalar not below r
    raises ValueError."""
    dev = BT._device(device, "verify_batch runs")
    B = len(presinfos)
    if B == 0:
        return np.zeros(0, bool)
    g, tg, tX = parse(G1, G2 ** 2, pk.fixed_part)
    Y = [parse(G1, b) for b in pk.Y]
    a = [parse(Zp, b) for b in attr]
    J = [i for i in range(len(a)) if i not in I]
    CI = g * product_([Y[i] ** a[i] for i in I])
    fixed = [bytes(p.fixed_part) for p in presinfos]
    pts = parse_points(fixed, 3, dev)
    A_, B_, U = (row(pts, k) for k in range(3))
    mb = bytes(m)
    cs = [ZpNumber.from_hash(hashlib.sha3_512(mb + f[:147]).digest()).value for f in fixed]
    scal = BT.ZpVec.parse([f[147 + 48 * i:195 + 48 * i] for i in range(2) for f in fixed]
                          + [bytes(x) for j in range(len(J)) for x in
                             (p.u[j] for p in presinfos)], dev)
    exps = torch.cat([BT.ZpVec.from_ints(cs, dev).std, scal.std]).reshape(-1, B, BT.FR_LIMBS)
    pw = stacked_powers([B_] + fixed_bases([CI], dev) + [A_] + fixed_bases([Y[j] for j in J], dev),
                        BT.ZpVec(exps))
    rhs = BT.G1Vec(tuple(c[1:] for c in pw.p)).product(0)
    lhs = U * row(pw, 0)
    cond1 = BT.pair_prod_fixed((A_, BT.G2Vec.from_elements([tX], dev)),
                               (B_.inverse(), BT.G2Vec.from_elements([tg], dev))).is_one()
    return (cond1 & (lhs == rhs)).cpu().numpy()
