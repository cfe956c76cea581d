"""The hash to G1 on a batch of field elements: the simplified SWU map
with Z = 11 onto the 11-isogenous curve, the isogeny's rational maps, and
cofactor clearing.

Counterpart of the JAX package's `hashing/sswu.py`, with the reference's
choice of candidate and sign (MIRACL's ECP_map2point and ECP_cfp; the
exact host version is host/sswu.py), and no branch: every row computes
both candidates and selects.  The products are K1 launches, the
independent ones of a step stacked into one launch:
  * ONE power chain x^((p-3)/4) (`FP_CTX.invsqrt`) gives both 1/w3 and
    the square-root candidate s1 of w3, checked by squaring.  When w3 is
    not a square, s1^2 = -w3 (p = 3 mod 4 makes -1 a non-square), so
    s1 sqrt(-Z) is a root of Z w3; the reference's host map takes
    (Z w3)^((p+1)/4), which may differ in sign, and the parity correction
    of y (parity(y) = parity(u)) makes the two agree.
  * The isogeny's four polynomials run their Horner steps side by side,
    one launch per step over 4 B rows: each table padded at its high end
    with zero coefficients (the monic ones with their leading 1) to the 16
    coefficients of the y numerator.
  * Cofactor clearing is curves/g1.py `clear_cofactor`: [1 + |x|]P by a
    chain of K7 doublings and K6 adds.
"""

from __future__ import annotations

import torch

from ..curves import g1 as G1C
from ..fields import fp as FP
from ..iso11_data import XDEN, XNUM, YDEN, YNUM
from ..params import ISO11_A, ISO11_B, P, SSWU_Z

#: the isogeny's tables padded to 16 coefficients, highest degree first:
#: (16, 4) ints, the columns x numerator, x denominator, y numerator, y
#: denominator
_DEG = len(YNUM)
_TABLE = [[0] * (_DEG - len(c)) + list(c) for c in
          (XNUM, [1] + list(XDEN), YNUM, [1] + list(YDEN))]
_SQRT_NEG_Z = pow(-SSWU_Z % P, (P + 1) // 4, P)
assert _SQRT_NEG_Z * _SQRT_NEG_Z % P == -SSWU_Z % P

_CONSTS: dict = {}


def _consts(device) -> dict:
    """The Montgomery constants on a device."""
    key = str(device)
    if key not in _CONSTS:
        _CONSTS[key] = {
            "A": FP.from_int(ISO11_A, device),
            "negB": FP.from_int(-ISO11_B % P, device),
            "B": FP.from_int(ISO11_B, device),
            "sqrt_negz": FP.from_int(_SQRT_NEG_Z, device),
            "one_std": torch.from_numpy(FP.limbs_of(1)).to(device),
            "table": FP.from_int([[_TABLE[j][i] for j in range(4)] for i in range(_DEG)],
                                 device),
        }
    return _CONSTS[key]


def _mul(*pairs):
    """The products of (a, b) pairs of one shape (or broadcasting to it):
    one K1 launch."""
    ops = torch.broadcast_tensors(*[x for pair in pairs for x in pair])
    return FP.mont_mul(torch.stack(ops[0::2]), torch.stack(ops[1::2])).unbind(0)


def map2point(u: torch.Tensor):
    """The SSWU map of u (..., 12) Montgomery limbs: a projective point
    (X, Y, Z) of E(Fp) on every row, before cofactor clearing."""
    c = _consts(u.device)
    one = FP.one(u.shape[:-1], u.device)
    u2, u_std = _mul((u, u), (u, c["one_std"]))
    sgn = u_std[..., 0] & 1
    t = FP.mul_small(u2, SSWU_Z)
    w, u3 = _mul((FP.add(t, one), t), (u2, u))
    D, X2 = _mul((w, c["A"]), (FP.add(w, one), c["negB"]))      # X2 = -B'(w + 1)
    X3, X2sq, Dsq = _mul((t, X2), (X2, X2), (D, D))
    AD2, D3 = _mul((Dsq, c["A"]), (Dsq, D))
    gx1, BD3 = _mul((FP.add(X2sq, AD2), X2), (D3, c["B"]))
    gx1 = FP.add(gx1, BD3)                                       # g(x1) D^3
    (w3,) = _mul((gx1, D))
    w3_inv, s1 = FP.invsqrt(w3)
    s1sq, Dinv = _mul((s1, s1), (w3_inv, gx1))                  # Dinv = 1/D
    qr = FP.eq(s1sq, w3)
    x_qr, x_nqr, D2, s2 = _mul((X2, Dinv), (X3, Dinv), (Dinv, Dinv), (s1, c["sqrt_negz"]))
    y_qr, D2u3 = _mul((s1, D2), (D2, FP.mul_small(u3, SSWU_Z)))
    (y_nqr,) = _mul((s2, D2u3))
    X = torch.where(qr[..., None], x_qr, x_nqr)
    Y = torch.where(qr[..., None], y_qr, y_nqr)
    (y_std,) = _mul((Y, c["one_std"]))
    Y = torch.where(((y_std[..., 0] & 1) != sgn)[..., None], FP.neg(Y), Y)
    # the four isogeny polynomials, one Horner step per launch
    tab = c["table"]                                              # (16, 4, 12)
    Xs = X.unsqueeze(0).expand(4, *X.shape)
    acc = tab[0].reshape((4,) + (1,) * (X.dim() - 1) + (12,)).expand_as(Xs)
    for i in range(1, _DEG):
        coef = tab[i].reshape((4,) + (1,) * (X.dim() - 1) + (12,)).expand_as(Xs)
        acc = FP.add(FP.mont_mul(acc, Xs), coef)
    xnum, xden, ynum, yden = acc.unbind(0)
    Yxden, Xo, Zo = _mul((Y, xden), (xnum, yden), (xden, yden))
    (Yo,) = _mul((ynum, Yxden))
    return (Xo, Yo, Zo)


def hash_field_to_g1(u: torch.Tensor):
    """The hash to G1 of field elements u (..., 12) Montgomery limbs: the
    SSWU map, then cofactor clearing; projective points of G1.

    At u = 0 the map degenerates (D = 0): the reference's map gives a point
    (x0, 0) off the curve, and its cofactor ladder keeps it, since a
    doubling of a point with y = 0 is the point at infinity and 1 + |x| is
    odd.  No point of E(Fp) has y = 0 (its order is odd), so such a row is
    kept as the map gave it, as the reference does; the complete formulas
    of the ladder would give the identity there (reference fault F7 of the
    JAX package's device map)."""
    P = map2point(u)
    cleared = G1C.clear_cofactor(P)
    keep = (FP.is_zero(P[1]) & ~FP.is_zero(P[2]))[..., None]
    return tuple(torch.where(keep, a, b) for a, b in zip(P, cleared))
