"""The optimal-ate pairing on Python ints (host side).

The host edges of a protocol (key generation, signing, presentations and
single verifications, api/elements.py `pair`) pair single points here;
batches pair on the device (pairing/pairing.py).  The Miller function
untwists the G2 point into E(Fp12) and evaluates generic lines: its value
differs from the device loop's by factors that the final exponentiation
kills, so the reduced values agree.  `pairing` gives the reference's
normalization, the ate pairing cubed (MIRACL's loop runs over 3|x|).

About 0.05 s per Miller loop and 0.2 s per final exponentiation in
CPython.
"""

from __future__ import annotations

from ..params import X_ABS
from . import field as F


def _embed(c, pos: int):
    """An Fp2 value at w-basis position pos (0..5) of Fp12."""
    cs = [F.FP2_ZERO] * 6
    cs[pos] = c
    return F.fp12_from_coeffs_w(tuple(cs))


_THREE = _embed((3, 0), 0)
#: 1/v and 1/(v w): the untwist (x, y) -> (x / v, y / (v w)) (M-type twist, w^6 = xi)
_INV_V = F.fp12_inv(_embed(F.FP2_ONE, 2))
_INV_VW = F.fp12_inv(_embed(F.FP2_ONE, 3))


def _untwist(q):
    return (F.fp12_mul(_embed(q[0], 0), _INV_V), F.fp12_mul(_embed(q[1], 0), _INV_VW))


def _sub(x, y):
    return F.fp12_add(x, F.fp12_neg(y))


def _slope(t, q):
    """The slope of the line through t and q (the tangent when t == q), or
    None for a vertical line."""
    (xt, yt), (xq, yq) = t, q
    if xt == xq:
        if yt != yq:
            return None
        return F.fp12_mul(F.fp12_mul(F.fp12_sqr(xt), _THREE), F.fp12_inv(F.fp12_add(yt, yt)))
    return F.fp12_mul(_sub(yq, yt), F.fp12_inv(_sub(xq, xt)))


def _line(t, q, s):
    """The line through t and q (tangent if equal) evaluated at s."""
    lam = _slope(t, q)
    if lam is None:
        return _sub(s[0], t[0])
    return _sub(_sub(s[1], t[1]), F.fp12_mul(lam, _sub(s[0], t[0])))


def _add(t, q):
    """t + q on E(Fp12), affine; None is the point at infinity."""
    lam = _slope(t, q)
    if lam is None:
        return None
    x3 = _sub(_sub(F.fp12_sqr(lam), t[0]), q[0])
    return (x3, _sub(F.fp12_mul(lam, _sub(t[0], x3)), t[1]))


def miller_loop(p, q):
    """f_{|x|, Q}(P), conjugated for the negative x; p affine G1 ints, q
    affine G2 (Fp2 pairs)."""
    s = (_embed((p[0], 0), 0), _embed((p[1], 0), 0))
    qq = _untwist(q)
    f, t = F.FP12_ONE, qq
    for bit in bin(X_ABS)[3:]:
        f = F.fp12_mul(F.fp12_sqr(f), _line(t, t, s))
        t = _add(t, t)
        if bit == "1":
            f = F.fp12_mul(f, _line(t, qq, s))
            t = _add(t, qq)
    return F.fp12_conj(f)


def reduced(f):
    """The reference's reduced value of a Miller value (or a product of
    them): the final exponentiation, cubed."""
    e = F.fp12_final_exp(f)
    return F.fp12_mul(F.fp12_sqr(e), e)


def pairing(p, q):
    """e(P, Q) with the reference's normalization; 1 if either point is the
    identity (None)."""
    if p is None or q is None:
        return F.FP12_ONE
    return reduced(miller_loop(p, q))
