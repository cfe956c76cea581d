"""Exact G1/G2 scalar multiplication on Python ints (host side).

The host group law behind the port's own test points and the scalar API
(api/elements.py): affine tuples in, affine tuples out, None for the point
at infinity.
  G1: (x, y) with ints mod p,      y^2 = x^3 + 4
  G2: ((xr, xi), (yr, yi)) in Fp2, y^2 = x^3 + 4(1+i)

Sums, ladders and multi-scalar products run in Jacobian coordinates with
one final inversion.
"""

from __future__ import annotations

from ..params import B_G1, B_G2, G1_GEN_X, G1_GEN_Y, G2_GEN_X, G2_GEN_Y, H_EFF_G1, P, R
from . import field as F

G1_GEN = (G1_GEN_X, G1_GEN_Y)
G2_GEN = (G2_GEN_X, G2_GEN_Y)


class _Fp:
    """Base-field ops for the generic Jacobian ladder (ints mod p)."""

    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def sqr(a):
        return (a * a) % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def is_zero(a):
        return a % P == 0


class _Fp2:
    """Quadratic-extension ops (host/field.py tuples)."""

    one = F.FP2_ONE
    add = staticmethod(F.fp2_add)
    sub = staticmethod(F.fp2_sub)
    mul = staticmethod(F.fp2_mul)
    sqr = staticmethod(F.fp2_sqr)
    inv = staticmethod(F.fp2_inv)
    is_zero = staticmethod(F.fp2_is_zero)


# Jacobian (X, Y, Z): affine x = X/Z^2, y = Y/Z^3; None is infinity.


def _j_dbl(p, K):
    if p is None:
        return None
    X, Y, Z = p
    if K.is_zero(Y):
        return None
    A = K.sqr(X)
    B = K.sqr(Y)
    C = K.sqr(B)
    D = K.sub(K.sqr(K.add(X, B)), K.add(A, C))
    D = K.add(D, D)
    E = K.add(K.add(A, A), A)
    X3 = K.sub(K.sqr(E), K.add(D, D))
    C8 = K.add(C, C)
    C8 = K.add(C8, C8)
    C8 = K.add(C8, C8)
    Y3 = K.sub(K.mul(E, K.sub(D, X3)), C8)
    Z3 = K.mul(K.add(Y, Y), Z)
    return (X3, Y3, Z3)


def _j_add(p, q, K):
    """General Jacobian + Jacobian (handles equal / opposite inputs)."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = K.sqr(Z1)
    Z2Z2 = K.sqr(Z2)
    U1 = K.mul(X1, Z2Z2)
    U2 = K.mul(X2, Z1Z1)
    S1 = K.mul(K.mul(Y1, Z2), Z2Z2)
    S2 = K.mul(K.mul(Y2, Z1), Z1Z1)
    H = K.sub(U2, U1)
    Rr = K.sub(S2, S1)
    if K.is_zero(H):
        if K.is_zero(Rr):
            return _j_dbl(p, K)
        return None
    HH = K.sqr(H)
    HHH = K.mul(H, HH)
    V = K.mul(U1, HH)
    X3 = K.sub(K.sub(K.sqr(Rr), HHH), K.add(V, V))
    Y3 = K.sub(K.mul(Rr, K.sub(V, X3)), K.mul(S1, HHH))
    Z3 = K.mul(K.mul(Z1, Z2), H)
    return (X3, Y3, Z3)


def _j_to_affine(p, K):
    if p is None or K.is_zero(p[2]):
        return None
    X, Y, Z = p
    zi = K.inv(Z)
    zi2 = K.sqr(zi)
    return (K.mul(X, zi2), K.mul(K.mul(Y, zi2), zi))


def _j_mul(pt, k, K, width=4):
    """Windowed Jacobian scalar multiplication by a nonnegative int k."""
    if pt is None or k == 0:
        return None
    base = (pt[0], pt[1], K.one)
    table = [None] * (1 << width)
    table[1] = base
    for i in range(2, 1 << width):
        table[i] = _j_add(table[i - 1], base, K)
    nw = -(-k.bit_length() // width)
    acc = None
    for w in range(nw - 1, -1, -1):
        if acc is not None:
            for _ in range(width):
                acc = _j_dbl(acc, K)
        d = (k >> (w * width)) & ((1 << width) - 1)
        if d:
            acc = _j_add(acc, table[d], K)
    return acc


def g1_mul(pt, k):
    """[k]pt on G1, k reduced mod r."""
    return _j_to_affine(_j_mul(pt, k % R, _Fp), _Fp)


def g1_clear_cofactor(pt):
    """[1 + |x|]pt on E(Fp): the effective cofactor, not reduced mod r."""
    return _j_to_affine(_j_mul(pt, H_EFF_G1, _Fp), _Fp)


def g2_mul(pt, k):
    """[k]pt on G2, k reduced mod r."""
    return _j_to_affine(_j_mul(pt, k % R, _Fp2), _Fp2)


def _j_of(pt, K):
    return None if pt is None else (pt[0], pt[1], K.one)


def g1_neg(pt):
    """-pt on G1."""
    return None if pt is None else (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    """p1 + p2 on G1 (equal and opposite points included)."""
    return _j_to_affine(_j_add(_j_of(p1, _Fp), _j_of(p2, _Fp), _Fp), _Fp)


def g1_msm(points, scalars):
    """sum_i [k_i] points[i] on G1, each k_i reduced mod r: the Jacobian
    ladders summed in Jacobian coordinates, with one final inversion."""
    acc = None
    for pt, k in zip(points, scalars):
        acc = _j_add(acc, _j_mul(pt, k % R, _Fp), _Fp)
    return _j_to_affine(acc, _Fp)


def g2_add(p1, p2):
    """p1 + p2 on G2 (equal and opposite points included)."""
    return _j_to_affine(_j_add(_j_of(p1, _Fp2), _j_of(p2, _Fp2), _Fp2), _Fp2)


def g2_neg(pt):
    """-pt on G2."""
    return None if pt is None else (pt[0], F.fp2_neg(pt[1]))


def g1_in_subgroup(pt) -> bool:
    """On the curve and [r]pt = O (the identity included)."""
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_G1) % P == 0 and _j_mul(pt, R, _Fp) is None


def g2_in_subgroup(pt) -> bool:
    """On the twist and [r]pt = O (the identity included)."""
    if pt is None:
        return True
    x, y = pt
    rhs = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2)
    return F.fp2_sqr(y) == (rhs[0] % P, rhs[1] % P) and _j_mul(pt, R, _Fp2) is None
