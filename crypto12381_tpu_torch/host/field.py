"""Exact BLS12-381 field arithmetic on Python ints (host side).

The few integer operations the port needs outside its tensors: the Fp
square root of the G1 codec, the Fp2 arithmetic behind the G2 ladders of
host/curve.py and the Frobenius constants of fields/tower.py, the Fp2
square root and sign of the G2 codec, and the w-basis view of Fp12 used
by the GT codec.

Representations:
  Fp   : int in [0, p)
  Fp2  : (real, imag)            a + b*i,  i^2 = -1
  Fp6  : (c0, c1, c2) of Fp2     c0 + c1*v + c2*v^2,  v^3 = xi = 1+i
  Fp12 : (a, b) of Fp6           a + b*w,  w^2 = v
"""

from __future__ import annotations

from ..params import P

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp_sqrt(a: int):
    """A square root of a mod p, or None if a is not a square
    (p = 3 mod 4: a^((p+1)/4))."""
    a %= P
    y = pow(a, (P + 1) // 4, P)
    return y if y * y % P == a else None


def fp2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def fp2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def fp2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def fp2_mul(x, y):
    a, b = x
    c, d = y
    return ((a * c - b * d) % P, (a * d + b * c) % P)


def fp2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def fp2_inv(x):
    a, b = x
    t = pow(a * a + b * b, -1, P)
    return (a * t % P, (-b * t) % P)


def fp2_is_zero(x):
    return x[0] % P == 0 and x[1] % P == 0


def fp2_sign(x):
    """MIRACL's FP2_sign: the parity of the real part, or of the imaginary
    part when the real part is 0."""
    return (x[1] if x[0] % P == 0 else x[0]) & 1


def fp2_sqrt(x):
    """The square root of x whose fp2_sign is 0 (MIRACL's FP2_sqrt with its
    sign fix), or None if x is not a square."""
    a, b = x[0] % P, x[1] % P
    if b == 0:
        r = fp_sqrt(a)
        if r is not None:
            cand = (r, 0)
        else:
            r = fp_sqrt(-a)                   # sqrt(a) = sqrt(-a) i
            if r is None:
                return None
            cand = (0, r)
    else:
        s = fp_sqrt(a * a + b * b)            # the norm's root
        if s is None:
            return None
        half = pow(2, -1, P)
        t = fp_sqrt((a + s) * half)
        if t is None:
            t = fp_sqrt((a - s) * half)
            if t is None:
                return None
        cand = (t, b * pow(2 * t, -1, P) % P)
    if fp2_sign(cand) == 1:
        cand = fp2_neg(cand)
    return cand if fp2_sqr(cand) == (a, b) else None


def fp2_pow(x, k: int):
    """x^k by square-and-multiply (k >= 0)."""
    r = FP2_ONE
    while k:
        if k & 1:
            r = fp2_mul(r, x)
        x = fp2_sqr(x)
        k >>= 1
    return r


def fp12_coeffs_w(x):
    """The 6 Fp2 coefficients (C0..C5) over the w-basis {w^k}:
    C0=a.c0, C1=b.c0, C2=a.c1, C3=b.c1, C4=a.c2, C5=b.c2 for x = a + b*w."""
    a, b = x
    return (a[0], b[0], a[1], b[1], a[2], b[2])


def fp12_from_coeffs_w(c):
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))
