"""Exact BLS12-381 field arithmetic on Python ints (host side).

The integer operations the port needs outside its tensors: the Fp square
root of the G1 codec, the Fp2 arithmetic behind the G2 ladders of
host/curve.py and the Frobenius constants of fields/tower.py, the Fp2
square root and sign of the G2 codec, the w-basis view of Fp12 used by
the GT codec, and the Fp6/Fp12 tower of the host pairing
(host/pairing.py) and of GT elements (api/elements.py).

Representations:
  Fp   : int in [0, p)
  Fp2  : (real, imag)            a + b*i,  i^2 = -1
  Fp6  : (c0, c1, c2) of Fp2     c0 + c1*v + c2*v^2,  v^3 = xi = 1+i
  Fp12 : (a, b) of Fp6           a + b*w,  w^2 = v
"""

from __future__ import annotations

from ..params import P, R

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp_sqrt(a: int):
    """A square root of a mod p, or None if a is not a square
    (p = 3 mod 4: a^((p+1)/4))."""
    a %= P
    y = pow(a, (P + 1) // 4, P)
    return y if y * y % P == a else None


def fp_is_qr(a: int) -> bool:
    """a is a square mod p (0 included): Euler's criterion."""
    return a % P == 0 or pow(a, (P - 1) // 2, P) == 1


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


def fp2_mul_xi(x):
    """x (1 + i)."""
    a, b = x
    return ((a - b) % P, (a + b) % P)


def fp2_conj(x):
    return (x[0], (-x[1]) % P)


# --------------------------------------------------------------------- Fp6

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(x, y):
    return tuple(fp2_add(a, b) for a, b in zip(x, y))


def fp6_sub(x, y):
    return tuple(fp2_sub(a, b) for a, b in zip(x, y))


def fp6_neg(x):
    return tuple(fp2_neg(a) for a in x)


def fp6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0, t1, t2 = fp2_mul(a0, b0), fp2_mul(a1, b1), fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)),
                                        fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
                 fp2_mul_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(x):
    """x v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return (fp2_mul_xi(x[2]), x[0], x[1])


def fp6_inv(x):
    a0, a1, a2 = x
    t0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    t1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    t2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    d = fp2_add(fp2_mul(a0, t0), fp2_mul_xi(fp2_add(fp2_mul(a2, t1), fp2_mul(a1, t2))))
    di = fp2_inv(d)
    return (fp2_mul(t0, di), fp2_mul(t1, di), fp2_mul(t2, di))


# --------------------------------------------------------------------- Fp12

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(x, y):
    return (fp6_add(x[0], y[0]), fp6_add(x[1], y[1]))


def fp12_neg(x):
    return (fp6_neg(x[0]), fp6_neg(x[1]))


def fp12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0, t1 = fp6_mul(a0, b0), fp6_mul(a1, b1)
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (fp6_add(t0, fp6_mul_by_v(t1)), c1)


def fp12_sqr(x):
    """x^2 with two Fp6 products: (a + b w)^2 = a^2 + b^2 v + 2 a b w, the
    first part as (a + b)(a + b v) - a b - a b v."""
    a, b = x
    t = fp6_mul(a, b)
    c0 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a, b), fp6_add(a, fp6_mul_by_v(b))), t),
                 fp6_mul_by_v(t))
    return (c0, fp6_add(t, t))


def fp12_conj(x):
    """The p^6 Frobenius (a, b) -> (a, -b): the inverse of a unitary element."""
    return (x[0], fp6_neg(x[1]))


def fp12_inv(x):
    a0, a1 = x
    di = fp6_inv(fp6_sub(fp6_mul(a0, a0), fp6_mul_by_v(fp6_mul(a1, a1))))
    return (fp6_mul(a0, di), fp6_neg(fp6_mul(a1, di)))


def fp12_pow(x, e: int):
    """x^e by square-and-multiply from the top bit; a negative e inverts."""
    if e < 0:
        x, e = fp12_inv(x), -e
    acc = FP12_ONE
    for bit in bin(e)[2:] if e else ():
        acc = fp12_sqr(acc)
        if bit == "1":
            acc = fp12_mul(acc, x)
    return acc


def fp12_canon(x):
    """The element with every Fp coefficient reduced mod p."""
    return tuple(tuple((c[0] % P, c[1] % P) for c in h) for h in x)


def fp12_eq(x, y):
    return fp12_canon(x) == fp12_canon(y)


#: xi^((p - 1) / 6): x -> x^p maps the w-basis coefficient C_k to conj(C_k) gamma^k
FROB_GAMMA = fp2_pow((1, 1), (P - 1) // 6)


def fp12_frob(x):
    """x^p."""
    out, gk = [], FP2_ONE
    for k, c in enumerate(fp12_coeffs_w(x)):
        if k:
            gk = fp2_mul(gk, FROB_GAMMA)
        out.append(fp2_mul(fp2_conj(c), gk))
    return fp12_from_coeffs_w(tuple(out))


#: the hard part of the final exponentiation: (p^4 - p^2 + 1) / r
HARD_EXP = (P ** 4 - P ** 2 + 1) // R


def fp12_final_exp(f):
    """f^((p^12 - 1) / r): the easy part f^((p^6 - 1)(p^2 + 1)) by a
    conjugation, an inversion and two Frobenius maps, then the hard part as
    one power by HARD_EXP.  The same value as the single power by
    (p^12 - 1) / r, in about a third of its products."""
    f = fp12_mul(fp12_conj(f), fp12_inv(f))
    f = fp12_mul(fp12_frob(fp12_frob(f)), f)
    return fp12_pow(f, HARD_EXP)
