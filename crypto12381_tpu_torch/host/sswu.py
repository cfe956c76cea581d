"""The reference's hash to G1 on Python ints (host side), exact.

The simplified SWU map with Z = 11 onto the 11-isogenous curve
y^2 = x^3 + A'x + B', the isogeny's rational maps (iso11_data.py), and
cofactor clearing, with the reference's choice of candidate and sign
(MIRACL's ECP_map2point and ECP_cfp): the bytes of a hashed point are part
of the protocols' byte formats.  hashing/sswu.py is the batched version
on tensors.
"""

from __future__ import annotations

from ..iso11_data import XDEN, XNUM, YDEN, YNUM
from ..params import ISO11_A, ISO11_B, P, SSWU_Z
from . import curve as C
from . import field as F


def _horner(coeffs, x: int, monic: bool) -> int:
    """The polynomial of coeffs (highest degree first) at x; a monic one
    has a leading 1 that the table leaves out."""
    acc = (x + coeffs[0]) % P if monic else coeffs[0]
    for c in coeffs[1:]:
        acc = (acc * x + c) % P
    return acc


def map2point(u: int):
    """The SSWU map of u in Fp to an affine point of E(Fp), before cofactor
    clearing."""
    sgn = u & 1
    t = SSWU_Z * u * u % P
    w = (t + 1) * t % P                      # Z^2 u^4 + Z u^2
    D = ISO11_A * w % P
    X2 = (-ISO11_B) * (w + 1) % P            # -B'(w + 1)
    X3 = t * X2 % P
    gx1 = (X2 * X2 + ISO11_A * D * D) * X2 % P
    gx1 = (gx1 + ISO11_B * pow(D, 3, P)) % P  # g(x1) D^3
    w3 = gx1 * D % P
    Dinv = (pow(w3, -1, P) if w3 else 0) * gx1 % P
    D2 = Dinv * Dinv % P
    if F.fp_is_qr(w3):
        X = X2 * Dinv % P
        Y = F.fp_sqrt(w3) * D2 % P
    else:
        X = X3 * Dinv % P
        Y = F.fp_sqrt(w3 * SSWU_Z % P) * (D2 * SSWU_Z * pow(u, 3, P) % P) % P
    if (Y & 1) ^ sgn:
        Y = (-Y) % P
    xnum, xden = _horner(XNUM, X, False), _horner(XDEN, X, True)
    ynum, yden = _horner(YNUM, X, False) * Y % P, _horner(YDEN, X, True)
    zi = pow(xden * yden % P, -1, P)
    return (xnum * yden % P * zi % P, ynum * xden % P * zi % P)


def hash_to_g1(digest64: bytes):
    """A 64-byte digest, read big-endian and reduced mod p, mapped to E and
    its cofactor cleared: an affine point of G1."""
    return C.g1_clear_cofactor(map2point(int.from_bytes(digest64, "big") % P))
