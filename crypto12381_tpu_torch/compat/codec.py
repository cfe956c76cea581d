"""Byte codecs matching the reference's serialization bit for bit.

  Zp : 48-byte big-endian integer.
  G1 : 49 bytes = prefix 0x02 (y even) / 0x03 (y odd) + x as 48-byte
       big-endian; the point at infinity is 0x02 and 48 zero bytes.
  G2 : 97 bytes = prefix 0x02 / 0x03 (fp2_sign of y) + x.imag + x.real,
       each 48-byte big-endian; the point at infinity is 0x02 and 96 zero
       bytes.
  GT : 576 bytes = FP12_toOctet order c,b,a over the reference's Fp4 tower,
       i.e. w-basis Fp2 coefficients in the order C5,C2,C4,C1,C3,C0, each as
       imag|real 48-byte big-endian integers.

Host-side: plain ints and tuples in, bytes out (the batched G1 codec of
api/batch.py agrees with these).
"""

from __future__ import annotations

from ..host import field as F
from ..params import B_G1, B_G2, MODBYTES, P, R

#: Fp2 coefficient order C5,C2,C4,C1,C3,C0 (FP12_toOctet writes FP4 c, b, a;
#: each FP4 writes FP2 b, a; each FP2 writes Fp imag, real).
_GT_ORDER = (5, 2, 4, 1, 3, 0)


def int_to_bytes(v: int, width: int = MODBYTES) -> bytes:
    return int(v).to_bytes(width, "big")


def int_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "big")


# ------------------------------------------------------------------ Zp


def zp_serialize(v: int) -> bytes:
    return int_to_bytes(v)


def zp_parse(b: bytes, *, check: bool = True) -> int:
    v = int_from_bytes(b)
    if check and v >= R:
        raise ValueError("Parse to Zp number over range.")
    return v


# ------------------------------------------------------------------ G1


def g1_serialize(pt) -> bytes:
    """Affine (x, y) ints, or None for the point at infinity."""
    if pt is None:
        return bytes([0x02]) + int_to_bytes(0)
    x, y = pt
    return bytes([0x03 if y & 1 else 0x02]) + int_to_bytes(x)


def g1_parse(b: bytes):
    prefix = b[0]
    x = int_from_bytes(b[1:49])
    if prefix not in (0x02, 0x03):
        raise ValueError("bad G1 prefix")
    y = F.fp_sqrt(x * x * x + B_G1)
    if y is None:
        raise ValueError("x not on curve")
    if (y & 1) != (prefix & 1):
        y = (-y) % P
    return (x, y)


# ------------------------------------------------------------------ G2


def g2_serialize(pt) -> bytes:
    """Affine ((xr, xi), (yr, yi)) ints, or None for the point at infinity."""
    if pt is None:
        return bytes([0x02]) + int_to_bytes(0) * 2
    (xr, xi), y = pt
    return bytes([0x03 if F.fp2_sign(y) else 0x02]) + int_to_bytes(xi) + int_to_bytes(xr)


def g2_parse(b: bytes):
    """The y of the prefix's sign on the twist y^2 = x^3 + 4(1 + i);
    raises if x is not on it."""
    x = (int_from_bytes(b[49:97]), int_from_bytes(b[1:49]))
    y = F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2))
    if y is None:
        raise ValueError("x not on twist")
    if F.fp2_sign(y) != (b[0] & 1):
        y = F.fp2_neg(y)
    return (x, y)


# ------------------------------------------------------------------ GT


def gt_serialize(f) -> bytes:
    """Host Fp12 tuple (host/field.py layout) -> 576 bytes."""
    cs = F.fp12_coeffs_w(f)
    out = bytearray()
    for k in _GT_ORDER:
        real, imag = cs[k]
        out += int_to_bytes(imag)
        out += int_to_bytes(real)
    return bytes(out)


def gt_parse(b: bytes):
    """576 bytes -> host Fp12 tuple (host/field.py layout), the inverse of
    gt_serialize."""
    cs = [None] * 6
    for slot, k in enumerate(_GT_ORDER):
        off = slot * 2 * MODBYTES
        cs[k] = (int_from_bytes(b[off + MODBYTES:off + 2 * MODBYTES]),
                 int_from_bytes(b[off:off + MODBYTES]))
    return F.fp12_from_coeffs_w(tuple(cs))
