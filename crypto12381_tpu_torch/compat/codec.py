"""GT byte codec matching the reference's serialization bit for bit.

GT : 576 bytes = FP12_toOctet order c,b,a over the reference's Fp4 tower,
     i.e. w-basis Fp2 coefficients in the order C5,C2,C4,C1,C3,C0, each as
     imag|real 48-byte big-endian integers.
"""

from __future__ import annotations

from ..host import field as F
from ..params import MODBYTES

#: Fp2 coefficient order C5,C2,C4,C1,C3,C0 (FP12_toOctet writes FP4 c, b, a;
#: each FP4 writes FP2 b, a; each FP2 writes Fp imag, real).
_GT_ORDER = (5, 2, 4, 1, 3, 0)


def int_to_bytes(v: int, width: int = MODBYTES) -> bytes:
    return int(v).to_bytes(width, "big")


def gt_serialize(f) -> bytes:
    """Host Fp12 tuple (host/field.py layout) -> 576 bytes."""
    cs = F.fp12_coeffs_w(f)
    out = bytearray()
    for k in _GT_ORDER:
        real, imag = cs[k]
        out += int_to_bytes(imag)
        out += int_to_bytes(real)
    return bytes(out)
