"""Host elements with the reference's paper notation, as far as the PS
scheme uses them.

Counterpart of the JAX package's `api/elements.py`: integers mod r and
host G1 and G2 points with the same multiplicative notation (`**` is
exponentiation), the same byte formats and the same draws from the
CSPRNG.  A protocol's bookkeeping runs here on exact host integers; its
bulk work runs batched on the device through api/batch.py.

`G1Pow` is the lazy power g^e of a base: it keeps the exponent, which is
what `schemes/ps.py` `sign_batch` reads to move every signature's powers
into one batched ladder.
"""

from __future__ import annotations

from ..compat import codec
from ..compat.csprng import RandomEngine
from ..host import curve as C
from ..params import R

__all__ = ["ZpNumber", "G1Element", "G1Pow", "G2Element"]


def _zp_int_or_none(v):
    """The int value of a scalar operand, or None for any other type (the
    operators then return NotImplemented)."""
    if isinstance(v, ZpNumber):
        return v.value
    if isinstance(v, int):
        return v % R
    return None


class ZpNumber:
    """A scalar mod r."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % R

    @classmethod
    def select(cls, rng: RandomEngine) -> "ZpNumber":
        return cls(rng.random_mod(R))

    @classmethod
    def select_nonzero(cls, rng: RandomEngine) -> "ZpNumber":
        return cls(rng.random_mod_nonzero(R))

    @classmethod
    def parse(cls, data: bytes) -> "ZpNumber":
        return cls(codec.zp_parse(bytes(data)))

    @classmethod
    def from_hash(cls, digest64: bytes) -> "ZpNumber":
        """A SHA3-512 digest as a big-endian integer, mod r."""
        return cls(int.from_bytes(digest64, "big") % R)

    def __add__(self, other):
        o = _zp_int_or_none(other)
        return NotImplemented if o is None else ZpNumber(self.value + o)

    def __mul__(self, other):
        o = _zp_int_or_none(other)
        return NotImplemented if o is None else ZpNumber(self.value * o)

    def __repr__(self):
        return f"Zp(0x{self.value:x})"

    def serialize(self) -> bytes:
        return codec.zp_serialize(self.value)


class G1Element:
    """A host G1 point: affine (x, y) ints, or None for the identity."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    @classmethod
    def parse(cls, data: bytes) -> "G1Element":
        return cls(codec.g1_parse(bytes(data)))

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else G1Pow(self, ei)

    def serialize(self) -> bytes:
        return codec.g1_serialize(self.pt)


class G1Pow:
    """The lazy power base^exp in G1: the exponent is kept, and the point
    is computed only when it is asked for."""

    __slots__ = ("base", "exp")

    def __init__(self, base: G1Element, exp: int):
        self.base = base
        self.exp = exp % R

    @classmethod
    def select_except1(cls, rng: RandomEngine) -> "G1Pow":
        """g1^u for a nonzero draw u."""
        return cls(G1Element(C.G1_GEN), rng.random_mod_nonzero(R))

    def point(self) -> G1Element:
        return G1Element(C.g1_mul(self.base.pt, self.exp))

    def serialize(self) -> bytes:
        return self.point().serialize()


class G2Element:
    """A host G2 point: affine ((xr, xi), (yr, yi)) ints, or None; powers
    are computed at once."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    @classmethod
    def parse(cls, data: bytes) -> "G2Element":
        return cls(codec.g2_parse(bytes(data)))

    @classmethod
    def select_except1(cls, rng: RandomEngine) -> "G2Element":
        """g2^u for a nonzero draw u."""
        return cls(C.g2_mul(C.G2_GEN, rng.random_mod_nonzero(R)))

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else G2Element(C.g2_mul(self.pt, ei))

    def serialize(self) -> bytes:
        return codec.g2_serialize(self.pt)
