"""Host elements with the reference's paper notation.

Counterpart of the JAX package's `api/elements.py`: integers mod r and
host G1 and G2 points with the same multiplicative notation (`**` is
exponentiation), the same byte formats and the same draws from the
CSPRNG.  A protocol's bookkeeping runs here on exact host integers; its
bulk work runs batched on the device through api/batch.py.

`G1Pow` is the lazy power g^e of a base: it keeps the exponent, which is
what `schemes/ps.py` `sign_batch` reads to move every signature's powers
into one batched ladder, and a product of powers is one host multi-scalar
product (`G1Element.product`).  `pair(P, Q)` is the lazy pairing
`GTPair`: a product of pairs keeps its pairs, and its value takes ONE
final exponentiation over the product of their Miller values
(host/pairing.py); `GTElement` is a value in GT.
"""

from __future__ import annotations

from ..compat import codec
from ..compat.csprng import RandomEngine
from ..host import curve as C
from ..host import field as F
from ..host import pairing as HP
from ..host import sswu as SS
from ..params import R

__all__ = ["ZpNumber", "G1Element", "G1Pow", "G2Element", "GTElement", "GTPair", "pair",
           "inverse"]


def _as_zp_int(v) -> int:
    o = _zp_int_or_none(v)
    if o is None:
        raise TypeError(f"cannot use {type(v)} as a Zp scalar")
    return o


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

    __radd__ = __add__

    def __sub__(self, other):
        o = _zp_int_or_none(other)
        return NotImplemented if o is None else ZpNumber(self.value - o)

    def __rsub__(self, other):
        o = _zp_int_or_none(other)
        return NotImplemented if o is None else ZpNumber(o - self.value)

    def __mul__(self, other):
        o = _zp_int_or_none(other)
        return NotImplemented if o is None else ZpNumber(self.value * o)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return ZpNumber(self.value * pow(_as_zp_int(other), -1, R))

    def __rtruediv__(self, other):
        return ZpNumber(_as_zp_int(other) * pow(self.value, -1, R))

    def __neg__(self):
        return ZpNumber(-self.value)

    def __pow__(self, e):
        return ZpNumber(pow(self.value, int(e), R))

    def inverse(self) -> "ZpNumber":
        return ZpNumber(pow(self.value, -1, R))

    def __eq__(self, other):
        return self.value == _as_zp_int(other)

    def __hash__(self):
        return hash(("Zp", self.value))

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
    def generator(cls) -> "G1Element":
        return cls(C.G1_GEN)

    @classmethod
    def identity(cls) -> "G1Element":
        return cls(None)

    @classmethod
    def parse(cls, data: bytes) -> "G1Element":
        return cls(codec.g1_parse(bytes(data)))

    @classmethod
    def from_hash(cls, digest64: bytes) -> "G1Element":
        """The reference's hash to G1 of a 64-byte digest: mod p, the SSWU
        map, cofactor clearing; exact, on the host (host/sswu.py).  The
        batched form is api/batch.py `hash_to_g1`."""
        return cls(SS.hash_to_g1(bytes(digest64)))

    def __mul__(self, other):
        if isinstance(other, (G1Element, G1Pow)):
            return G1Element(C.g1_add(self.pt, other.point().pt))
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, (G1Element, G1Pow)):
            return G1Element(C.g1_add(self.pt, C.g1_neg(other.point().pt)))
        return NotImplemented

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else G1Pow(self, ei)

    __xor__ = __pow__

    def __eq__(self, other):
        if isinstance(other, (G1Element, G1Pow)):
            return self.pt == other.point().pt
        return NotImplemented

    def __hash__(self):
        return hash(("G1", self.pt))

    def point(self) -> "G1Element":
        return self

    def in_subgroup(self) -> bool:
        """On the curve and of order r (the identity included)."""
        return C.g1_in_subgroup(self.pt)

    def inverse(self) -> "G1Element":
        return G1Element(C.g1_neg(self.pt))

    def serialize(self) -> bytes:
        return codec.g1_serialize(self.pt)

    @staticmethod
    def product(elems) -> "G1Element":
        """The product of G1 elements and powers: the powers as ONE host
        multi-scalar product, the elements added to it."""
        acc, pows = None, []
        for e in elems:
            if isinstance(e, G1Pow):
                pows.append(e)
            else:
                acc = C.g1_add(acc, e.point().pt)
        if pows:
            acc = C.g1_add(acc, C.g1_msm([p.base.pt for p in pows], [p.exp for p in pows]))
        return G1Element(acc)


class G1Pow:
    """The lazy power base^exp in G1: the exponent is kept, and the point
    is computed only when it is asked for."""

    __slots__ = ("base", "exp")

    def __init__(self, base: G1Element, exp: int):
        self.base = base
        self.exp = exp % R

    @classmethod
    def select(cls, rng: RandomEngine) -> "G1Pow":
        """g1^u for a draw u."""
        return cls(G1Element(C.G1_GEN), rng.random_mod(R))

    @classmethod
    def select_except1(cls, rng: RandomEngine) -> "G1Pow":
        """g1^u for a nonzero draw u."""
        return cls(G1Element(C.G1_GEN), rng.random_mod_nonzero(R))

    def point(self) -> G1Element:
        return G1Element(C.g1_mul(self.base.pt, self.exp))

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else G1Pow(self.base, self.exp * ei)

    __xor__ = __pow__

    def __mul__(self, other):
        if isinstance(other, G1Pow):
            return G1Element(C.g1_msm([self.base.pt, other.base.pt], [self.exp, other.exp]))
        if isinstance(other, G1Element):
            return self.point() * other
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, (G1Element, G1Pow)):
            return self.point() / other.point()
        return NotImplemented

    def __eq__(self, other):
        if isinstance(other, (G1Element, G1Pow)):
            return self.point().pt == other.point().pt
        return NotImplemented

    def __hash__(self):
        return hash(("G1Pow", self.base.pt, self.exp))

    def inverse(self) -> "G1Pow":
        return G1Pow(self.base, -self.exp)

    def serialize(self) -> bytes:
        return self.point().serialize()


class G2Element:
    """A host G2 point: affine ((xr, xi), (yr, yi)) ints, or None; powers
    are computed at once."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    @classmethod
    def generator(cls) -> "G2Element":
        return cls(C.G2_GEN)

    @classmethod
    def identity(cls) -> "G2Element":
        return cls(None)

    @classmethod
    def parse(cls, data: bytes) -> "G2Element":
        return cls(codec.g2_parse(bytes(data)))

    @classmethod
    def select(cls, rng: RandomEngine) -> "G2Element":
        """g2^u for a draw u."""
        return cls(C.g2_mul(C.G2_GEN, rng.random_mod(R)))

    @classmethod
    def select_except1(cls, rng: RandomEngine) -> "G2Element":
        """g2^u for a nonzero draw u."""
        return cls(C.g2_mul(C.G2_GEN, rng.random_mod_nonzero(R)))

    def __mul__(self, other):
        if isinstance(other, G2Element):
            return G2Element(C.g2_add(self.pt, other.pt))
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, G2Element):
            return G2Element(C.g2_add(self.pt, C.g2_neg(other.pt)))
        return NotImplemented

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else G2Element(C.g2_mul(self.pt, ei))

    __xor__ = __pow__

    def __eq__(self, other):
        if isinstance(other, G2Element):
            return self.pt == other.pt
        return NotImplemented

    def __hash__(self):
        return hash(("G2", self.pt))

    def point(self) -> "G2Element":
        return self

    def in_subgroup(self) -> bool:
        """On the twist and of order r."""
        return C.g2_in_subgroup(self.pt)

    def inverse(self) -> "G2Element":
        return G2Element(C.g2_neg(self.pt))

    def serialize(self) -> bytes:
        return codec.g2_serialize(self.pt)

    @staticmethod
    def product(elems) -> "G2Element":
        acc = None
        for e in elems:
            acc = C.g2_add(acc, e.pt)
        return G2Element(acc)


class GTElement:
    """A value in GT: a host Fp12 tuple (host/field.py layout)."""

    __slots__ = ("val",)

    def __init__(self, val):
        self.val = val

    @classmethod
    def parse(cls, data: bytes) -> "GTElement":
        return cls(codec.gt_parse(bytes(data)))

    @classmethod
    def one(cls) -> "GTElement":
        return cls(F.FP12_ONE)

    def __mul__(self, other):
        if isinstance(other, (GTElement, GTPair)):
            return GTElement(F.fp12_mul(self.val, other.value().val))
        return NotImplemented

    def __truediv__(self, other):
        return GTElement(F.fp12_mul(self.val, F.fp12_inv(other.value().val)))

    def __pow__(self, e):
        ei = _zp_int_or_none(e)
        return NotImplemented if ei is None else GTElement(F.fp12_pow(self.val, ei))

    __xor__ = __pow__

    def __eq__(self, other):
        if isinstance(other, (GTElement, GTPair)):
            return F.fp12_eq(self.val, other.value().val)
        return NotImplemented

    def __hash__(self):
        return hash(("GT", F.fp12_canon(self.val)))

    def value(self) -> "GTElement":
        return self

    def in_subgroup(self) -> bool:
        """x^r = 1."""
        return F.fp12_eq(F.fp12_pow(self.val, R), F.FP12_ONE)

    def inverse(self) -> "GTElement":
        return GTElement(F.fp12_inv(self.val))

    def serialize(self) -> bytes:
        return codec.gt_serialize(self.val)


class GTPair:
    """The lazy pairing product prod e(P_i, Q_i): products of pairs keep
    their pairs, and the value takes one final exponentiation over the
    product of the Miller values (pairs with an identity point give 1)."""

    __slots__ = ("pairs",)

    def __init__(self, pairs):
        self.pairs = list(pairs)   # [(G1 affine, G2 affine), ...]

    def value(self) -> GTElement:
        acc = None
        for p1, p2 in self.pairs:
            if p1 is not None and p2 is not None:
                f = HP.miller_loop(p1, p2)
                acc = f if acc is None else F.fp12_mul(acc, f)
        return GTElement.one() if acc is None else GTElement(HP.reduced(acc))

    def __mul__(self, other):
        if isinstance(other, GTPair):
            return GTPair(self.pairs + other.pairs)
        if isinstance(other, GTElement):
            return self.value() * other
        return NotImplemented

    def __truediv__(self, other):
        return self.value() / other

    def __pow__(self, e):
        return self.value() ** e

    __xor__ = __pow__

    def __eq__(self, other):
        return self.value() == other

    def serialize(self) -> bytes:
        return self.value().serialize()


def pair(p1, p2) -> GTPair:
    """The lazy pairing e(p1, p2) of a G1 and a G2 element."""
    return GTPair([(p1.point().pt, p2.point().pt)])


def inverse(x):
    """The reference's free-function inverse."""
    return x.inverse()
