"""The reference's set notation for a protocol's host edges, as far as
the ported schemes use it.

Counterpart of the JAX package's `api/sets.py`: the group tags `Zp`,
`G1`, `G2` and `GT`, where `~S` excludes the identity and `S ** n` is a
cartesian power; `select_in` draws elements from the CSPRNG in the
reference's order; `parse` and `serialize` read and write their
concatenated bytes; `hash_(...)` is an incremental SHA3-512 whose
`.to(Zp)` is the digest mod r; `pair` and `inverse` are the element
functions; `encode_to`, `make_Zp`, `polynomial`, `sum_` and `product_`
(over a plain list; the symbolic forms wait for a port of the JAX
package's `api/algebra.py`) are the reference's scalar helpers.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..compat.csprng import RandomEngine, create_random_engine
from ..params import GT_BYTES, MODBYTES, R
from .elements import G1Element, G1Pow, G2Element, GTElement, ZpNumber, inverse, pair

__all__ = ["Zp", "G1", "G2", "GT", "Set", "CartesianPower", "select_in", "parse",
           "serialize", "hash_", "HashState", "create_random_engine", "encode_to",
           "make_Zp", "polynomial", "sum_", "product_", "inverse", "pair"]


@dataclass(frozen=True)
class Set:
    """A group tag: `~S` excludes the identity, `S ** n` is the cartesian
    power."""

    name: str
    serialized_size: int
    star: bool = False

    def __invert__(self) -> "Set":
        return Set(self.name, self.serialized_size, star=True)

    def __pow__(self, n: int) -> "CartesianPower":
        return CartesianPower(self, n)

    def __repr__(self):
        return ("*" if self.star else "") + self.name


@dataclass(frozen=True)
class CartesianPower:
    base: Set
    exponent: int

    def __invert__(self) -> "CartesianPower":
        # ~Zp ** 2 parses as ~(Zp ** 2): star the base set
        return CartesianPower(~self.base, self.exponent)


Zp = Set("Zp", MODBYTES)
G1 = Set("G1", 1 + MODBYTES)
G2 = Set("G2", 1 + 2 * MODBYTES)
GT = Set("GT", GT_BYTES)

_PARSERS = {"Zp": ZpNumber.parse, "G1": G1Element.parse, "G2": G2Element.parse,
            "GT": GTElement.parse}


def _select_one(s: Set, rng: RandomEngine):
    if s.name == "Zp":
        return ZpNumber.select_nonzero(rng) if s.star else ZpNumber.select(rng)
    if s.star and s.name == "G1":
        return G1Pow.select_except1(rng)
    if s.star and s.name == "G2":
        return G2Element.select_except1(rng)
    raise ValueError(f"cannot select in {s}")


def select_in(s, rng: RandomEngine, n: int | None = None):
    """One random element of a set, a tuple of them for a cartesian power,
    or a list of n of them, drawn in order."""
    if isinstance(s, CartesianPower):
        return tuple(_select_one(s.base, rng) for _ in range(s.exponent))
    if n is not None:
        return [_select_one(s, rng) for _ in range(n)]
    return _select_one(s, rng)


def parse(*args):
    """parse(SetA, SetB, ..., data): the elements in order, one element for
    a single set; raises if data has the wrong length or an element does
    not parse."""
    *sets, data = args
    flat = []
    for s in sets:
        flat.extend([s.base] * s.exponent if isinstance(s, CartesianPower) else [s])
    data = bytes(data)
    total = sum(s.serialized_size for s in flat)
    if len(data) != total:
        raise ValueError(f"parse: need {total} bytes, got {len(data)}")
    out, off = [], 0
    for s in flat:
        out.append(_PARSERS[s.name](data[off:off + s.serialized_size]))
        off += s.serialized_size
    return out[0] if len(out) == 1 else tuple(out)


def serialize(*elems) -> bytes:
    """The elements' bytes, concatenated (lists and tuples flattened)."""
    out = bytearray()
    for e in elems:
        out += serialize(*e) if isinstance(e, (list, tuple)) else e.serialize()
    return bytes(out)


class HashState:
    """SHA3-512 over raw bytes and the serialized bytes of elements."""

    def __init__(self, *args):
        self._h = hashlib.sha3_512()
        for a in args:
            self.update(a)

    def update(self, a) -> "HashState":
        if isinstance(a, (bytes, bytearray, memoryview)):
            self._h.update(bytes(a))
        elif hasattr(a, "serialize"):
            self._h.update(a.serialize())
        elif isinstance(a, (list, tuple)):
            for e in a:
                self.update(e)
        else:
            raise TypeError(f"cannot hash {type(a)}")
        return self

    def digest(self) -> bytes:
        return self._h.digest()

    def to(self, s: Set):
        if s.name == "Zp":
            return ZpNumber.from_hash(self.digest())
        raise ValueError(f"hash .to({s}) is not ported")


def hash_(*args) -> HashState:
    return HashState(*args)


def sum_(items):
    """The sum of a list of Zp values; 0 for an empty list."""
    acc = None
    for it in items:
        acc = it if acc is None else acc + it
    return ZpNumber(0) if acc is None else acc


def product_(items):
    """The product of a non-empty list: G1 elements and powers as one host
    multi-scalar product (`G1Element.product`), G2 elements by the group
    law, pairings as one lazy `GTPair` (one final exponentiation), anything
    else left to right.  Raises on an empty list, as the JAX package does."""
    items = list(items)
    if not items:
        raise ValueError("empty product")
    if isinstance(items[0], (G1Element, G1Pow)):
        return G1Element.product(items)
    if isinstance(items[0], G2Element):
        return G2Element.product(items)
    acc = items[0]
    for it in items[1:]:
        acc = acc * it
    return acc


#: encode_to's unit: 31 bytes, below r, with a marker bit just above them
_UNIT = 31


def encode_to(s: Set, message) -> list[ZpNumber]:
    """A message as Zp elements: each 31-byte unit read big-endian, plus
    2^248 so that no element is 0; a short last unit fills the unit's high
    bytes.  The empty message has no element."""
    if s.name != "Zp":
        raise ValueError("encode_to is defined for Zp only")
    message = message.encode() if isinstance(message, str) else bytes(message)
    marker = 1 << (8 * _UNIT)
    return [ZpNumber(marker + int.from_bytes(message[i:i + _UNIT].ljust(_UNIT, b"\0"), "big"))
            for i in range(0, len(message), _UNIT)]


def make_Zp(x: int) -> ZpNumber:
    """An integer as a Zp element (negative values taken mod r)."""
    return ZpNumber(x)


def polynomial(x, a0, coeffs):
    """a0 + sum_i coeffs[i-1] x^i at an integer (or Zp) point x, with the
    powers as exact integers mod r."""
    xi = x.value if isinstance(x, ZpNumber) else int(x)
    acc, p = a0, 1
    for a in coeffs:
        p = p * xi % R
        acc = acc + a * ZpNumber(p)
    return acc
