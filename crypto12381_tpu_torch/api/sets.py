"""The reference's set notation for a protocol's host edges.

Counterpart of the JAX package's `api/sets.py`: the group tags `Zp`,
`G1`, `G2` and `GT`, where `~S` excludes the identity, `S ** n` is a
cartesian power and `A | B` (or `A * B`) a product set; `select_in`
draws elements from the CSPRNG in the reference's order; `parse` and
`serialize` read and write their concatenated bytes, and `@packed`
declares a fixed-layout struct of elements that `parse` and
`serialize(...).to(...)` also read; `hash_(...)` is an incremental
SHA3-512 (`|` appends) whose `.to(Zp)` is the digest mod r and `.to(G1)`
the host SSWU hash to G1; `pair` and `inverse` are the element
functions; `encode_to`, `make_Zp`, `polynomial`, `sum_` and `product_`
are the reference's scalar helpers, the last two over a list or over a
symbolic body and an index range (api/algebra.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..compat.csprng import RandomEngine
from ..params import GT_BYTES, MODBYTES, R
from . import algebra as ALG
from .elements import G1Element, G1Pow, G2Element, GTElement, ZpNumber, inverse, pair

__all__ = ["Zp", "G1", "G2", "GT", "Set", "CartesianPower", "ProductSet", "select_in", "parse",
           "serialize", "SerializedPack", "packed", "hash_", "HashState",
           "create_random_engine", "encode_to", "make_Zp", "polynomial", "sum_", "product_",
           "inverse", "pair"]


def create_random_engine(seed) -> RandomEngine:
    """The reference's seeded CSPRNG (compat/csprng.py; its
    `create_random_engine(seed, native=True)` takes the C twin)."""
    return RandomEngine(seed)


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

    def __or__(self, other) -> "ProductSet":
        """The product set A | B."""
        return ProductSet((self,) + _parts(other))

    __mul__ = __or__

    def __repr__(self):
        return ("*" if self.star else "") + self.name


@dataclass(frozen=True)
class CartesianPower:
    base: Set
    exponent: int

    @property
    def serialized_size(self) -> int:
        return self.base.serialized_size * self.exponent

    def __pow__(self, n: int) -> "CartesianPower":
        return CartesianPower(self.base, self.exponent * n)

    def __invert__(self) -> "CartesianPower":
        # ~Zp ** 2 parses as ~(Zp ** 2): star the base set
        return CartesianPower(~self.base, self.exponent)


@dataclass(frozen=True)
class ProductSet:
    """A | B | ...: its parts in order."""

    parts: tuple

    @property
    def serialized_size(self) -> int:
        return sum(p.serialized_size for p in self.parts)

    def __or__(self, other) -> "ProductSet":
        return ProductSet(self.parts + _parts(other))

    __mul__ = __or__


def _parts(s) -> tuple:
    return s.parts if isinstance(s, ProductSet) else (s,)


Zp = Set("Zp", MODBYTES)
G1 = Set("G1", 1 + MODBYTES)
G2 = Set("G2", 1 + 2 * MODBYTES)
GT = Set("GT", GT_BYTES)

_PARSERS = {"Zp": ZpNumber.parse, "G1": G1Element.parse, "G2": G2Element.parse,
            "GT": GTElement.parse}


def _select_one(s: Set, rng: RandomEngine):
    if s.name == "Zp":
        return ZpNumber.select_nonzero(rng) if s.star else ZpNumber.select(rng)
    if s.name == "G1":
        return G1Pow.select_except1(rng) if s.star else G1Pow.select(rng)
    if s.name == "G2":
        return G2Element.select_except1(rng) if s.star else G2Element.select(rng)
    raise ValueError(f"cannot select in {s}")


def select_in(s, rng: RandomEngine, n: int | None = None):
    """One random element of a set, a tuple of them for a cartesian power
    or a product set, or a list of n of them, drawn in order."""
    if isinstance(s, CartesianPower):
        return tuple(_select_one(s.base, rng) for _ in range(s.exponent))
    if isinstance(s, ProductSet):
        return tuple(_select_one(p, rng) for p in s.parts)
    if n is not None:
        return [_select_one(s, rng) for _ in range(n)]
    return _select_one(s, rng)


def _flatten(sets) -> list[Set]:
    flat = []
    for s in sets:
        if isinstance(s, CartesianPower):
            flat.extend([s.base] * s.exponent)
        else:
            flat.extend(_parts(s))
    return flat


def parse(*args):
    """parse(SetA, SetB, ..., data): the elements in order, one element for
    a single set; parse(PackedClass, data): an instance of a @packed class.
    Raises if data has the wrong length or an element does not parse."""
    *sets, data = args
    data = bytes(data)
    if len(sets) == 1 and isinstance(sets[0], type) and hasattr(sets[0], "_pack_fields"):
        return sets[0].parse(data)
    flat = _flatten(sets)
    total = sum(s.serialized_size for s in flat)
    if len(data) != total:
        raise ValueError(f"parse: need {total} bytes, got {len(data)}")
    out, off = [], 0
    for s in flat:
        out.append(_PARSERS[s.name](data[off:off + s.serialized_size]))
        off += s.serialized_size
    return out[0] if len(out) == 1 else tuple(out)


class SerializedPack(bytes):
    """The bytes of serialize(...), which `.to(PackedClass)` reads as an
    instance of a @packed class of the same size."""

    def to(self, struct_cls):
        if not hasattr(struct_cls, "_pack_fields"):
            raise TypeError(f"{struct_cls!r} is not a @packed struct")
        if len(self) != struct_cls.SERIALIZED_SIZE:
            raise ValueError(f"serialized pack is {len(self)} bytes; {struct_cls.__name__} "
                             f"needs {struct_cls.SERIALIZED_SIZE}")
        return struct_cls.parse(bytes(self))


def serialize(*elems) -> SerializedPack:
    """The elements' bytes, concatenated (lists and tuples flattened; raw
    bytes as they are)."""
    out = bytearray()
    for e in elems:
        if isinstance(e, (list, tuple)):
            out += serialize(*e)
        elif isinstance(e, (bytes, bytearray)):
            out += e
        else:
            out += e.serialize()
    return SerializedPack(out)


def packed(cls):
    """A fixed-layout struct of group elements: the class attributes that
    are sets, cartesian powers or product sets are its fields, in order.

        @packed
        class Signature:
            h = G1
            e = Zp

    The class gains SERIALIZED_SIZE, an __init__ over the fields,
    `parse(data)`, `serialize()` and field-wise equality."""
    fields = [(n, spec) for n, spec in vars(cls).items()
              if isinstance(spec, (Set, CartesianPower, ProductSet))]
    if not fields:
        raise TypeError(f"@packed class {cls.__name__} declares no fields")
    names = [n for n, _ in fields]
    specs = [s for _, s in fields]
    sizes = [s.serialized_size for s in specs]
    cls._pack_fields = tuple(fields)
    cls.SERIALIZED_SIZE = sum(sizes)

    def __init__(self, *args, **kw):
        vals = dict(zip(names, args))
        vals.update(kw)
        if set(vals) != set(names):
            raise TypeError(f"{cls.__name__} needs fields {names}")
        for n in names:
            setattr(self, n, vals[n])

    @classmethod
    def _parse(kls, data: bytes):
        if len(data) != kls.SERIALIZED_SIZE:
            raise ValueError(f"{kls.__name__}: need {kls.SERIALIZED_SIZE} bytes, "
                             f"got {len(data)}")
        vals, off = [], 0
        for spec, size in zip(specs, sizes):
            vals.append(parse(spec, data[off:off + size]))
            off += size
        return kls(*vals)

    def _serialize(self) -> SerializedPack:
        return serialize(*(getattr(self, n) for n in names))

    def __eq__(self, other):
        if not isinstance(other, cls):
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n) for n in names)

    def __repr__(self):
        return f"{cls.__name__}({', '.join(f'{n}={getattr(self, n)!r}' for n in names)})"

    cls.__init__ = __init__
    cls.parse = _parse
    cls.serialize = _serialize
    cls.__eq__ = __eq__
    cls.__hash__ = None
    cls.__repr__ = __repr__
    return cls


class HashState:
    """SHA3-512 over raw bytes and the serialized bytes of elements; `|`
    appends like `update`."""

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
        elif isinstance(a, int):
            raise TypeError("hash of raw int is ambiguous; wrap in ZpNumber")
        else:
            raise TypeError(f"cannot hash {type(a)}")
        return self

    __or__ = update

    def digest(self) -> bytes:
        return self._h.digest()

    def to(self, s: Set):
        """The digest mod r (Zp) or hashed to G1 (G1Element.from_hash)."""
        if s.name == "Zp":
            return ZpNumber.from_hash(self.digest())
        if s.name == "G1":
            return G1Element.from_hash(self.digest())
        raise ValueError(f"hash .to({s}) not supported (matches reference)")


def hash_(*args) -> HashState:
    return HashState(*args)


def _symbolic_terms(expr, spec) -> list:
    """A symbolic body at each value of its index range: spec is an
    algebra.RangeSub (i.in_[n], i.in_(values).except_(j)) or a bare count
    (the symbol is then `i`)."""
    if isinstance(spec, int):
        spec = ALG.RangeSub("i", lo=0, hi=spec)
    if not isinstance(spec, ALG.RangeSub):
        raise TypeError(f"bad symbolic range spec {spec!r}")
    vals = spec.resolve()
    if vals is None:
        raise ValueError("symbolic range bounds must be concrete here")
    return [ALG.substitute(expr, **{spec.name: v}) for v in vals]


def sum_(items, spec=None):
    """The sum of a list of Zp values, or of a symbolic body over an index
    range (`sum_(expr, i.in_[n])`); 0 for no term."""
    if spec is not None:
        items = _symbolic_terms(items, spec)
    acc = None
    for it in items:
        acc = it if acc is None else acc + it
    return ZpNumber(0) if acc is None else acc


def product_(items, spec=None):
    """The product of a non-empty list, or of a symbolic body over an index
    range (`product_(expr, i.in_[n].except_(j))`, materialized first, so
    that the fusion below sees the whole product): G1 elements and powers
    as one host multi-scalar product (`G1Element.product`), G2 elements by
    the group law, pairings as one lazy `GTPair` (one final
    exponentiation), anything else left to right.  Raises on no term, as
    the JAX package does."""
    if spec is not None:
        items = _symbolic_terms(items, spec)
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
