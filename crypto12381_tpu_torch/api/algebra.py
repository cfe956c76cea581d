"""The reference's symbolic index notation (include/crypto12381/algebra.hpp):
deferred expressions in named symbols, substitution (plain, by an
expression, and over a range with exclusions), symbolic subscripts of
ranges, and the range adaptors (algebraic, sequence, transform, filter,
except, materialize, subscript) behind the Sigma/Pi notation of
api/sets.py `sum_` and `product_`.

Counterpart of the JAX package's `api/algebra.py`, pure Python: the
reference builds these trees at compile time with C++ templates
(symbol<"x">, symbol_substitution, algebraic_range); here they are small
runtime trees with the same semantics.  Host element operators return
NotImplemented on an expression, so `g ** x[i]` and `r * a[i]` build
deferred nodes through the reflected operators.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

__all__ = [
    "Symbol", "symbols", "substitute", "subscript", "sequence", "algebraic",
    "transform", "filter_", "except_", "materialize", "Sum", "Prod",
    "x", "y", "z", "i", "j", "k",
]


class Expr:
    """Base deferred expression node."""

    def _eval(self, env: dict):
        raise NotImplementedError

    def _symbols(self, out: list):
        raise NotImplementedError

    # -- operator sugar (algebra.hpp:689-729) -------------------------

    def __add__(self, o):
        return BinOp("+", self, o)

    def __radd__(self, o):
        return BinOp("+", o, self)

    def __sub__(self, o):
        return BinOp("-", self, o)

    def __rsub__(self, o):
        return BinOp("-", o, self)

    def __mul__(self, o):
        return BinOp("*", self, o)

    def __rmul__(self, o):
        return BinOp("*", o, self)

    def __truediv__(self, o):
        return BinOp("/", self, o)

    def __rtruediv__(self, o):
        return BinOp("/", o, self)

    def __pow__(self, o):
        return BinOp("**", self, o)

    def __rpow__(self, o):
        """base ** symbolic-exponent (group elements defer here, so
        `g ** x[i]` builds a deferred node like the reference's
        symbolic_invocation, algebra.hpp:492-521)."""
        return BinOp("**", o, self)

    __xor__ = __pow__

    def __neg__(self):
        return BinOp("-", 0, self)

    def __getitem__(self, idx):
        """Symbolic subscript chaining: `rows[k][ii]` stays deferred until
        every index binds (ref subscript, algebra.hpp:397-425)."""
        return Subscript(self, idx)

    # -- invocation = substitution ------------------------------------

    def __call__(self, *subs, **kw):
        """expr(sub...) substitutes; ranged substitutions yield an
        AlgebraicRange of the expression over the range."""
        return _apply_subs(self, subs, kw)


def _ordered_symbols(e) -> list:
    out: list = []
    if isinstance(e, Expr):
        e._symbols(out)
    dedup = []
    for s in out:
        if s.name not in [d.name for d in dedup]:
            dedup.append(s)
    return dedup


def _apply_subs(expr, subs, kw):
    env: dict[str, Any] = {}
    ranged: list[RangeSub] = []
    syms = _ordered_symbols(expr)
    pos: list[Any] = []
    for s in subs:
        if isinstance(s, RangeSub):
            ranged.append(s)
        elif isinstance(s, Binding):
            env[s.name] = s.value
        else:
            pos.append(s)
    for p, s in zip(pos, syms):
        env[s.name] = p
    env.update(kw)
    out = _subst(expr, env) if env else expr
    # multiple ranged substitutions nest with the LAST one outermost
    # (matches the reference's multi-index invocation, e.g. MHAC's
    # share matrices are party-major for (ii.in[...], k.in[...]))
    if not ranged:
        return out

    def build(e, remaining):
        if not remaining:
            return e
        rs = remaining[-1].with_env(env)
        vals = rs.resolve()
        if vals is None:
            assert len(remaining) == 1, "deferred bounds only for one range"
            return RangedInvoke(e, rs)
        return AlgebraicRange(
            [build(_subst(e, {rs.name: v}), remaining[:-1]) for v in vals]
        )

    return build(out, ranged)


def _ranged(e, rs: "RangeSub"):
    vals = rs.resolve()
    if vals is None:
        return RangedInvoke(e, rs)
    return AlgebraicRange([_subst(e, {rs.name: v}) for v in vals])


class RangedInvoke(Expr):
    """A ranged substitution whose bounds/excludes are still symbolic;
    resolves to an AlgebraicRange once every symbol binds."""

    __slots__ = ("expr", "rs")

    def __init__(self, expr, rs):
        self.expr = expr
        self.rs = rs

    def _eval(self, env):
        return _ranged(_subst(self.expr, env), self.rs.with_env(env))

    def _symbols(self, out):
        if isinstance(self.expr, Expr):
            self.expr._symbols(out)
        self.rs._symbols(out)


def _subst(e, env: dict):
    if isinstance(e, Expr):
        r = e._eval(env)
        return r
    return e


class Symbol(Expr):
    """Named placeholder (ref symbol<"x">, algebra.hpp:449-477)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _eval(self, env):
        return env.get(self.name, self)

    def _symbols(self, out):
        out.append(self)

    # x = value  ->  binding;  Python needs explicit call: x.be(value)
    def be(self, value) -> "Binding":
        return Binding(self.name, value)

    @property
    def in_(self) -> "_InHelper":
        """i.in_[n], i.in_[a, b], i.in_(iterable) (algebra.hpp:549-575)."""
        return _InHelper(self.name)

    def __repr__(self):
        return self.name


class Binding:
    __slots__ = ("name", "value")

    def __init__(self, name, value):
        self.name = name
        self.value = value


class RangeSub:
    """Ranged substitution i.in_[...] with optional .except_(...); bounds
    and exclusions may themselves be symbolic and resolve later."""

    __slots__ = ("name", "lo", "hi", "items", "excl")

    def __init__(self, name, lo=None, hi=None, items=None, excl=()):
        self.name = name
        self.lo = lo
        self.hi = hi
        self.items = list(items) if items is not None else None
        self.excl = tuple(excl)

    def except_(self, *vals) -> "RangeSub":
        return RangeSub(self.name, self.lo, self.hi, self.items,
                        self.excl + tuple(vals))

    def with_env(self, env) -> "RangeSub":
        if not env:
            return self
        f = lambda v: _subst(v, env)
        return RangeSub(
            self.name,
            f(self.lo) if self.lo is not None else None,
            f(self.hi) if self.hi is not None else None,
            [f(v) for v in self.items] if self.items is not None else None,
            tuple(f(v) for v in self.excl),
        )

    def resolve(self):
        """Concrete value list, or None while anything is still symbolic."""
        parts = list(self.excl)
        if self.items is None:
            parts += [self.lo, self.hi]
        else:
            parts += self.items
        if any(isinstance(v, Expr) for v in parts if v is not None):
            return None
        vals = self.items if self.items is not None else list(range(self.lo, self.hi))
        excl = set(self.excl)
        return [v for v in vals if v not in excl]

    def _symbols(self, out):
        for v in list(self.excl) + [self.lo, self.hi] + (self.items or []):
            if isinstance(v, Expr):
                v._symbols(out)


class _InHelper:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __getitem__(self, key):
        if isinstance(key, tuple):
            a, b = key
            return RangeSub(self.name, lo=a, hi=b)
        return RangeSub(self.name, lo=0, hi=key)

    def __call__(self, iterable):
        return RangeSub(self.name, items=list(iterable))


class BinOp(Expr):
    __slots__ = ("op", "l", "r")

    def __init__(self, op, l, r):
        self.op = op
        self.l = l
        self.r = r

    def _eval(self, env):
        l = _subst(self.l, env)
        r = _subst(self.r, env)
        if isinstance(l, Expr) or isinstance(r, Expr):
            return BinOp(self.op, l, r)
        if self.op == "+":
            return l + r
        if self.op == "-":
            return l - r
        if self.op == "*":
            return l * r
        if self.op == "/":
            return l / r
        if self.op == "**":
            return l**r
        raise ValueError(self.op)

    def _symbols(self, out):
        for side in (self.l, self.r):
            if isinstance(side, Expr):
                side._symbols(out)


class Subscript(Expr):
    """range[symbolic index] (ref subscript, algebra.hpp:397-425)."""

    __slots__ = ("seq", "idx")

    def __init__(self, seq, idx):
        self.seq = seq
        self.idx = idx

    def _eval(self, env):
        seq = _subst(self.seq, env) if isinstance(self.seq, Expr) else self.seq
        idx = _subst(self.idx, env)
        if isinstance(seq, Expr) or isinstance(idx, Expr):
            return Subscript(seq, idx)
        return seq[idx]

    def _symbols(self, out):
        if isinstance(self.seq, Expr):
            self.seq._symbols(out)
        if isinstance(self.idx, Expr):
            self.idx._symbols(out)


class AlgebraicRange:
    """Range interoperating with the DSL: symbolic subscripting, adaptor
    piping (ref algebraic_range, algebra.hpp:609-687)."""

    def __init__(self, items: Iterable):
        self._items = list(items)

    def __getitem__(self, idx):
        if isinstance(idx, Expr):
            return Subscript(self, idx)
        return self._items[idx]

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def __eq__(self, other):
        return list(self) == list(other)

    def transform(self, fn: Callable) -> "AlgebraicRange":
        return AlgebraicRange([fn(v) for v in self._items])

    def filter(self, pred: Callable) -> "AlgebraicRange":
        return AlgebraicRange([v for v in self._items if pred(v)])

    def except_(self, *vals) -> "AlgebraicRange":
        return AlgebraicRange([v for v in self._items if v not in vals])

    def materialize(self) -> list:
        return list(self._items)


def algebraic(seq: Iterable) -> AlgebraicRange:
    return AlgebraicRange(seq)


def sequence(a, b=None) -> AlgebraicRange:
    """sequence(n) = [0, n); sequence(a, b) = [a, b) (algebra.hpp:523-547)."""
    return AlgebraicRange(range(a) if b is None else range(a, b))


def transform(seq, fn) -> AlgebraicRange:
    return algebraic(seq).transform(fn)


def filter_(seq, pred) -> AlgebraicRange:
    return algebraic(seq).filter(pred)


def except_(seq, *vals) -> AlgebraicRange:
    return algebraic(seq).except_(*vals)


def materialize(seq) -> list:
    return list(seq)


def subscript(seq, idx):
    """subscript(range, i) — symbolic or concrete (algebra.hpp:397-425)."""
    if isinstance(idx, Expr):
        return Subscript(seq if isinstance(seq, AlgebraicRange) else algebraic(seq), idx)
    return seq[idx]


def substitute(expr, **kw):
    """substitute(expr, i=0) (algebra.hpp:288-383)."""
    return _subst(expr, kw) if isinstance(expr, Expr) else expr


def symbols(names: str):
    return tuple(Symbol(n) for n in names.replace(",", " ").split())


# predefined symbols (algebra.hpp:577-586)
x, y, z, i, j, k = symbols("x y z i j k")


# ---------------------------------------------------------------------------
# Σ / Π with symbolic index binding (set.hpp:465-554)
# ---------------------------------------------------------------------------


class _Reducer:
    def __init__(self, combine: Callable, name: str):
        self._combine = combine
        self._name = name

    def __getitem__(self, spec):
        """Sum[n](expr) / Sum[i.in_(range).except_(j)](expr) — the symbol
        defaults to `i` when a bare count is given."""
        if isinstance(spec, RangeSub):
            rs = spec
        elif isinstance(spec, int):
            rs = RangeSub("i", lo=0, hi=spec)
        else:
            raise TypeError(f"bad reducer spec {spec!r}")

        def run(expr):
            vals = [
                _subst(expr, {rs.name: v}) if isinstance(expr, Expr) else expr
                for v in rs.resolve()
            ]
            if not vals:
                raise ValueError(f"empty {self._name}")
            acc = vals[0]
            for v in vals[1:]:
                acc = self._combine(acc, v)
            return acc

        return run


Sum = _Reducer(lambda a, b: a + b, "Σ")
Prod = _Reducer(lambda a, b: a * b, "Π")
