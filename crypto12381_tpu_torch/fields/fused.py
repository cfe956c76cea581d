"""Tower products, Fp12 operations and G1 and G2 curve operations as
single kernels (K2-K14).

Counterpart of the JAX package's `fields/fp32k.py`.  Each kernel computes
one whole tower product, Fp12 operation or curve operation per instance,
pre-sums and combines included, so no intermediate leaves the kernel:

  K2 `fp2_mul` (csrc/tower.cu)  (..., 2, 12) x (..., 2, 12): 3 Fp products
  K3 `fp2_sqr`                  (..., 2, 12):                 2 Fp products
  K4 `fp6_mul`                  (..., 3, 2, 12) x same:      18 Fp products
  K8 `fp12_mul` (csrc/fp12.cu)  (..., 2, 3, 2, 12) x same:   54 Fp products
  K9 `fp12_sqr`                 (..., 2, 3, 2, 12):          36 Fp products
  K10 `fp12_usqr`               (..., 2, 3, 2, 12):          18 Fp products
      `fp12_cyc_pow_fixed`      (..., 2, 3, 2, 12), public e: K10's squares
                                and K8's products of x^e in one launch
  K11 `fp12_sparse_mul`         (..., 2, 3, 2, 12) x k lines (k, ..., 3, 2, 12):
                                45 k
  K5 `g1_madd` (csrc/g1.cu)     (..., 3, 12) + (..., 2, 12): 11 Fp products
  K6 `g1_add`                   (..., 3, 12) + (..., 3, 12): 12 Fp products
  K7 `g1_dbl`                   (..., 3, 12):                 8 Fp products
  K12 `g2_add` (csrc/g2.cu)     (..., 3, 2, 12) + same:      36 Fp products
  K13 `g2_madd`                 (..., 3, 2, 12) + (..., 2, 2, 12): 33
  K14 `g2_dbl`                  (..., 3, 2, 12):             22 Fp products

Operands are canonical; the outputs are canonical.  A CUDA tensor
launches the kernel, a CPU tensor runs the plain version beside it, which
computes the same canonical value through `fp.mont_mul_plain` (the Fp12
plain versions through the plain versions of K2-K4, so they launch no
kernel on the card either).  The TPU ran K8-K11 as row-stacked composites
of K2-K4 with the combines in plain XLA (`fp32k.py` `fp12_mul_c` and its
siblings); the plain versions keep that algebra.  It ran K12-K14 as the
composites `g2_add_c`, `g2_madd_c` and `g2_dbl_c`, three K2 rounds each
with 3b' as a third round of products; here, as in its programs
`prog_g2_*`, 3b' = 12 xi is folded into the operands, and the plain
versions are two stacked K2 plain calls.
"""

from __future__ import annotations

import torch

from .. import _build
from . import fp as FP

# ---------------------------------------------------------------------------
# Small helpers over (..., 2, 12) Fp2 and (..., 3, 2, 12) Fp6 tensors
# ---------------------------------------------------------------------------


def mul_xi(a: torch.Tensor) -> torch.Tensor:
    """Multiply by xi = 1+i: (re, im) -> (re - im, re + im)."""
    re, im = a[..., 0, :], a[..., 1, :]
    return torch.stack([FP.sub(re, im), FP.add(re, im)], -2)


def mul_by_v(a: torch.Tensor) -> torch.Tensor:
    """Fp6 times v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return torch.stack([mul_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], -3)


def _flat(x: torch.Tensor, tail: int) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[-tail:])).contiguous()


# ---------------------------------------------------------------------------
# K2: Fp2 product
# ---------------------------------------------------------------------------


def fp2_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
    re = t0 - t1, im = t2 - t0 - t1.  The three products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t = FP.mont_mul_plain(torch.stack([a0, a1, FP.add_raw(a0, a1)], -2),
                          torch.stack([b0, b1, FP.add_raw(b0, b1)], -2))
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return torch.stack([FP.sub(t0, t1), FP.sub(FP.sub(t2, t0), t1)], -2)


def fp2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return fp2_mul_plain(a, b)
    a2, b2 = _flat(a, 2), _flat(b, 2)
    out = torch.empty_like(a2)
    if a2.shape[0]:
        _build.launch("tower", "fp2_mul", (a2, b2, out), a2.shape[0])
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# K3: Fp2 square
# ---------------------------------------------------------------------------


def fp2_sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """(a0+a1)(a0-a1), a0 * 2a1 — two products in one call."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return FP.mont_mul_plain(torch.stack([FP.add_raw(a0, a1), a0], -2),
                             torch.stack([FP.sub(a0, a1), FP.add_raw(a1, a1)], -2))


def fp2_sqr(a: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return fp2_sqr_plain(a)
    a2 = _flat(a, 2)
    out = torch.empty_like(a2)
    if a2.shape[0]:
        _build.launch("tower", "fp2_sqr", (a2, out), a2.shape[0])
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# K4: Fp6 product
# ---------------------------------------------------------------------------


def fp6_combine(t: torch.Tensor) -> torch.Tensor:
    """(..., 6, 2, 12) products t0, t1, t2, m01, m12, m02 of an Fp6
    Karatsuba -> (..., 3, 2, 12):
    c0 = t0 + xi(m12 - t1 - t2), c1 = m01 - t0 - t1 + xi t2,
    c2 = m02 - t0 - t2 + t1."""
    t0, t1, t2, m01, m12, m02 = [t[..., i, :, :] for i in range(6)]
    c0 = FP.add(t0, mul_xi(FP.sub(m12, FP.add(t1, t2))))
    c1 = FP.add(FP.sub(m01, FP.add(t0, t1)), mul_xi(t2))
    c2 = FP.add(FP.sub(m02, FP.add(t0, t2)), t1)
    return torch.stack([c0, c1, c2], -3)


def fp6_pairs(a: torch.Tensor, b: torch.Tensor):
    """The 6 Fp2 operand pairs of an Fp6 Karatsuba product, as two
    (..., 6, 2, 12) tensors; the pre-sums are reduced mod p."""
    def side(x):
        x0, x1, x2 = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
        return torch.stack([x0, x1, x2, FP.add(x0, x1), FP.add(x1, x2), FP.add(x0, x2)], -3)
    return side(a), side(b)


def fp6_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return fp6_combine(fp2_mul_plain(*fp6_pairs(a, b)))


def fp6_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return fp6_mul_plain(a, b)
    a2, b2 = _flat(a, 3), _flat(b, 3)
    out = torch.empty_like(a2)
    if a2.shape[0]:
        _build.launch("tower", "fp6_mul", (a2, b2, out), a2.shape[0])
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# K8-K11: the Fp12 operations.  An Fp12 x = a + b w is (..., 2, 3, 2, 12)
# with halves a = x[..., 0, :, :, :] and b = x[..., 1, :, :, :]; a sparse
# Miller line c0 + c3 w^3 + c5 w^5 is (..., 3, 2, 12) [c0, c3, c5].  Each
# plain version stacks its products into one plain K4, K3 or K2 call and
# does the combines with the plain modular ops of fields/fp.py.
# ---------------------------------------------------------------------------


def _halves(x: torch.Tensor):
    return x[..., 0, :, :, :], x[..., 1, :, :, :]


def _fp12(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], -4)


def _launch12(fn: str, *ins: torch.Tensor, exponent: int | None = None) -> torch.Tensor:
    """Launch `fn` of the Fp12 library over the rows of its operands, whose
    batch dims are those of the first (an Fp12 value): a fresh result of
    the first operand's shape; a power chain's public exponent passed on."""
    nb = ins[0].dim() - 4
    flat = [_flat(x, x.dim() - nb) for x in ins]
    out = torch.empty_like(flat[0])
    if out.shape[0]:
        _build.launch("fp12", fn, (*flat, out), out.shape[0], exponent=exponent)
    return out.reshape(ins[0].shape)


def fp12_mul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x y = t0 + v t1 + (m - t0 - t1) w with t0 = a c, t1 = b d and
    m = (a + b)(c + d): the three Fp6 products in one plain K4 call."""
    x, y = torch.broadcast_tensors(x, y)
    a, b = _halves(x)
    c, d = _halves(y)
    t0, t1, m = fp6_mul_plain(torch.stack([a, b, FP.add(a, b)]),
                              torch.stack([c, d, FP.add(c, d)])).unbind(0)
    return _fp12(FP.add(t0, mul_by_v(t1)), FP.sub(m, FP.add(t0, t1)))


def fp12_sqr_plain(x: torch.Tensor) -> torch.Tensor:
    """x^2 with t = (a + b)(a + v b), m = a b: c0 = t - m - v m, c1 = 2 m;
    the two Fp6 products in one plain K4 call."""
    a, b = _halves(x)
    t, m = fp6_mul_plain(torch.stack([FP.add(a, b), a]),
                         torch.stack([FP.add(a, mul_by_v(b)), b])).unbind(0)
    return _fp12(FP.sub(t, FP.add(m, mul_by_v(m))), FP.add(m, m))


def fp12_usqr_plain(x: torch.Tensor) -> torch.Tensor:
    """The cyclotomic (Granger-Scott) square: the 9 Fp2 squares of
    X = (b1, a2, b2), Y = (a0, b0, a1) and X + Y in one plain K3 call.
    Valid only in the cyclotomic subgroup; as algebra it is the same
    polynomial for any input."""
    a, b = _halves(x)
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    X = torch.stack([b1, a2, b2], -3)
    Y = torch.stack([a0, b0, a1], -3)
    x2, y2, s = fp2_sqr_plain(torch.stack([X, Y, FP.add(X, Y)])).unbind(0)
    cross = FP.sub(s, FP.add(x2, y2)).unbind(-3)          # 2 X Y: t6, t7, t8'
    T = torch.stack([mul_xi(cross[2]), cross[0], cross[1]], -3)
    U = FP.add(mul_xi(x2), y2)                            # xi X^2 + Y^2
    return _fp12(FP.sub(FP.mul_small(U, 3), FP.double(a)),
                 FP.add(FP.mul_small(T, 3), FP.double(b)))


def _sparse_mul_one(f: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """f (c0 + c3 w^3 + c5 w^5): the 15 Fp2 products in one plain K2 call.
    t0 = a c0; t1 = (xi (b1 c5 + b2 c3), b0 c3 + xi b2 c5, b0 c5 + b1 c3);
    m = (a + b)(c0 + c3 v + c5 v^2) as an Fp6 Karatsuba product; the
    result is t0 + v t1 + (m - t0 - t1) w."""
    f, line = _expand_line(f, line)
    a, b = _halves(f)
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    c0, c3, c5 = line.unbind(-3)
    s = FP.add(a, b)
    s0, s1, s2 = s.unbind(-3)
    s01, s12, s02 = FP.add(torch.stack([s0, s1, s0]), torch.stack([s1, s2, s2])).unbind(0)
    c03, c35, c05 = FP.add(torch.stack([c0, c3, c0]), torch.stack([c3, c5, c5])).unbind(0)
    lhs = torch.stack([a0, a1, a2, b1, b2, b0, b2, b0, b1, s0, s1, s2, s01, s12, s02])
    rhs = torch.stack([c0, c0, c0, c5, c3, c3, c5, c5, c3, c0, c3, c5, c03, c35, c05])
    t00, t01, t02, u0, u1, u2, u3, u4, u5, *v = fp2_mul_plain(lhs, rhs).unbind(0)
    t0 = torch.stack([t00, t01, t02], -3)
    t1 = torch.stack([mul_xi(FP.add(u0, u1)), FP.add(u2, mul_xi(u3)), FP.add(u4, u5)], -3)
    m = fp6_combine(torch.stack(v, -3))
    return _fp12(FP.add(t0, mul_by_v(t1)), FP.sub(m, FP.add(t0, t1)))


def _expand_line(f: torch.Tensor, line: torch.Tensor):
    """Broadcast the batch dims of an Fp12 value and a sparse line."""
    batch = torch.broadcast_shapes(f.shape[:-4], line.shape[:-3])
    return f.expand(batch + f.shape[-4:]), line.expand(batch + line.shape[-3:])


def _line_stack(f: torch.Tensor, lines: torch.Tensor):
    """f and its lines as a (k, batch..., 3, 2, 12) stack, the batch dims
    of both broadcast: `lines` is a stack when it has as many dims as f,
    else a single line (k = 1)."""
    if lines.dim() != f.dim():
        lines = lines[None]
    if not lines.shape[0]:
        raise ValueError("fp12_sparse_mul: no line")
    batch = torch.broadcast_shapes(f.shape[:-4], lines.shape[1:-3])
    return (f.expand(batch + f.shape[-4:]),
            lines.expand(lines.shape[:1] + batch + lines.shape[-3:]))


def fp12_sparse_mul_plain(f: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """f l_1 ... l_k for a stack of k sparse lines (k, batch..., 3, 2, 12),
    or f l for one line (batch..., 3, 2, 12): the one-line algebra
    (`_sparse_mul_one`) k times, in order."""
    f, lines = _line_stack(f, lines)
    for line in lines.unbind(0):
        f = _sparse_mul_one(f, line)
    return f


def fp12_cyc_pow_fixed_plain(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a public e >= 1 by the kernel's chain: from the top bit down,
    a cyclotomic square at each later bit and a product by x at each set
    one (`fp12_usqr_plain`, `fp12_mul_plain`).  Valid only in the
    cyclotomic subgroup; as algebra it is the same polynomial for any
    input."""
    if e < 1:
        raise ValueError("fp12_cyc_pow_fixed: the exponent must be at least 1")
    acc = x
    for bit in bin(e)[3:]:
        acc = fp12_usqr_plain(acc)
        if bit == "1":
            acc = fp12_mul_plain(acc, x)
    return acc


def fp12_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = torch.broadcast_tensors(x, y)
    if x.device.type == "cpu":
        return fp12_mul_plain(x, y)
    return _launch12("fp12_mul", x, y)


def fp12_sqr(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return fp12_sqr_plain(x)
    return _launch12("fp12_sqr", x)


def fp12_usqr(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return fp12_usqr_plain(x)
    return _launch12("fp12_usqr", x)


def fp12_cyc_pow_fixed(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a public exponent e >= 1 (the final exponentiation's g^|x|):
    one launch of the whole chain of cyclotomic squares and products."""
    if x.device.type == "cpu":
        return fp12_cyc_pow_fixed_plain(x, e)
    return _launch12("fp12_cyc_pow_fixed", x, exponent=e)


def fp12_sparse_mul(f: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """f l_1 ... l_k for k stacked sparse lines (k, batch..., 3, 2, 12), or
    one line (batch..., 3, 2, 12): one launch absorbs them all."""
    f, lines = _line_stack(f, lines)
    if f.device.type == "cpu":
        return fp12_sparse_mul_plain(f, lines)
    k = lines.shape[0]
    f2 = _flat(f, 4)
    lines2 = lines.reshape((k, -1) + lines.shape[-3:]).contiguous()
    out = torch.empty_like(f2)
    if out.shape[0]:
        _build.launch("fp12", "fp12_sparse_mul", (f2, lines2, out), out.shape[0], stack=k)
    return out.reshape(f.shape)


# ---------------------------------------------------------------------------
# K5, K6, K7: complete G1 curve operations (RCB15, 3b = 12 folded into the
# operands).  Points are (..., 3, 12) [X, Y, Z]; the mixed add's second
# operand is affine (..., 2, 12) [x, y] with Z = 1 implied.  Each plain
# version runs the kernel's two product rounds as two stacked K1 plain
# products.
# ---------------------------------------------------------------------------


def _mul12(x: torch.Tensor) -> torch.Tensor:
    """12 x mod p: three modular doublings and an add (8x + 4x)."""
    x4 = FP.double(FP.double(x))
    return FP.add(FP.double(x4), x4)


def _rcb_round2(t1m, z3a, t3, t4, w, bt5, mul=FP.mont_mul_plain, dim=-2) -> torch.Tensor:
    """X3 = t1m t3 - bt5 t4, Y3 = t1m z3a + bt5 w, Z3 = z3a t4 + w t3: the six
    products in one plain call of `mul` (K1's over Fp, K2's over Fp2, the
    coordinates along `dim`)."""
    c = mul(torch.stack([t1m, bt5, t1m, bt5, z3a, w], dim),
            torch.stack([t3, t4, z3a, w, t4, t3], dim)).unbind(dim)
    return torch.stack([FP.sub(c[0], c[1]), FP.add(c[2], c[3]), FP.add(c[4], c[5])], dim)


def _expand_mixed(p: torch.Tensor, q: torch.Tensor, elem: int = 1):
    """Broadcast the batch dims of a projective and an affine point whose
    coordinates have `elem` dims (1 for Fp, 2 for Fp2)."""
    k = 1 + elem
    batch = torch.broadcast_shapes(p.shape[:-k], q.shape[:-k])
    return p.expand(batch + p.shape[-k:]), q.expand(batch + q.shape[-k:])


def g1_madd_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = _expand_mixed(p, q)
    X1, Y1, Z1 = p.unbind(-2)
    x2, y2 = q.unbind(-2)
    t0, t1, m3, zx, zy = FP.mont_mul_plain(
        torch.stack([X1, Y1, FP.add_raw(X1, Y1), x2, y2], -2),
        torch.stack([x2, y2, FP.add_raw(x2, y2), Z1, Z1], -2)).unbind(-2)
    t3 = FP.sub(FP.sub(m3, t0), t1)
    t4 = FP.add(zy, Y1)
    bt5 = _mul12(FP.add(zx, X1))
    w = FP.add(FP.double(t0), t0)
    bt2 = _mul12(Z1)
    return _rcb_round2(FP.sub(t1, bt2), FP.add(t1, bt2), t3, t4, w, bt5)


def g1_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p.unbind(-2)
    X2, Y2, Z2 = q.unbind(-2)
    t0, t1, t2, m3, m4, m5 = FP.mont_mul_plain(
        torch.stack([X1, Y1, Z1, FP.add_raw(X1, Y1), FP.add_raw(Y1, Z1), FP.add_raw(X1, Z1)], -2),
        torch.stack([X2, Y2, Z2, FP.add_raw(X2, Y2), FP.add_raw(Y2, Z2), FP.add_raw(X2, Z2)], -2),
    ).unbind(-2)
    t3 = FP.sub(FP.sub(m3, t0), t1)
    t4 = FP.sub(FP.sub(m4, t1), t2)
    bt5 = _mul12(FP.sub(FP.sub(m5, t0), t2))
    w = FP.add(FP.double(t0), t0)
    bt2 = _mul12(t2)
    return _rcb_round2(FP.sub(t1, bt2), FP.add(t1, bt2), t3, t4, w, bt5)


def g1_dbl_plain(p: torch.Tensor) -> torch.Tensor:
    X, Y, Z = p.unbind(-2)
    t0, t1, xy, z2 = FP.mont_mul_plain(torch.stack([Y, Y, X, Z], -2),
                                       torch.stack([Y, Z, Y, Z], -2)).unbind(-2)
    t2 = _mul12(z2)
    e8 = FP.double(FP.double(FP.double(t0)))                   # 8 Y^2
    y3a = FP.add(t0, t2)                                       # Y^2 + 3b Z^2
    t0m = FP.sub(t0, FP.add(FP.double(t2), t2))                # Y^2 - 9b Z^2
    x3b, y3b, x3a, z3 = FP.mont_mul_plain(torch.stack([t0m, t0m, e8, e8], -2),
                                          torch.stack([xy, y3a, t2, t1], -2)).unbind(-2)
    return torch.stack([FP.double(x3b), FP.add(y3b, x3a), z3], -2)


def _launch_rows(lib: str, fn: str, elem: int, *ins: torch.Tensor) -> torch.Tensor:
    """Flatten each point operand to (rows, k, *coordinate) (a coordinate of
    `elem` dims), launch `fn` of the curve library `lib` over the rows, and
    give the projective result the first operand's shape."""
    flat = [_flat(x, 1 + elem) for x in ins]
    out = torch.empty_like(flat[0])
    if out.shape[0]:
        _build.launch(lib, fn, (*flat, out), out.shape[0])
    return out.reshape(ins[0].shape)


def g1_madd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P + (x2 : y2 : 1) for projective p (..., 3, 12) and affine q
    (..., 2, 12), broadcast over the batch."""
    p, q = _expand_mixed(p, q)
    if p.device.type == "cpu":
        return g1_madd_plain(p, q)
    return _launch_rows("curve", "g1_madd", 1, p, q)


def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    if p.device.type == "cpu":
        return g1_add_plain(p, q)
    return _launch_rows("curve", "g1_add", 1, p, q)


def g1_dbl(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return g1_dbl_plain(p)
    return _launch_rows("curve", "g1_dbl", 1, p)


# ---------------------------------------------------------------------------
# K12, K13, K14: complete G2 curve operations over Fp2 (the same RCB15
# formulas, 3b' = 12 xi folded into the operands).  Points are
# (..., 3, 2, 12) [X, Y, Z]; the mixed add's second operand is affine
# (..., 2, 2, 12) [x, y] with Z = 1 implied, never the identity.  Each
# plain version runs the kernel's two product rounds as two stacked K2
# plain calls.
# ---------------------------------------------------------------------------


def _mul12xi(x: torch.Tensor) -> torch.Tensor:
    """12 xi x for Fp2 x: (12 (x0 - x1), 12 (x0 + x1))."""
    return _mul12(mul_xi(x))


def _g2_round2(t1m, z3a, t3, t4, w, bt5) -> torch.Tensor:
    return _rcb_round2(t1m, z3a, t3, t4, w, bt5, mul=fp2_mul_plain, dim=-3)


def g2_madd_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = _expand_mixed(p, q, 2)
    X1, Y1, Z1 = p.unbind(-3)
    x2, y2 = q.unbind(-3)
    t0, t1, m3, zx, zy = fp2_mul_plain(
        torch.stack([X1, Y1, FP.add(X1, Y1), Z1, Z1], -3),
        torch.stack([x2, y2, FP.add(x2, y2), x2, y2], -3)).unbind(-3)
    t3 = FP.sub(FP.sub(m3, t0), t1)
    t4 = FP.add(zy, Y1)
    bt5 = _mul12xi(FP.add(zx, X1))
    w = FP.add(FP.double(t0), t0)
    bt2 = _mul12xi(Z1)
    return _g2_round2(FP.sub(t1, bt2), FP.add(t1, bt2), t3, t4, w, bt5)


def g2_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p.unbind(-3)
    X2, Y2, Z2 = q.unbind(-3)
    t0, t1, t2, m3, m4, m5 = fp2_mul_plain(
        torch.stack([X1, Y1, Z1, FP.add(X1, Y1), FP.add(Y1, Z1), FP.add(X1, Z1)], -3),
        torch.stack([X2, Y2, Z2, FP.add(X2, Y2), FP.add(Y2, Z2), FP.add(X2, Z2)], -3),
    ).unbind(-3)
    t3 = FP.sub(FP.sub(m3, t0), t1)
    t4 = FP.sub(FP.sub(m4, t1), t2)
    bt5 = _mul12xi(FP.sub(FP.sub(m5, t0), t2))
    w = FP.add(FP.double(t0), t0)
    bt2 = _mul12xi(t2)
    return _g2_round2(FP.sub(t1, bt2), FP.add(t1, bt2), t3, t4, w, bt5)


def g2_dbl_plain(p: torch.Tensor) -> torch.Tensor:
    X, Y, Z = p.unbind(-3)
    t0, t1, xy, z2 = fp2_mul_plain(torch.stack([Y, Y, X, Z], -3),
                                   torch.stack([Y, Z, Y, Z], -3)).unbind(-3)
    t2 = _mul12xi(z2)                                          # 3b' Z^2
    e8 = FP.double(FP.double(FP.double(t0)))                   # 8 Y^2
    y3a = FP.add(t0, t2)
    t0m = FP.sub(t0, FP.add(FP.double(t2), t2))
    x3b, y3b, x3a, z3 = fp2_mul_plain(torch.stack([t0m, t0m, e8, e8], -3),
                                      torch.stack([xy, y3a, t2, t1], -3)).unbind(-3)
    return torch.stack([FP.double(x3b), FP.add(y3b, x3a), z3], -3)


def g2_madd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P + (x2 : y2 : 1) for projective p (..., 3, 2, 12) and affine q
    (..., 2, 2, 12), broadcast over the batch."""
    p, q = _expand_mixed(p, q, 2)
    if p.device.type == "cpu":
        return g2_madd_plain(p, q)
    return _launch_rows("curve2", "g2_madd", 2, p, q)


def g2_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    if p.device.type == "cpu":
        return g2_add_plain(p, q)
    return _launch_rows("curve2", "g2_add", 2, p, q)


def g2_dbl(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return g2_dbl_plain(p)
    return _launch_rows("curve2", "g2_dbl", 2, p)
