"""Tower products and G1 curve operations as single kernels (K2-K7), and
the row-stacked Fp12 composites built on the tower kernels.

Counterpart of the JAX package's `fields/fp32k.py`.  Each kernel computes
one whole tower product or curve operation per instance, pre-sums and
combines included, so no intermediate leaves the kernel:

  K2 `fp2_mul` (csrc/tower.cu)  (..., 2, 12) x (..., 2, 12): 3 Fp products
  K3 `fp2_sqr`                  (..., 2, 12):                 2 Fp products
  K4 `fp6_mul`                  (..., 3, 2, 12) x same:      18 Fp products
  K5 `g1_madd` (csrc/g1.cu)     (..., 3, 12) + (..., 2, 12): 11 Fp products
  K6 `g1_add`                   (..., 3, 12) + (..., 3, 12): 12 Fp products
  K7 `g1_dbl`                   (..., 3, 12):                 8 Fp products

Operands are canonical; the outputs are canonical.  A CUDA tensor
launches the kernel, a CPU tensor runs the plain version beside it, which
computes the same canonical value through `fp.mont_mul_plain`.

The composites stack the instances of one Fp12-level operation along the
leading axis into ONE kernel launch, as the TPU path does, and do the
cross-instance combines with the plain modular ops of fields/fp.py.
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
# Row-stacked Fp12 composites.  Inputs (n, 2, 3, 2, 12); the halves of an
# Fp12 x = a + b w are x[:, 0] and x[:, 1].
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor, k: int):
    return list(x.reshape((k, -1) + tuple(x.shape[1:])).unbind(0))


def fp12_mul_c(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fp12 product as ONE fp6_mul launch of 3 stacked instances:
    a*c, b*d, (a+b)*(c+d)."""
    a, b = x[:, 0], x[:, 1]
    c, d = y[:, 0], y[:, 1]
    lhs = torch.cat([a, b, FP.add(a, b)], 0)
    rhs = torch.cat([c, d, FP.add(c, d)], 0)
    t0, t1, m = _split(fp6_mul(lhs, rhs), 3)
    c0 = FP.add(t0, mul_by_v(t1))
    c1 = FP.sub(m, FP.add(t0, t1))
    return torch.stack([c0, c1], 1)


def fp12_sqr_c(x: torch.Tensor) -> torch.Tensor:
    """Fp12 square as one 2-instance fp6_mul launch:
    t = (a+b)(a + v b), m = a b; c0 = t - m - v m, c1 = 2m."""
    a, b = x[:, 0], x[:, 1]
    lhs = torch.cat([FP.add(a, b), a], 0)
    rhs = torch.cat([FP.add(a, mul_by_v(b)), b], 0)
    t, m = _split(fp6_mul(lhs, rhs), 2)
    c0 = FP.sub(t, FP.add(m, mul_by_v(m)))
    return torch.stack([c0, FP.add(m, m)], 1)


def fp12_usqr_c(x: torch.Tensor) -> torch.Tensor:
    """Cyclotomic (Granger-Scott) square as one 9-instance fp2_sqr launch.
    Valid only in the cyclotomic subgroup; as algebra it is the same
    polynomial for any input."""
    a, b = x[:, 0], x[:, 1]
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    X = torch.stack([b1, a2, b2], 1)
    Y = torch.stack([a0, b0, a1], 1)
    ops = torch.stack([X, Y, FP.add(X, Y)], 0)          # (3, n, 3, 2, 12)
    sq = fp2_sqr(ops)
    x2, y2, s = sq[0], sq[1], sq[2]
    cross = FP.sub(s, FP.add(x2, y2))                    # 2XY: t6, t7, t8'
    t8 = mul_xi(cross[:, 2])
    T = torch.stack([t8, cross[:, 0], cross[:, 1]], 1)   # (t8, t6, t7)
    U = FP.add(mul_xi(x2), y2)                           # xi X^2 + Y^2
    c0 = FP.sub(FP.mul_small(U, 3), FP.double(a))
    c1 = FP.add(FP.mul_small(T, 3), FP.double(b))
    return torch.stack([c0, c1], 1)


def sparse_mul_c(f: torch.Tensor, c0: torch.Tensor, c3: torch.Tensor,
                 c5: torch.Tensor) -> torch.Tensor:
    """f * (c0 + c3 w^3 + c5 w^5) as one 15-instance fp2_mul launch.
    f: (n, 2, 3, 2, 12); c0, c3, c5: (n, 2, 12)."""
    a, b = f[:, 0], f[:, 1]
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    s = FP.add(a, b)
    s0, s1, s2 = s[:, 0], s[:, 1], s[:, 2]
    s01, s12, s02 = FP.add(torch.stack([s0, s1, s0]), torch.stack([s1, s2, s2])).unbind(0)
    c03, c35, c05 = FP.add(torch.stack([c0, c3, c0]), torch.stack([c3, c5, c5])).unbind(0)
    lhs = torch.stack([a0, a1, a2, b1, b2, b0, b2, b0, b1, s0, s1, s2, s01, s12, s02])
    rhs = torch.stack([c0, c0, c0, c5, c3, c3, c5, c5, c3, c0, c3, c5, c03, c35, c05])
    (t00, t01, t02, u0, u1, u2, u3, u4, u5,
     v0, v1, v2, v01, v12, v02) = fp2_mul(lhs, rhs).unbind(0)
    t1_0 = mul_xi(FP.add(u0, u1))
    t1_1 = FP.add(u2, mul_xi(u3))
    t1_2 = FP.add(u4, u5)
    m_0 = FP.add(v0, mul_xi(FP.sub(v12, FP.add(v1, v2))))
    m_1 = FP.add(FP.sub(v01, FP.add(v0, v1)), mul_xi(v2))
    m_2 = FP.add(FP.sub(v02, FP.add(v0, v2)), v1)
    t0 = torch.stack([t00, t01, t02], 1)
    t1 = torch.stack([t1_0, t1_1, t1_2], 1)
    m = torch.stack([m_0, m_1, m_2], 1)
    out0 = FP.add(t0, mul_by_v(t1))
    out1 = FP.sub(m, FP.add(t0, t1))
    return torch.stack([out0, out1], 1)


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


def _rcb_round2(t1m, z3a, t3, t4, w, bt5) -> torch.Tensor:
    """X3 = t1m t3 - bt5 t4, Y3 = t1m z3a + bt5 w, Z3 = z3a t4 + w t3."""
    c = FP.mont_mul_plain(torch.stack([t1m, bt5, t1m, bt5, z3a, w], -2),
                          torch.stack([t3, t4, z3a, w, t4, t3], -2)).unbind(-2)
    return torch.stack([FP.sub(c[0], c[1]), FP.add(c[2], c[3]), FP.add(c[4], c[5])], -2)


def _expand_mixed(p: torch.Tensor, q: torch.Tensor):
    """Broadcast the batch dims of a projective and an affine point."""
    batch = torch.broadcast_shapes(p.shape[:-2], q.shape[:-2])
    return p.expand(batch + p.shape[-2:]), q.expand(batch + q.shape[-2:])


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


def _launch_rows(fn: str, out_shape, *ins: torch.Tensor) -> torch.Tensor:
    """Flatten each operand to (rows, k, 12), launch `fn` of the curve
    library over the rows, and shape the (rows, 3, 12) result."""
    flat = [_flat(x, 2) for x in ins]
    out = torch.empty((flat[0].shape[0], 3, flat[0].shape[-1]), dtype=torch.int32,
                      device=flat[0].device)
    if out.shape[0]:
        _build.launch("curve", fn, (*flat, out), out.shape[0])
    return out.reshape(out_shape)


def g1_madd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P + (x2 : y2 : 1) for projective p (..., 3, 12) and affine q
    (..., 2, 12), broadcast over the batch."""
    p, q = _expand_mixed(p, q)
    if p.device.type == "cpu":
        return g1_madd_plain(p, q)
    return _launch_rows("g1_madd", p.shape, p, q)


def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    if p.device.type == "cpu":
        return g1_add_plain(p, q)
    return _launch_rows("g1_add", p.shape, p, q)


def g1_dbl(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return g1_dbl_plain(p)
    return _launch_rows("g1_dbl", p.shape, p)
