"""Batched short-Weierstrass group law (y^2 = x^3 + b, a = 0).

Counterpart of the JAX package's `curves/weierstrass.py`: the complete
homogeneous-projective formulas of Renes-Costello-Batina 2015 (one
branch-free formula per operation, identity included), over a pluggable
field-ops table.  Points are tuples (X, Y, Z): x = X/Z, y = Y/Z; identity
is (0, 1, 0).

A table with `fused_add`, `fused_madd` and `fused_dbl` sends every
addition, mixed addition and doubling to those single-kernel operations
(G1's: K6, K5, K7; G2's: K12, K13, K14).  Both tables have them; without
them (a table made without, as the tests make one) each `mul_many` call is
one multiplication round, over Fp2 one K2 launch with the round's
products stacked (the TPU path's `g2_add_c`, `g2_madd_c` and `g2_dbl_c`
composites are these same three rounds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class FieldOps:
    """Field operation table for one coefficient field."""

    add: Callable
    sub: Callable
    mul_many: Callable            # list[(a, b)] -> list[product]
    b3_const: Callable            # like-tensor -> 3b as a field element
    neg: Optional[Callable] = None
    is_zero: Optional[Callable] = None    # element -> bool over the batch
    eq: Optional[Callable] = None         # elements -> bool over the batch
    zero: Optional[Callable] = None       # (batch, device) -> element
    one: Optional[Callable] = None        # (batch, device) -> element
    #: element dims past the batch dims (1 for Fp (12,), 2 for Fp2 (2, 12))
    elem_ndim: int = 1
    #: single-kernel complete add (p, q) -> p + q
    fused_add: Optional[Callable] = None
    #: single-kernel mixed add (p, (x2, y2)) with Z2 = 1 implied
    fused_madd: Optional[Callable] = None
    #: single-kernel dedicated doubling
    fused_dbl: Optional[Callable] = None
    #: field inversion (Fermat chain), for the MSM's batch inversion
    inv: Optional[Callable] = None


def stack_point(ops: FieldOps, p) -> torch.Tensor:
    """(X, Y, Z) -> one tensor (..., 3, *elem)."""
    return torch.stack(torch.broadcast_tensors(*p), -1 - ops.elem_ndim)


def unstack_point(ops: FieldOps, t: torch.Tensor):
    """(..., k, *elem) -> tuple of its k coordinates (views)."""
    return t.unbind(-1 - ops.elem_ndim)


def on_stacked(ops: FieldOps, kernel, *points):
    """A single-kernel point operation (stacked (..., k, *elem) tensors in
    and out) on points given as coordinate tuples."""
    return unstack_point(ops, kernel(*(stack_point(ops, p) for p in points)))


def identity(ops: FieldOps, batch=(), device="cpu"):
    return (ops.zero(batch, device), ops.one(batch, device), ops.zero(batch, device))


def is_identity(ops: FieldOps, p):
    return ops.is_zero(p[2])


def negate(ops: FieldOps, p):
    return (p[0], ops.neg(p[1]), p[2])


def select_point(ops: FieldOps, mask, p, q):
    """Row-wise p where mask else q; mask has the batch shape."""
    m = mask.reshape(mask.shape + (1,) * ops.elem_ndim)
    return tuple(torch.where(m, a, b) for a, b in zip(p, q))


def add(ops: FieldOps, p, q):
    """Complete addition (RCB15 Alg. 7): 14 field products in three rounds
    here; the kernels K6 and K12 fold 3b into their operands (12 products,
    two rounds)."""
    if ops.fused_add is not None:
        return ops.fused_add(p, q)
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, m3, m4, m5 = ops.mul_many([
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (ops.add(X1, Y1), ops.add(X2, Y2)),
        (ops.add(Y1, Z1), ops.add(Y2, Z2)),
        (ops.add(X1, Z1), ops.add(X2, Z2)),
    ])
    t3 = ops.sub(m3, ops.add(t0, t1))        # X1Y2 + X2Y1
    t4 = ops.sub(m4, ops.add(t1, t2))        # Y1Z2 + Y2Z1
    t5 = ops.sub(m5, ops.add(t0, t2))        # X1Z2 + X2Z1
    w = ops.add(ops.add(t0, t0), t0)         # 3 X1X2
    b3 = ops.b3_const(X1)
    bt2, bt5 = ops.mul_many([(b3, t2), (b3, t5)])
    z3a = ops.add(t1, bt2)                   # Y1Y2 + 3b Z1Z2
    t1m = ops.sub(t1, bt2)                   # Y1Y2 - 3b Z1Z2
    c = ops.mul_many([(t3, t1m), (t4, bt5), (bt5, w), (t1m, z3a), (w, t3), (z3a, t4)])
    return (ops.sub(c[0], c[1]), ops.add(c[3], c[2]), ops.add(c[5], c[4]))


def double(ops: FieldOps, p):
    """Dedicated exception-free doubling (RCB15 Alg. 9, j-invariant 0):
    X3 = 2XY(Y^2 - 9bZ^2); Y3 = (Y^2 - 9bZ^2)(Y^2 + 3bZ^2) + 24bY^2Z^2;
    Z3 = 8Y^3Z.  Three multiplication rounds, or K7 (G1) and K14 (G2)."""
    if ops.fused_dbl is not None:
        return ops.fused_dbl(p)
    X, Y, Z = p
    t0, t1, xy, z2 = ops.mul_many([(Y, Y), (Y, Z), (X, Y), (Z, Z)])
    (t2,) = ops.mul_many([(ops.b3_const(z2), z2)])
    t0_2 = ops.add(t0, t0)
    t0_4 = ops.add(t0_2, t0_2)
    z3_8y2 = ops.add(t0_4, t0_4)                       # 8 Y^2
    y3a = ops.add(t0, t2)                              # Y^2 + 3bZ^2
    t0m = ops.sub(t0, ops.add(ops.add(t2, t2), t2))    # Y^2 - 9bZ^2
    x3a, z3, y3b, x3b = ops.mul_many(
        [(t2, z3_8y2), (t1, z3_8y2), (t0m, y3a), (t0m, xy)])
    return (ops.add(x3b, x3b), ops.add(y3b, x3a), z3)


def madd(ops: FieldOps, p, q):
    """Mixed complete addition p + (X2 : Y2 : 1) (RCB15 Alg. 7 with Z2 = 1).
    q must not be the identity, which has no Z = 1 form.  Three
    multiplication rounds, or K5 (G1) and K13 (G2)."""
    if ops.fused_madd is not None:
        return ops.fused_madd(p, q)
    X1, Y1, Z1 = p
    X2, Y2 = q
    t0, t1, m3, zx, zy = ops.mul_many(
        [(X1, X2), (Y1, Y2), (ops.add(X1, Y1), ops.add(X2, Y2)), (X2, Z1), (Y2, Z1)])
    t3 = ops.sub(m3, ops.add(t0, t1))        # X1Y2 + X2Y1
    t4 = ops.add(zy, Y1)                     # Y1Z2 + Y2Z1
    t5 = ops.add(zx, X1)                     # X1Z2 + X2Z1
    w = ops.add(ops.add(t0, t0), t0)         # 3 X1X2
    b3 = ops.b3_const(Z1)
    bt2, bt5 = ops.mul_many([(b3, Z1), (b3, t5)])
    z3a = ops.add(t1, bt2)
    t1m = ops.sub(t1, bt2)
    c = ops.mul_many([(t3, t1m), (t4, bt5), (bt5, w), (t1m, z3a), (w, t3), (z3a, t4)])
    return (ops.sub(c[0], c[1]), ops.add(c[3], c[2]), ops.add(c[5], c[4]))


def eq(ops: FieldOps, p, q):
    """Projective equality: X1Z2 == X2Z1 and Y1Z2 == Y2Z1, with the
    identity (Z == 0) equal only to itself."""
    m = ops.mul_many([(p[0], q[2]), (q[0], p[2]), (p[1], q[2]), (q[1], p[2])])
    cross = ops.eq(m[0], m[1]) & ops.eq(m[2], m[3])
    i1, i2 = is_identity(ops, p), is_identity(ops, q)
    return torch.where(i1 | i2, i1 & i2, cross)


def on_curve(ops: FieldOps, p):
    """Y^2 Z == X^3 + b Z^3 (the identity passes), compared times 3."""
    X, Y, Z = p
    y2, x2, z2 = ops.mul_many([(Y, Y), (X, X), (Z, Z)])
    y2z, x3, z3 = ops.mul_many([(y2, Z), (x2, X), (z2, Z)])
    (bz3,) = ops.mul_many([(ops.b3_const(z3), z3)])     # 3b Z^3
    lhs = ops.add(ops.add(y2z, y2z), y2z)
    rhs = ops.add(ops.add(ops.add(x3, x3), x3), bz3)
    return ops.eq(lhs, rhs)


def scalar_bits(e_std: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Standard-domain Fr limbs (..., 18) of 16 bits -> bits (..., n_bits),
    least significant first."""
    idx = torch.arange(n_bits, device=e_std.device)
    return (e_std[..., idx // 16].to(torch.int64) >> (idx % 16)) & 1


def scalar_mul_bits(ops: FieldOps, p, bits: torch.Tensor):
    """Double-and-add over a bit tensor (..., n), most significant bit
    first, the add selected branch-free; a plain Python loop over n."""
    acc = identity(ops, bits.shape[:-1], bits.device)
    for i in range(bits.shape[-1] - 1, -1, -1):
        acc = double(ops, acc)
        acc = select_point(ops, bits[..., i] != 0, add(ops, acc, p), acc)
    return acc


def scalar_mul(ops: FieldOps, p, e_std: torch.Tensor, n_bits: int = 255):
    return scalar_mul_bits(ops, p, scalar_bits(e_std, n_bits))


def mul_const_chain(ops: FieldOps, p, k: int):
    """[k]P for a host constant k > 0 as a static double-and-add chain:
    only k's set bits pay an addition (k = |x|: 63 doublings, 5 adds)."""
    assert k > 0
    acc = p
    for bit in bin(k)[3:]:
        acc = double(ops, acc)
        if bit == "1":
            acc = add(ops, acc, p)
    return acc
