"""Batched short-Weierstrass group law (y^2 = x^3 + b, a = 0).

Counterpart of the JAX package's `curves/weierstrass.py`: the complete
homogeneous-projective formulas of Renes-Costello-Batina 2015 (one
branch-free formula per operation, identity included), over a pluggable
field-ops table.  Points are (X, Y, Z): x = X/Z, y = Y/Z; identity is
(0, 1, 0).

Each `mul_many` call is one multiplication round; for G2 it is one K2
launch with the round's products stacked (the TPU path's g2_dbl_c and
g2_madd_c composites are these same three rounds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class FieldOps:
    """Field operation table for one coefficient field."""

    add: Callable
    sub: Callable
    mul_many: Callable            # list[(a, b)] -> list[product]
    b3_const: Callable            # like-tensor -> 3b as a field element


def double(ops: FieldOps, p):
    """Dedicated exception-free doubling (RCB15 Alg. 9, j-invariant 0):
    X3 = 2XY(Y^2 - 9bZ^2); Y3 = (Y^2 - 9bZ^2)(Y^2 + 3bZ^2) + 24bY^2Z^2;
    Z3 = 8Y^3Z.  Three multiplication rounds."""
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
    q must not be the identity.  Three multiplication rounds."""
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
