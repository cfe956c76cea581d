"""Batched G1 = E(Fp): y^2 = x^3 + 4.

Counterpart of the JAX package's `curves/g1.py`.  Points are tuples
(X, Y, Z) of Fp tensors (..., 12).  The ops table sends every complete
addition, mixed addition and doubling to the single-kernel operations of
fields/fused.py (K6, K5, K7): CUDA kernels on the card, their plain
versions on the CPU.  Other products (the affine conversion, the
endomorphism, equality) go through K1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as FP
from ..fields import fused as FK
from ..params import B_G1, G1_GEN_X, G1_GEN_Y, H_EFF_G1, X_ABS
from . import weierstrass as W

_B3: dict = {}


def _b3(like: torch.Tensor) -> torch.Tensor:
    """3b = 12 in Montgomery form (R = 2^384), on like's device."""
    key = str(like.device)
    if key not in _B3:
        _B3[key] = FP.from_int(3 * B_G1, like.device)
    return _B3[key]


def _mul_many(pairs):
    """The products of a list of (a, b): one K1 launch."""
    a = torch.stack(torch.broadcast_tensors(*[x for x, _ in pairs]), -2)
    b = torch.stack(torch.broadcast_tensors(*[y for _, y in pairs]), -2)
    return list(FP.mont_mul(a, b).unbind(-2))


@functools.lru_cache(maxsize=1)
def ops() -> W.FieldOps:
    return W.FieldOps(
        add=FP.add,
        sub=FP.sub,
        mul_many=_mul_many,
        b3_const=_b3,
        neg=FP.neg,
        is_zero=FP.is_zero,
        eq=FP.eq,
        zero=FP.zero,
        one=FP.one,
        elem_ndim=1,
        fused_add=lambda p, q: W.on_stacked(ops(), FK.g1_add, p, q),
        fused_madd=lambda p, q: W.on_stacked(ops(), FK.g1_madd, p, q),
        fused_dbl=lambda p: W.on_stacked(ops(), FK.g1_dbl, p),
        inv=FP.inv,
    )


# -- constructors ------------------------------------------------------------


def generator(batch=(), device="cpu"):
    batch = tuple(batch)
    x = FP.from_int(G1_GEN_X, device)
    y = FP.from_int(G1_GEN_Y, device)
    return (x.expand(batch + x.shape), y.expand(batch + y.shape), FP.one(batch, device))


def identity(batch=(), device="cpu"):
    return W.identity(ops(), tuple(batch), device)


def from_affine_ints(xs, ys, device="cpu"):
    """Host ints (scalars or lists) -> projective points with Z = 1."""
    x = FP.from_int(xs, device)
    return (x, FP.from_int(ys, device), FP.one(x.shape[:-1], device))


# -- group ops ---------------------------------------------------------------


def add(p, q):
    return W.add(ops(), p, q)


def double(p):
    return W.double(ops(), p)


def madd(p, q):
    return W.madd(ops(), p, q)


def neg(p):
    return W.negate(ops(), p)


def eq(p, q):
    return W.eq(ops(), p, q)


def is_identity(p):
    return W.is_identity(ops(), p)


def on_curve(p):
    return W.on_curve(ops(), p)


def scalar_mul(p, e_std):
    """[e]P; e_std: Fr standard-domain limbs (..., 18).  The GLV ladder:
    128 doublings and 128 complete adds."""
    from . import endo

    return endo.glv_mul_g1(ops(), p, e_std)


def scalar_mul_plain(p, e_std, n_bits: int = 255):
    """[e]P by plain double-and-add over n_bits bits (a differential
    oracle for scalar_mul)."""
    return W.scalar_mul(ops(), p, e_std, n_bits)


def mul_int(p, k: int):
    """[k]P for a host integer k (no reduction mod r; cofactors)."""
    if k == 0:
        return identity(p[0].shape[:-1], p[0].device)
    return W.mul_const_chain(ops(), p, k)


def clear_cofactor(p):
    """Effective cofactor clearing: [1 + |x|]P."""
    return mul_int(p, H_EFF_G1)


def in_subgroup(p):
    """Endomorphism subgroup check: phi(P) == [x^2 - 1]P (the eigenvalue
    of this package's beta), on the curve, and [x]P != P to reject low
    order points; two |x| chains of K7 and K6.  The identity is a member."""
    from . import endo

    o = ops()
    xp = W.mul_const_chain(o, p, X_ABS)
    low = W.eq(o, xp, p)
    x2p = W.mul_const_chain(o, xp, X_ABS)
    t = W.add(o, x2p, W.negate(o, p))                     # [x^2 - 1]P
    member = W.eq(o, endo.phi_g1(p), t) & ~low & on_curve(p)
    return member | is_identity(p)


# -- affine / host conversion ------------------------------------------------


def to_affine(p):
    """(x, y, inf_mask): Montgomery-form affine coordinates by one K1
    inversion chain; identity rows give (0, 0) and inf True."""
    X, Y, Z = p
    zi = FP.inv(Z)
    x, y = _mul_many([(X, zi), (Y, zi)])
    return x, y, is_identity(p)


def to_affine_ints(p):
    """Host ints: a tuple (x, y) or None for one point, else an object
    array of them over the batch shape."""
    x, y, inf = to_affine(p)
    xi, yi = FP.to_int(x), FP.to_int(y)
    inf = inf.cpu().numpy()
    if inf.shape == ():
        return None if bool(inf) else (int(xi), int(yi))
    out = np.empty(inf.shape, object)
    for idx in np.ndindex(inf.shape):
        out[idx] = None if bool(inf[idx]) else (int(xi[idx]), int(yi[idx]))
    return out
