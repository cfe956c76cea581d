"""Batched G2 = E'(Fp2): y^2 = x^3 + 4(1+i) (M-type twist).

Counterpart of the JAX package's `curves/g2.py` for what the pairing
and G2Vec need: the ops table, the generator and the identity, affine
input, doubling and mixed addition.
"""

from __future__ import annotations

import functools

import torch

from ..fields import fp as FP
from ..fields import tower as TW
from ..params import B_G2, G2_GEN_X, G2_GEN_Y
from . import weierstrass as W

_B3: dict = {}


def _b3(like: torch.Tensor) -> torch.Tensor:
    """3 b' = 12(1+i) in Montgomery form (R = 2^384), on like's device."""
    key = str(like.device)
    t = _B3.get(key)
    if t is None:
        t = _B3[key] = torch.stack([FP.from_int(3 * B_G2[0], like.device),
                                    FP.from_int(3 * B_G2[1], like.device)])
    return t


@functools.lru_cache(maxsize=1)
def ops() -> W.FieldOps:
    return W.FieldOps(
        add=TW.fp2_add,
        sub=TW.fp2_sub,
        mul_many=TW.fp2_mul_many,
        b3_const=_b3,
        neg=TW.fp2_neg,
        is_zero=TW.fp2_is_zero,
        eq=TW.fp2_eq,
        zero=TW.fp2_zero,
        one=TW.fp2_one,
        elem_ndim=2,
    )


def _fp2_from_ints(v, device):
    return torch.stack([FP.from_int(v[0], device), FP.from_int(v[1], device)], -2)


def generator(batch=(), device="cpu"):
    x = _fp2_from_ints(G2_GEN_X, device)
    y = _fp2_from_ints(G2_GEN_Y, device)
    return (x.expand(*batch, 2, -1), y.expand(*batch, 2, -1), TW.fp2_one(batch, device))


def identity(batch=(), device="cpu"):
    return W.identity(ops(), batch, device)


def from_affine_fp2(x_pair, y_pair, device="cpu"):
    """Host Fp2 int pairs (re, im), scalars or lists, to projective points."""
    x = _fp2_from_ints(x_pair, device)
    return (x, _fp2_from_ints(y_pair, device), TW.fp2_one(x.shape[:-2], device))


def double(p):
    return W.double(ops(), p)


def madd(p, q):
    return W.madd(ops(), p, q)
