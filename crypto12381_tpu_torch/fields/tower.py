"""Batched Fp2/Fp6/Fp12 tower arithmetic.

Counterpart of the JAX package's `fields/tower.py`, with the same tower
(v^3 = xi = 1+i, w^2 = v) and the same layout with L = 12:
  Fp2  : (..., 2, 12)        [re, im]
  Fp6  : (..., 3, 2, 12)     coefficients of 1, v, v^2
  Fp12 : (..., 2, 3, 2, 12)  coefficients of 1, w

Every product of one tower operation is stacked into one kernel launch:
Fp2 products into K2, squares into K3, Fp6 products into K4, and each
Fp12 product, square and cyclotomic square is one launch of K8, K9 or K10
(fields/fused.py).  Products by an Fp element (line evaluation) and the
inversion chain go through K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import field as HF
from ..params import LIMBS, P
from . import fp as FP
from . import fused as FK

# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

fp2_add = FP.add
fp2_sub = FP.sub
fp2_neg = FP.neg
fp2_mul_small = FP.mul_small
fp2_mul_xi = FK.mul_xi
fp2_mul = FK.fp2_mul


def fp2_conj(a):
    return torch.stack([a[..., 0, :], FP.neg(a[..., 1, :])], -2)


def fp2_mul_fp(a, s):
    """Both coefficients of a times an Fp element s (..., 12): K1."""
    return FP.mont_mul(a, s[..., None, :])


def _stack_many(items):
    """Broadcast a list of tensors and stack them on a new leading axis."""
    return torch.stack(torch.broadcast_tensors(*items), 0)


def fp2_mul_many(pairs):
    """Karatsuba Fp2 products for a list of (a, b): one K2 launch."""
    k = len(pairs)
    st = _stack_many([c for pr in pairs for c in pr])
    st = st.reshape((k, 2) + tuple(st.shape[1:]))
    return list(FK.fp2_mul(st[:, 0], st[:, 1]).unbind(0))


def fp2_sqr_many(elems):
    """Squares of a list of Fp2 elements: one K3 launch."""
    return list(FK.fp2_sqr(_stack_many(elems)).unbind(0))


def fp2_inv(a):
    """1/(a0 + a1 i) = (a0 - a1 i) / (a0^2 + a1^2): K1 products and the
    K1 inversion chain."""
    t = FP.mont_mul(a, a)
    di = FP.inv(FP.add(t[..., 0, :], t[..., 1, :]))
    o = FP.mont_mul(a, di[..., None, :])
    return torch.stack([o[..., 0, :], FP.neg(o[..., 1, :])], -2)


def fp2_eq(a, b):
    return torch.all(a == b, dim=-1).all(-1)


def fp2_is_zero(a):
    return torch.all(a == 0, dim=-1).all(-1)


def fp2_zero(batch=(), device="cpu"):
    return FP.zero(tuple(batch) + (2,), device)


def fp2_one(batch=(), device="cpu"):
    return torch.stack([FP.one(batch, device), FP.zero(batch, device)], -2)


# ---------------------------------------------------------------------------
# Fp6 (c0 + c1 v + c2 v^2)
# ---------------------------------------------------------------------------

fp6_mul_by_v = FK.mul_by_v


def fp6_stack(c0, c1, c2):
    return torch.stack([c0, c1, c2], -3)


def fp6_mul_many(pairs):
    """Any number of Fp6 products: one K4 launch."""
    k = len(pairs)
    st = _stack_many([c for pr in pairs for c in pr])
    st = st.reshape((k, 2) + tuple(st.shape[1:]))
    return list(FK.fp6_mul(st[:, 0], st[:, 1]).unbind(0))


def fp6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    s0, s1, s2, s12, s01, s02 = fp2_mul_many(
        [(a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)])
    t0 = FP.sub(s0, fp2_mul_xi(s12))
    t1 = FP.sub(fp2_mul_xi(s2), s01)
    t2 = FP.sub(s1, s02)
    p0, p1, p2 = fp2_mul_many([(a0, t0), (a2, t1), (a1, t2)])
    d = FP.add(p0, fp2_mul_xi(FP.add(p1, p2)))
    di = fp2_inv(d)
    return fp6_stack(*fp2_mul_many([(t0, di), (t1, di), (t2, di)]))


def fp6_zero(batch=(), device="cpu"):
    return FP.zero(tuple(batch) + (3, 2), device)


def fp6_one(batch=(), device="cpu"):
    return fp6_stack(fp2_one(batch, device), fp2_zero(batch, device),
                     fp2_zero(batch, device))


# ---------------------------------------------------------------------------
# Fp12 (a + b w)
# ---------------------------------------------------------------------------


def fp12_stack(a, b):
    return torch.stack([a, b], -4)


#: K8, K9, K10 (fields/fused.py); any broadcast batch shape.  The cyclotomic
#: square is valid ONLY in the cyclotomic subgroup (everything past the
#: easy part of the final exponentiation).
fp12_mul = FK.fp12_mul
fp12_sqr = FK.fp12_sqr
fp12_usqr = FK.fp12_usqr


def fp12_conj(x):
    return fp12_stack(x[..., 0, :, :, :], FP.neg(x[..., 1, :, :, :]))


def fp12_inv(x):
    a, b = x[..., 0, :, :, :], x[..., 1, :, :, :]
    t0, t1 = fp6_mul_many([(a, a), (b, b)])
    di = fp6_inv(FP.sub(t0, fp6_mul_by_v(t1)))
    o0, o1 = fp6_mul_many([(a, di), (b, di)])
    return fp12_stack(o0, FP.neg(o1))


def fp12_eq(x, y):
    return torch.all((x == y).reshape(x.shape[:-4] + (-1,)), dim=-1)


def fp12_one(batch=(), device="cpu"):
    return fp12_stack(fp6_one(batch, device), fp6_zero(batch, device))


def fp12_is_one(x):
    return fp12_eq(x, fp12_one(x.shape[:-4], x.device))


# --------------------------------------------------------------- w-basis

#: position of w-basis coefficient C_k in the (2, 3) = (half, v-power) grid:
#: C0=a.c0, C1=b.c0, C2=a.c1, C3=b.c1, C4=a.c2, C5=b.c2
_W_POS = [(k % 2, k // 2) for k in range(6)]


def fp12_coeffs_w(x):
    return [x[..., h, c, :, :] for h, c in _W_POS]


def fp12_from_coeffs_w(cs):
    return fp12_stack(fp6_stack(cs[0], cs[2], cs[4]), fp6_stack(cs[1], cs[3], cs[5]))


# ------------------------------------------------------------- Frobenius

_GAMMAS: dict = {}


def frob_gammas(n: int) -> np.ndarray:
    """gamma_{n,k} = xi^(k (p^n - 1)/6) for k = 0..5 as (6, 2, 12)
    Montgomery limbs (R = 2^384), computed once on the host with exact
    integers."""
    got = _GAMMAS.get(n)
    if got is None:
        gamma = HF.fp2_pow((1, 1), (pow(P, n) - 1) // 6)
        acc = HF.FP2_ONE
        rows = []
        for _ in range(6):
            rows.append(np.stack([FP.mont_const(acc[0]), FP.mont_const(acc[1])]))
            acc = HF.fp2_mul(acc, gamma)
        got = _GAMMAS[n] = np.stack(rows)
    return got


def _gammas_on(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    t = _GAMMAS.get(key)
    if t is None:
        t = _GAMMAS[key] = torch.from_numpy(frob_gammas(n)).to(device)
    return t


def fp12_frob(x, n: int = 1):
    """x -> x^(p^n): C_k -> conj^n(C_k) * gamma_{n,k}, the 6 products in
    one K2 launch."""
    cs = torch.stack(fp12_coeffs_w(x), -3)           # (..., 6, 2, 12)
    if n % 2 == 1:
        cs = fp2_conj(cs)
    out = fp2_mul(cs, _gammas_on(n, x.device))
    return fp12_from_coeffs_w(list(out.unbind(-3)))


# ----------------------------------------------------- host conversions


def fp12_to_host(x):
    """(2, 3, 2, 12) tensor -> host Fp12 tuple; with batch dims, a list."""
    if x.dim() > 4:
        return [fp12_to_host(r) for r in x.reshape((-1, 2, 3, 2, LIMBS))]
    cs = tuple((int(FP.to_int(c[0])), int(FP.to_int(c[1]))) for c in fp12_coeffs_w(x))
    return HF.fp12_from_coeffs_w(cs)
