"""Batched G2 = E'(Fp2): y^2 = x^3 + 4(1+i) (M-type twist).

Counterpart of the JAX package's `curves/g2.py`: the ops table, the
generator and the identity, affine input, the group law, the GS scalar
multiplication, the subgroup check, cofactor clearing and the affine
conversion.  The ops table sends every complete addition, mixed addition
and doubling to the single-kernel operations of fields/fused.py (K12,
K13, K14): the JAX package's Pallas programs `prog_g2_add`,
`prog_g2_madd` and `prog_g2_dbl`, which the TPU could not compile and ran
as three stacked K2 rounds instead.  CUDA kernels on the card, their
plain versions on the CPU.  Other products (the affine conversion, psi,
equality, the curve check) are K2 launches with a round's Fp2 products
stacked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as FP
from ..fields import fused as FK
from ..fields import tower as TW
from ..params import B_G2, G2_GEN_X, G2_GEN_Y, X_ABS
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
        fused_add=lambda p, q: W.on_stacked(ops(), FK.g2_add, p, q),
        fused_madd=lambda p, q: W.on_stacked(ops(), FK.g2_madd, p, q),
        fused_dbl=lambda p: W.on_stacked(ops(), FK.g2_dbl, p),
        inv=TW.fp2_inv,
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
    """[e]Q; e_std: Fr standard-domain limbs (..., 18).  The 4-dimensional
    GS ladder: 64 doublings and 64 complete adds over a 16-entry table."""
    from . import endo

    return endo.gs_mul_g2(ops(), p, e_std)


def scalar_mul_plain(p, e_std, n_bits: int = 255):
    """[e]Q by plain double-and-add over n_bits bits (a differential
    oracle for scalar_mul)."""
    return W.scalar_mul(ops(), p, e_std, n_bits)


def mul_int(p, k: int):
    """[k]Q for a host integer k (no reduction mod r; cofactors): from the
    identity, a doubling per bit of k and an add per set bit, the JAX
    package's sequence (so its projective values too)."""
    acc = identity(p[0].shape[:-2], p[0].device)
    for bit in bin(k)[2:] if k else ():
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def in_subgroup(p):
    """Membership in G2: psi(Q) == [x]Q, i.e. psi(Q) + [|x|]Q == O (x is
    negative), and Q on the twist; one 64-bit chain and one psi instead of
    a full [r]Q.  The identity is a member."""
    from . import endo

    o = ops()
    chk = W.add(o, endo.psi_g2(p), W.mul_const_chain(o, p, X_ABS))
    return W.is_identity(o, chk) & on_curve(p)


def clear_cofactor(p):
    """Budroni-Pintore cofactor clearing,
    h(Q) = [x^2 - x - 1]Q + [x - 1]psi(Q) + psi^2([2]Q), with the two |x|
    chains shared (x = -|x|)."""
    from . import endo

    o = ops()
    t0 = mul_int(p, X_ABS)                                 # [-x]Q
    t1 = mul_int(t0, X_ABS)                                # [x^2]Q
    a = W.add(o, W.add(o, t1, t0), W.negate(o, p))         # [x^2 - x - 1]Q
    b = endo.psi_g2(W.negate(o, W.add(o, t0, p)))          # psi([x - 1]Q)
    c = endo.psi_g2(endo.psi_g2(W.double(o, p)))           # psi^2([2]Q)
    return W.add(o, W.add(o, a, b), c)


# -- affine / host conversion ------------------------------------------------


def to_affine(p):
    """(x, y, inf_mask): Montgomery-form affine coordinates through one K1
    inversion chain (TW.fp2_inv); identity rows give (0, 0) and inf True."""
    X, Y, Z = p
    zi = TW.fp2_inv(Z)
    x, y = TW.fp2_mul_many([(X, zi), (Y, zi)])
    return x, y, is_identity(p)


def to_affine_ints(p):
    """Host ints: ((xr, xi), (yr, yi)) or None for one point, else an
    object array of them over the batch shape."""
    x, y, inf = to_affine(p)
    xi, yi = FP.to_int(x), FP.to_int(y)
    inf = inf.cpu().numpy()

    def pt(idx):
        if bool(inf[idx]):
            return None
        return ((int(xi[idx + (0,)]), int(xi[idx + (1,)])),
                (int(yi[idx + (0,)]), int(yi[idx + (1,)])))

    if inf.shape == ():
        return pt(())
    out = np.empty(inf.shape, object)
    for idx in np.ndindex(inf.shape):
        out[idx] = pt(idx)
    return out
