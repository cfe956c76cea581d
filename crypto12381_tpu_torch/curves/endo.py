"""Endomorphism scalar multiplication: GLV on G1, Galbraith-Scott on G2.

Counterpart of the JAX package's `curves/endo.py` (`_beta_limbs`,
`_psi_consts`, `phi_g1`, `psi_g2`, `_subset_table`, `_gather`, `_shamir`,
`glv_mul_g1`, `gs_mul_g2`).  On G1 the scalar splits on the device as
e = k1 + lambda k2 (ops/scalar_decomp.py), and both half-scalars walk ONE
shared Shamir ladder over the table {O, P, phi(P), P + phi(P)}: 128 steps
of one doubling (K7) and one complete addition (K6) each, with a row-wise
table gather per step.  On G2 the scalar splits into four 64-bit digits,
e = sum_i d_i |x|^i, and the digits walk one ladder of 64 steps over the
16 subset sums of {Q, -psi(Q), psi^2(Q), -psi^3(Q)}: each step a doubling
(K14) and a complete add (K12) over Fp2.  The complete
formulas need no branch for identity entries or equal points.

  phi(x, y) = (beta x, y) = [lambda] P on G1, lambda = x^2 - 1, beta a cube
  root of unity in Fp.
  psi(x, y) = (c_x conj(x), c_y conj(y)) = [x] Q on G2 (untwist, Frobenius,
  twist).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as FP
from ..fields import tower as TW
from ..host import field as HF
from ..ops import scalar_decomp as SD
from ..params import P
from . import weierstrass as W


@functools.lru_cache(maxsize=1)
def _beta_limbs() -> np.ndarray:
    """beta = (2^((p-1)/3))^2, the cube root of unity whose phi is
    [lambda] (the JAX package's choice), in Montgomery form for the port's
    R = 2^384."""
    beta = pow(pow(2, (P - 1) // 3, P), 2, P)
    return FP.mont_const(beta)


@functools.lru_cache(maxsize=1)
def _psi_consts() -> tuple[np.ndarray, np.ndarray]:
    """(c_x, c_y) = (xi^-((p-1)/3), xi^-((p-1)/2)), xi = 1 + i, as (2, 12)
    Fp2 Montgomery limbs for the port's R = 2^384."""
    xi = (1, 1)
    cx = HF.fp2_inv(HF.fp2_pow(xi, (P - 1) // 3))
    cy = HF.fp2_inv(HF.fp2_pow(xi, (P - 1) // 2))
    return tuple(np.stack([FP.mont_const(v) for v in c]) for c in (cx, cy))


def phi_g1(p):
    """(X, Y, Z) -> (beta X, Y, Z): one K1 launch."""
    X, Y, Z = p
    b = torch.from_numpy(_beta_limbs()).to(X.device)
    return (FP.mont_mul(X, b.expand_as(X)), Y, Z)


def psi_g2(q):
    """Projective psi: (c_x conj(X), c_y conj(Y), conj(Z)); both products
    in one K2 launch."""
    X, Y, Z = q
    cx, cy = (torch.from_numpy(c).to(X.device) for c in _psi_consts())
    Xc, Yc = TW.fp2_mul_many([(TW.fp2_conj(X), cx), (TW.fp2_conj(Y), cy)])
    return (Xc, Yc, TW.fp2_conj(Z))


def _subset_table(ops: W.FieldOps, bases):
    """All 2^n subset sums of `bases` stacked as (2^n, ...batch, 3, 12):
    T[m] = sum of bases[i] over the set bits i of m."""
    table = [W.identity(ops, bases[0][0].shape[:-ops.elem_ndim], bases[0][0].device)]
    for i, b in enumerate(bases):
        table += [W.add(ops, t, b) for t in table[: 1 << i]]
    return torch.stack([W.stack_point(ops, t) for t in table], 0)


def _gather(T, idx):
    """T: (S, ...batch, 3, *elem), idx: (...batch) -> row idx[b] of T for
    every batch position b, as (...batch, 3, *elem)."""
    batch = idx.shape
    flat = T.reshape((T.shape[0], -1) + T.shape[1 + len(batch):])
    rows = torch.arange(flat.shape[1], device=T.device)
    return flat[idx.reshape(-1), rows].reshape(batch + flat.shape[2:])


def _shamir(ops: W.FieldOps, bases, digit_limbs, n_bits: int):
    """sum_i [d_i] bases[i] with one shared double-and-add ladder, a
    Python loop over n_bits static steps.

    digit_limbs: (...batch, n_bases, Ld) normalized standard-domain limbs."""
    T = _subset_table(ops, bases)
    bits = SD.bits_msb_first(digit_limbs, n_bits)       # (n_bits, ...batch, n_bases)
    weights = torch.tensor([1 << i for i in range(len(bases))], device=bits.device)
    idxs = (bits * weights).sum(-1)                     # (n_bits, ...batch)
    acc = W.identity(ops, digit_limbs.shape[:-2], digit_limbs.device)
    for i in range(n_bits):
        acc = W.double(ops, acc)
        acc = W.add(ops, acc, W.unstack_point(ops, _gather(T, idxs[i])))
    return acc


def glv_mul_g1(ops: W.FieldOps, p, e_std: torch.Tensor):
    """[e]P via the 2-dimensional GLV split; e_std: (...batch, 18) Fr
    standard-domain limbs (the JAX package's layout)."""
    k1, k2 = SD.glv_split(e_std)
    return _shamir(ops, [p, phi_g1(p)], torch.stack([k1, k2], -2), SD.GLV_BITS)


def gs_mul_g2(ops: W.FieldOps, q, e_std: torch.Tensor):
    """[e]Q via the 4-dimensional GS split; e_std: (...batch, 18) Fr
    standard-domain limbs."""
    digits = SD.gs_split(e_std)                          # (..., 4, 4)
    q1 = W.negate(ops, psi_g2(q))
    q2 = psi_g2(psi_g2(q))
    q3 = W.negate(ops, psi_g2(q2))
    return _shamir(ops, [q, q1, q2, q3], digits, SD.GS_BITS)
