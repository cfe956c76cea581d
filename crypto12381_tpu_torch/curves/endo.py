"""GLV scalar multiplication on G1 with the cube-root endomorphism.

Counterpart of the JAX package's `curves/endo.py` (`_beta_limbs`, `phi_g1`,
`_subset_table`, `_gather`, `_shamir`, `glv_mul_g1`): the scalar splits
on the device as e = k1 + lambda k2 (ops/scalar_decomp.py), and both
half-scalars walk ONE shared Shamir ladder over the table
{O, P, phi(P), P + phi(P)}: 128 steps of one doubling (K7) and one
complete addition (K6) each, with a row-wise table gather per step.  The
complete formulas need no branch for identity entries or equal points.

  phi(x, y) = (beta x, y) = [lambda] P on G1, lambda = x^2 - 1, beta a cube
  root of unity in Fp.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fp as FP
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


def phi_g1(p):
    """(X, Y, Z) -> (beta X, Y, Z): one K1 launch."""
    X, Y, Z = p
    b = torch.from_numpy(_beta_limbs()).to(X.device)
    return (FP.mont_mul(X, b.expand_as(X)), Y, Z)


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
