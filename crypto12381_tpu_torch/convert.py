"""Carry field values between the JAX package's arrays and the port's
tensors, so that one set of inputs can feed both: Fp values (any leading
shape: Fp2, Fp12, batch), points as tuples of coordinates (projective or
affine, G1 or G2), and Fr scalars.

The JAX package's field arrays hold (..., 50) float32 signed 8-bit digits
of a Montgomery form with R = 2^400, possibly loose (any representative of
the class, digits slightly outside [0, 255]).  The port's tensors hold
(..., 12) canonical 32-bit limbs of the Montgomery form with R = 2^384.
Both conversions go through exact integers: a JAX value v = x 2^400 maps
to v 2^-16 = x 2^384 mod p, and back.  Any leading shape (Fp2, Fp12,
batch) is kept.  Takes and returns numpy arrays on the JAX side, so this
module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import fp as FP
from .params import LIMBS, P

JAX_DIGITS = 50
_TO_PORT = pow(2, -16, P)
_TO_JAX = pow(2, 16, P)


def from_jax_fp(np_digits, device="cpu") -> torch.Tensor:
    """(..., 50) float32 digits, Montgomery R = 2^400 -> (..., 12) tensor."""
    d = np.asarray(np_digits)
    if d.shape[-1] != JAX_DIGITS:
        raise ValueError(f"expected {JAX_DIGITS} digits, got shape {d.shape}")
    ints = np.rint(d).astype(np.int64).reshape(-1, JAX_DIGITS)
    out = np.empty((ints.shape[0], LIMBS), np.int32)
    for i, row in enumerate(ints):
        v = sum(int(x) << (8 * k) for k, x in enumerate(row))
        out[i] = FP.limbs_of(v % P * _TO_PORT % P)
    return torch.from_numpy(out.reshape(d.shape[:-1] + (LIMBS,))).to(device)


def to_jax_fp(x: torch.Tensor) -> np.ndarray:
    """(..., 12) tensor (any value below 2^384) -> (..., 50) float32
    canonical digits, Montgomery R = 2^400."""
    a = x.detach().cpu().numpy()
    flat = a.reshape(-1, LIMBS)
    out = np.empty((flat.shape[0], JAX_DIGITS), np.float32)
    for i, row in enumerate(flat):
        v = FP.int_of(row) % P * _TO_JAX % P
        out[i] = [(v >> (8 * k)) & 0xFF for k in range(JAX_DIGITS)]
    return out.reshape(a.shape[:-1] + (JAX_DIGITS,))


def from_jax_point(coords, device="cpu") -> tuple:
    """A JAX point (tuple of coordinate digit arrays, projective or affine)
    -> tuple of port tensors."""
    return tuple(from_jax_fp(c, device) for c in coords)


def to_jax_point(p) -> tuple:
    return tuple(to_jax_fp(c) for c in p)


def from_jax_fr(np_limbs, device="cpu") -> torch.Tensor:
    """Fr scalars: both sides hold (..., 18) int32 standard-domain limbs of
    16 bits, so only the container changes."""
    return torch.from_numpy(np.asarray(np_limbs, np.int32).copy()).to(device)


def to_jax_fr(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.int32)
