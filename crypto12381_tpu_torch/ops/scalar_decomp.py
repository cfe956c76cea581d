"""Scalar decompositions for the G1 GLV and the G2/GT GS ladders, batched
on the device.

Counterpart of the JAX package's `ops/scalar_decomp.py` (`mul_const`,
`divmod_const`, `glv_split`, `gs_split`, `bits_msb_first`).  The divisors
lambda and |x| are fixed public constants, so each division is a
branch-free Barrett reduction over limb tensors: one constant product, a
limb shift and two conditional corrections.

Scalars keep the JAX package's layout: standard-domain (not Montgomery)
limbs of 16 bits, least significant first, in int32 tensors (..., L).
Inside, the limb arithmetic runs in int64, where 16 x 16-bit products and
their column sums cannot overflow; outputs are int32 limbs in [0, 2^16).
"""

from __future__ import annotations

import functools

import torch

from ..params import R, X_ABS

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

#: GLV eigenvalue on G1: lambda = x^2 - 1, with lambda^2 + lambda + 1 = r,
#: so phi(x, y) = (beta x, y) is [lambda] on G1.  128 bits.
GLV_LAMBDA = X_ABS * X_ABS - 1
assert GLV_LAMBDA**2 + GLV_LAMBDA + 1 == R

#: Shamir ladder length: bits of the two half-scalars.
GLV_BITS = max(GLV_LAMBDA.bit_length(), ((R - 1) // GLV_LAMBDA).bit_length())
#: GS ladder length: bits of the four digits below |x|.
GS_BITS = X_ABS.bit_length()


def _to_limbs(v: int, n: int) -> list[int]:
    assert 0 <= v < 1 << (LIMB_BITS * n)
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def carry_fix(cols: torch.Tensor):
    """Non-negative int64 columns (..., n) -> (limbs in [0, 2^16), carry
    out of the top), by one carry pass over the columns."""
    out = []
    carry = torch.zeros_like(cols[..., 0])
    for i in range(cols.shape[-1]):
        c = cols[..., i] + carry
        out.append(c & LIMB_MASK)
        carry = c >> LIMB_BITS
    return torch.stack(out, -1), carry


def borrow_sub(x: torch.Tensor, y: torch.Tensor):
    """x - y for normalized int64 limbs: (difference mod 2^(16n), borrow
    out of the top as 0/1)."""
    out = []
    borrow = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        d = x[..., i] - y[..., i] - borrow
        out.append(d & LIMB_MASK)
        borrow = -(d >> LIMB_BITS)               # d >= -2^16: 1 on a borrow
    return torch.stack(out, -1), borrow


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Keep or zero-pad the last dim to n limbs."""
    if x.shape[-1] >= n:
        return x[..., :n]
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (n - x.shape[-1],))], -1)


def _mul_const64(a: torch.Tensor, m_limbs) -> torch.Tensor:
    au = a.to(torch.int64)
    La = au.shape[-1]
    cols = au.new_zeros(au.shape[:-1] + (La + len(m_limbs),))
    for j, mj in enumerate(m_limbs):
        if mj:
            cols[..., j:j + La] += au * mj
    return carry_fix(cols)[0]


def mul_const(a: torch.Tensor, m_limbs) -> torch.Tensor:
    """Exact product of normalized limbs a (..., La) with a host constant
    given as 16-bit limbs (Lm,) -> (..., La + Lm) normalized int32 limbs."""
    return _mul_const64(a, [int(m) for m in m_limbs]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _barrett_consts(d: int, s_limbs: int, lr: int):
    m = (1 << (LIMB_BITS * s_limbs)) // d
    lm = -(-m.bit_length() // LIMB_BITS)
    return _to_limbs(m, lm), _to_limbs(d, lr)


def divmod_const(k: torch.Tensor, d: int, lq: int, lr: int):
    """(k // d, k mod d) for normalized limbs k (..., Lk) and a host
    constant divisor d, as int32 limbs (..., lq) and (..., lr).  The caller
    guarantees the true quotient fits lq limbs and d fits lr.  Barrett's
    estimate is q - 2, q - 1 or q; two branch-free corrections fix it."""
    k = k.to(torch.int64)
    Lk = k.shape[-1]
    m_limbs, d_limbs = _barrett_consts(d, Lk, lr)
    q = _pad(_mul_const64(k, m_limbs)[..., Lk:], lq)
    qd = _pad(_mul_const64(q, d_limbs), Lk)
    r, _ = borrow_sub(k, qd)            # exact: q <= true quotient
    d_wide = torch.tensor(_to_limbs(d, Lk), dtype=torch.int64, device=k.device)
    one = torch.tensor(_to_limbs(1, lq), dtype=torch.int64, device=k.device)
    for _ in range(2):
        diff, borrow = borrow_sub(r, d_wide.expand_as(r))
        ge = (borrow == 0)[..., None]
        r = torch.where(ge, diff, r)
        q = torch.where(ge, carry_fix(q + one)[0], q)
    return q.to(torch.int32), r[..., :lr].to(torch.int32)


def glv_split(e_std: torch.Tensor):
    """(..., L >= 16) Fr standard limbs -> (k1, k2), each (..., 8) limbs,
    with e = k1 + GLV_LAMBDA * k2 exactly (e < r = lambda^2 + lambda + 1,
    so both halves are below 2^128)."""
    k2, k1 = divmod_const(e_std, GLV_LAMBDA, lq=8, lr=8)
    return k1, k2


def gs_split(e_std: torch.Tensor) -> torch.Tensor:
    """(..., L) Fr standard limbs -> (..., 4, 4) digit limbs with
    e = sum_i d_i |x|^i, each d_i < |x| (64 bits): three divisions by |x|.
    psi acts as [x] = [-|x|] on G2 (and the Frobenius as x on the GT
    r-torsion), so [e]Q = sum_i [d_i] ((-1)^i psi^i(Q))."""
    digits = []
    k = e_std
    for _ in range(3):
        k, d = divmod_const(k, X_ABS, lq=max(4, k.shape[-1] - 3), lr=4)
        digits.append(d)
    digits.append(k[..., :4])                      # e // |x|^3 < r / |x|^3 < |x|
    return torch.stack(digits, -2)


def bits_msb_first(d: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Normalized limbs (..., L) -> bits (n_bits, ...), most significant
    first."""
    idx = torch.arange(n_bits - 1, -1, -1, device=d.device)
    bits = (d[..., idx // LIMB_BITS].to(torch.int64) >> (idx % LIMB_BITS)) & 1
    return bits.movedim(-1, 0)
