"""Shamir secret sharing over Zp: sharing and Lagrange reconstruction, on
the host and batched.

Counterpart of the JAX package's `schemes/sss.py` (the reference's
examples/shamir-secret-sharing): the same CSPRNG draws and bytes.  A
t-of-n sharing of a secret s gives the shares p(1), ..., p(n) of a
polynomial p of degree t - 1 with p(0) = s; any t of them give s back by
Lagrange interpolation at 0.

`share_batch` and `reconstruct_batch` run on the CUDA card by default (and
raise without one); `device="cpu"` runs the plain versions.  Sharing is
ONE Horner ladder over the n points (t - 1 steps of a product and a sum
mod r, K1's Fr instance); reconstruction forms the t x t differences
x_i - x_j, multiplies them out along j in a tree, and inverts the t
denominators and the t values -x_j with one power-chain launch each.
"""

from __future__ import annotations

import torch

from ..api import batch as BT
from ..api.elements import ZpNumber
from ..api.sets import Zp, make_Zp, parse, polynomial, select_in, serialize

__all__ = ["share", "reconstruct", "share_batch", "reconstruct_batch"]

FR = BT.FR


def share(t: int, n: int, secret: bytes, random) -> list[bytes]:
    """t-of-n sharing on the host: p(1..n) for p(0) = secret and t - 1
    drawn coefficients."""
    s = parse(Zp, secret)
    a = select_in(Zp, random, t - 1)
    return [serialize(polynomial(x, s, a)) for x in range(1, n + 1)]


def reconstruct(indexes, shares) -> bytes:
    """Lagrange interpolation at 0 on the host:
    sum_i y_i prod_{j != i} -x_j / (x_i - x_j)."""
    x = [make_Zp(i) for i in indexes]
    y = [parse(Zp, s) for s in shares]
    acc = ZpNumber(0)
    for i in range(len(x)):
        lam = ZpNumber(1)
        for j in range(len(x)):
            if j != i:
                lam = lam * (-x[j] / (x[i] - x[j]))
        acc = acc + y[i] * lam
    return serialize(acc)


def share_batch(t: int, n: int, secret: bytes, random, device=None) -> list[bytes]:
    """The bytes of `share` (the same draws), with the n evaluations as ONE
    Horner ladder: acc = a_{t-1}, then acc = acc x + a_k for k = t-2 .. 0,
    each step on all n points at once (a (1,) coefficient broadcast)."""
    dev = BT._device(device, "share_batch runs")
    s = parse(Zp, secret)
    a = select_in(Zp, random, t - 1)
    coeffs = BT.ZpVec.from_ints([c.value for c in [s] + a], dev).std
    xs = BT.ZpVec.from_ints(range(1, n + 1), dev)
    acc = BT.ZpVec(coeffs[-1:])
    for k in range(t - 2, -1, -1):
        acc = acc * xs + BT.ZpVec(coeffs[k:k + 1])
    return BT.ZpVec(acc.std.expand(n, -1)).serialize()        # t = 1: n copies of s


def _tree(op, x: torch.Tensor) -> torch.Tensor:
    """op reduced along axis 0 in log2 steps, each one call of op on the
    two halves (an odd row carried to the next step)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        merged = op(x[:half], x[half:2 * half])
        x = torch.cat([merged, x[2 * half:]]) if x.shape[0] % 2 else merged
    return x[0]


def reconstruct_batch(indexes, shares, device=None) -> bytes:
    """The bytes of `reconstruct`, with the Lagrange weights batched: the
    t x t differences x_i - x_j (1 on the diagonal) multiplied out along j,
    their t inverses and those of -x_j by one power chain each
    (`batch_inv`), prod_j -x_j by a tree, and the weighted sum by a tree of
    additions."""
    dev = BT._device(device, "reconstruct_batch runs")
    t = len(indexes)
    ys = BT.ZpVec.from_ints([parse(Zp, s).value for s in shares], dev)
    if t == 1:
        return ys.serialize()[0]
    xm = FR.to_mont(BT.ZpVec.from_ints(indexes, dev).limbs32())          # (t, 8)
    diff = FR.sub(xm[:, None], xm[None, :])                               # (t, t, 8)
    eye = torch.eye(t, dtype=torch.bool, device=dev)[..., None]
    diff = torch.where(eye, FR.one((t, t), dev), diff)
    den_inv = FR.batch_inv(_tree(FR.mont_mul, diff.movedim(1, 0)))                 # (t, 8)
    neg_xm = FR.neg(xm)
    num = FR.mont_mul(_tree(FR.mont_mul, neg_xm).expand_as(neg_xm), FR.batch_inv(neg_xm))
    lam = FR.mont_mul(num, den_inv)
    terms = FR.mont_mul(lam, ys.limbs32())              # REDC(lam R y) = lam y, standard
    return BT.ZpVec.from_limbs32(_tree(FR.add, terms)).serialize()[0]
