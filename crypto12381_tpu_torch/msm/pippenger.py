"""Batched Pippenger multi-scalar multiplication on G1 and G2.

Counterpart of the JAX package's `msm/pippenger.py` (the scan Pippenger:
`window_digits`, `signed_window_digits`, `force_affine`, `pad_affine`,
`msm`, `_suffix_weighted`, `_collapse_buckets`, `msm_g1`, `msm_g2`), with
the same algorithm and parameters, over G1 (K5-K7) or G2 (K13, K12,
K14):
  * scalars split into K signed c-bit window digits in [-2^(c-1), 2^(c-1)]
    (the offset trick: no sequential borrow chain);
  * points go affine up front by a Montgomery batch inversion of the Z
    column (identity points become the generator with scalar 0), so every
    bucket update is a mixed add (K5 on G1, K13 on G2);
  * G lanes each own a private (K, 2^(c-1) + 1) bucket grid; a Python loop
    walks the n / G point blocks, and per step each lane adds its point,
    sign-corrected per window, into one bucket of each window (one K5 or K13
    launch over G * K rows);
  * lanes reduce by a log2(G) tree of complete adds (K6, K12), buckets
    collapse by the suffix-sum split into O(sqrt(nbuck)) steps, windows
    combine Horner-style with c doublings (K7, K14) and one add per
    window.
The complete formulas keep every step exception-free: identity buckets,
repeated points and doubling collisions need no branch.
"""

from __future__ import annotations

import math

import torch

from ..curves import g1 as G1
from ..curves import g2 as G2
from ..curves import weierstrass as W
from ..ops.scalar_decomp import LIMB_BITS, LIMB_MASK, carry_fix

N_BITS = 255


def window_digits(e_std: torch.Tensor, c: int, K: int | None = None) -> torch.Tensor:
    """(..., L) standard-domain Fr limbs -> (..., K) unsigned c-bit window
    digits (int32).  Each digit straddles at most two 16-bit limbs."""
    if K is None:
        K = -(-N_BITS // c)
    e = e_std.to(torch.int64)
    L = e.shape[-1]
    bit0 = torch.arange(K, device=e.device) * c
    limb = bit0 // LIMB_BITS
    lo = e[..., limb.clamp(max=L - 1)]
    hi = torch.where(limb + 1 < L, e[..., (limb + 1).clamp(max=L - 1)], 0)
    both = lo | (hi << LIMB_BITS)
    return ((both >> (bit0 % LIMB_BITS)) & ((1 << c) - 1)).to(torch.int32)


def signed_window_digits(e_std: torch.Tensor, c: int, nbits: int = 258) -> torch.Tensor:
    """(..., L) Fr standard limbs -> (..., K) signed digits in
    [-2^(c-1), 2^(c-1)], K = ceil(nbits / c), with e = sum d_i 2^(ci).

    f = e + sum_i 2^(ci + c - 1); the unsigned c-bit digits of f minus
    2^(c-1) are the signed digits.  With nbits = 258 any 256-bit e
    decomposes exactly (f < 2^(cK))."""
    K = -(-nbits // c)
    off = sum(1 << (c * i + c - 1) for i in range(K))
    L = e_std.shape[-1]
    off_limbs = torch.tensor([(off >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)],
                             dtype=torch.int64, device=e_std.device)
    f, _ = carry_fix(e_std.to(torch.int64) + off_limbs)
    return window_digits(f, c, K) - (1 << (c - 1))


def block_inverse(ops: W.FieldOps, v: torch.Tensor, block: int = 128) -> torch.Tensor:
    """The inverse of every element of v (n, *elem), none of them 0, by
    Montgomery's trick in two levels: the n values are cut into `block`
    rows of m = ceil(n / block) columns, a running product walks the rows
    (block product launches over m columns), ONE Fermat inversion inverts
    the m column totals, and a backward walk hands each value its inverse
    (block launches over 2m rows: the inverse and the next carry stacked).
    About 3 products per element plus one chain over m rows."""
    n = v.shape[0]
    dev = v.device
    elem = tuple(v.shape[1:])
    pad = (-n) % block
    if pad:
        v = torch.cat([v, ops.one((pad,), dev)], 0)
    m = v.shape[0] // block
    zb = v.reshape((m, block) + elem).transpose(0, 1)            # (block, m, *elem)
    prefix = []
    carry = ops.one((m,), dev)
    for j in range(block):
        prefix.append(carry)
        (carry,) = ops.mul_many([(carry, zb[j])])
    carry = ops.inv(carry)
    inv = [None] * block
    for j in reversed(range(block)):
        inv[j], carry = ops.mul_many([(carry, prefix[j]), (carry, zb[j])])
    return torch.stack(inv, 0).transpose(0, 1).reshape((-1,) + elem)[:n]


def force_affine(ops: W.FieldOps, points, scalars_std, gen_affine, block: int = 128):
    """Projective batch -> (x, y) affine batch and adjusted scalars.

    The Z column is inverted by `block_inverse` (2 * block product launches
    and one chain).  Identity points (Z = 0) become `gen_affine` with
    scalar 0, so the bucket phase never sees a Z != 1 operand.  Any
    coefficient field: elements are (n, *elem)."""
    X, Y, Z = points
    n = scalars_std.shape[0]
    dev = Z.device
    elem = tuple(Z.shape[1:])
    is_id = ops.is_zero(Z)
    m_id = is_id.reshape((n,) + (1,) * len(elem))
    zinv = block_inverse(ops, torch.where(m_id, ops.one((n,), dev), Z), block)
    x, y = ops.mul_many([(X, zinv), (Y, zinv)])
    gx, gy = gen_affine
    x = torch.where(m_id, gx.expand_as(x), x)
    y = torch.where(m_id, gy.expand_as(y), y)
    scalars_std = torch.where(is_id[:, None], torch.zeros_like(scalars_std), scalars_std)
    return x, y, scalars_std


def pad_affine(ops: W.FieldOps, xy, scalars_std, lanes: int, gen_affine):
    """Pad n to a multiple of lanes with generator points and zero scalars
    (any affine point works at scalar 0; the identity has no Z = 1 form)."""
    x, y = xy
    pad = (-scalars_std.shape[0]) % lanes
    if pad == 0:
        return xy, scalars_std
    gx, gy = gen_affine
    x = torch.cat([x, gx.expand((pad,) + x.shape[1:])], 0)
    y = torch.cat([y, gy.expand((pad,) + y.shape[1:])], 0)
    scalars_std = torch.cat([scalars_std, scalars_std.new_zeros((pad, scalars_std.shape[1]))], 0)
    return (x, y), scalars_std


def _stacked(ops: W.FieldOps, op, *pts: torch.Tensor) -> torch.Tensor:
    """A point operation on points stacked as (..., 3, *elem) tensors."""
    return W.stack_point(ops, op(ops, *(W.unstack_point(ops, t) for t in pts)))


def msm(points, scalars_std, ops: W.FieldOps, c: int = 8, lanes: int = 64, gen_affine=None):
    """sum_i scalars[i] * points[i].

    points: projective (X, Y, Z) of (n, *elem) tensors (elem (12,) for G1,
    (2, 12) for G2); scalars_std: (n, L) standard-domain Fr limbs.  lanes
    must be a power of two.  gen_affine: (x, y) of a fixed non-identity
    affine point, for identity replacement and padding.  Returns one
    projective point (batch shape ())."""
    assert lanes & (lanes - 1) == 0
    K = -(-258 // c)
    nbuck = (1 << (c - 1)) + 1
    dev = scalars_std.device

    x, y, scalars_std = force_affine(ops, points, scalars_std, gen_affine)
    (x, y), scalars_std = pad_affine(ops, (x, y), scalars_std, lanes, gen_affine)
    steps = scalars_std.shape[0] // lanes
    elem = tuple(x.shape[1:])
    emask = (1,) * len(elem)

    digits = signed_window_digits(scalars_std, c).reshape(steps, lanes, K)
    neg = digits < 0
    idx = digits.abs()
    # -y for every point once, not once per step
    xs = x.reshape((steps, lanes, 1) + elem)
    ys = y.reshape((steps, lanes, 1) + elem)
    nys = ops.neg(y).reshape((steps, lanes, 1) + elem)

    # (lanes, K, nbuck, 3, *elem), all identity; a real tensor (it is
    # updated in place), not a broadcast view
    buckets = torch.zeros((lanes, K, nbuck, 3) + elem, dtype=x.dtype, device=dev)
    buckets[:, :, :, 1] = ops.one((), dev)

    lane_idx = torch.arange(lanes, device=dev)[:, None]
    win_idx = torch.arange(K, device=dev)[None, :]
    for s in range(steps):
        cur = buckets[lane_idx, win_idx, idx[s]]               # (lanes, K, 3, *elem)
        py = torch.where(neg[s].reshape(neg[s].shape + emask), nys[s], ys[s])
        q = torch.stack([xs[s].expand_as(py), py], -1 - len(elem))
        new = _stacked(ops, W.madd, cur, q)
        # each (lane, window) pair names one bucket, so the indices of one
        # step are unique and the in-place scatter has no collisions
        buckets[lane_idx, win_idx, idx[s]] = new

    # lane tree -> (K, nbuck, 3, *elem)
    g = lanes
    while g > 1:
        half = g // 2
        buckets = _stacked(ops, W.add, buckets[:half], buckets[half:g])
        g = half
    buckets = buckets[0]

    S = W.stack_point(ops, _collapse_buckets(ops, buckets, nbuck, K))     # (K, 3, *elem)
    return _horner(ops, S, c)


def _horner(ops: W.FieldOps, S: torch.Tensor, c: int):
    """The window combine sum_k 2^(ck) S[k], Horner from the top window
    down: c doublings and one add per window.  S: (K, 3, *elem)."""
    acc = W.identity(ops, (), S.device)
    for k in range(S.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = W.double(ops, acc)
        acc = W.add(ops, acc, W.unstack_point(ops, S[k]))
    return acc


def _suffix_weighted(ops: W.FieldOps, pts: torch.Tensor, m: int):
    """sum_{b=0}^{m-1} b * pts[:, b] per leading row, by the running-sum
    and total scan over b = m-1 .. 1."""
    K = pts.shape[0]
    run = total = W.identity(ops, (K,), pts.device)
    for b in range(m - 1, 0, -1):
        run = W.add(ops, run, W.unstack_point(ops, pts[:, b]))
        total = W.add(ops, total, run)
    return total


def _collapse_buckets(ops: W.FieldOps, buckets: torch.Tensor, nbuck: int, K: int):
    """S_k = sum_{b >= 1} b * bucket[k, b] in O(sqrt(nbuck)) steps.

    With b = chi * cc + j (chi a power of two):
    S = sum_j j * (sum_cc P[cc, j]) + chi * sum_cc cc * (sum_j P[cc, j]);
    the inner sums are log-depth tree reductions, the weighted sums short
    suffix scans."""
    chi = 1
    while chi * chi < nbuck:
        chi *= 2
    m = -(-nbuck // chi)
    pad = chi * m - nbuck
    if pad:
        idp = W.stack_point(ops, W.identity(ops, (K, pad), buckets.device))
        buckets = torch.cat([buckets, idp], 1)
    grid = buckets.reshape((K, m, chi) + buckets.shape[2:])

    def tree(pts, axis):
        while pts.shape[axis] > 1:
            nloc = pts.shape[axis]
            half = nloc // 2
            a = pts.narrow(axis, 0, half)
            b = pts.narrow(axis, half, half)
            s = _stacked(ops, W.add, a, b)
            if nloc % 2:
                s = torch.cat([s, pts.narrow(axis, nloc - 1, 1)], axis)
            pts = s
        return pts.squeeze(axis)

    cols = tree(grid, 1)                     # (K, chi, 3, 12): sum over cc
    rows = tree(grid, 2)                     # (K, m, 3, 12):   sum over j
    s1 = _suffix_weighted(ops, cols, chi)    # sum j * col_j
    s2 = _suffix_weighted(ops, rows, m)      # sum cc * row_cc
    for _ in range(int(math.log2(chi))):     # chi * s2
        s2 = W.double(ops, s2)
    return W.add(ops, s1, s2)


def _gen_affine_g1(device):
    g = G1.generator((), device)
    return (g[0], g[1])


def _gen_affine_g2(device):
    g = G2.generator((), device)
    return (g[0], g[1])


def msm_g1(points, scalars_std, c: int = 8, lanes: int = 64):
    return msm(points, scalars_std, G1.ops(), c, lanes, _gen_affine_g1(scalars_std.device))


def msm_g2(points, scalars_std, c: int = 8, lanes: int = 64):
    return msm(points, scalars_std, G2.ops(), c, lanes, _gen_affine_g2(scalars_std.device))
