"""The front end and the finish shared by the large-n G1 MSMs.

Counterpart of the JAX package's `msm/sorted.py` as far as msm/rounds.py
needs it: `_prep` (force-affine, the point table, signed window digits)
and `_finish` (the bucket collapse and the Horner window combine).  The
sorted merge-tree MSM itself (`msm_g1_sorted`, `_staged`, `_staged_v1`,
`block_batch_inv`) is not ported: the JAX package reaches it only under an
environment override.
"""

from __future__ import annotations

import torch

from ..curves import g1 as G1
from ..curves import weierstrass as W
from ..fields import fp as FP
from . import pippenger as MSM


def _prep(points, scalars_std, c: int, nbits: int = 258, affine: bool = False):
    """Front end: affine points, the point table and the signed window
    digits.

    points: projective (X, Y, Z) of (n, 12) tensors; scalars_std: (n, 18)
    standard-domain Fr limbs.  `nbits`: the scalars' coverage (258 takes
    any 256-bit value; 256 assumes canonical scalars below r).
    `affine`: the caller guarantees Z = 1 on every row (no identity), and
    X, Y are read as they are; otherwise the Z column is inverted
    (MSM.force_affine: an identity row becomes the generator with scalar
    0).  An odd n is padded with the generator under scalar 0.

    Returns (tab, digits): tab (n2, 3, 12) the canonical Montgomery
    (x, y, -y) of every point, digits (n2, K) int32 signed window digits,
    n2 = n rounded up to even."""
    ops = G1.ops()
    gx, gy = MSM._gen_affine_g1(scalars_std.device)
    if affine:
        x, y = points[0], points[1]
    else:
        x, y, scalars_std = MSM.force_affine(ops, points, scalars_std, (gx, gy))
    if x.shape[0] % 2:
        x = torch.cat([x, gx[None]], 0)
        y = torch.cat([y, gy[None]], 0)
        scalars_std = torch.cat([scalars_std, scalars_std.new_zeros((1, scalars_std.shape[1]))], 0)
    tab = torch.stack([x, y, FP.neg(y)], 1)
    digits = MSM.signed_window_digits(scalars_std, c, nbits)
    return tab, digits


def _finish(grids: torch.Tensor, c: int, K: int, nbuck: int):
    """Bucket collapse over all windows, then the Horner window combine:
    grids (K, nbuck, 3, 12) -> one projective point."""
    ops = G1.ops()
    S = W.stack_point(ops, MSM._collapse_buckets(ops, grids, nbuck, K))
    return MSM._horner(ops, S, c)
