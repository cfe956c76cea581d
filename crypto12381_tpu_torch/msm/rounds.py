"""Dense-rounds Pippenger MSM on G1: the route of G1Vec.msm for n >= 2^17.

Counterpart of the JAX package's `msm/rounds.py` (`msm_g1_rounds` and the
graphs of its `_jits`), with the same schedule:

  front:  force-affine (one K1 chain for the Z column) unless the caller
          says every Z is 1, and the signed c-bit window digits of the
          scalars at nbits = 256 (msm/sorted.py `_prep`); a check that no
          scalar is >= r;
  sort:   ONE stable sort of all K windows' |digits| (K, n).  Equal
          buckets become runs, in point order within a run; two
          collision-free scatters give every (window, bucket) its run
          START and LENGTH;
  counts: ONE host fetch brings back the range check, the longest run R
          and the number of runs longer than j for j < 512.  R > 512 or a
          scalar >= r sends the call to the scan MSM at c = 8, as the JAX
          package does;
  rounds: a dense accumulator slot per (window, bucket).  Round j adds
          the j-th point of every live run: one row gather, one complete
          mixed add over all the slots (ONE K5 launch) and a select on
          j < length.  The complete formulas absorb doublings (repeated
          points), P + (-P) and identity accumulators without a branch;
  ladder: as runs end, the live slots are compacted down the fixed
          sizes of `_LADDER` (one gather each), so that late rounds do not
          pay for the whole slot array; the schedule comes from the counts;
  finish: the slots scatter back into the (K, nbuck) bucket grid, which
          collapses and combines as in msm/pippenger (K6, K7).

The point table.  The JAX package packs x and y of a point into one
(n, 128) float32 row, one TPU tile, which its gather reads fastest.  Here
the table is (2 n2, 2, 12) int32 canonical Montgomery limbs, 96 bytes per
row: row i holds (x_i, y_i) and row n2 + i holds (x_i, -y_i), so the sign
of a digit is folded into the row index taken from the sort, and each
round's operand of K5 is one gather of whole 16-byte-aligned rows, with
no negation or select per round.
"""

from __future__ import annotations

import torch

from ..curves import g1 as G1
from ..curves import weierstrass as W
from ..fields import fused as FK
from ..params import R
from . import pippenger as MSM
from .sorted import _finish, _prep

__all__ = ["msm_g1_rounds"]

#: survival counts fetched after the sort; a longer run sends the call to
#: the scan MSM
_COUNT_CAP = 512

#: the compaction ladder: slot-array sizes the live slots shrink to
_LADDER = (262144, 131072, 65536, 32768, 16384)

_R_LIMBS = [(R >> (16 * i)) & 0xFFFF for i in range(18)]


def _any_ge_r(scalars_std: torch.Tensor) -> torch.Tensor:
    """Whether any scalar (n, 18) is >= r: a lexicographic compare from
    the top limb down (the nbits = 256 digits are exact only below r)."""
    r = torch.tensor(_R_LIMBS, dtype=torch.int32, device=scalars_std.device)
    ne = scalars_std != r
    hi = 17 - ne.flip(1).to(torch.int32).argmax(1)
    rows = torch.arange(scalars_std.shape[0], device=scalars_std.device)
    ge = torch.where(ne.any(1), scalars_std[rows, hi] > r[hi], True)
    return ge.any()


def _sort(digits: torch.Tensor, nbuck: int):
    """(n2, K) signed digits -> (prow, stf, lnf): the table row of every
    sorted (window, position) entry (n2 added for a negative digit), and
    per (window, bucket) slot the flat start of its run and its length
    (0 for bucket 0, whose digit adds nothing)."""
    n2, K = digits.shape
    dev = digits.device
    dT = digits.t().to(torch.int64)                          # (K, n2)
    skeys, psel = torch.sort(dT.abs(), dim=1, stable=True)
    prow = (psel + torch.where(torch.gather(dT, 1, psel) < 0, n2, 0)).reshape(-1)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    iota = torch.arange(n2, device=dev).expand(K, n2)
    rows = torch.arange(K, device=dev)[:, None].expand(K, n2)
    # one entry per run into the grids; every other entry into the extra
    # sentinel column nbuck, which is cut off
    starts = torch.full((K, nbuck + 1), n2, dtype=torch.int64, device=dev)
    starts[rows, torch.where(first, skeys, nbuck)] = iota
    ends = torch.zeros((K, nbuck + 1), dtype=torch.int64, device=dev)
    ends[rows, torch.where(last, skeys, nbuck)] = iota + 1
    starts, ends = starts[:, :nbuck], ends[:, :nbuck]
    lens = (ends - torch.where(starts < n2, starts, 0)).clamp_(min=0)
    lens[:, 0] = 0
    stf = torch.arange(K, device=dev)[:, None] * n2 + starts.clamp(max=n2 - 1)
    return prow, stf.reshape(-1), lens.reshape(-1)


def _compact(stf, lnf, orig, acc, grid, j: int, S_to: int):
    """Merge the slots into the grid, then gather the slots still live
    before round j (at most S_to of them, by the counts) into S_to rows;
    the rest are dead slots (length 0, identity, dropped at the merge)."""
    S_from, S0 = stf.shape[0], grid.shape[0] - 1
    dev = stf.device
    grid[orig] = acc                                      # dead slots: row S0
    surv = lnf > j
    dest = torch.where(surv, surv.cumsum(0) - 1, S_to)
    src = torch.full((S_to + 1,), S_from, dtype=torch.int64, device=dev)
    src[dest] = torch.arange(S_from, device=dev)          # S_to: the sentinel
    src = src[:S_to]
    ok = src < S_from
    srcc = src.clamp(max=S_from - 1)
    ident = W.stack_point(G1.ops(), W.identity(G1.ops(), (), dev))
    return (torch.where(ok, stf[srcc], 0), torch.where(ok, lnf[srcc], 0),
            torch.where(ok, orig[srcc], S0),
            torch.where(ok[:, None, None], acc[srcc], ident))


def msm_g1_rounds(points, scalars_std, c: int = 16, affine: bool = False):
    """sum_i scalars[i] * points[i] over G1 by dense rounds of complete
    mixed adds.  The round loop is driven from the host, with one fetch of
    the counts per call.  Returns one projective point.

    points: projective (X, Y, Z) of (n, 12) tensors; scalars_std: (n, 18)
    standard-domain Fr limbs.  Scalars must be below r for the rounds (the
    nbits = 256 digits); any scalar >= r, or a run longer than 512 (many
    equal scalars), sends the call to the scan MSM at c = 8.
    `affine=True`: the caller guarantees Z = 1 on every row, with no
    identity, and the front skips the Z inversion."""
    dev = scalars_std.device
    K = -(-256 // c)
    nbuck = (1 << (c - 1)) + 1
    S0 = K * nbuck

    tab, digits = _prep(points, scalars_std, c, nbits=256, affine=affine)
    n2 = tab.shape[0]
    nf = K * n2
    table = torch.cat([tab[:, 0:2], tab[:, 0::2]], 0)      # (x, y), then (x, -y)
    del tab
    bad = _any_ge_r(scalars_std)
    prow, stf, lnf = _sort(digits, nbuck)
    del digits
    hist = torch.bincount(lnf.clamp(max=_COUNT_CAP), minlength=_COUNT_CAP + 1)
    counts = S0 - hist.cumsum(0)[:_COUNT_CAP]              # runs longer than j
    fetched = torch.cat([bad.reshape(1).to(torch.int64), lnf.max().reshape(1),
                         counts]).tolist()                  # the ONE host fetch
    R_len, counts = fetched[1], fetched[2:]
    if fetched[0] or R_len > _COUNT_CAP:
        return MSM.msm_g1(points, scalars_std, c=8)

    ops = G1.ops()
    ident = W.stack_point(ops, W.identity(ops, (), dev))
    acc = ident.expand(S0, 3, ident.shape[-1]).clone()
    grid = ident.expand(S0 + 1, 3, ident.shape[-1]).clone()
    orig = torch.arange(S0, device=dev)
    ladder = [s for s in _LADDER if s < S0]
    S = S0
    for j in range(R_len):
        # compact before round j when the live count fits a smaller rung
        # (every rung it fits is popped; one compaction to the smallest)
        target = None
        while ladder and counts[j] <= ladder[0]:
            target = ladder.pop(0)
        if target is not None and target < S:
            stf, lnf, orig, acc = _compact(stf, lnf, orig, acc, grid, j, target)
            S = target
        q = table[prow[(stf + j).clamp_(max=nf - 1)]]       # (S, 2, 12)
        acc = torch.where((lnf > j)[:, None, None], FK.g1_madd(acc, q), acc)
    grid[orig] = acc
    return _finish(grid[:S0].reshape(K, nbuck, 3, -1), c, K, nbuck)
