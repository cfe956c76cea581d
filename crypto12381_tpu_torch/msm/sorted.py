"""Sort-based batched-affine Pippenger MSM on G1, and the front end and
finish shared with msm/rounds.py.

Counterpart of the JAX package's `msm/sorted.py`: `_prep` (force-affine,
the point table, signed window digits), `_finish` (the bucket collapse and
the Horner window combine), `block_batch_inv`, `pass_sizes`, and the three
MSMs, `msm_g1_sorted`, `msm_g1_sorted_staged_v1` and
`msm_g1_sorted_staged`, which give the same points as the JAX package's.
`G1Vec.msm` does not route to them; they are called directly, and
PERF.md times them against its routes on the H100.  Per window:

  1. a stable sort of the n |digits| carrying the point index: equal
     buckets become runs, in point order within a run;
  2. merge passes: each pass pairs the entries at even and odd positions
     of every run and adds each pair, compacting the survivors (the even
     entries) into the next pass's slots.  pass_sizes bounds the survivor
     count of every pass over every input: a run of length l leaves
     ceil(l / 2), and a window has at most min(m, nbuck) runs;
  3. a batched-affine pass knows all its pair denominators before any
     addition, so ONE Montgomery block inversion (`block_batch_inv`, one
     K1 power chain) serves the whole pass: 5M + 2S per add against 12M
     for the complete projective add.  Edge cases cost no product: the
     coordinates are canonical, so x1 == x2 and y1 == -y2 are limb
     compares, and the doubling denominator 2 y1 is the y1 + y2 computed
     anyway;
  4. the merged entries have unique keys and scatter without collision
     into the window's row of a (K, nbuck) bucket grid; `_finish`
     collapses it.

The three MSMs:
  * `msm_g1_sorted`: one window at a time, pass 1 batched-affine with its
    own inversion, passes 2+ by the complete projective add (K6);
  * `msm_g1_sorted_staged_v1`: the same passes with ONE inversion over
    every window's pass-1 denominators;
  * `msm_g1_sorted_staged`: every window in each pass, and every pass
    batched-affine.  One host fetch per pass does two jobs: it switches
    from the FAST pass (no equal-x pair: no doubling and no infinity) to
    the GENERAL one (doubling by 3 x^2 / 2 y, P + (-P) to an infinity
    flag carried forward) once a merge pair has equal x, and it ends the
    pass loop when nothing is left to merge.

What the JAX module has and this one does not: `_quantize`,
`_chunk_plan`, `_chunked` and the `_CH_*`/`_INV_*` constants share Mosaic
compiles between pass sizes, and `canon1`/`tighten` keep signed f32
digits in range.  Here the values are always canonical limbs and every
pass runs at pass_sizes' own output size, which is the survivor bound
itself.  The staging of the JAX entry points (separate jits) has no
meaning in eager PyTorch; what `_staged_v1` keeps is its one shared
inversion, and `_pass1_den` is the `den` of `_pass1_gather`'s result,
which `_pass1_apply` then takes whole.
"""

from __future__ import annotations

import torch

from ..curves import g1 as G1
from ..curves import weierstrass as W
from ..fields import fp as FP
from . import pippenger as MSM

#: sentinel bucket key of dead and padding slots (above any |digit|)
_SENT = 1 << 24

#: rows of one column of the Montgomery block inversion: the walk is 2 BLOCK
#: dependent K1 launches over m / BLOCK rows, and the one Fermat chain runs
#: over m / BLOCK rows.  The host launches the walk one step at a time, so
#: a pass's inversion costs about BLOCK launches' host time until the
#: chain's rows dominate; most passes of a large MSM are late ones of a few
#: hundred thousand values, where 32 beats 128 (PERF.md)
BLOCK = 32


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


# ---------------------------------------------------------------------------
# Montgomery block inversion
# ---------------------------------------------------------------------------


def block_batch_inv(v: torch.Tensor, zeros=None, B: int | None = None) -> torch.Tensor:
    """The inverse of every Fp element of v (m, 12), Montgomery form in
    and out, with ONE Fermat chain: the m values split into columns of B,
    a running product walks each column (B launches over m / B rows), one
    chain inverts the column totals, and a backward walk hands each value
    its inverse (MSM.block_inverse).  About 3 products per element.

    zeros: (m,) bool marking the zero inputs (which return 0); None tests
    for them here; False when the caller guarantees that there are none.
    B defaults to BLOCK; the result does not depend on it.  The JAX
    function's unroll U belongs to its scan and has no counterpart."""
    B = B or BLOCK
    if zeros is False:
        return MSM.block_inverse(G1.ops(), v, B)
    if zeros is None:
        zeros = FP.is_zero(v)
    safe = torch.where(zeros[:, None], FP.one((), v.device), v)
    return torch.where(zeros[:, None], 0, MSM.block_inverse(G1.ops(), safe, B))


# ---------------------------------------------------------------------------
# Pass machinery, on (Kw, m) sorted keys: Kw windows side by side
# ---------------------------------------------------------------------------


def pass_sizes(n: int, nbuck: int) -> list[int]:
    """The survivor-array sizes of passes 1..ceil(log2 n): each pass bounds
    its survivors by size/2 + runs/2 over every distribution (a run of
    length l leaves ceil(l/2) survivors; runs <= min(size, nbuck))."""
    sizes = []
    m = n
    for _ in range(max(1, (n - 1).bit_length())):
        nxt = min(m, -(-m // 2) + (min(m, nbuck) + 1) // 2 + 1)
        sizes.append(nxt)
        m = nxt
    return sizes


def _run_pos(k: torch.Tensor) -> torch.Tensor:
    """Position of each entry inside its equal-key run, per row of sorted
    keys (Kw, m)."""
    m = k.shape[1]
    iota = torch.arange(m, device=k.device).expand_as(k)
    change = torch.ones_like(k, dtype=torch.bool)
    change[:, 1:] = k[:, 1:] != k[:, :-1]
    return iota - torch.cummax(torch.where(change, iota, 0), 1).values


def _survivor_src(even: torch.Tensor, m_next: int) -> torch.Tensor:
    """The indices of the even-position survivors, compacted per row into
    m_next slots; an unused slot holds m.  Survivors past m_next are
    dropped: by pass_sizes' bound only those of the sentinel run at the
    sorted tail can be, and they carry no point."""
    Kw, m = even.shape
    pos = even.cumsum(1) - 1
    dest = torch.where(even & (pos < m_next), pos, m_next)
    src = torch.full((Kw, m_next + 1), m, dtype=torch.int64, device=even.device)
    src.scatter_(1, dest, torch.arange(m, device=even.device).expand(Kw, m))
    return src[:, :m_next]                 # column m_next took every other entry


def _pair_gather(k: torch.Tensor, m_next: int):
    """The pass prologue: survivor indices src, partner indices src1, the
    survivors' keys ka (the sentinel in unused slots) and the merge mask
    (a survivor whose partner has its key)."""
    m = k.shape[1]
    src = _survivor_src((_run_pos(k) & 1) == 0, m_next)
    src1 = (src + 1).clamp_(max=m)
    ka = _key_at(k, src)
    merge = (_key_at(k, src1) == ka) & (ka < _SENT)
    return src, src1, ka, merge


def _key_at(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """k's entries at idx, the sentinel at index m."""
    m = k.shape[1]
    return torch.where(idx < m, torch.gather(k, 1, idx.clamp(max=m - 1)), _SENT)


def _flag_at(inf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The infinity flags at idx; index m (no entry) reads as infinite."""
    m = inf.shape[1]
    return torch.where(idx < m, torch.gather(inf, 1, idx.clamp(max=m - 1)), True)


def _gath(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Kw, m, ...) -> (Kw, m_out, ...) rows at idx.  Index m (an unused
    slot or a missing partner) reads row m - 1: such a slot's key is the
    sentinel or it does not merge, so its values are never used."""
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[rows, idx.clamp(max=a.shape[1] - 1)]


def _any_mergeable(k: torch.Tensor) -> torch.Tensor:
    """Whether any two neighbours of a row share a real key (on the device)."""
    return ((k[:, 1:] == k[:, :-1]) & (k[:, :-1] < _SENT)).any()


def _sort_windows(digits: torch.Tensor, tab: torch.Tensor):
    """(n2, Kw) signed digits and the point table -> per window the sorted
    |digits| (Kw, n2) and the sorted points' x and sign-resolved y
    (Kw, n2, 12): one stable sort and one gather per coordinate."""
    n2 = digits.shape[0]
    d = digits.t().to(torch.int64)
    keys, sidx = torch.sort(d.abs(), dim=1, stable=True)
    neg = torch.gather(d, 1, sidx) < 0
    xs = tab[:, 0][sidx]
    ys = torch.cat([tab[:, 1], tab[:, 2]], 0)[sidx + torch.where(neg, n2, 0)]
    return keys, xs, ys


def _pass1_gather(k, x, y, m_next: int) -> dict:
    """Pass-1 front: the pair gathers and the edge cases by limb compares.
    den = x2 - x1, or 2 y1 = y1 + y2 when x1 == x2; 1 where the pair is
    P + (-P) (den is never 0: distinct x give a nonzero difference, and no
    point of y^2 = x^3 + 4 has y = 0)."""
    src, src1, ka, merge = _pair_gather(k, m_next)
    xa, ya, xb, yb = _gath(x, src), _gath(y, src), _gath(x, src1), _gath(y, src1)
    xeq = FP.eq(xa, xb)
    s_ab = FP.add(ya, yb)
    inf_out = xeq & FP.is_zero(s_ab)
    den = torch.where(xeq[..., None], s_ab, FP.sub(xb, xa))
    den = torch.where(inf_out[..., None], FP.one((), x.device), den)
    return dict(ka=ka, merge=merge, xa=xa, ya=ya, xb=xb, yb=yb, xeq=xeq, inf_out=inf_out,
                den=den)


def _lam_add(xa, ya, xb, num, dinv):
    """The affine sum of (xa, ya) and (xb, .) with slope num * dinv:
    lam, then x3 = lam^2 - xa - xb and y3 = lam (xa - x3) - ya (three K1
    launches)."""
    lam = FP.mont_mul(num, dinv)
    x3 = FP.sub(FP.sub(FP.mont_mul(lam, lam), xa), xb)
    return x3, FP.sub(FP.mont_mul(lam, FP.sub(xa, x3)), ya)


def _pass1_apply(g: dict, dinv: torch.Tensor):
    """Pass 1 on its gathers g (`_pass1_gather`) with the inverses of
    g["den"] given: the batched-affine pair merge.  Returns the survivors'
    keys and projective points (X, Y, Z), (Kw, m_next, 12) each; P + (-P)
    gives (0, 1, 0), a dead slot Z = 0.  5M + 2S per attempted add (four
    K1 launches)."""
    ka, merge, xeq = g["ka"], g["merge"], g["xeq"]
    xa, ya, xb, yb = g["xa"], g["ya"], g["xb"], g["yb"]
    x2 = FP.mont_mul(xa, xa)
    num = torch.where(xeq[..., None], FP.mul_small(x2, 3), FP.sub(yb, ya))
    x3, y3 = _lam_add(xa, ya, xb, num, dinv)
    one = FP.one((), xa.device)
    m1 = merge[..., None]
    i1 = (merge & g["inf_out"])[..., None]
    live = (ka < _SENT)[..., None]
    X = torch.where(i1, 0, torch.where(m1, x3, xa))
    Y = torch.where(i1, one, torch.where(m1, y3, ya))
    Z = torch.where(i1 | ~live, 0, one.expand_as(xa))
    return ka, (X, Y, Z)


def _affine_pass(k, x, y, m_next: int):
    """Pass 1 with its own inversion."""
    g = _pass1_gather(k, x, y, m_next)
    den = g["den"]
    dinv = block_batch_inv(den.reshape(-1, 12), zeros=False).reshape(den.shape)
    return _pass1_apply(g, dinv)


def _rcb_pass(ops, k, P, m_next: int):
    """Passes 2+: pair merge with the complete projective add (K6)."""
    src, src1, ka, merge = _pair_gather(k, m_next)
    A = tuple(_gath(c, src) for c in P)
    S = W.add(ops, A, tuple(_gath(c, src1) for c in P))
    out = W.select_point(ops, merge, S, A)
    return ka, W.select_point(ops, ka >= _SENT, W.identity(ops, (), k.device), out)


def _grid(k, P, nbuck: int) -> torch.Tensor:
    """Scatter each window's merged entries (unique keys) into its row of a
    (Kw, nbuck, 3, 12) identity grid; sentinel keys go to a dropped
    column."""
    ops = G1.ops()
    Kw = k.shape[0]
    ident = W.stack_point(ops, W.identity(ops, (), k.device))
    grid = ident.expand(Kw, nbuck + 1, 3, ident.shape[-1]).clone()
    rows = torch.arange(Kw, device=k.device)[:, None]
    grid[rows, torch.where(k < nbuck, k, nbuck)] = W.stack_point(ops, P)
    return grid[:, :nbuck]


def _merge_and_grid(ops, k, P, sizes, nbuck: int) -> torch.Tensor:
    """Passes 2+ and the bucket scatter.  A pass that shrinks the slots
    always runs; one that cannot runs only while a mergeable pair is left
    (one host fetch)."""
    for m_next in sizes[1:]:
        if m_next < k.shape[1] or bool(_any_mergeable(k)):
            k, P = _rcb_pass(ops, k, P, m_next)
    return _grid(k, P, nbuck)


def _window_params(c: int):
    return -(-258 // c), (1 << (c - 1)) + 1


def msm_g1_sorted(points, scalars_std, c: int = 16):
    """sum_i scalars[i] * points[i] over G1, one window at a time: the
    sort, pass 1 batched-affine with its own inversion, passes 2+ by the
    complete projective add, the window's bucket row.

    points: projective (X, Y, Z) of (n, 12) tensors; scalars_std: (n, 18)
    standard-domain Fr limbs.  Returns one projective point."""
    ops = G1.ops()
    K, nbuck = _window_params(c)
    tab, digits = _prep(points, scalars_std, c)
    sizes = pass_sizes(tab.shape[0], nbuck)
    grids = []
    for w in range(K):
        k, x, y = _sort_windows(digits[:, w:w + 1], tab)
        k, P = _affine_pass(k, x, y, sizes[0])
        grids.append(_merge_and_grid(ops, k, P, sizes, nbuck))
    return _finish(torch.cat(grids, 0), c, K, nbuck)


def msm_g1_sorted_staged_v1(points, scalars_std, c: int = 16):
    """msm_g1_sorted with ONE inversion over every window's pass-1
    denominators (one chain per call, not per window), the windows side by
    side.  Returns one projective point."""
    ops = G1.ops()
    K, nbuck = _window_params(c)
    tab, digits = _prep(points, scalars_std, c)
    sizes = pass_sizes(tab.shape[0], nbuck)
    k, x, y = _sort_windows(digits, tab)
    k, P = _affine_pass(k, x, y, sizes[0])
    return _finish(_merge_and_grid(ops, k, P, sizes, nbuck), c, K, nbuck)


# ---------------------------------------------------------------------------
# Every pass batched-affine, every window in each pass
# ---------------------------------------------------------------------------


def _v2_struct(k, x, y, inf, m_out: int) -> dict:
    """A pass's front, no product: the pair structure, the operands, the
    denominators.  inf None: the FAST pass (no infinity, and a merge pair
    with equal x only counted, in `xeq_any`); else the GENERAL pass over
    the infinity flags inf (Kw, m): a pair with an infinite member takes
    the other, equal x doubles (den 2 y) or cancels (P + (-P))."""
    src, src1, ka, merge = _pair_gather(k, m_out)
    xa, ya, xb, yb = _gath(x, src), _gath(y, src), _gath(x, src1), _gath(y, src1)
    xeq = FP.eq(xa, xb)
    one = FP.one((), x.device)
    st = dict(ka=ka, merge=merge, xa=xa, ya=ya, xb=xb, yb=yb)
    if inf is None:
        st["xeq_any"] = (xeq & merge).any()
        st["den"] = torch.where(merge[..., None], FP.sub(xb, xa), one)
        return st
    ia, ib = _flag_at(inf, src), _flag_at(inf, src1)
    live = merge & ~ia & ~ib
    xeq = xeq & live
    s_ab = FP.add(ya, yb)
    inf_out = xeq & FP.is_zero(s_ab)
    add_ok = live & ~inf_out
    den = torch.where(xeq[..., None], s_ab, FP.sub(xb, xa))
    st.update(ia=ia, ib=ib, xeq=xeq, inf_out=inf_out,
              den=torch.where(add_ok[..., None], den, one))
    return st


def _v2_apply(st: dict, dinv: torch.Tensor):
    """A pass's products and selects: (x, y, inf) of the survivors (inf
    None for a FAST pass).  Three K1 launches, four in a GENERAL pass (x^2
    for the doubling slope)."""
    xa, ya, xb, yb, merge = st["xa"], st["ya"], st["xb"], st["yb"], st["merge"]
    num = FP.sub(yb, ya)
    if "xeq" not in st:
        x3, y3 = _lam_add(xa, ya, xb, num, dinv)
        m1 = merge[..., None]
        return torch.where(m1, x3, xa), torch.where(m1, y3, ya), None
    ia, ib, xeq, inf_out = st["ia"], st["ib"], st["xeq"], st["inf_out"]
    num = torch.where(xeq[..., None], FP.mul_small(FP.mont_mul(xa, xa), 3), num)
    x3, y3 = _lam_add(xa, ya, xb, num, dinv)
    add_ok = (merge & ~ia & ~ib & ~inf_out)[..., None]
    take_b = (merge & ia & ~ib)[..., None]
    x_out = torch.where(add_ok, x3, torch.where(take_b, xb, xa))
    y_out = torch.where(add_ok, y3, torch.where(take_b, yb, ya))
    return x_out, y_out, torch.where(merge, (ia & ib) | inf_out, ia)


def _v2_finish(k, x, y, inf, c: int, nbuck: int):
    """The surviving affine entries as projective points (an infinite one
    as (0, 1, 0)) into the bucket grid, then `_finish`."""
    one = FP.one((), x.device)
    if inf is None:
        P = (x, y, one.expand_as(x))
    else:
        i1 = inf[..., None]
        P = (torch.where(i1, 0, x), torch.where(i1, one, y), torch.where(i1, 0, one.expand_as(x)))
    return _finish(_grid(k, P, nbuck), c, k.shape[0], nbuck)


def msm_g1_sorted_staged(points, scalars_std, c: int = 16, record: dict | None = None):
    """sum_i scalars[i] * points[i] over G1, every pass batched-affine over
    all windows at once (see the module docstring); the pass loop is
    driven from the host with ONE fetch per pass.  Returns one projective
    point.

    points: projective (X, Y, Z) of (n, 12) tensors (through the
    force-affine front); scalars_std: (n, 18) standard-domain Fr limbs.
    record: a dict that receives the pass count ("passes"), the pass (from
    1) at which GENERAL took over ("general_from", None: FAST throughout)
    and the output size of each pass run ("sizes")."""
    _, nbuck = _window_params(c)
    tab, digits = _prep(points, scalars_std, c)
    k, x, y = _sort_windows(digits, tab)
    del tab, digits
    sizes = pass_sizes(k.shape[1], nbuck)
    inf = None
    general_from = None
    st = _v2_struct(k, x, y, None, sizes[0])
    if bool(st["xeq_any"]):                                # pass 1's fetch
        general_from = 1
    for i, m_out in enumerate(sizes):
        if general_from is not None and "xeq" not in st:
            if inf is None:
                inf = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
            st = _v2_struct(k, x, y, inf, m_out)
        den = st.pop("den")
        dinv = block_batch_inv(den.reshape(-1, 12), zeros=False).reshape(den.shape)
        del den
        k = st["ka"]
        x, y, inf = _v2_apply(st, dinv)
        del st, dinv
        # the ONE fetch of the pass: is anything left to merge, and (FAST)
        # has the next pass an equal-x merge pair
        more = _any_mergeable(k)
        st = {}
        if general_from is None and i + 1 < len(sizes):
            st = _v2_struct(k, x, y, None, sizes[i + 1])
            more, nxt = torch.stack([more, st["xeq_any"]]).tolist()
            if more and nxt:
                general_from = i + 2
        else:
            more = bool(more)
        if not more:
            break
    else:
        # pass_sizes covers the worst case (ceil(log2 n) halvings)
        raise RuntimeError("sorted MSM: the merge passes did not converge")
    if record is not None:
        record.update(passes=i + 1, general_from=general_from, sizes=sizes[:i + 1])
    return _v2_finish(k, x, y, inf, c, nbuck)
