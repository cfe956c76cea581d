"""Batched optimal-ate pairing with the reference's normalization.

Counterpart of the JAX package's `pairing/pairing.py`: the n3/n digit
Miller loop with M-type twist line functions, the final conjugation for
the negative x, and the final exponentiation whose hard part is CUBED (the
reference's reduced pairing is the textbook ate pairing cubed); products
of pairings with one shared squaring chain (`multi_miller_shared`, and
`multi_miller_precomp` on precomputed fixed-G2 lines); and the GT power
`gt_pow`.  The digit schedule is a host constant, so the loops are plain
Python loops over static digits: no data-dependent control flow.

Line values are sparse Fp12 elements with w-basis coefficients at
positions (0, 3, 5).
"""

from __future__ import annotations

import functools

import torch

from ..curves import g2 as G2
from ..fields import fp as FP
from ..fields import fused as FK
from ..fields import tower as TW
from ..host.curve import G1_GEN, G2_GEN
from ..ops import scalar_decomp as SD
from ..params import LIMBS, P, R, X_ABS


@functools.lru_cache(maxsize=1)
def _digits() -> list[int]:
    """bt_i = bit(3n, i) - bit(n, i) for i = nb-2 .. 1, n = |x|."""
    n = X_ABS
    n3 = 3 * n
    nb = n3.bit_length()
    return [((n3 >> i) & 1) - ((n >> i) & 1) for i in range(nb - 2, 0, -1)]


def _exponent_identity_check():
    """The hard-part decomposition used below, checked exactly on import."""
    x = -X_ABS
    lhs = (x - 1) ** 2 * (x + P) * (x * x + P * P - 1) + 3
    assert lhs == 3 * ((P**4 - P**2 + 1) // R), "hard-part identity"


_exponent_identity_check()


# ---------------------------------------------------------------------------
# Line evaluation (M-type twist)
# ---------------------------------------------------------------------------


def _line_dbl_coeffs(A):
    """Tangent line at A = (X, Y, Z): AA = -2YZ xi; BB = 12 xi Z^2 - Y^2;
    CC = 3X^2."""
    X, Y, Z = A
    yz, x2, y2, z2 = TW.fp2_mul_many([(Y, Z), (X, X), (Y, Y), (Z, Z)])
    aa = TW.fp2_mul_xi(TW.fp2_neg(TW.fp2_add(yz, yz)))
    bb = TW.fp2_sub(TW.fp2_mul_xi(TW.fp2_mul_small(z2, 12)), y2)
    cc = TW.fp2_mul_small(x2, 3)
    return (aa, bb, cc)


def _line_add_coeffs(A, Pxy):
    """Chord through A = (X1, Y1, Z1) and affine (X2, Y2):
    l1 = X1 - Z1 X2; l2 = Y1 - Z1 Y2; AA = xi l1; BB = l2 X2 - l1 Y2;
    CC = -l2."""
    X1, Y1, Z1 = A
    X2, Y2 = Pxy
    zx, zy = TW.fp2_mul_many([(Z1, X2), (Z1, Y2)])
    l1 = TW.fp2_sub(X1, zx)
    l2 = TW.fp2_sub(Y1, zy)
    m1, m2 = TW.fp2_mul_many([(l2, X2), (l1, Y2)])
    return (TW.fp2_mul_xi(l1), TW.fp2_sub(m1, m2), TW.fp2_neg(l2))


def _eval_line(coeffs, qx, qy):
    """(AA, BB, CC) -> sparse line value (AA qy, BB, CC qx) at the G1
    point: both products in one K1 launch."""
    aa, bb, cc = coeffs
    t = FP.mont_mul(torch.stack([aa, cc]), torch.stack([qy, qx])[..., None, :])
    return (t[0], bb, t[1])


def _line_dbl(A, qx, qy):
    return _eval_line(_line_dbl_coeffs(A), qx, qy)


def _line_add(A, Pxy, qx, qy):
    return _eval_line(_line_add_coeffs(A, Pxy), qx, qy)


def _mul_sparse(f, line):
    """f * line where line = (c0, c3, c5) has w-coefficients only at
    positions 0, 3, 5: one K11 launch (fields/fused.fp12_sparse_mul) on
    the line packed as (..., 3, 2, 12)."""
    return FK.fp12_sparse_mul(f, torch.stack(torch.broadcast_tensors(*line), -3))


def _mul_lines(f, c0, c3, c5, inf):
    """f times the k lines (c0[i], c3[i], c5[i]) in order, each coefficient
    (k, batch..., 2, 12): ONE K11 launch on the (k, batch..., 3, 2, 12)
    stack.  inf: (k, batch...) bool or None; a flagged pair's line is 1
    (c0 = 1, c3 = c5 = 0)."""
    if inf is not None:
        m = inf[..., None, None]
        c0 = torch.where(m, TW.fp2_one((), f.device), c0)
        c3 = torch.where(m, 0, c3)
        c5 = torch.where(m, 0, c5)
    return FK.fp12_sparse_mul(f, torch.stack(torch.broadcast_tensors(c0, c3, c5), -3))


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def miller_loop(p_aff, q_aff):
    """f over the reference's n3/n digit schedule.

    p_aff: G1 affine (x, y), Fp tensors (..., 12)
    q_aff: G2 affine (X, Y), Fp2 tensors (..., 2, 12)
    Returns the Miller value after the negative-x conjugation."""
    qx, qy = p_aff
    Px, Py = q_aff
    batch = qx.shape[:-1]
    dev = qx.device
    NPy = TW.fp2_neg(Py)
    A = (Px, Py, TW.fp2_one(batch, dev))
    f = TW.fp12_one(batch, dev)
    for d in _digits():
        f = TW.fp12_sqr(f)
        f = _mul_sparse(f, _line_dbl(A, qx, qy))
        A = G2.double(A)
        if d:
            pay = Py if d > 0 else NPy
            f = _mul_sparse(f, _line_add(A, (Px, pay), qx, qy))
            A = G2.madd(A, (Px, pay))
    return TW.fp12_conj(f)


def multi_miller(p_affs, q_affs):
    """The product of the Miller values of k pairs along the leading axis
    (one final exponentiation serves them all).  Up to 4 pairs share one
    squaring chain (multi_miller_shared); more run as one batched Miller
    loop and a tree of Fp12 products."""
    if p_affs[0].shape[0] <= 4:
        return multi_miller_shared(p_affs, q_affs)
    return fp12_tree_product(miller_loop(p_affs, q_affs))


def fp12_tree_product(f):
    """The product of the Fp12 values along the leading axis: a log-depth
    tree of stacked Fp12 products."""
    while f.shape[0] > 1:
        k = f.shape[0]
        half = k // 2
        red = TW.fp12_mul(f[:half], f[half:2 * half])
        f = red if k % 2 == 0 else torch.cat([red, f[-1:]], 0)
    return f[0]


def multi_miller_shared(p_affs, q_affs, inf=None):
    """prod_i Miller(P_i, Q_i) over the leading axis k with ONE shared
    squaring chain: per digit step the accumulator squares once and
    absorbs every pair's line in one sparse product launch (the
    reference's PAIR_another accumulation).  Every pair runs its own G2
    steps, one batch over the k pairs and the rows.

    p_affs: G1 affine (x, y), tensors (k, batch..., 12); q_affs: G2 affine
    (X, Y), tensors (k, batch..., 2, 12); inf: optional (k, batch...) bool,
    a flagged pair contributing exactly 1 (its points become the
    generators, so that the line algebra stays finite, and its lines 1).
    Returns the product after the negative-x conjugation."""
    qx, qy = p_affs
    Px, Py = q_affs
    dev = qx.device
    if inf is not None:
        m1 = inf[..., None]
        m2 = inf[..., None, None]
        g2x, g2y = (torch.stack([FP.from_int(c[0], dev), FP.from_int(c[1], dev)])
                    for c in G2_GEN)
        qx = torch.where(m1, FP.from_int(G1_GEN[0], dev), qx)
        qy = torch.where(m1, FP.from_int(G1_GEN[1], dev), qy)
        Px = torch.where(m2, g2x, Px)
        Py = torch.where(m2, g2y, Py)
    NPy = TW.fp2_neg(Py)
    A = (Px, Py, TW.fp2_one(qx.shape[:-1], dev))
    f = TW.fp12_one(qx.shape[1:-1], dev)

    for d in _digits():
        f = TW.fp12_sqr(f)
        f = _mul_lines(f, *_line_dbl(A, qx, qy), inf)
        A = G2.double(A)
        if d:
            pay = Py if d > 0 else NPy
            f = _mul_lines(f, *_line_add(A, (Px, pay), qx, qy), inf)
            A = G2.madd(A, (Px, pay))
    return TW.fp12_conj(f)


def multi_pairing(p_affs, q_affs):
    """e(P_1, Q_1) e(P_2, Q_2) ... over the leading axis, one final
    exponentiation."""
    return final_exp(multi_miller(p_affs, q_affs))


# ---------------------------------------------------------------------------
# Fixed-G2 precomputed lines
# ---------------------------------------------------------------------------
# A scheme's verify pairs against fixed public-key G2 points: the Miller
# loop's G2 arithmetic (the line coefficients and the double/add steps)
# depends on Q alone, so for a fixed Q it runs once, batch-free, and the
# batch's loop only evaluates the lines at its G1 points (the batched
# analogue of MIRACL's PAIR_precomp / PAIR_another_pc).


def precompute_g2_lines(q_aff):
    """The Miller line coefficients of fixed G2 points Q.

    q_aff: affine (X, Y) Fp2 tensors (..., 2, 12): one point, or a few
    fixed points as one batch (pair_prod_fixed passes all of its Q at
    once, one pass through the digit schedule).  Returns (dbl, add): two
    (n_digits, 3, ..., 2, 12) tensors, per digit step the tangent line's
    (AA, BB, CC) and, where the digit is nonzero, the chord line's (zeros
    elsewhere), the JAX package's layout."""
    Px, Py = q_aff
    batch, dev = Px.shape[:-2], Px.device
    NPy = TW.fp2_neg(Py)
    A = (Px, Py, TW.fp2_one(batch, dev))
    none = torch.zeros((3,) + tuple(batch) + (2, LIMBS), dtype=torch.int32, device=dev)
    dbl, add = [], []
    for d in _digits():
        dbl.append(torch.stack(_line_dbl_coeffs(A)))
        A = G2.double(A)
        if d:
            pay = Py if d > 0 else NPy
            add.append(torch.stack(_line_add_coeffs(A, (Px, pay))))
            A = G2.madd(A, (Px, pay))
        else:
            add.append(none)
    return torch.stack(dbl), torch.stack(add)


def _absorb(f, coeffs, qx, qy, inf):
    """f times k precomputed lines, each evaluated at its pair's G1 points:
    coeffs (3, k, 2, 12); qx, qy (k, batch..., 12); inf (k, batch...) or
    None, a masked pair's line being 1.  The k evaluations are one K1
    launch; the k sparse products one K11 launch."""
    k, nb = qx.shape[0], qx.dim() - 2
    aa, bb, cc = (c.reshape((k,) + (1,) * nb + (2, LIMBS)) for c in coeffs)
    t = FP.mont_mul(torch.stack([aa, cc]), torch.stack([qy, qx])[..., None, :])
    return _mul_lines(f, t[0], bb, t[1], inf)


def multi_miller_precomp(p_affs, lines, inf=None):
    """prod_i Miller(P_i, Q_i) for k fixed Q_i, with ONE shared squaring
    chain: per digit step the accumulator squares once and absorbs each
    pair's precomputed line evaluated at P_i; no G2 arithmetic in the loop.

    p_affs: G1 affine (x, y), tensors (k, batch..., 12);
    lines: precompute_g2_lines of the k points Q_i as one batch;
    inf: optional (k, batch...) bool, a flagged pair contributes exactly 1.
    Returns the product after the negative-x conjugation."""
    qx, qy = p_affs
    dbl, add = lines
    f = TW.fp12_one(qx.shape[1:-1], qx.device)
    for j, d in enumerate(_digits()):
        f = TW.fp12_sqr(f)
        f = _absorb(f, dbl[j], qx, qy, inf)
        if d:
            f = _absorb(f, add[j], qx, qy, inf)
    return TW.fp12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _pow_abs_x(g):
    """g^|x| by cyclotomic squarings, with a multiply at each of the 5 set
    bits of |x| after the leading one: the whole chain in one launch
    (fields/fused.fp12_cyc_pow_fixed)."""
    return FK.fp12_cyc_pow_fixed(g, X_ABS)


def final_exp(f):
    """f^((p^12-1)/r * 3): the easy part, then the cubed hard part
    3(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3."""
    m = TW.fp12_mul(TW.fp12_conj(f), TW.fp12_inv(f))
    m = TW.fp12_mul(TW.fp12_frob(m, 2), m)
    # m is in the cyclotomic subgroup: inverse == conjugate
    a = TW.fp12_conj(TW.fp12_mul(_pow_abs_x(m), m))                # m^(x-1)
    b = TW.fp12_conj(TW.fp12_mul(_pow_abs_x(a), a))                # a^(x-1)
    d = TW.fp12_mul(TW.fp12_conj(_pow_abs_x(b)), TW.fp12_frob(b, 1))  # b^(x+p)
    dx2 = _pow_abs_x(_pow_abs_x(d))
    e = TW.fp12_mul(TW.fp12_mul(dx2, TW.fp12_frob(d, 2)), TW.fp12_conj(d))
    return TW.fp12_mul(e, TW.fp12_mul(TW.fp12_sqr(m), m))           # e * m^3


# ---------------------------------------------------------------------------
# GT exponentiation (Galbraith-Scott, cyclotomic squarings)
# ---------------------------------------------------------------------------


def gt_pow(f, e_std):
    """f^e for f in GT (a reduced-pairing value) and e_std standard-domain
    Fr limbs (..., 18): the reference's PAIR_GTpow.

    e = sum_i d_i |x|^i with the Frobenius as the endomorphism (f^p = f^x
    on the r-torsion; conjugation is the inverse in the cyclotomic
    subgroup): a 16-entry table of subset products of
    {f, conj(f^p), f^(p^2), conj(f^(p^3))}, then 64 steps of a cyclotomic
    square (K10) and a product (K8) by the row's entry.  Each level of the
    table is one stacked Fp12 product over its entries."""
    batch = f.shape[:-4]
    bases = [f, TW.fp12_conj(TW.fp12_frob(f, 1)), TW.fp12_frob(f, 2),
             TW.fp12_conj(TW.fp12_frob(f, 3))]
    T = TW.fp12_one(batch, f.device)[None]
    for b in bases:
        T = torch.cat([T, TW.fp12_mul(T, b)], 0)           # (2^(i+1), ..., 2, 3, 2, 12)
    bits = SD.bits_msb_first(SD.gs_split(e_std), SD.GS_BITS)      # (64, ..., 4)
    idxs = (bits * torch.tensor([1, 2, 4, 8], device=bits.device)).sum(-1)
    flat = T.reshape((16, -1) + T.shape[-4:])
    rows = torch.arange(flat.shape[1], device=f.device)
    acc = TW.fp12_one(batch, f.device)
    for i in range(SD.GS_BITS):
        acc = TW.fp12_usqr(acc)
        acc = TW.fp12_mul(acc, flat[idxs[i].reshape(-1), rows].reshape(acc.shape))
    return acc


# ---------------------------------------------------------------------------
# Public pairing API
# ---------------------------------------------------------------------------


def pairing_affine(p_aff, q_aff, p_inf=None, q_inf=None):
    """Reduced pairing e(P, Q) from affine coordinates.  Optional boolean
    infinity masks (batch shape) give e(O, .) = e(., O) = 1."""
    f = final_exp(miller_loop(p_aff, q_aff))
    if p_inf is not None or q_inf is not None:
        batch = p_aff[0].shape[:-1]
        inf = torch.zeros(batch, dtype=torch.bool, device=f.device)
        for m in (p_inf, q_inf):
            if m is not None:
                inf = inf | torch.as_tensor(m, dtype=torch.bool, device=f.device)
        f = torch.where(inf[..., None, None, None, None], TW.fp12_one(batch, f.device), f)
    return f


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pair_batch runs on a CUDA card by default and none is present; "
                "pass device='cpu' to run the plain versions")
        device = "cuda"
    return torch.device(device)


def pair_batch(g1_points, g2_points, p_inf=None, q_inf=None, device=None):
    """Batched reduced pairing of host affine points.

    g1_points: list of (x, y) ints, or None for the point at infinity.
    g2_points: list of ((xr, xi), (yr, yi)), or None.
    p_inf, q_inf: optional boolean masks; a masked row pairs to one.
    device: defaults to the CUDA card, and raises if there is none.
    Returns the GT values as a (B, 2, 3, 2, 12) tensor on the device
    (tower.fp12_to_host and compat.codec.gt_serialize read them back)."""
    dev = _device(device)
    n = len(g1_points)
    if len(g2_points) != n:
        raise ValueError("g1_points and g2_points differ in length")
    g1_inf = [pt is None for pt in g1_points]
    g2_inf = [pt is None for pt in g2_points]
    g1 = [G1_GEN if pt is None else pt for pt in g1_points]
    g2 = [G2_GEN if pt is None else pt for pt in g2_points]
    px = FP.from_int([pt[0] for pt in g1], dev)
    py = FP.from_int([pt[1] for pt in g1], dev)
    qx = torch.stack([FP.from_int([pt[0][0] for pt in g2], dev),
                      FP.from_int([pt[0][1] for pt in g2], dev)], -2)
    qy = torch.stack([FP.from_int([pt[1][0] for pt in g2], dev),
                      FP.from_int([pt[1][1] for pt in g2], dev)], -2)
    pm = torch.tensor(g1_inf, dtype=torch.bool)
    qm = torch.tensor(g2_inf, dtype=torch.bool)
    if p_inf is not None:
        pm = pm | torch.as_tensor(p_inf, dtype=torch.bool).cpu()
    if q_inf is not None:
        qm = qm | torch.as_tensor(q_inf, dtype=torch.bool).cpu()
    return pairing_affine((px, py), (qx, qy), pm.to(dev), qm.to(dev))
