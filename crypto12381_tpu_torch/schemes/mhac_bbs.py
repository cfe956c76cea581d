"""MHAC-BBS: multi-holder anonymous credentials over BBS with threshold
shares: issuer setup, attributes, issuing, presentation groups and types,
presentations and their verification on the host, and batched
presentation and verification.

Counterpart of the JAX package's `schemes/mhac_bbs.py` (the reference's
examples/MHAC-bbs): the same algorithms, CSPRNG draw order, index
conventions (private attribute shares party-major, shares[party][attr])
and byte formats, so a seeded flow gives the reference's bytes.  The
issuer Shamir-shares the BBS exponent e; a group of t holders combines
its shares by Lagrange interpolation in the exponent, and its members'
masked responses are aggregated into one presentation, whose fixed part
is A_ | B_ | ch | zr | ze (G1^2 | Zp^3).

`cred_pres_batch` and `verify_pres_batch` run on the CUDA card by
default (and raise without one); `device="cpu"` runs the plain versions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..api import batch as BT
from ..api.algebra import algebraic, symbols
from ..api.elements import ZpNumber
from ..api.sets import (G1, G2, Zp, hash_, inverse, make_Zp, pair, parse, polynomial, product_,
                        select_in, serialize, sum_)
from ..hashing import keccak as KC
from . import bbs
from .bbs import fixed_bases, parse_points, row, stacked_powers

__all__ = ["IssSetupResult", "Creds", "AttributesInfo", "PresGroup", "PresType", "Pres",
           "iss_setup", "generate_attributes", "cred_iss", "make_pres_group", "make_pres_type",
           "cred_pres", "cred_pres_batch", "verify_pres", "verify_pres_batch"]


@dataclass
class IssSetupResult:
    pp: bbs.PublicParameters
    keys: bbs.Keys


@dataclass
class AttributesInfo:
    public_attributes: list            # [Zp bytes] in Pub order
    private_attributes_share: list     # [party][prv_attr] Zp bytes
    commitments: list                  # [G1 bytes] per party


@dataclass
class Creds:
    A: bytes
    e_share: list
    D: list


@dataclass
class PresGroup:
    S: list
    lam: list      # [Zp bytes]
    D: bytes


@dataclass
class PresType:
    Rev: list
    C_rev: bytes
    C_pub: bytes


@dataclass
class Pres:
    fixed_part: bytes   # G1^2 | Zp^3  (A_, B_, ch, zr, ze)
    z: list
    z_hid_pub: list


def iss_setup(m: int, random) -> IssSetupResult:
    pp = bbs.setup(m, random)
    return IssSetupResult(pp=pp, keys=bbs.key_gen(pp, random))


def _pub_of(m, Prv):
    return [i for i in range(m) if i not in Prv]


def _lagrange_at_zero(x) -> list:
    """The Lagrange coefficients at 0 of the points x."""
    lam = []
    for k in range(len(x)):
        lk = ZpNumber(1)
        for y in range(len(x)):
            if y != k:
                lk = lk * (-x[y] / (x[k] - x[y]))
        lam.append(lk)
    return lam


def generate_attributes(pp, t: int, n: int, Prv, random) -> AttributesInfo:
    """m attributes, a Shamir polynomial of degree t - 1 for each private
    one, each party's shares and its commitment prod_i h[Prv[i]]^share."""
    h = [parse(G1, b) for b in pp.h]
    Pub = _pub_of(len(h), Prv)
    attr = select_in(Zp, random, len(h))
    a = select_in(Zp, random, len(Prv) * (t - 1))
    shares = [[polynomial(k + 1, attr[Prv[ii]], a[ii * (t - 1):(ii + 1) * (t - 1)])
               for k in range(n)] for ii in range(len(Prv))]
    C = [product_([h[Prv[ii]] ** shares[ii][k] for ii in range(len(Prv))]) for k in range(n)]
    return AttributesInfo(
        public_attributes=[serialize(attr[i]) for i in Pub],
        private_attributes_share=[[serialize(shares[ii][k]) for ii in range(len(Prv))]
                                  for k in range(n)],
        commitments=[serialize(c) for c in C])


def cred_iss(pp, sk: bytes, t: int, commitments, Pub, public_attributes, random) -> Creds:
    """A BBS signature A = C_a^(1/(gamma + e)) on the Lagrange-combined
    commitment C_a, e Shamir-shared, and each party's D_i = C_i A^-e_i."""
    g1, _ = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    gamma = parse(Zp, sk)
    C = [parse(G1, b) for b in commitments]
    pub_a = [parse(Zp, b) for b in public_attributes]
    lam = _lagrange_at_zero([make_Zp(i) for i in range(1, t + 1)])
    C_a = g1 * product_([C[i] ** lam[i] for i in range(t)]) * product_(
        [h[Pub[ii]] ** pub_a[ii] for ii in range(len(Pub))])
    e = select_in(Zp, random)
    A = C_a ** inverse(gamma + e)
    a = select_in(Zp, random, t - 1)
    e_share = [polynomial(i, e, a) for i in range(1, len(C) + 1)]
    D = [C[i] * (A ** (-e_share[i])) for i in range(len(C))]
    return Creds(A=serialize(A), e_share=[serialize(s) for s in e_share],
                 D=[serialize(d) for d in D])


def make_pres_group(creds: Creds, S) -> PresGroup:
    """Lagrange interpolation in the exponent over the parties S (points
    S[k] + 1): D = prod_k D_S[k]^lambda_k."""
    D_share = [parse(G1, b) for b in creds.D]
    lam = _lagrange_at_zero([make_Zp(i + 1) for i in S])
    D = product_([D_share[S[k]] ** lam[k] for k in range(len(S))])
    return PresGroup(S=list(S), lam=[serialize(v) for v in lam], D=serialize(D))


def make_pres_type(pp, Rev, Prv, public_attributes) -> PresType:
    """C_rev = g1 prod over the revealed public attributes, C_pub = C_rev
    times the product over the hidden public ones."""
    g1, _ = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    pub_a = [parse(Zp, b) for b in public_attributes]
    Pub = _pub_of(len(h), Prv)
    Hid = [i for i in range(len(h)) if i not in Rev]
    I_Pub_in_Rev = [i for i in range(len(Pub)) if Pub[i] in Rev]
    I_Pub_in_Hid = [i for i in range(len(Pub)) if Pub[i] in Hid]
    C_rev = (g1 * product_([h[Pub[ii]] ** pub_a[ii] for ii in I_Pub_in_Rev])
             if I_Pub_in_Rev else g1.point())
    C_pub = (C_rev * product_([h[Pub[ii]] ** pub_a[ii] for ii in I_Pub_in_Hid])
             if I_Pub_in_Hid else C_rev)
    return PresType(Rev=list(Rev), C_rev=serialize(C_rev), C_pub=serialize(C_pub))


class _Index:
    """The index sets of a presentation type: Pub, Hid, HidPub and the
    positions the responses and the transcript use."""

    def __init__(self, m: int, Prv, Rev):
        self.Pub = _pub_of(m, Prv)
        self.Hid = [i for i in range(m) if i not in Rev]
        self.HidPub = [i for i in self.Hid if i not in Prv]
        self.I_Pub_in_Rev = [i for i in range(len(self.Pub)) if self.Pub[i] in Rev]
        self.I_Pub_in_HidPub = [i for i in range(len(self.Pub)) if self.Pub[i] in self.HidPub]
        self.I_Hid_in_HidPub = [i for i in range(len(self.Hid)) if self.Hid[i] in self.HidPub]


def _draws(random, t: int, n_prv: int, n_hid: int):
    """One presentation's draws in the reference's order: r, alpha, the
    parties' betas, the aggregator's betas, the gammas."""
    r = select_in(Zp, random)
    alpha = select_in(Zp, random)
    beta_share = select_in(Zp, random, (t - 1) * n_prv)
    beta_share_j = select_in(Zp, random, n_hid)
    gamma_share = select_in(Zp, random, t)
    return r, alpha, beta_share, beta_share_j, gamma_share


def _responses(ix: _Index, Prv, ch, r, alpha, beta_share, beta_share_j, gamma_share, S, lam,
               a_share, e_share, pub_a):
    """z, ze, zr and z_hid_pub, with the aggregator at j = 0: Sigma over the
    party index k in the reference's symbolic notation."""
    t = len(S)
    k_, = symbols("kk")
    beta_rows = algebraic([beta_share_j] + [beta_share[(k - 1) * len(Prv):k * len(Prv)]
                                            for k in range(1, t)])
    S_r, lam_r = algebraic(S), algebraic(lam)
    a_share_r, e_share_r, gamma_r = algebraic(a_share), algebraic(e_share), algebraic(gamma_share)
    z = [sum_(beta_rows[k_][ii] + ch * (r * a_share_r[S_r[k_]][ii] * lam_r[k_]), k_.in_[t])
         for ii in range(len(Prv))]
    ze = sum_(gamma_r[k_] + ch * (-(e_share_r[S_r[k_]]) * lam_r[k_]), k_.in_[t])
    zr = alpha + ch * r
    z_hid_pub = [beta_share_j[ix.I_Hid_in_HidPub[ii]] + ch * (pub_a[ix.I_Pub_in_HidPub[ii]] * r)
                 for ii in range(len(ix.HidPub))]
    return z, ze, zr, z_hid_pub


def cred_pres(pp, creds: Creds, group: PresGroup, ptype: PresType, Prv, public_attributes,
              attr_shares, random) -> Pres:
    """A presentation of the group's credential under the type, on the
    host, with the aggregator at j = 0."""
    h = [parse(G1, b) for b in pp.h]
    A = parse(G1, creds.A)
    e_share = [parse(Zp, b) for b in creds.e_share]
    S = group.S
    lam = [parse(Zp, b) for b in group.lam]
    D = parse(G1, group.D)
    C_rev = parse(G1, ptype.C_rev)
    C_pub = parse(G1, ptype.C_pub)
    pub_a = [parse(Zp, b) for b in public_attributes]
    a_share = [[parse(Zp, b) for b in row_] for row_ in attr_shares]
    ix = _Index(len(h), Prv, ptype.Rev)
    t, j = len(S), 0

    r, alpha, beta_share, beta_share_j, gamma_share = _draws(random, t, len(Prv), len(ix.Hid))
    A_ = A ** r
    B_ = (C_pub * D) ** r

    # Pi[i.in(Hid)](h_i^beta_i) and the parties' products, in the
    # reference's symbolic index notation
    i_, = symbols("ii")
    h_r, Hid_r, Prv_r = algebraic(h), algebraic(ix.Hid), algebraic(Prv)
    bsj = algebraic(beta_share_j)
    Uj = (C_rev ** alpha) * product_(h_r[Hid_r[i_]] ** bsj[i_], i_.in_[len(ix.Hid)]) * (
        A_ ** gamma_share[j])
    Uks = [product_(h_r[Prv_r[i_]] ** algebraic(beta_share[(k - 1) * len(Prv):k * len(Prv)])[i_],
                    i_.in_[len(Prv)]) * (A_ ** gamma_share[k])
           for k in range(1, t)]
    U = Uj * product_(Uks) if Uks else Uj
    ch = hash_(U, A_, B_, [pub_a[ii] for ii in ix.I_Pub_in_Rev]).to(Zp)
    z, ze, zr, z_hid_pub = _responses(ix, Prv, ch, r, alpha, beta_share, beta_share_j,
                                      gamma_share, S, lam, a_share, e_share, pub_a)
    return Pres(fixed_part=serialize(A_, B_, ch, zr, ze), z=[serialize(v) for v in z],
                z_hid_pub=[serialize(v) for v in z_hid_pub])


def cred_pres_batch(pp, creds_list, group_list, ptype_list, Prv, public_attributes_list,
                    attr_shares_list, random, device=None) -> list[Pres]:
    """B presentations, byte-identical to B host cred_pres calls on the
    same CSPRNG stream.  All share (pp, Prv), one Rev and one threshold t.

    The draws stay on the host in cred_pres's order, one presentation
    after another.  U's product is flattened per base: the gammas' powers
    of A_ fold into A^(r Sigma gamma) (the same group element as
    A_^(Sigma gamma)), and each hidden base h_i takes the sum of its
    betas.  So a row needs A^r, (C_pub D)^r, C_rev^alpha, one power per
    hidden base and A^(r Sigma gamma): ONE stacked GLV call over all the
    rows, a tree of complete adds for U, and one g1_bytes of A_, B_ and U
    (one inversion chain).  The Fiat-Shamir hash and the linear responses
    run on the host."""
    dev = BT._device(device, "cred_pres_batch runs")
    B = len(creds_list)
    if not (len(group_list) == len(ptype_list) == len(public_attributes_list)
            == len(attr_shares_list) == B):
        raise ValueError("the presentation inputs differ in length")
    if B == 0:
        return []
    h = [parse(G1, b) for b in pp.h]
    Rev, t = ptype_list[0].Rev, len(group_list[0].S)
    if any(pt.Rev != Rev for pt in ptype_list) or any(len(g.S) != t for g in group_list):
        raise ValueError("cred_pres_batch needs one Rev and one threshold t")
    ix = _Index(len(h), Prv, Rev)
    # the hidden bases, then any private one that is revealed (none when
    # Rev lies in Pub, as the reference requires)
    hbases = ix.Hid + [i for i in Prv if i not in ix.Hid]
    draws, exps = [], []
    for _ in range(B):
        d = r, alpha, beta_share, beta_share_j, gamma_share = _draws(random, t, len(Prv),
                                                                     len(ix.Hid))
        draws.append(d)
        e = {i: beta_share_j[k].value for k, i in enumerate(ix.Hid)}
        for k in range(1, t):
            for pos, i in enumerate(Prv):
                e[i] = e.get(i, 0) + beta_share[(k - 1) * len(Prv) + pos].value
        gsum = sum(g.value for g in gamma_share)
        exps.append([r.value, r.value, alpha.value] + [e.get(i, 0) for i in hbases]
                    + [r.value * gsum])
    # the rows usually share their credential, group and type: each
    # distinct point is parsed (a host square root) once
    g1 = functools.lru_cache(maxsize=None)(lambda b: parse(G1, b))
    A = BT.G1Vec.from_elements([g1(c.A) for c in creds_list], dev)
    CD = (BT.G1Vec.from_elements([g1(pt.C_pub) for pt in ptype_list], dev)
          * BT.G1Vec.from_elements([g1(g.D) for g in group_list], dev))
    C_rev = BT.G1Vec.from_elements([g1(pt.C_rev) for pt in ptype_list], dev)
    k = len(exps[0])
    e = BT.ZpVec.from_ints([exps[b][i] for i in range(k) for b in range(B)], dev)
    pw = stacked_powers([A, CD, C_rev] + fixed_bases([h[i] for i in hbases], dev) + [A],
                        BT.ZpVec(e.std.reshape(k, B, BT.FR_LIMBS)))
    U = BT.G1Vec(tuple(c[2:] for c in pw.p)).product(0)
    AB = BT.G1Vec(tuple(c[:2] for c in pw.p))
    enc = BT.g1_bytes(bbs.cat_rows(AB, BT.G1Vec(tuple(c[None] for c in U.p)))).cpu().numpy()
    A_b, B_b, U_b = ([bytes(x) for x in enc[i]] for i in range(3))
    out = []
    for b in range(B):
        pub_a = [parse(Zp, x) for x in public_attributes_list[b]]
        a_share = [[parse(Zp, x) for x in row_] for row_ in attr_shares_list[b]]
        e_share = [parse(Zp, x) for x in creds_list[b].e_share]
        lam = [parse(Zp, x) for x in group_list[b].lam]
        r, alpha, beta_share, beta_share_j, gamma_share = draws[b]
        ch = hash_(U_b[b], A_b[b], B_b[b], [pub_a[ii] for ii in ix.I_Pub_in_Rev]).to(Zp)
        z, ze, zr, z_hid_pub = _responses(ix, Prv, ch, r, alpha, beta_share, beta_share_j,
                                          gamma_share, group_list[b].S, lam, a_share, e_share,
                                          pub_a)
        out.append(Pres(fixed_part=A_b[b] + B_b[b] + bytes(serialize(ch, zr, ze)),
                        z=[bytes(serialize(v)) for v in z],
                        z_hid_pub=[bytes(serialize(v)) for v in z_hid_pub]))
    return out


def verify_pres(pp, pk: bytes, ptype: PresType, Prv, public_attributes, pres: Pres) -> bool:
    """U = B_^-ch C_rev^zr prod h^z A_^ze; ch == H(U, A_, B_, revealed)
    and e(A_, w) == e(B_, g2), on the host."""
    _, g2 = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    w = parse(G2, pk)
    C_rev = parse(G1, ptype.C_rev)
    pub_a = [parse(Zp, b) for b in public_attributes]
    A_, B_, ch, zr, ze = parse(G1 ** 2, Zp ** 3, pres.fixed_part)
    z = [parse(Zp, b) for b in pres.z]
    z_hid_pub = [parse(Zp, b) for b in pres.z_hid_pub]
    ix = _Index(len(h), Prv, ptype.Rev)
    C_hid = product_([h[Prv[ii]] ** z[ii] for ii in range(len(Prv))]
                     + [h[ix.HidPub[ii]] ** z_hid_pub[ii] for ii in range(len(ix.HidPub))])
    U = (B_ ** (-ch)) * (C_rev ** zr) * C_hid * (A_ ** ze)
    ok_ch = ch == hash_(U, A_, B_, [pub_a[ii] for ii in ix.I_Pub_in_Rev]).to(Zp)
    return ok_ch and pair(A_, w) == pair(B_, g2)


def verify_pres_batch(pp, pk: bytes, ptype: PresType, Prv, public_attributes, presentations,
                      device=None) -> np.ndarray:
    """Verify B presentations under one (pp, pk, ptype, Prv, public
    attributes): a (B,) bool array.

    A_ and B_ of every row come from ONE batched parse (one square-root
    chain); U = B_^-ch C_rev^zr A_^ze prod h_Prv^z prod h_HidPub^z' takes
    ONE stacked GLV call of (3 + |Prv| + |HidPub|) B rows and a tree of
    complete adds; e(A_, w) == e(B_, g2) is one two-pair pair_prod_fixed
    on the fixed w and g2.  The challenge is recomputed on the device:
    g1_bytes(U) | g1_bytes(A_) | g1_bytes(B_) | the revealed public
    attributes, framed and hashed by hashing/keccak.py, reduced mod r
    (hash_to_zp) and compared with ch.  A point that does not parse or a
    scalar not below r raises ValueError."""
    dev = BT._device(device, "verify_pres_batch runs")
    B = len(presentations)
    if B == 0:
        return np.zeros(0, bool)
    _, g2 = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    w = parse(G2, pk)
    pub_a = [parse(Zp, b) for b in public_attributes]
    ix = _Index(len(h), Prv, ptype.Rev)
    fixed = [bytes(p.fixed_part) for p in presentations]
    AB = parse_points(fixed, 2, dev)
    A_, B_ = row(AB, 0), row(AB, 1)
    nz = len(Prv) + len(ix.HidPub)
    scal = BT.ZpVec.parse([f[98 + 48 * i:146 + 48 * i] for i in range(3) for f in fixed]
                          + [bytes(p.z[ii]) for ii in range(len(Prv)) for p in presentations]
                          + [bytes(p.z_hid_pub[ii]) for ii in range(len(ix.HidPub))
                             for p in presentations], dev)
    s = scal.std.reshape(3 + nz, B, BT.FR_LIMBS)
    ch = BT.ZpVec(s[0])
    exps = torch.cat([(-ch).std[None], s[1:]])                  # -ch, zr, ze, z, z'
    bases = [B_] + fixed_bases([parse(G1, ptype.C_rev)], dev) + [A_] + fixed_bases(
        [h[i] for i in Prv + ix.HidPub], dev)
    U = stacked_powers(bases, BT.ZpVec(exps)).product(0)
    ok_pair = BT.pair_prod_fixed((A_, BT.G2Vec.from_elements([w], dev)),
                                 (B_.inverse(), BT.G2Vec.from_elements([g2], dev))).is_one()
    ABb = BT.g1_bytes(AB)
    rev = b"".join(pub_a[ii].serialize() for ii in ix.I_Pub_in_Rev)
    revb = torch.frombuffer(bytearray(rev), dtype=torch.uint8).to(dev) if rev else \
        torch.zeros(0, dtype=torch.uint8, device=dev)
    data = torch.cat([BT.g1_bytes(U), ABb[0], ABb[1], revb.expand(B, -1)], -1)
    lens = torch.full((B,), data.shape[1], dtype=torch.int64, device=dev)
    want = BT.hash_to_zp(KC.sha3_512_blocks(*KC.frame_device(data, lens)))
    return (ok_pair & (ch == want)).cpu().numpy()
