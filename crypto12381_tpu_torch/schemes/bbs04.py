"""BBS04 short group signatures (Boneh-Boyen-Shacham): key generation,
signing, verification and opening on the host, and batched verification
and opening.

Counterpart of the JAX package's `schemes/bbs04.py` (the reference's
examples/bbs04): the same algorithms, CSPRNG draw order and byte formats,
so a seeded flow gives the reference's bytes.  gpk = g1 | g2 | h | u | v
| w (G1 | G2 | G1^3 | G2), gmsk = xi1 | xi2, a member key A_i | x_i, a
signature T1 | T2 | T3 | c | sa | sb | sx | sd1 | sd2 (G1^3 | Zp^6).
Messages are bytes (the batched entry points also take str, as UTF-8).

The batched entry points run on the CUDA card by default (and raise
without one); `device="cpu"` runs the plain versions.  `verify_batch`
recomputes the commitments of every row with all thirteen G1 powers in ONE
stacked GLV call, R3 as a two-pair `pair_prod_fixed` on g2 and w, and the
Fiat-Shamir challenge on the device: the transcript bytes (g1_bytes,
gt_bytes) after each row's message, framed and hashed by
hashing/keccak.py, reduced mod r (hash_to_zp) and compared with c.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..api import batch as BT
from ..api.sets import G1, G2, Zp, hash_, inverse, pair, parse, select_in, serialize
from ..hashing import keccak as KC
from .bbs import fixed_bases, parse_points, row, stacked_powers

__all__ = ["Keys", "key_gen", "sign", "verify", "open_signature", "verify_batch", "open_batch"]


@dataclass
class Keys:
    gpk: bytes          # G1 | G2 | G1^3 | G2  (g1, g2, h, u, v, w)
    gmsk: bytes         # Zp^2                 (xi1, xi2)
    gsk: list           # [G1 | Zp]            (A_i, x_i) per member


def _mb(m) -> bytes:
    return m.encode() if isinstance(m, str) else bytes(m)


def key_gen(n: int, random) -> Keys:
    g1, h = select_in((~G1) ** 2, random)
    g2 = select_in(~G2, random)
    xi1, xi2, gamma = select_in((~Zp) ** 3, random)
    u = h ** inverse(xi1)
    v = h ** inverse(xi2)
    w = g2 ** gamma
    gsk = []
    for _ in range(n):
        xi = select_in(~Zp, random)
        gsk.append(serialize(g1 ** inverse(gamma + xi), xi))
    return Keys(gpk=serialize(g1, g2, h, u, v, w), gmsk=serialize(xi1, xi2), gsk=gsk)


def sign(gpk: bytes, gsk: bytes, message, random) -> bytes:
    g1, g2, h, u, v, w = parse(G1, G2, G1 ** 3, G2, gpk)
    A, x = parse(G1, Zp, gsk)
    alpha, beta, ra, rb, rx, rd1, rd2 = select_in(Zp ** 7, random)
    T1 = u ** alpha
    T2 = v ** beta
    T3 = A * (h ** (alpha + beta))
    R1 = u ** ra
    R2 = v ** rb
    R3 = pair((T3 ** rx) * (h ** (-(rd1 + rd2))), g2) * pair(h ** (-(ra + rb)), w)
    R4 = (T1 ** rx) * (u ** (-rd1))
    R5 = (T2 ** rx) * (v ** (-rd2))
    c = hash_(message, T1, T2, T3, R1, R2, R3, R4, R5).to(Zp)
    cx = c * x
    return serialize(T1, T2, T3, c, ra + c * alpha, rb + c * beta, rx + cx,
                     rd1 + alpha * cx, rd2 + beta * cx)


def verify(gpk: bytes, message, signature: bytes) -> bool:
    g1, g2, h, u, v, w = parse(G1, G2, G1 ** 3, G2, gpk)
    T1, T2, T3, c, sa, sb, sx, sd1, sd2 = parse(G1 ** 3, Zp ** 6, signature)
    neg_c = -c
    R1 = (u ** sa) * (T1 ** neg_c)
    R2 = (v ** sb) * (T2 ** neg_c)
    R3 = pair((T3 ** sx) * (h ** (-sd1 + -sd2)) / (g1 ** c), g2) * pair(
        (h ** (-(sa + sb))) * (T3 ** c), w)
    R4 = (T1 ** sx) * (u ** (-sd1))
    R5 = (T2 ** sx) * (v ** (-sd2))
    return c == hash_(message, T1, T2, T3, R1, R2, R3, R4, R5).to(Zp)


def open_signature(gmsk: bytes, signature: bytes) -> bytes:
    """The signer's A = T3 / (T1^xi1 T2^xi2)."""
    T1, T2, T3, *_ = parse(G1 ** 3, Zp ** 6, signature)
    xi1, xi2 = parse(Zp ** 2, gmsk)
    return serialize(T3 / ((T1 ** xi1) * (T2 ** xi2)))


def _parse_signatures(signatures, dev):
    """(T, s): T the (3, B) points T1, T2, T3 from ONE batched parse (one
    square-root chain), s the (6, B) scalars c, sa, sb, sx, sd1, sd2."""
    sig = [bytes(s) for s in signatures]
    s = BT.ZpVec.parse((s[147 + 48 * i:195 + 48 * i] for i in range(6) for s in sig), dev)
    return parse_points(sig, 3, dev), BT.ZpVec(s.std.reshape(6, len(sig), BT.FR_LIMBS))


def verify_batch(gpk: bytes, messages, signatures, device=None) -> np.ndarray:
    """Verify B group signatures under one gpk: a (B,) bool array.

    R1 = u^sa T1^-c, R2 = v^sb T2^-c, R4 = T1^sx u^-sd1, R5 = T2^sx v^-sd2
    and the G1 sides of R3 = e(T3^sx h^(-sd1 - sd2) g1^-c, g2)
    e(h^-(sa + sb) T3^c, w) take thirteen powers, ONE stacked GLV call of
    13 B rows; their products are two batched group operations.  The
    challenge is recomputed on the device and compared with c.  A point
    that does not parse or a scalar not below r raises ValueError."""
    dev = BT._device(device, "verify_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    B = len(messages)
    if B == 0:
        return np.zeros(0, bool)
    g1e, g2e, he, ue, ve, we = parse(G1, G2, G1 ** 3, G2, gpk)
    T, s = _parse_signatures(signatures, dev)
    T1, T2, T3 = (row(T, k) for k in range(3))
    c, sa, sb, sx, sd1, sd2 = (BT.ZpVec(s.std[i]) for i in range(6))
    neg = -s
    nc, nsa, nsb, _, nsd1, nsd2 = (BT.ZpVec(neg.std[i]) for i in range(6))
    g1, h, u, v = fixed_bases([g1e, he, ue, ve], dev)
    bases = [u, T1, v, T2, T1, u, T2, v, T3, h, g1, h, T3]
    exps = [sa, nc, sb, nc, sx, nsd1, sx, nsd2, sx, nsd1 + nsd2, nc, nsa + nsb, c]
    pw = stacked_powers(bases, BT.ZpVec(torch.stack([e.std for e in exps])))
    even = BT.G1Vec(tuple(t[[0, 2, 4, 6, 8, 11]] for t in pw.p))
    odd = BT.G1Vec(tuple(t[[1, 3, 5, 7, 9, 12]] for t in pw.p))
    prods = even * odd                                   # R1, R2, R4, R5, P/g1^-c, Q
    P = row(prods, 4) * row(pw, 10)
    R3 = BT.pair_prod_fixed((P, BT.G2Vec.from_elements([g2e], dev)),
                            (row(prods, 5), BT.G2Vec.from_elements([we], dev)))
    Tb = BT.g1_bytes(T)                                  # (3, B, 49)
    Rb = BT.g1_bytes(BT.G1Vec(tuple(t[:4] for t in prods.p)))   # one inversion chain
    elem = torch.cat([Tb[0], Tb[1], Tb[2], Rb[0], Rb[1], BT.gt_bytes(R3), Rb[2], Rb[3]], -1)
    msgs = [_mb(m) for m in messages]
    lens = np.array([len(m) for m in msgs], np.int64)
    md = np.zeros((B, max(1, int(lens.max()))), np.uint8)
    md[np.arange(md.shape[1])[None, :] < lens[:, None]] = np.frombuffer(b"".join(msgs), np.uint8)
    data, total = KC.assemble_rows(torch.from_numpy(md).to(dev), torch.from_numpy(lens).to(dev),
                                   elem)
    want = BT.hash_to_zp(KC.sha3_512_blocks(*KC.frame_device(data, total)))
    return (c == want).cpu().numpy()


def open_batch(gmsk: bytes, signatures, device=None) -> list[bytes]:
    """The signers' A = T3 / (T1^xi1 T2^xi2) of B signatures, both powers
    in ONE stacked GLV call of 2 B rows: a list of 49-byte points.  A point
    that does not parse or a scalar not below r raises ValueError."""
    dev = BT._device(device, "open_batch runs")
    B = len(signatures)
    if B == 0:
        return []
    xi1, xi2 = parse(Zp ** 2, gmsk)
    T, _ = _parse_signatures(signatures, dev)
    exps = BT.ZpVec.from_ints([xi1.value] * B + [xi2.value] * B, dev)
    pw = stacked_powers([row(T, 0), row(T, 1)],
                        BT.ZpVec(exps.std.reshape(2, B, BT.FR_LIMBS)))
    return (row(T, 2) / (row(pw, 0) * row(pw, 1))).serialize()
