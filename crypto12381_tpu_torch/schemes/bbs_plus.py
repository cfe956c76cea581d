"""BBS+ signatures (BBS with a blinding base h0): setup, key generation,
the host signer, and batched signing and verification.

Counterpart of the JAX package's `schemes/bbs_plus.py` (the reference's
examples/bbs-plus): the same algorithms, CSPRNG draw order and byte
formats.  A message is raw bytes, encoded with `encode_to(Zp, ...)`; a
signature is A | x | r (G1 | Zp | Zp).

The batched paths are schemes/bbs.py's with one more row block in the
stacked GLV call: h0^r for the blinding.  They run on the CUDA card by
default (and raise without one); `device="cpu"` runs the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..api import batch as BT
from ..api.sets import (G1, G2, Zp, encode_to, inverse, pair, parse, product_, select_in,
                        serialize)
from .bbs import (Keys, base_product, block_exponents, fixed_bases, sign_from_base,
                  stacked_powers, verify_from_bases)

__all__ = ["PublicParameters", "Keys", "setup", "key_gen", "sign", "sign_batch", "verify",
           "verify_batch"]


@dataclass
class PublicParameters:
    g1_g2_h0: bytes    # G1 | G2 | G1
    h: list            # [G1 bytes], one base per message block


def setup(n: int, random) -> PublicParameters:
    """g1, g2, the blinding base h0 and n block bases h_i, each a nonzero
    power of a generator."""
    g1 = select_in(~G1, random)
    g2 = select_in(~G2, random)
    h0 = select_in(~G1, random)
    h = [serialize(select_in(~G1, random)) for _ in range(n)]
    return PublicParameters(g1_g2_h0=serialize(g1, g2, h0), h=h)


def key_gen(pp: PublicParameters, random) -> Keys:
    gamma = select_in(~Zp, random)
    _, g2, _ = parse(G1, G2, G1, pp.g1_g2_h0)
    return Keys(pk=serialize(g2 ** gamma), sk=serialize(gamma))


def sign(pp: PublicParameters, sk: bytes, message: bytes, random) -> bytes:
    """A = (g1 h0^r prod h_i^m_i)^(1/(gamma + x)) for draws (x, r);
    sigma = (A, x, r).  On the host; an empty message raises (an empty
    product), as in the JAX package."""
    g1, _, h0 = parse(G1, G2, G1, pp.g1_g2_h0)
    h = [parse(G1, b) for b in pp.h]
    gamma = parse(Zp, sk)
    m = encode_to(Zp, message)
    if len(m) > len(h):
        raise ValueError("message is too long")
    x, r = select_in(Zp ** 2, random)
    base = g1 * (h0 ** r) * product_([h[i] ** m[i] for i in range(len(m))])
    return serialize(base ** inverse(gamma + x), x, r)


def verify(pp: PublicParameters, pk: bytes, message: bytes, signature: bytes) -> bool:
    """e(A, w g2^x) == e(g1 h0^r prod h_i^m_i, g2), on the host."""
    g1, g2, h0 = parse(G1, G2, G1, pp.g1_g2_h0)
    h = [parse(G1, b) for b in pp.h]
    w = parse(G2, pk)
    m = encode_to(Zp, message)
    if len(m) > len(h):
        raise ValueError("message is too long")
    A, x, r = parse(G1, Zp, Zp, signature)
    rhs = g1 * (h0 ** r) * product_([h[i] ** m[i] for i in range(len(m))])
    return pair(A, w * (g2 ** x)) == pair(rhs, g2)


def sign_batch(pp: PublicParameters, sk: bytes, messages, random, device=None) -> list[bytes]:
    """B signatures, byte-identical to B host signs on the same CSPRNG
    stream.  messages: B raw byte strings.  Per message, on the host and
    in the reference's order, the draws (x, r) and 1/(gamma + x); then
    base = g1 h0^r prod h_i^m_i with h0^r and every block ladder in one
    ((1 + n) B)-row GLV call, and A = base^(1/(gamma + x)) at B rows."""
    dev = BT._device(device, "sign_batch runs")
    g1e, _, h0e = parse(G1, G2, G1, pp.g1_g2_h0)
    he = [parse(G1, b) for b in pp.h]
    gamma = parse(Zp, sk)
    enc = [encode_to(Zp, m) for m in messages]
    n = max((len(e) for e in enc), default=0)
    if n > len(he):
        raise ValueError("message is too long")
    xr, rs, einv = [], [], []
    for _ in enc:
        x, r = select_in(Zp ** 2, random)
        xr.append(x.serialize() + r.serialize())
        rs.append(r.value)
        einv.append(inverse(gamma + x).value)
    B = len(enc)
    if B == 0:
        return []
    exps = torch.cat([BT.ZpVec.from_ints(rs, dev).std[None], block_exponents(enc, n, dev).std])
    powers = stacked_powers(fixed_bases([h0e] + he[:n], dev), BT.ZpVec(exps))
    return sign_from_base(einv, xr, base_product(BT.G1Vec.from_elements([g1e], dev), powers, B))


def verify_batch(pp: PublicParameters, pk: bytes, messages, signatures,
                 device=None) -> np.ndarray:
    """Verify B signatures under one (pp, pk): a (B,) bool array.
    messages: B raw byte strings.  An A that does not parse, an x or r
    that is not below r, or a message longer than pp.h raises ValueError."""
    dev = BT._device(device, "verify_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    g1e, g2e, h0e = parse(G1, G2, G1, pp.g1_g2_h0)
    he = [parse(G1, b) for b in pp.h]
    we = parse(G2, pk)
    enc = [encode_to(Zp, m) for m in messages]
    n = max((len(e) for e in enc), default=0)
    if n > len(he):
        raise ValueError("message is too long")
    if not enc:
        return np.zeros(0, bool)
    sig = [bytes(s) for s in signatures]
    A = BT.G1Vec.parse((s[:49] for s in sig), dev)
    xs = BT.ZpVec.parse((s[49:97] for s in sig), dev)
    rs = BT.ZpVec.parse((s[97:145] for s in sig), dev)
    exps = torch.cat([rs.std[None], block_exponents(enc, n, dev).std])
    return verify_from_bases(A, xs, fixed_bases([h0e] + he[:n], dev), BT.ZpVec(exps),
                          BT.G1Vec.from_elements([g1e], dev),
                          BT.G2Vec.from_elements([we], dev), BT.G2Vec.from_elements([g2e], dev))
