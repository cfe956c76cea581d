"""BBS signatures over pre-encoded messages: setup, key generation, the
host signer, and batched signing and verification.

Counterpart of the JAX package's `schemes/bbs.py` (the reference's
examples/bbs): the same algorithms, CSPRNG draw order and byte formats, so
a seeded flow gives the reference's bytes.  A message is a list of
48-byte Zp blocks (`encode_message`); a signature is A | x (G1 | Zp).

The batched entry points run their group work on the CUDA card by
default (and raise without one); `device="cpu"` runs the plain versions.
All the message-block ladders h_i^m_i of a batch of B run as ONE GLV call
of n B rows (block i's base repeated B times, short messages padded with
the exponent 0, whose power is the identity), and the product over the
blocks is a tree of complete adds along the block axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..api import batch as BT
from ..api.sets import (G1, G2, Zp, encode_to, inverse, pair, parse, product_, select_in,
                        serialize)

__all__ = ["PublicParameters", "Keys", "setup", "key_gen", "encode_message", "sign",
           "sign_batch", "verify", "verify_batch"]


@dataclass
class PublicParameters:
    g1_g2: bytes       # G1 | G2
    h: list            # [G1 bytes], one base per message block


@dataclass
class Keys:
    pk: bytes          # G2: w = g2^gamma
    sk: bytes          # Zp: gamma


def setup(n: int, random) -> PublicParameters:
    """g1, g2 and n block bases h_i, each a nonzero power of a generator."""
    g1 = select_in(~G1, random)
    g2 = select_in(~G2, random)
    h = select_in(~G1, random, n)
    return PublicParameters(g1_g2=serialize(g1, g2), h=[serialize(hi) for hi in h])


def key_gen(pp: PublicParameters, random) -> Keys:
    gamma = select_in(~Zp, random)
    _, g2 = parse(G1, G2, pp.g1_g2)
    return Keys(pk=serialize(g2 ** gamma), sk=serialize(gamma))


def encode_message(message: bytes) -> list[bytes]:
    return [serialize(m) for m in encode_to(Zp, message)]


def sign(pp: PublicParameters, sk: bytes, message: list[bytes], random) -> bytes:
    """A = (g1 prod h_i^m_i)^(1/(gamma + x)) for a draw x; sigma = (A, x).
    On the host; an empty message raises (an empty product), as in the JAX
    package."""
    g1, _ = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    gamma = parse(Zp, sk)
    m = [parse(Zp, b) for b in message]
    if len(m) > len(h):
        raise ValueError("message is too long")
    x = select_in(Zp, random)
    base = g1 * product_([h[i] ** m[i] for i in range(len(m))])
    return serialize(base ** inverse(gamma + x), x)


def verify(pp: PublicParameters, pk: bytes, message: list[bytes], signature: bytes) -> bool:
    """e(A, w g2^x) == e(g1 prod h_i^m_i, g2), on the host."""
    g1, g2 = parse(G1, G2, pp.g1_g2)
    h = [parse(G1, b) for b in pp.h]
    w = parse(G2, pk)
    m = [parse(Zp, b) for b in message]
    if len(m) > len(h):
        raise ValueError("message is too long")
    A, x = parse(G1, Zp, signature)
    return pair(A, w * (g2 ** x)) == pair(g1 * product_([h[i] ** m[i] for i in range(len(m))]),
                                          g2)


def block_exponents(blocks, n: int, dev) -> BT.ZpVec:
    """(n, B) exponents: block i of message b in row i, column b, and 0 past
    a message's end.  blocks: B lists of Zp elements."""
    flat = [m[i].value if i < len(m) else 0 for i in range(n) for m in blocks]
    return BT.ZpVec(BT.ZpVec.from_ints(flat, dev).std.reshape(n, len(blocks), BT.FR_LIMBS))


def row(v, i: int):
    """Row block i of a point vector of batch shape (k, ...), with the
    vector's z_is_one."""
    return type(v)(tuple(c[i] for c in v.p), z_is_one=v.z_is_one)


def cat_rows(*vecs):
    """Point vectors of one kind joined along their batch axis; built from
    affine data if all of them are."""
    return type(vecs[0])(tuple(torch.cat(x) for x in zip(*(v.p for v in vecs))),
                         z_is_one=all(v.z_is_one for v in vecs))


def parse_points(blobs, k: int, dev) -> BT.G1Vec:
    """The first k 49-byte points of each of B blobs as a (k, B) G1Vec,
    from ONE batched parse (one square-root chain)."""
    v = BT.G1Vec.parse((b[49 * i:49 * (i + 1)] for i in range(k) for b in blobs), dev)
    return BT.G1Vec(tuple(c.reshape(k, len(blobs), *c.shape[1:]) for c in v.p), z_is_one=True)


def fixed_bases(elems, dev) -> list[BT.G1Vec]:
    """Host G1 points as batch-free G1Vecs, uploaded together."""
    v = BT.G1Vec.from_elements(elems, dev)
    return [row(v, i) for i in range(len(elems))]


def stacked_powers(bases, exps: BT.ZpVec) -> BT.G1Vec:
    """bases[i] ** exps[i] for every row block i, as ONE GLV call over all
    the rows: bases are G1Vecs of batch shape () or (B,), exps (k, B)."""
    B = exps.std.shape[1]
    coords = zip(*(b.broadcast_to((B,)).p for b in bases))
    return BT.G1Vec(tuple(torch.stack(c) for c in coords)) ** exps


def base_product(g1: BT.G1Vec, powers: BT.G1Vec | None, B: int) -> BT.G1Vec:
    """g1 times the product of `powers` (k, B) over its row blocks: (B,)."""
    if powers is None:
        return g1.broadcast_to((B,))
    return g1 * powers.product(0)


def sign_from_base(einv, xs_bytes, base: BT.G1Vec) -> list[bytes]:
    """A = base^(1/(gamma + x)) on every row (one GLV call and one batched
    affine serialize), each A's bytes followed by its row of xs_bytes."""
    A = (base ** BT.ZpVec.from_ints(einv, base.p[0].device)).serialize()
    return [a + x for a, x in zip(A, xs_bytes)]


def sign_batch(pp: PublicParameters, sk: bytes, messages, random, device=None) -> list[bytes]:
    """B signatures, byte-identical to B host signs on the same CSPRNG
    stream.  messages: B lists of encoded Zp blocks.  Per message, on the
    host and in the reference's order, one draw x and 1/(gamma + x); then
    base = g1 prod h_i^m_i with every block ladder in one (n B)-row GLV
    call, and A = base^(1/(gamma + x)) at B rows."""
    dev = BT._device(device, "sign_batch runs")
    g1e, _ = parse(G1, G2, pp.g1_g2)
    he = [parse(G1, b) for b in pp.h]
    gamma = parse(Zp, sk)
    enc = [[parse(Zp, b) for b in m] for m in messages]
    n = max((len(m) for m in enc), default=0)
    if n > len(he):
        raise ValueError("message is too long")
    xs, einv = [], []
    for _ in enc:
        x = select_in(Zp, random)
        xs.append(x.serialize())
        einv.append(inverse(gamma + x).value)
    B = len(enc)
    if B == 0:
        return []
    powers = stacked_powers(fixed_bases(he[:n], dev), block_exponents(enc, n, dev)) if n else None
    return sign_from_base(einv, xs, base_product(BT.G1Vec.from_elements([g1e], dev), powers, B))


def verify_from_bases(A: BT.G1Vec, xs: BT.ZpVec, bases, exps, g1: BT.G1Vec, w: BT.G2Vec,
                      g2: BT.G2Vec) -> np.ndarray:
    """e(A, w g2^x) == e(g1 prod bases_i^exps_i, g2) for every row, as
    e(A, w) e(A^x / (g1 prod ...), g2) == 1: the ladders and A^x in ONE
    GLV call, both G2 operands fixed (pair_prod_fixed).  exps: (k, B) for
    the k bases.  A (B,) bool array."""
    B, k = xs.std.shape[0], len(bases)
    powers = stacked_powers(list(bases) + [A], BT.ZpVec(torch.cat([exps.std, xs.std[None]])))
    ax = row(powers, k)
    base = base_product(g1, BT.G1Vec(tuple(c[:k] for c in powers.p)) if k else None, B)
    ok = BT.pair_prod_fixed((A, w), (ax / base, g2)).is_one()
    return ok.cpu().numpy()


def verify_batch(pp: PublicParameters, pk: bytes, messages, signatures,
                 device=None) -> np.ndarray:
    """Verify B signatures under one (pp, pk): a (B,) bool array.
    messages: B lists of encoded Zp blocks.  An A that does not parse, an
    x that is not below r, or a message longer than pp.h raises
    ValueError."""
    dev = BT._device(device, "verify_batch runs")
    if len(signatures) != len(messages):
        raise ValueError("messages and signatures differ in length")
    g1e, g2e = parse(G1, G2, pp.g1_g2)
    he = [parse(G1, b) for b in pp.h]
    we = parse(G2, pk)
    enc = [[parse(Zp, b) for b in m] for m in messages]
    n = max((len(m) for m in enc), default=0)
    if n > len(he):
        raise ValueError("message is too long")
    if not enc:
        return np.zeros(0, bool)
    sig = [bytes(s) for s in signatures]
    A = BT.G1Vec.parse((s[:49] for s in sig), dev)
    xs = BT.ZpVec.parse((s[49:97] for s in sig), dev)
    return verify_from_bases(A, xs, fixed_bases(he[:n], dev), block_exponents(enc, n, dev),
                          BT.G1Vec.from_elements([g1e], dev),
                          BT.G2Vec.from_elements([we], dev), BT.G2Vec.from_elements([g2e], dev))
