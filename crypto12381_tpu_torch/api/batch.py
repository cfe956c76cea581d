"""Batched G1, G2, GT and scalar vectors: the paper notation over device
tensors.

Counterpart of the JAX package's `api/batch.py` for G1, G2, GT and Zp: a
vector of elements is ONE tensor (leading batch dims), and the operators
lower to the batched curve code:

  * ``G1Vec ** ZpVec``    -> the GLV ladder over the whole batch (K6, K7)
  * ``G1Vec.msm(ZpVec)``  -> the scan Pippenger (K5, K6, K7) for n < 2^17,
    the dense-rounds Pippenger (msm/rounds.py, one K5 launch per round)
    from 2^17 on
  * ``G1Vec * G1Vec``     -> the group operation (K6)
  * ``G2Vec ** ZpVec``, ``G2Vec * G2Vec``, ``G2Vec.msm(ZpVec)`` -> the GS
    ladder, the group operation and the scan Pippenger over Fp2 (K12-K14;
    K2 for psi, K1 and K2 for the affine conversions)
  * ``GTVec ** ZpVec``, ``GTVec * GTVec``, ``/``, ``inverse``,
    ``product`` -> the GS power ladder with cyclotomic squarings and the
    Fp12 products (K2-K4, K1)
  * ``pair_vec(P, Q)``    -> e(P_i, Q_i) row by row (K1-K4)
  * ``pair_prod((P1, Q1), ...)`` -> prod_i e(P_i, Q_i): one shared Miller
    squaring chain with per-row G2 lines, one final exponentiation
  * ``ZpVec + - * neg``, ``ZpVec.inverse()`` -> arithmetic mod r on the Fr
    instance of K1 (``*``: two Fr products; inverse: one power chain); a
    (1,) operand broadcasts against (n,)
  * ``pair_prod_fixed((P1, Q1), ...)`` -> prod_i e(P_i, Q_i) with every Q_i
    a fixed G2 point: precomputed lines, one shared Miller loop, one final
    exponentiation (K1-K4)
  * ``g1_bytes``, ``zp_bytes``, ``gt_bytes`` -> the reference's encodings
    as uint8 tensors where the vector lies, for device Fiat-Shamir
    transcripts; ``hash_to_zp`` -> SHA3-512 digests mod r (K1, Fr)

Scalars keep the JAX package's layout: (..., 18) int32 standard-domain
limbs of 16 bits; arithmetic packs them into 8 limbs of 32 bits on the
device and back.  Host constructors put their tensors on the CUDA card by
default and raise without one; `device="cpu"` runs the plain versions.
Host <-> device crossings happen at construction and at serialize, with
the byte codecs of compat/codec.py.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..compat import codec
from ..curves import g1 as G1C
from ..curves import g2 as G2C
from ..curves import weierstrass as W
from ..fields import fp as FP
from ..fields import tower as TW
from ..host import field as HF
from ..msm import pippenger as MSM
from ..msm import rounds as MR
from ..pairing import pairing as PAIR
from ..params import B_G1, LIMBS, MODBYTES, R

__all__ = ["ZpVec", "G1Vec", "G2Vec", "GTVec", "g1_bytes", "gt_bytes", "hash_to_g1",
           "hash_to_zp", "pair_prod", "pair_prod_fixed", "pair_vec", "zp_bytes"]

#: Fr scalars: 18 limbs of 16 bits (the JAX package's Fr layout)
FR_LIMBS = 18
FR = FP.FR_CTX
#: from this size on, G1Vec.msm takes msm/rounds.py (as the JAX package's)
ROUNDS_MSM_MIN = 1 << 17
#: the window width of that route, whatever `c` the caller gives
ROUNDS_MSM_C = 16


def _device(device, what: str = "point and scalar vectors are built") -> torch.device:
    """The device asked for; by default the CUDA card, and without one an
    error that names `what` runs there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} on a CUDA card by default and none is present; pass "
                "device='cpu' to run the plain versions")
        device = "cuda"
    return torch.device(device)


class ZpVec:
    """A batch of scalars mod r: (..., 18) int32 standard-domain limbs.

    Arithmetic is exact mod r, canonical in and out, on the Fr field of
    fields/fp.py: + - and neg in plain PyTorch, * as to_mont(REDC(a b)) =
    a b (two `fr_mont_mul` launches), inverse as the Fermat chain a^(r-2)
    in the Montgomery domain (to_mont, one `fr_pow_fixed` launch,
    from_mont); inverse(0) = 0.  The operands of + - * broadcast as torch
    tensors do (a (1,) operand against (n,)): the plain ops broadcast, and
    K1's wrapper expands its operands and makes them contiguous, so no
    kernel is handed a stride-0 tensor."""

    __slots__ = ("std",)

    def __init__(self, std: torch.Tensor):
        self.std = std

    @classmethod
    def from_ints(cls, values, device=None) -> "ZpVec":
        vals = [int(v) % R for v in values]
        raw = b"".join(v.to_bytes(2 * FR_LIMBS, "little") for v in vals)
        limbs = np.frombuffer(raw, "<u2").reshape(len(vals), FR_LIMBS).astype(np.int32)
        return cls(torch.from_numpy(limbs).to(_device(device)))

    @classmethod
    def parse(cls, blobs: Iterable[bytes], device=None) -> "ZpVec":
        """48-byte big-endian scalars, each checked to be below r (the
        reference's range check)."""
        arr = np.frombuffer(b"".join(bytes(b) for b in blobs), np.uint8).reshape(-1, MODBYTES)
        rb = np.frombuffer(R.to_bytes(MODBYTES, "big"), np.uint8)
        ne = arr != rb
        first = ne.argmax(axis=1)
        in_range = ne.any(axis=1) & (arr[np.arange(arr.shape[0]), first] < rb[first])
        if not bool(in_range.all()):
            raise ValueError("Parse to Zp number over range.")
        le = arr[:, ::-1].astype(np.int32)                  # least significant first
        limbs = le[:, 0:2 * FR_LIMBS:2] + (le[:, 1:2 * FR_LIMBS:2] << 8)
        return cls(torch.from_numpy(np.ascontiguousarray(limbs)).to(_device(device)))

    def to_ints(self):
        """Python ints: one int, or an object array over the batch shape."""
        host = self.std.cpu().numpy().astype(np.int64)
        flat = host.reshape(-1, host.shape[-1])
        out = np.empty(flat.shape[0], object)
        for i, row in enumerate(flat):
            out[i] = sum(int(w) << (16 * k) for k, w in enumerate(row))
        return out[0] if host.ndim == 1 else out.reshape(host.shape[:-1])

    def serialize(self) -> list[bytes]:
        host = self.std.cpu().numpy().astype(np.int64).reshape(-1, self.std.shape[-1])
        out = np.zeros((host.shape[0], MODBYTES), np.uint8)
        k = np.arange(host.shape[1])
        out[:, MODBYTES - 1 - 2 * k] = host & 0xFF
        out[:, MODBYTES - 2 - 2 * k] = (host >> 8) & 0xFF
        return [bytes(r) for r in out]

    # -- arithmetic (canonical standard-domain in, canonical out) ---------

    def limbs32(self) -> torch.Tensor:
        """The values as (..., 8) int32 limbs of 32 bits (the Fr kernels'
        layout), on the device."""
        w = self.std[..., :16].to(torch.int64)
        v = w[..., 0::2] | (w[..., 1::2] << 16)
        return (v - ((v >> 31) << 32)).to(torch.int32)

    @classmethod
    def from_limbs32(cls, x: torch.Tensor) -> "ZpVec":
        u = x.to(torch.int64) & 0xFFFFFFFF
        w = torch.stack([u & 0xFFFF, u >> 16], -1).reshape(*x.shape[:-1], 16)
        pad = torch.zeros(*x.shape[:-1], FR_LIMBS - 16, dtype=torch.int64, device=x.device)
        return cls(torch.cat([w, pad], -1).to(torch.int32))

    def __add__(self, other: "ZpVec") -> "ZpVec":
        return ZpVec.from_limbs32(FR.add(self.limbs32(), other.limbs32()))

    def __sub__(self, other: "ZpVec") -> "ZpVec":
        return ZpVec.from_limbs32(FR.sub(self.limbs32(), other.limbs32()))

    def __neg__(self) -> "ZpVec":
        return ZpVec.from_limbs32(FR.neg(self.limbs32()))

    def __mul__(self, other: "ZpVec") -> "ZpVec":
        return ZpVec.from_limbs32(FR.to_mont(FR.mont_mul(self.limbs32(), other.limbs32())))

    def inverse(self) -> "ZpVec":
        return ZpVec.from_limbs32(FR.from_mont(FR.inv(FR.to_mont(self.limbs32()))))

    def __eq__(self, other) -> torch.Tensor:  # type: ignore[override]
        return torch.all(self.std == other.std, dim=-1)

    def __hash__(self):
        raise TypeError("ZpVec is not hashable")


def _tree_product(ops, p, axis: int):
    """Group-law reduction along `axis` in log2 steps of complete adds."""
    p = tuple(c.movedim(axis, 0) for c in p)
    n = p[0].shape[0]
    while n > 1:
        half = n // 2
        merged = W.add(ops, tuple(c[:half] for c in p), tuple(c[half:2 * half] for c in p))
        if n % 2:
            merged = tuple(torch.cat([m, c[n - 1:n]], 0) for m, c in zip(merged, p))
        p = merged
        n = p[0].shape[0]
    return tuple(c[0] for c in p)


class _PointVec:
    """Batched projective points (X, Y, Z) with the group operation written
    multiplicatively, as the reference's point classes do."""

    __slots__ = ("p", "z_is_one")
    _mod = None  # the curve module

    def __init__(self, p, z_is_one: bool = False):
        self.p = tuple(p)
        #: every Z is 0 or 1 (built from affine data): affine() then skips
        #: the inversion chain
        self.z_is_one = z_is_one

    def __mul__(self, other):
        return type(self)(self._mod.add(self.p, other.p))

    def __truediv__(self, other):
        return type(self)(self._mod.add(self.p, self._mod.neg(other.p)))

    def __pow__(self, e):
        e_std = e.std if isinstance(e, ZpVec) else e
        return type(self)(self._mod.scalar_mul(self.p, e_std))

    __xor__ = __pow__

    def inverse(self):
        return type(self)(self._mod.neg(self.p), z_is_one=self.z_is_one)

    def __eq__(self, other) -> torch.Tensor:  # type: ignore[override]
        return self._mod.eq(self.p, other.p)

    def __hash__(self):
        raise TypeError("point vectors are not hashable")

    def product(self, axis: int = 0):
        """The group operation over an axis (a tree of complete adds; use
        msm for the product of powers)."""
        return type(self)(_tree_product(self._mod.ops(), self.p, axis))

    @property
    def shape(self):
        return self.p[0].shape[:-self._mod.ops().elem_ndim]

    def broadcast_to(self, batch):
        """The vector broadcast to the batch shape `batch` (as torch.expand:
        a batch shape () or (1,) to any); views, which every kernel wrapper
        makes contiguous before a launch."""
        nd = self._mod.ops().elem_ndim
        return type(self)(tuple(c.expand(tuple(batch) + c.shape[c.dim() - nd:]) for c in self.p),
                          z_is_one=self.z_is_one)

    def affine(self):
        """(x, y, inf_mask) in Montgomery form; the mask has the batch
        shape (Z = 0 over the whole coordinate, Fp for G1, Fp2 for G2)."""
        if self.z_is_one:
            return self.p[0], self.p[1], self._mod.ops().is_zero(self.p[2])
        return self._mod.to_affine(self.p)


class G1Vec(_PointVec):
    _mod = G1C

    @classmethod
    def generator(cls, batch=(), device=None) -> "G1Vec":
        return cls(G1C.generator(batch, _device(device)), z_is_one=True)

    @classmethod
    def identity(cls, batch=(), device=None) -> "G1Vec":
        return cls(G1C.identity(batch, _device(device)), z_is_one=True)

    @classmethod
    def from_affine(cls, pts: Sequence, device=None) -> "G1Vec":
        """Host affine points: (x, y) int tuples, or None for infinity."""
        dev = _device(device)
        xs = [0 if p is None else int(p[0]) for p in pts]
        ys = [1 if p is None else int(p[1]) for p in pts]
        zs = [0 if p is None else 1 for p in pts]
        return cls((FP.from_int(xs, dev), FP.from_int(ys, dev), FP.from_int(zs, dev)),
                   z_is_one=True)

    @classmethod
    def from_elements(cls, elems: Iterable, device=None) -> "G1Vec":
        """Host G1 elements or powers (api/elements.py)."""
        return cls.from_affine([e.point().pt for e in elems], device)

    @classmethod
    def parse(cls, blobs: Iterable[bytes], device=None) -> "G1Vec":
        """49-byte compressed points, with the y of every point from ONE
        batched square-root chain on the device (K1) and the parity select
        of the prefix.  Raises on a bad prefix or an x off the curve, as
        codec.g1_parse does."""
        dev = _device(device)
        arr = np.frombuffer(b"".join(bytes(b) for b in blobs), np.uint8).reshape(-1, 49)
        prefix = arr[:, 0]
        if not np.isin(prefix, (0x02, 0x03)).all():
            raise ValueError("bad G1 prefix")
        x = FP.from_int([int.from_bytes(r[1:].tobytes(), "big") for r in arr], dev)
        rhs = FP.add(FP.mont_mul(FP.mont_mul(x, x), x), FP.from_int(B_G1, dev).expand_as(x))
        y = FP.sqrt(rhs)
        if not bool(FP.eq(FP.mont_mul(y, y), rhs).all()):
            raise ValueError("x not on curve")
        odd = FP.from_mont(y)[..., 0] & 1
        want_odd = torch.from_numpy((prefix & 1).astype(np.int32)).to(dev)
        y = torch.where((odd != want_odd)[..., None], FP.neg(y), y)
        return cls((x, y, FP.one(x.shape[:-1], dev)), z_is_one=True)

    def serialize(self) -> list[bytes]:
        """49-byte compressed points: g1_bytes on the device, one fetch."""
        return [bytes(r) for r in g1_bytes(self).reshape(-1, 49).cpu().numpy()]

    def to_elements(self) -> list:
        """Host G1 elements (api/elements.py), the batch flattened: one
        affine conversion on the device."""
        from .elements import G1Element

        pts = G1C.to_affine_ints(self.p)
        return [G1Element(p) for p in (pts.reshape(-1) if isinstance(pts, np.ndarray) else [pts])]

    def msm(self, scalars: ZpVec, c: int | None = None, lanes: int = 64) -> "G1Vec":
        """prod_i self[i] ** scalars[i] over the leading axis.  Batch-free
        result.

        n < 2^17: the scan Pippenger with the JAX package's defaults (c = 8,
        lanes = 64 clipped to the batch).  n >= 2^17: the dense-rounds
        Pippenger at c = 16 (msm/rounds.py), as the JAX package routes it;
        `c` and `lanes` are ignored there.  A vector built from affine data
        (`z_is_one`) skips the rounds' Z inversion; its identity rows
        (Z = 0) get the scalar 0 first, so that their raw (X, Y) never
        enter a bucket (the JAX package adds them as the point (0, 1))."""
        n = self.p[0].shape[0]
        if n >= ROUNDS_MSM_MIN:
            e = scalars.std
            if self.z_is_one:
                e = torch.where(G1C.is_identity(self.p)[:, None], 0, e)
            return G1Vec(MR.msm_g1_rounds(self.p, e, c=ROUNDS_MSM_C, affine=self.z_is_one))
        lanes = min(lanes, 1 << max(0, (n - 1).bit_length() - 1)) or 1
        return G1Vec(MSM.msm_g1(self.p, scalars.std, c=c or 8, lanes=lanes))


class G2Vec(_PointVec):
    """Batched G2 points: the group law over Fp2, ``**`` by the GS ladder,
    the scan Pippenger MSM; PS's verify takes its public-key points as
    batch-free G2Vec."""

    _mod = G2C

    @classmethod
    def generator(cls, batch=(), device=None) -> "G2Vec":
        return cls(G2C.generator(batch, _device(device)), z_is_one=True)

    @classmethod
    def identity(cls, batch=(), device=None) -> "G2Vec":
        return cls(G2C.identity(batch, _device(device)), z_is_one=True)

    @classmethod
    def from_affine(cls, pts: Sequence, device=None) -> "G2Vec":
        """Host affine points: ((xr, xi), (yr, yi)) int tuples, or None for
        infinity."""
        dev = _device(device)
        xs = [(0, 0) if p is None else p[0] for p in pts]
        ys = [(1, 0) if p is None else p[1] for p in pts]
        zs = [(0, 0) if p is None else (1, 0) for p in pts]
        return cls(tuple(FP.from_int([[int(c) for c in v] for v in vals], dev)
                         for vals in (xs, ys, zs)), z_is_one=True)

    @classmethod
    def from_elements(cls, elems: Iterable, device=None) -> "G2Vec":
        """Host G2 elements (api/elements.py)."""
        return cls.from_affine([e.point().pt for e in elems], device)

    @classmethod
    def parse(cls, blobs: Iterable[bytes], device=None) -> "G2Vec":
        """97-byte points through the host codec; raises on an x off the
        twist, as codec.g2_parse does."""
        return cls.from_affine([codec.g2_parse(bytes(b)) for b in blobs], device)

    def serialize(self) -> list[bytes]:
        """97-byte points (one affine conversion on the device, the host
        codec per point)."""
        pts = G2C.to_affine_ints(self.p)
        return [codec.g2_serialize(p) for p in (pts.reshape(-1) if isinstance(pts, np.ndarray)
                                                 else [pts])]

    def msm(self, scalars: ZpVec, c: int = 8, lanes: int = 64) -> "G2Vec":
        """prod_i self[i] ** scalars[i] over the leading axis by the scan
        Pippenger over Fp2 (c = 8, lanes = 64 clipped to the batch, as the
        JAX package's).  Batch-free result."""
        n = self.p[0].shape[0]
        lanes = min(lanes, 1 << max(0, (n - 1).bit_length() - 1)) or 1
        return G2Vec(MSM.msm_g2(self.p, scalars.std, c=c, lanes=lanes))


def _reduce_p(limbs: torch.Tensor) -> torch.Tensor:
    """int32 limbs of values below 2^384 (< 10 p) -> the values mod p."""
    for _ in range(9):
        limbs = FP.FP_CTX._cond_sub_p(limbs.to(torch.int64) & 0xFFFFFFFF)
    return limbs


class GTVec:
    """A batch of GT elements: (..., 2, 3, 2, 12) Fp12 tensors."""

    __slots__ = ("f",)

    def __init__(self, f: torch.Tensor):
        self.f = f

    @classmethod
    def one(cls, batch=(), device=None) -> "GTVec":
        return cls(TW.fp12_one(batch, _device(device)))

    @classmethod
    def parse(cls, blobs: Iterable[bytes], device=None) -> "GTVec":
        """576-byte GT encodings: the 12 Fp coefficients cross as ONE
        (B, 6, 2, 48) byte array, become limbs with numpy (no host big
        ints), are reduced mod p and enter the Montgomery form in one K1
        launch."""
        dev = _device(device)
        arr = np.frombuffer(b"".join(bytes(b) for b in blobs), np.uint8).reshape(-1, 6, 2, 48)
        le = np.ascontiguousarray(arr[..., ::-1]).view("<u4").astype(np.uint32)
        limbs = torch.from_numpy(le.view(np.int32)).to(dev)        # [slot][imag, real]
        mont = FP.FP_CTX.to_mont(_reduce_p(limbs))
        cs6 = [None] * 6
        for slot, k in enumerate(codec._GT_ORDER):
            cs6[k] = mont[:, slot].flip(-2)                          # (real, imag)
        return cls(TW.fp12_from_coeffs_w(cs6))

    @property
    def shape(self):
        return self.f.shape[:-4]

    def __mul__(self, other: "GTVec") -> "GTVec":
        return GTVec(TW.fp12_mul(self.f, other.f))

    def __truediv__(self, other: "GTVec") -> "GTVec":
        return GTVec(TW.fp12_mul(self.f, TW.fp12_inv(other.f)))

    def __pow__(self, e):
        e_std = e.std if isinstance(e, ZpVec) else e
        return GTVec(PAIR.gt_pow(self.f, e_std))

    __xor__ = __pow__

    def inverse(self) -> "GTVec":
        return GTVec(TW.fp12_inv(self.f))

    def inverse_unitary(self) -> "GTVec":
        """Conjugation: the inverse of a reduced-pairing value (cyclotomic
        subgroup), without an Fp12 inversion."""
        return GTVec(TW.fp12_conj(self.f))

    def __eq__(self, other) -> torch.Tensor:  # type: ignore[override]
        return TW.fp12_eq(self.f, other.f)

    def __hash__(self):
        raise TypeError("GTVec is not hashable")

    def is_one(self) -> torch.Tensor:
        return TW.fp12_is_one(self.f)

    def product(self, axis: int = 0) -> "GTVec":
        """The product over an axis: a tree of Fp12 products."""
        return GTVec(PAIR.fp12_tree_product(self.f.movedim(axis, 0)))

    @classmethod
    def from_elements(cls, elems: Iterable, device=None) -> "GTVec":
        """Host GT elements (api/elements.py GTElement) as one batch."""
        dev = _device(device)
        vals = [[list(c) for c in HF.fp12_coeffs_w(e.value().val)] for e in elems]
        cs = FP.from_int(vals, dev).reshape(len(vals), 6, 2, LIMBS)
        return cls(TW.fp12_from_coeffs_w([cs[:, k] for k in range(6)]))

    def serialize(self) -> list[bytes]:
        """576-byte encodings of the batch: gt_bytes on the device, one
        fetch."""
        return [bytes(r) for r in gt_bytes(self).reshape(-1, 576).cpu().numpy()]


# -- device bytes and hashing to Zp -------------------------------------------
#
# The serialized forms of a batch as uint8 tensors where the batch lies, for
# the device Fiat-Shamir transcripts (hashing/keccak.py), and digests to Zp.

_BYTE_SHIFTS = (0, 8, 16, 24)


def _fp_be48(std: torch.Tensor) -> torch.Tensor:
    """(..., 12) canonical standard-domain limbs -> (..., 48) uint8
    big-endian."""
    sh = torch.tensor(_BYTE_SHIFTS, device=std.device)
    le = ((std.to(torch.int64)[..., None] & 0xFFFFFFFF) >> sh) & 0xFF
    return le.to(torch.uint8).reshape(*std.shape[:-1], 4 * std.shape[-1]).flip(-1)


def g1_bytes(vec: G1Vec) -> torch.Tensor:
    """(...,) G1Vec -> (..., 49) uint8 compressed encodings on its device
    (the identity is 0x02 and 48 zero bytes)."""
    x, y, inf = vec.affine()
    st = FP.from_mont(torch.stack([x, y], -2))
    prefix = torch.where(inf, 2, 2 + (st[..., 1, 0] & 1)).to(torch.uint8)
    xb = torch.where(inf[..., None], torch.zeros((), dtype=torch.uint8, device=x.device),
                     _fp_be48(st[..., 0, :]))
    return torch.cat([prefix[..., None], xb], -1)


def zp_bytes(vec: ZpVec) -> torch.Tensor:
    """(...,) ZpVec -> (..., 48) uint8 big-endian encodings on its device:
    12 zero bytes, then the 18 limbs of 16 bits high limb first."""
    std = vec.std.to(torch.int64)
    le = torch.stack([std & 0xFF, std >> 8], -1).reshape(*std.shape[:-1], 2 * FR_LIMBS)
    pad = torch.zeros(*std.shape[:-1], MODBYTES - 2 * FR_LIMBS, dtype=torch.uint8,
                      device=std.device)
    return torch.cat([pad, le.to(torch.uint8).flip(-1)], -1)


def gt_bytes(vec: GTVec) -> torch.Tensor:
    """(...,) GTVec -> (..., 576) uint8 encodings on its device: the
    w-coefficients in codec._GT_ORDER, each imaginary part before the real
    part, 48-byte big-endian; one K1 launch leaves the Montgomery form."""
    cs = FP.from_mont(torch.stack(TW.fp12_coeffs_w(vec.f), -3))      # (..., 6, 2, 12)
    order = torch.tensor(codec._GT_ORDER, device=cs.device)
    be = _fp_be48(cs.index_select(-3, order).flip(-2))               # (..., 6, 2, 48)
    return be.reshape(*cs.shape[:-3], 576)


def _digest_halves(digests: torch.Tensor) -> torch.Tensor:
    """(B, 64) uint8 digests -> (B, 2, 8) int64 32-bit limbs of their
    big-endian halves [hi, lo], least significant limb first."""
    be = digests.to(torch.int64).reshape(-1, 2, 8, 4).flip(-2)
    return (be << torch.tensor(_BYTE_SHIFTS[::-1], device=digests.device)).sum(-1)


def hash_to_zp(digests: torch.Tensor) -> ZpVec:
    """(B, 64) uint8 SHA3-512 digests -> their values mod r, on their
    device (ZpNumber.from_hash on every row): hi 2^256 + lo with hi and lo
    the big-endian halves, each reduced below r by two conditional
    subtractions; hi 2^256 = hi R is one `fr_mont_mul` (to_mont), then one
    modular add."""
    limbs = _digest_halves(digests)
    for _ in range(2):                                                # 2^256 < 3 r
        limbs = FR._cond_sub_p(limbs).to(torch.int64) & 0xFFFFFFFF
    limbs = FP._i32(limbs)
    return ZpVec.from_limbs32(FR.add(FR.to_mont(limbs[:, 0]), limbs[:, 1]))


def hash_to_g1(digests: torch.Tensor) -> G1Vec:
    """(B, 64) uint8 digests -> G1 points on their device
    (G1Element.from_hash on every row): the digest mod p, by the reduction
    of hash_to_zp on Fp (both halves are below 2^256 < p, and the sum
    hi 2^256 + lo enters the Montgomery form as hi (2^256 R^2) + lo R^2:
    ONE `fp_mont_mul` launch and a modular add), then the SSWU map and
    cofactor clearing (hashing/sswu.py).  Projective points."""
    from ..hashing import sswu as SSWU

    halves = _digest_halves(digests)
    limbs = FP._i32(torch.cat([halves, torch.zeros_like(halves[..., :LIMBS - 8])], -1))
    fac = FP.FP_CTX.limbs_of
    k = torch.from_numpy(np.stack([fac((1 << 256) * FP.FP_CTX.r2_mod % FP.FP_CTX.modulus),
                                   fac(FP.FP_CTX.r2_mod)])).to(digests.device)
    hi, lo = FP.mont_mul(limbs, k.expand_as(limbs)).unbind(-2)
    return G1Vec(SSWU.hash_field_to_g1(FP.add(hi, lo)))


def _masked_miller(g1v: G1Vec, g2v: G2Vec) -> torch.Tensor:
    """Miller values of the rows, 1 where P or Q is the identity."""
    px, py, pinf = g1v.affine()
    qx, qy, qinf = g2v.affine()
    f = PAIR.miller_loop((px, py), (qx, qy))
    inf = pinf | qinf
    return torch.where(inf[..., None, None, None, None], TW.fp12_one(f.shape[:-4], f.device), f)


def pair_vec(g1v: G1Vec, g2v: G2Vec) -> GTVec:
    """The reduced pairing e(P_i, Q_i) row by row (the reference's
    normalization, the ate pairing cubed); e(O, .) = e(., O) = 1."""
    return GTVec(PAIR.final_exp(_masked_miller(g1v, g2v)))


def pair_prod(*pairs: tuple) -> GTVec:
    """prod_i e(P_i, Q_i) over the argument pairs (G1Vec, G2Vec) with ONE
    shared Miller squaring chain (per step one Fp12 square for all pairs,
    each pair's G2 line per row) and ONE final exponentiation.  All pairs
    share a batch shape; a pair with an identity P or Q contributes 1."""
    p_aff = [a.affine() for a, _ in pairs]
    q_aff = [b.affine() for _, b in pairs]
    px = torch.stack([p[0] for p in p_aff])
    py = torch.stack([p[1] for p in p_aff])
    qx = torch.stack([q[0] for q in q_aff])
    qy = torch.stack([q[1] for q in q_aff])
    inf = torch.stack([p[2] | q[2] for p, q in zip(p_aff, q_aff)])
    return GTVec(PAIR.final_exp(PAIR.multi_miller_shared((px, py), (qx, qy), inf=inf)))


def pair_prod_fixed(*pairs: tuple) -> GTVec:
    """prod_i e(P_i, Q_i) over the argument pairs (G1Vec, G2Vec), where every
    Q_i is ONE fixed point (batch shape () or (1,)) and the P_i share a
    batch shape.  The lines of all the Q_i are precomputed in one
    batch-free pass, the batch runs one shared Miller loop with no G2
    arithmetic, and one final exponentiation.  A pair whose P or Q is the
    identity contributes 1."""
    p_aff = [a.affine() for a, _ in pairs]
    px = torch.stack([p[0] for p in p_aff])
    py = torch.stack([p[1] for p in p_aff])
    q_aff = []
    for _, b in pairs:
        if b.shape not in ((), (1,)):
            raise ValueError("pair_prod_fixed needs batch-free G2 operands")
        q_aff.append(b.affine())
    qx = torch.stack([q[0].reshape(2, LIMBS) for q in q_aff])
    qy = torch.stack([q[1].reshape(2, LIMBS) for q in q_aff])
    q_inf = torch.stack([q[2].reshape(()) for q in q_aff])
    inf = torch.stack([p[2] for p in p_aff]) | q_inf.reshape((-1,) + (1,) * (px.dim() - 2))
    lines = PAIR.precompute_g2_lines((qx, qy))
    return GTVec(PAIR.final_exp(PAIR.multi_miller_precomp((px, py), lines, inf)))
