"""Fp and Fr arithmetic on 32-bit limbs, with kernel K1: the Montgomery
product and the fixed-exponent power chain.

Counterpart of the JAX package's `fields/fp32.py` (with `fields/active.py`).
A `Field` record carries one prime field's modulus, limb count and
Montgomery constants, and its methods are that field's operations:
`FP_CTX` is the base field, `FR_CTX` the scalar field (the counterparts of
the JAX `FP_CTX` and `FR_CTX`).  The module-level functions (`add`,
`mont_mul`, `inv`, `sqrt`, ...) are `FP_CTX`'s methods.

An Fp element is a `torch.int32` tensor of shape (..., 12): 12 little-endian
32-bit limbs, read as unsigned, of the Montgomery form x * 2^384 mod p.
An Fr element is (..., 8) limbs of x * 2^256 mod r.  Every value is
canonical (0 <= v < modulus) at every function boundary, so equality of
elements is equality of limbs, and no normalize/tighten/reduce_full step
exists.

Operations run where their tensors are.  `mont_mul` launches the CUDA
kernel `fp_mont_mul` or `fr_mont_mul` (csrc/fp.cu) for a CUDA tensor and
its plain version `mont_mul_plain` for a CPU tensor; `pow_fixed` launches
`fp_pow_fixed` or `fr_pow_fixed`, the whole chain in one launch, or runs
`pow_fixed_plain`, the same chain of plain products.  The modular
add/sub/neg are plain PyTorch on both: each is a few dozen elementwise ops
over the limbs, with the carry and borrow chains resolved by one integer
addition of bitmasks instead of a loop over the limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..params import (FR_LIMBS32, FR_N0_16, FR_R2_MOD, FR_R_INV, FR_R_MOD, LIMBS, N0_16, P,
                      R, R2_MOD, R_INV, R_MOD)

_M32 = 0xFFFFFFFF
_CONSTS: dict = {}


def _const(key, vals, device) -> torch.Tensor:
    """Small int64 constant tensors, uploaded once per device."""
    key = (key, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(vals, dtype=torch.int64, device=device)
        _CONSTS[key] = t
    return t


def _bits(n: int, device) -> torch.Tensor:
    return _const(("bits", n), [1 << i for i in range(n)], device)


def _idx(n: int, device) -> torch.Tensor:
    return _const(("idx", n), list(range(n)), device)


# ---------------------------------------------------------------------------
# Limb plumbing
# ---------------------------------------------------------------------------


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _chain(gen, prop, bits, idx):
    """Carries (or borrows) into each position of a chain of words, from
    per-word generate and propagate flags: with X = G | P and Y = G as
    bitmasks, bit i of (X + Y) ^ X ^ Y is the carry into word i, and bit
    len(idx) the carry out.  Returns (into, out) as int64 0/1 tensors."""
    g = (gen.to(torch.int64) * bits).sum(-1)
    x = g | (prop.to(torch.int64) * bits).sum(-1)
    c = (x + g) ^ x ^ g
    return (c[..., None] >> idx) & 1, (c >> idx.numel()) & 1


def _carry32(s: torch.Tensor, dev):
    """Limbs s in [0, 2^33) (int64) -> normalized limbs, carry out."""
    n = s.shape[-1]
    cin, cout = _chain(s > _M32, s == _M32, _bits(n, dev), _idx(n, dev))
    return (s + cin) & _M32, cout


def _borrow32(d: torch.Tensor, dev):
    """Limb differences d in (-2^32, 2^32) (int64) -> limbs, borrow out."""
    n = d.shape[-1]
    bin_, bout = _chain(d < 0, d == 0, _bits(n, dev), _idx(n, dev))
    return (d - bin_) & _M32, bout


class Field:
    """A prime field on `limbs` 32-bit limbs with Montgomery R = 2^(32 limbs),
    and its operations.  `name` prefixes the C functions of its kernels
    (`<name>_mont_mul`, `<name>_pow_fixed`)."""

    def __init__(self, name: str, modulus: int, limbs: int, n0_16: int, r_mod: int,
                 r2_mod: int, r_inv: int):
        self.name = name
        self.modulus = modulus
        self.limbs = limbs
        self.n0_16 = n0_16              # -modulus^-1 mod 2^16
        self.r_mod = r_mod              # R mod modulus: the Montgomery one
        self.r2_mod = r2_mod            # R^2 mod modulus: the to-Montgomery factor
        self.r_inv = r_inv              # R^-1 mod modulus
        self.p_limbs = [(modulus >> (32 * i)) & _M32 for i in range(limbs)]
        self.p_words16 = [(modulus >> (16 * i)) & 0xFFFF for i in range(2 * limbs)]

    def _p(self, device) -> torch.Tensor:
        return _const((self.name, "p"), self.p_limbs, device)

    def _cond_sub_p(self, t: torch.Tensor) -> torch.Tensor:
        """int64 limbs of a value in [0, 2 modulus) -> int32 limbs of the value
        mod the modulus."""
        d, borrow = _borrow32(t - self._p(t.device), t.device)
        return _i32(torch.where(borrow[..., None] == 1, t, d))

    # -- host conversion ----------------------------------------------------

    def limbs_of(self, v: int) -> np.ndarray:
        """Plain int in [0, R) -> (limbs,) int32 limbs (no domain change)."""
        return np.array([(v >> (32 * i)) & _M32 for i in range(self.limbs)],
                        np.uint32).view(np.int32)

    @staticmethod
    def int_of(limbs) -> int:
        """(limbs,) limbs (int32 bit patterns) -> plain int."""
        u = np.asarray(limbs, np.int32).view(np.uint32)
        return sum(int(w) << (32 * i) for i, w in enumerate(u))

    def mont_const(self, v: int) -> np.ndarray:
        """Host int -> Montgomery-form limbs (limbs,) int32."""
        return self.limbs_of(v % self.modulus * self.r_mod % self.modulus)

    def from_int(self, values, device="cpu") -> torch.Tensor:
        """Int or nested list of ints -> Montgomery tensor (..., limbs)."""
        arr = np.asarray(values, dtype=object)
        flat = arr.reshape(-1)
        out = np.empty((flat.shape[0], self.limbs), np.int32)
        for i, v in enumerate(flat):
            out[i] = self.mont_const(int(v))
        return torch.from_numpy(out.reshape(arr.shape + (self.limbs,))).to(device)

    def to_int(self, x: torch.Tensor):
        """Montgomery tensor (..., limbs) -> python int (no batch dims) or an
        object array of ints in [0, modulus)."""
        a = x.detach().cpu().numpy()
        flat = a.reshape(-1, self.limbs)
        out = np.empty(flat.shape[0], object)
        for i in range(flat.shape[0]):
            out[i] = self.int_of(flat[i]) * self.r_inv % self.modulus
        if a.ndim == 1:
            return out[0]
        return out.reshape(a.shape[:-1])

    def one(self, batch=(), device="cpu") -> torch.Tensor:
        return torch.from_numpy(self.mont_const(1)).to(device).expand(*batch, self.limbs)

    def zero(self, batch=(), device="cpu") -> torch.Tensor:
        return torch.zeros(*batch, self.limbs, dtype=torch.int32, device=device)

    # -- modular ring operations (plain PyTorch, canonical in and out) ------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, _ = _carry32(_u64(a) + _u64(b), a.device)
        return self._cond_sub_p(s)

    def add_raw(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b without reduction: a value below 2p, the form of a Karatsuba
        pre-sum (an Fp product takes it as an operand; an Fr product does
        not, see params.py)."""
        s, _ = _carry32(_u64(a) + _u64(b), a.device)
        return _i32(s)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dev = a.device
        d, borrow = _borrow32(_u64(a) - _u64(b), dev)
        dp, _ = _carry32(d + self._p(dev), dev)
        return _i32(torch.where(borrow[..., None] == 1, dp, d))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """k * a for a small host integer k >= 0, by double-and-add."""
        if k == 0:
            return torch.zeros_like(a)
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(a == b, dim=-1)

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return torch.all(a == 0, dim=-1)

    # -- K1: Montgomery product ---------------------------------------------

    def mont_mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """REDC(a * b) = a * b * R^-1 mod the modulus, canonical, for operands
        below 2p (Fp) or canonical operands (Fr).

        Plain version of K1 on 2 * limbs words of 16 bits in int64: the
        schoolbook product as one broadcast multiply plus anti-diagonal sums,
        then word-by-word Montgomery reduction with n0' = -modulus^-1 mod
        2^16 (the same R as the kernel's 32-bit CIOS, so the canonical output
        is the same bits).  Works on any device."""
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        dev = a.device
        L = self.limbs
        n = a.numel() // L
        W = 2 * L

        def words(x):
            u = _u64(x.reshape(n, L))
            return torch.stack([u & 0xFFFF, u >> 16], -1).reshape(n, W)

        aw, bw = words(a), words(b)
        prod = (aw[:, :, None] * bw[:, None, :]).reshape(n, W * W)   # < 2^32 each
        idx = _idx(W, dev)
        diag = (idx[:, None] + idx[None, :]).reshape(-1)
        t = torch.zeros(n, 2 * W, dtype=torch.int64, device=dev)
        t.index_add_(1, diag, prod)                                  # < 2^37 each
        p16 = _const((self.name, "p16"), self.p_words16, dev)
        for i in range(W):
            m = ((t[:, i] & 0xFFFF) * self.n0_16) & 0xFFFF
            t[:, i : i + W] += m[:, None] * p16
            t[:, i + 1] += t[:, i] >> 16
        hi = t[:, W:]                                 # value < 2p, lazy columns
        for _ in range(2):                            # columns -> [0, 2^16 + 2^7)
            q = hi >> 16
            hi = (hi & 0xFFFF) + torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], 1)
        cin, _ = _chain(hi > 0xFFFF, hi == 0xFFFF, _bits(W, dev), idx)
        hi = (hi + cin) & 0xFFFF
        limbs = hi[:, 0::2] | (hi[:, 1::2] << 16)
        return self._cond_sub_p(limbs).reshape(shape)

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """REDC(a * b) for canonical operands (for Fp also pre-sums below
        2p), any matching or broadcastable leading shape.  K1 on a CUDA
        tensor, its plain version on a CPU tensor."""
        a, b = torch.broadcast_tensors(a, b)
        if a.device.type == "cpu":
            return self.mont_mul_plain(a, b)
        shape = a.shape
        a2 = a.reshape(-1, self.limbs).contiguous()
        b2 = b.reshape(-1, self.limbs).contiguous()
        out = torch.empty_like(a2)
        if a2.shape[0]:
            _build.launch("fp", f"{self.name}_mont_mul", (a2, b2, out), a2.shape[0])
        return out.reshape(shape)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Canonical standard-domain limbs -> the Montgomery form of the same
        value: REDC(x * R^2), one K1 launch."""
        r2 = torch.from_numpy(self.limbs_of(self.r2_mod)).to(x.device)
        return self.mont_mul(x, r2.expand_as(x))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> the canonical standard-domain limbs of the same
        value, on the device: REDC(x * 1), one K1 launch."""
        one_std = torch.from_numpy(self.limbs_of(1)).to(x.device)
        return self.mont_mul(x, one_std.expand_as(x))

    # -- K1: fixed public exponents -----------------------------------------

    def pow_fixed_plain(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e for a host exponent e, by a static square-and-multiply chain of
        plain products from the top bit (only e's set bits pay a multiply):
        the plain version of the chain kernel.  Works on any device."""
        if e == 0:
            return self.one(x.shape[:-1], x.device).clone()
        acc = x
        for bit in bin(e)[3:]:
            acc = self.mont_mul_plain(acc, acc)
            if bit == "1":
                acc = self.mont_mul_plain(acc, x)
        return acc

    def pow_fixed(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x^e for a host exponent 0 <= e < 2^384, every row by the same
        chain as pow_fixed_plain: ONE launch of the chain kernel on a CUDA
        tensor, the plain chain on a CPU tensor."""
        if e == 0:
            return self.one(x.shape[:-1], x.device).clone()
        if x.device.type == "cpu":
            return self.pow_fixed_plain(x, e)
        x2 = x.reshape(-1, self.limbs).contiguous()
        out = torch.empty_like(x2)
        if x2.shape[0]:
            _build.launch("fp", f"{self.name}_pow_fixed", (x2, out), x2.shape[0], exponent=e)
        return out.reshape(x.shape)

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Fermat inversion x^(modulus - 2); inv(0) = 0."""
        return self.pow_fixed(x, self.modulus - 2)

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of every element of x (Montgomery form in and out), 0
        for a 0 element: the JAX package's `batch_inv` (fields/fp.py,
        fields/fp32.py).

        That version is Montgomery's trick: one inversion and two
        `lax.scan`s of products along an axis, t dependent steps, which
        here would be 2t launches one after the other.  On a CUDA tensor the
        Fermat chain of every element is ONE `pow_fixed` launch whatever t
        is, so this is `inv`, and no axis is needed."""
        return self.inv(x)

    def sqrt(self, x: torch.Tensor) -> torch.Tensor:
        """x^((p+1)/4): a square root of x when x is a square (p = 3 mod 4);
        the caller checks sqrt(x)^2 == x."""
        assert self.modulus % 4 == 3
        return self.pow_fixed(x, (self.modulus + 1) // 4)

    def is_qr(self, x: torch.Tensor) -> torch.Tensor:
        """Euler's criterion: x^((p-1)/2) == 1, or x == 0."""
        t = self.pow_fixed(x, (self.modulus - 1) // 2)
        return self.eq(t, self.one(x.shape[:-1], x.device)) | self.is_zero(x)

    def invsqrt(self, x: torch.Tensor):
        """(inverse, sqrt candidate) from ONE chain t = x^((p-3)/4), for
        p = 3 mod 4: sqrt = x t and inv = t^4 x.  The sqrt output is a root
        only when x is a square (callers check by squaring)."""
        assert self.modulus % 4 == 3
        t = self.pow_fixed(x, (self.modulus - 3) // 4)
        t2 = self.mont_mul(t, t)
        return self.mont_mul(self.mont_mul(t2, t2), x), self.mont_mul(t, x)


#: the base field Fp: 12 limbs, R = 2^384
FP_CTX = Field("fp", P, LIMBS, N0_16, R_MOD, R2_MOD, R_INV)
#: the scalar field Fr: 8 limbs, R = 2^256 (canonical operands only)
FR_CTX = Field("fr", R, FR_LIMBS32, FR_N0_16, FR_R_MOD, FR_R2_MOD, FR_R_INV)

# The Fp operations under their module-level names.
limbs_of = FP_CTX.limbs_of
int_of = FP_CTX.int_of
mont_const = FP_CTX.mont_const
from_int = FP_CTX.from_int
to_int = FP_CTX.to_int
one = FP_CTX.one
zero = FP_CTX.zero
add = FP_CTX.add
add_raw = FP_CTX.add_raw
sub = FP_CTX.sub
neg = FP_CTX.neg
double = FP_CTX.double
mul_small = FP_CTX.mul_small
eq = FP_CTX.eq
is_zero = FP_CTX.is_zero
mont_mul_plain = FP_CTX.mont_mul_plain
mont_mul = FP_CTX.mont_mul
from_mont = FP_CTX.from_mont
pow_fixed_plain = FP_CTX.pow_fixed_plain
pow_fixed = FP_CTX.pow_fixed
inv = FP_CTX.inv
batch_inv = FP_CTX.batch_inv
sqrt = FP_CTX.sqrt
is_qr = FP_CTX.is_qr
invsqrt = FP_CTX.invsqrt
