"""Fp arithmetic on 32-bit limbs, with the Montgomery product as kernel K1.

Counterpart of the JAX package's `fields/fp32.py` (with `fields/active.py`).

An Fp element is a `torch.int32` tensor of shape (..., 12): 12 little-endian
32-bit limbs, read as unsigned, of the Montgomery form x * 2^384 mod p.
Every value is canonical (0 <= v < p) at every function boundary, so
equality of elements is equality of limbs, and no normalize/tighten/
reduce_full step exists.

Operations run where their tensors are.  `mont_mul` launches the CUDA
kernel `fp_mont_mul` (csrc/fp.cu) for a CUDA tensor and its plain version
`mont_mul_plain` for a CPU tensor.  The modular add/sub/neg are plain
PyTorch on both: each is a few dozen elementwise ops over the limbs, with
the carry and borrow chains resolved by one integer addition of bitmasks
instead of a loop over the limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..params import (LIMBS, N0_16, P, P_LIMBS, P_WORDS16, R_INV, R_MOD,
                      WORDS16)

_M32 = 0xFFFFFFFF
_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    """Small int64 constant tensors, uploaded once per device."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        vals = {
            "p": P_LIMBS,
            "p16": P_WORDS16,
            "bits12": [1 << i for i in range(LIMBS)],
            "idx12": list(range(LIMBS)),
            "bits24": [1 << i for i in range(WORDS16)],
            "idx24": list(range(WORDS16)),
        }[name]
        t = torch.tensor(vals, dtype=torch.int64, device=device)
        _CONSTS[key] = t
    return t


# ---------------------------------------------------------------------------
# Host conversion
# ---------------------------------------------------------------------------


def limbs_of(v: int) -> np.ndarray:
    """Plain int in [0, 2^384) -> (12,) int32 limbs (no domain change)."""
    return np.array([(v >> (32 * i)) & _M32 for i in range(LIMBS)],
                    np.uint32).view(np.int32)


def int_of(limbs) -> int:
    """(12,) limbs (int32 bit patterns) -> plain int."""
    u = np.asarray(limbs, np.int32).view(np.uint32)
    return sum(int(w) << (32 * i) for i, w in enumerate(u))


def mont_const(v: int) -> np.ndarray:
    """Host int -> Montgomery-form limbs (12,) int32."""
    return limbs_of(v % P * R_MOD % P)


def from_int(values, device="cpu") -> torch.Tensor:
    """Int or nested list of ints -> Montgomery tensor (..., 12)."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    out = np.empty((flat.shape[0], LIMBS), np.int32)
    for i, v in enumerate(flat):
        out[i] = mont_const(int(v))
    return torch.from_numpy(out.reshape(arr.shape + (LIMBS,))).to(device)


def to_int(x: torch.Tensor):
    """Montgomery tensor (..., 12) -> python int (no batch dims) or an
    object array of ints in [0, p)."""
    a = x.detach().cpu().numpy()
    flat = a.reshape(-1, LIMBS)
    out = np.empty(flat.shape[0], object)
    for i in range(flat.shape[0]):
        out[i] = int_of(flat[i]) * R_INV % P
    if a.ndim == 1:
        return out[0]
    return out.reshape(a.shape[:-1])


def one(batch=(), device="cpu") -> torch.Tensor:
    return torch.from_numpy(mont_const(1)).to(device).expand(*batch, LIMBS)


def zero(batch=(), device="cpu") -> torch.Tensor:
    return torch.zeros(*batch, LIMBS, dtype=torch.int32, device=device)


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
    cin, cout = _chain(s > _M32, s == _M32, _const("bits12", dev), _const("idx12", dev))
    return (s + cin) & _M32, cout


def _borrow32(d: torch.Tensor, dev):
    """Limb differences d in (-2^32, 2^32) (int64) -> limbs, borrow out."""
    bin_, bout = _chain(d < 0, d == 0, _const("bits12", dev), _const("idx12", dev))
    return (d - bin_) & _M32, bout


def _cond_sub_p(t: torch.Tensor) -> torch.Tensor:
    """int64 limbs of a value in [0, 2p) -> int32 limbs of the value mod p."""
    d, borrow = _borrow32(t - _const("p", t.device), t.device)
    return _i32(torch.where(borrow[..., None] == 1, t, d))


# ---------------------------------------------------------------------------
# Modular ring operations (plain PyTorch, canonical in and out)
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, _ = _carry32(_u64(a) + _u64(b), a.device)
    return _cond_sub_p(s)


def add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b without reduction: a value below 2p, the form of a Karatsuba
    pre-sum (a Montgomery product takes it as an operand)."""
    s, _ = _carry32(_u64(a) + _u64(b), a.device)
    return _i32(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dev = a.device
    d, borrow = _borrow32(_u64(a) - _u64(b), dev)
    dp, _ = _carry32(d + _const("p", dev), dev)
    return _i32(torch.where(borrow[..., None] == 1, dp, d))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def double(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """k * a for a small host integer k >= 0, by double-and-add."""
    if k == 0:
        return torch.zeros_like(a)
    acc = a
    for bit in bin(k)[3:]:
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, a)
    return acc


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


# ---------------------------------------------------------------------------
# K1: Montgomery product
# ---------------------------------------------------------------------------


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a * b) = a * b * 2^-384 mod p, canonical, for operands below 2p.

    Plain version of K1 on 24 words of 16 bits in int64: the schoolbook
    product as one broadcast multiply plus anti-diagonal sums, then
    word-by-word Montgomery reduction with n0' = -p^-1 mod 2^16 (the same
    R = 2^384 as the kernel's 12 x 32-bit CIOS, so the canonical output is
    the same bits).  Works on any device."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    dev = a.device
    n = a.numel() // LIMBS
    W = WORDS16

    def words(x):
        u = _u64(x.reshape(n, LIMBS))
        return torch.stack([u & 0xFFFF, u >> 16], -1).reshape(n, W)

    aw, bw = words(a), words(b)
    prod = (aw[:, :, None] * bw[:, None, :]).reshape(n, W * W)   # < 2^32 each
    idx = _const("idx24", dev)
    diag = (idx[:, None] + idx[None, :]).reshape(-1)
    t = torch.zeros(n, 2 * W, dtype=torch.int64, device=dev)
    t.index_add_(1, diag, prod)                                  # < 2^37 each
    p16 = _const("p16", dev)
    for i in range(W):
        m = ((t[:, i] & 0xFFFF) * N0_16) & 0xFFFF
        t[:, i : i + W] += m[:, None] * p16
        t[:, i + 1] += t[:, i] >> 16
    hi = t[:, W:]                                 # value < 2p, lazy columns
    for _ in range(2):                            # columns -> [0, 2^16 + 2^7)
        q = hi >> 16
        hi = (hi & 0xFFFF) + torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], 1)
    cin, _ = _chain(hi > 0xFFFF, hi == 0xFFFF, _const("bits24", dev), idx)
    hi = (hi + cin) & 0xFFFF
    limbs = hi[:, 0::2] | (hi[:, 1::2] << 16)
    return _cond_sub_p(limbs).reshape(shape)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a * b) for canonical operands (or pre-sums below 2p), any
    matching or broadcastable leading shape.  K1 on a CUDA tensor, its
    plain version on a CPU tensor."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    shape = a.shape
    a2 = a.reshape(-1, LIMBS).contiguous()
    b2 = b.reshape(-1, LIMBS).contiguous()
    out = torch.empty_like(a2)
    if a2.shape[0]:
        _build.launch("fp", "fp_mont_mul", (a2, b2, out), a2.shape[0])
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Fixed public exponents
# ---------------------------------------------------------------------------


def pow_fixed(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a host exponent e, by a static square-and-multiply chain of
    K1 launches (only e's set bits pay a multiply)."""
    if e == 0:
        return one(x.shape[:-1], x.device).clone()
    acc = x
    for bit in bin(e)[3:]:
        acc = mont_mul(acc, acc)
        if bit == "1":
            acc = mont_mul(acc, x)
    return acc


def inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat inversion x^(p-2); inv(0) = 0."""
    return pow_fixed(x, P - 2)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """x^((p+1)/4): a square root of x when x is a square (p = 3 mod 4);
    the caller checks sqrt(x)^2 == x."""
    return pow_fixed(x, (P + 1) // 4)


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> the canonical standard-domain limbs of the same
    value, on the device: REDC(x * 1), one K1 launch."""
    one_std = torch.from_numpy(limbs_of(1)).to(x.device)
    return mont_mul(x, one_std.expand_as(x))
