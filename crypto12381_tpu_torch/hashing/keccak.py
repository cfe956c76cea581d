"""Batched SHA3-512 (Keccak-f[1600]) on tensors: the device Fiat-Shamir.

Counterpart of the JAX package's `hashing/keccak.py`, which is plain XLA
there, so it is plain PyTorch here (no kernel of its own): a batch of B
transcripts hashes as one sponge over a (B, 25, 2) lane state.

  * A 64-bit lane is a (lo, hi) pair of 32-bit halves held in int64, so
    every shift is exact: a left shift stays below 2^63 and is masked
    back to 32 bits, a right shift of a nonnegative value is logical.
  * The 24 rounds are unrolled, each theta, rho-pi, chi and iota over all
    25 lanes and both halves at once (about 30 tensor ops a round).
  * Ragged rows: the blocks of a (B, nblk, 72) buffer are absorbed in
    turn, and a row keeps its state once its own block count is reached.

`sha3_512_batch` frames its rows on the host; `frame_device` and
`assemble_rows` frame and join rows that are already on the device (a
scheme's serialized group elements after its messages), and
`sha3_512_blocks` hashes framed blocks.  The digests equal
hashlib.sha3_512's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.batch import _device

_M32 = 0xFFFFFFFF
RATE = 72            # SHA3-512's rate in bytes: 9 lanes
DIGEST = 64

#: rotation offsets r[x, y] at flat lane 5 y + x
_RHO = np.array([0, 1, 62, 28, 27,
                 36, 44, 6, 55, 20,
                 3, 10, 43, 25, 39,
                 41, 45, 15, 21, 8,
                 18, 2, 61, 56, 14], np.int64)

_RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
       0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
       0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
       0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
       0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008]

#: pi: the lane at flat 5 ny + nx comes from 5 y + x, (nx, ny) = (y, (2x + 3y) mod 5)
_PI = np.zeros(25, np.int64)
for _y in range(5):
    for _x in range(5):
        _PI[5 * ((2 * _x + 3 * _y) % 5) + _y] = 5 * _y + _x
_RHO_PI = _RHO[_PI]

_CONSTS: dict = {}


def _consts(device):
    """Per device: the pi gather index, the rho rotations (swap mask and
    shift), theta's rotation by 1, and iota's per-round lane-0 table."""
    key = str(device)
    if key not in _CONSTS:
        def rot(r):
            r = np.asarray(r, np.int64) % 64
            return (torch.from_numpy(r >= 32).to(device)[:, None],
                    torch.from_numpy(r % 32).to(device)[:, None])

        rc = np.zeros((24, 25, 2), np.int64)
        rc[:, 0, 0] = [c & _M32 for c in _RC]
        rc[:, 0, 1] = [c >> 32 for c in _RC]
        _CONSTS[key] = {
            "pi": torch.from_numpy(_PI).to(device),
            "rho": rot(_RHO_PI),
            "one": rot(np.ones(5, np.int64)),
            "rc": torch.from_numpy(rc).to(device),
        }
    return _CONSTS[key]


def _rotl(v: torch.Tensor, rot) -> torch.Tensor:
    """64-bit rotate-left of (..., k, 2) (lo, hi) lanes by per-lane
    amounts: a half swap for amounts of 32 and more, then a shift s < 32
    of both halves with the other half's top bits carried in."""
    swap, s = rot
    v = torch.where(swap, v.flip(-1), v)
    return ((v << s) | (v.flip(-1) >> (32 - s))) & _M32


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] permutation of (B, 25, 2) states."""
    k = _consts(state.device)
    B = state.shape[0]
    for rnd in range(24):
        g = state.view(B, 5, 5, 2)                                   # [y, x]
        c = g[:, 0] ^ g[:, 1] ^ g[:, 2] ^ g[:, 3] ^ g[:, 4]          # theta
        d = c.roll(1, 1) ^ _rotl(c.roll(-1, 1), k["one"])
        flat = (g ^ d[:, None]).reshape(B, 25, 2)
        flat = _rotl(flat.index_select(1, k["pi"]), k["rho"])        # rho + pi
        g = flat.view(B, 5, 5, 2)
        g = g ^ (~g.roll(-1, 2) & g.roll(-2, 2))                     # chi
        state = g.reshape(B, 25, 2) ^ k["rc"][rnd]                   # iota
    return state


def _bytes_to_lanes(block: torch.Tensor) -> torch.Tensor:
    """(B, 8k) uint8 -> (B, k, 2) little-endian 32-bit halves."""
    b = block.to(torch.int64).reshape(block.shape[0], -1, 2, 4)
    return (b << torch.tensor([0, 8, 16, 24], device=block.device)).sum(-1)


def _lanes_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """(B, k, 2) halves -> (B, 8k) uint8 little-endian."""
    b = (lanes[..., None] >> torch.tensor([0, 8, 16, 24], device=lanes.device)) & 0xFF
    return b.to(torch.uint8).reshape(lanes.shape[0], -1)


def absorb_squeeze(blocks: torch.Tensor, nblk_row: torch.Tensor, rate: int = RATE,
                   out_bytes: int = DIGEST) -> torch.Tensor:
    """The sponge over framed (B, nblk, rate) uint8 blocks, each row
    absorbing only its first nblk_row blocks; one squeeze of out_bytes
    (<= rate): (B, out_bytes) uint8."""
    B, nblk, _ = blocks.shape
    rl = rate // 8
    state = torch.zeros(B, 25, 2, dtype=torch.int64, device=blocks.device)
    nblk_row = nblk_row.to(blocks.device)
    for j in range(nblk):
        absorbed = torch.cat([state[:, :rl] ^ _bytes_to_lanes(blocks[:, j]), state[:, rl:]], 1)
        state = torch.where((j < nblk_row)[:, None, None], keccak_f(absorbed), state)
    return _lanes_to_bytes(state[:, :(out_bytes + 7) // 8])[:, :out_bytes]


def pad_blocks(data: np.ndarray, lengths, rate: int = RATE):
    """Host framing of (B, maxlen) uint8 rows of byte lengths `lengths`:
    ((B, nblk, rate) uint8 blocks, (B,) int32 block counts).  0x06 at the
    row's length, 0x80 on the last byte of its final block."""
    data = np.asarray(data, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    B = data.shape[0]
    nblk_row = lengths // rate + 1
    nblk = int(nblk_row.max()) if B else 1
    buf = np.zeros((B, nblk * rate), np.uint8)
    w = min(data.shape[1], nblk * rate)
    keep = np.arange(w)[None, :] < lengths[:, None]
    buf[:, :w] = np.where(keep, data[:, :w], 0)
    rows = np.arange(B)
    buf[rows, lengths] |= 0x06
    buf[rows, nblk_row * rate - 1] |= 0x80
    return buf.reshape(B, nblk, rate), nblk_row.astype(np.int32)


def sha3_512_batch(data, lengths, device=None) -> torch.Tensor:
    """SHA3-512 of (B, maxlen) uint8 rows of byte lengths `lengths`, framed
    on the host, hashed on `device` (the CUDA card by default):
    (B, 64) uint8 digests there."""
    dev = _device(device, "sha3_512_batch runs")
    blocks, nrow = pad_blocks(data, lengths)
    return absorb_squeeze(torch.from_numpy(blocks).to(dev), torch.from_numpy(nrow).to(dev))


def sha3_512_blocks(blocks: torch.Tensor, nblk_row: torch.Tensor) -> torch.Tensor:
    """SHA3-512 of blocks already framed where they lie (frame_device)."""
    return absorb_squeeze(blocks, nblk_row)


def frame_device(data: torch.Tensor, lengths: torch.Tensor, rate: int = RATE):
    """Framing of (B, L) uint8 rows of byte lengths `lengths` where they
    lie: ((B, L // rate + 1, rate) blocks, (B,) block counts).  Bytes at
    and past a row's length are zeroed; 0x06 goes at the length and 0x80
    is added on the last byte of the row's final block (0x86 when the two
    fall on one byte)."""
    B, L = data.shape
    nblk = L // rate + 1
    dev = data.device
    lengths = lengths.to(dev, torch.int64)
    buf = torch.cat([data, torch.zeros(B, nblk * rate - L, dtype=torch.uint8, device=dev)], 1)
    col = torch.arange(nblk * rate, device=dev)[None, :]
    buf = torch.where(col < lengths[:, None], buf, torch.zeros((), dtype=torch.uint8, device=dev))
    rows = torch.arange(B, device=dev)
    buf = buf.index_put((rows, lengths), torch.full((B,), 0x06, dtype=torch.uint8, device=dev))
    nrow = lengths // rate + 1
    last = nrow * rate - 1
    buf = buf.index_put((rows, last), buf[rows, last] + 0x80)
    return buf.reshape(B, nblk, rate), nrow


def assemble_rows(prefix: torch.Tensor, prefix_len: torch.Tensor, suffix: torch.Tensor):
    """Per row prefix[i, :prefix_len[i]] || suffix[i] in a (B, Lp + Ls)
    buffer (one gather; the slack past a row's length is what
    frame_device zeroes), and the rows' lengths."""
    B, Lp = prefix.shape
    Ls = suffix.shape[1]
    both = torch.cat([prefix, suffix], 1)
    j = torch.arange(Lp + Ls, device=prefix.device)[None, :]
    pl = prefix_len.to(prefix.device, torch.int64)[:, None]
    idx = torch.where(j < pl, j, torch.clamp(Lp + j - pl, max=Lp + Ls - 1))
    return torch.gather(both, 1, idx.expand(B, -1)), pl[:, 0] + Ls
