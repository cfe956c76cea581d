"""MIRACL's deterministic CSPRNG, bit for bit.

Every seeded flow of the reference (keys, signatures, re-randomizations)
depends on this exact byte stream.  The published algorithm: the seed's
SHA-256 stirs a Marsaglia-Zaman subtract-with-borrow lagged Fibonacci
generator (8 `sirand` rounds, each with a 10,000-step warm-up); the pool
is the SHA-256 of the low bytes of 128 generator words, served a byte at
a time and refilled every 32 bytes.

`random_mod` is MIRACL's BIG_randomnum: it draws 2 nbits(q) bits, each
byte read from its low bit up, the first bit drawn the most significant,
and reduces mod q.  `random_mod_nonzero` draws mod q - 1 and adds 1.
"""

from __future__ import annotations

import hashlib

_NK = 21
_NJ = 6
_NV = 8
_M32 = 0xFFFFFFFF


class RandomEngine:
    """A seeded byte stream with the reference's RandomEngine draws."""

    def __init__(self, seed: bytes | str):
        if isinstance(seed, str):
            seed = seed.encode()
        self._ira = [0] * _NK
        self._rndptr = 0
        self._borrow = 0
        self._pool = b""
        self._pool_ptr = 0
        self._seed(seed)

    # -- Marsaglia-Zaman generator ------------------------------------

    def _sbrand(self) -> int:
        self._rndptr += 1
        if self._rndptr < _NK:
            return self._ira[self._rndptr]
        self._rndptr = 0
        k = _NK - _NJ
        for i in range(_NK):
            if k == _NK:
                k = 0
            t = self._ira[k]
            pdiff = (t - self._ira[i] - self._borrow) & _M32
            if pdiff < t:
                self._borrow = 0
            if pdiff > t:
                self._borrow = 1
            self._ira[i] = pdiff
            k += 1
        return self._ira[0]

    def _sirand(self, seed: int) -> None:
        self._borrow = 0
        self._rndptr = 0
        self._ira[0] ^= seed
        m = 1
        for i in range(1, _NK):
            in_ = (_NV * i) % _NK
            self._ira[in_] ^= m
            t = m
            m = (seed - m) & _M32
            seed = t
        for _ in range(10000):
            self._sbrand()

    def _fill_pool(self) -> None:
        h = hashlib.sha256()
        for _ in range(128):
            h.update(bytes([self._sbrand() & 0xFF]))
        self._pool = h.digest()
        self._pool_ptr = 0

    def _seed(self, raw: bytes) -> None:
        self._pool_ptr = 0
        self._ira = [0] * _NK
        if raw:
            digest = hashlib.sha256(raw).digest()
            for i in range(8):
                self._sirand(int.from_bytes(digest[4 * i:4 * i + 4], "little"))
        self._fill_pool()

    # -- draws ---------------------------------------------------------

    def rand_byte(self) -> int:
        r = self._pool[self._pool_ptr]
        self._pool_ptr += 1
        if self._pool_ptr >= 32:
            self._fill_pool()
        return r

    def rand_bytes(self, n: int) -> bytes:
        return bytes(self.rand_byte() for _ in range(n))

    def random_mod(self, q: int) -> int:
        """2 nbits(q) bits, the first drawn the most significant, mod q."""
        d = 0
        r = 0
        for j in range(2 * q.bit_length()):
            if j % 8 == 0:
                r = self.rand_byte()
            else:
                r >>= 1
            d = (d << 1) + (r & 1)
        return d % q

    def random_mod_nonzero(self, q: int) -> int:
        """A draw in [1, q): mod q - 1, then plus 1."""
        return self.random_mod(q - 1) + 1


def create_random_engine(seed: bytes | str) -> RandomEngine:
    return RandomEngine(seed)
