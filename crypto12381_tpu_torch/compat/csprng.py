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

`NativeRandomEngine` draws the same stream from the repository's C twin
(cpp/compat_csprng.c, built by cpp/Makefile into
cpp/libcrypto12381_compat.so on first use); `create_random_engine(seed,
native=True)` takes it when the library loads and this module's engine
otherwise, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess

_NK = 21
_NJ = 6
_NV = 8
_M32 = 0xFFFFFFFF


#: each byte with its bits in reverse order
_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _draw_bits(rand_bytes, n: int) -> int:
    """n bits from ceil(n / 8) bytes, each byte read from its low bit up,
    the first bit drawn the most significant (BIG_randomnum's order)."""
    raw = rand_bytes((n + 7) // 8).translate(_REVERSED)
    return int.from_bytes(raw, "big") >> (8 * len(raw) - n)


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
        self._pool = hashlib.sha256(bytes([self._sbrand() & 0xFF for _ in range(128)])).digest()
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
        return _draw_bits(self.rand_bytes, 2 * q.bit_length()) % q

    def random_mod_nonzero(self, q: int) -> int:
        """A draw in [1, q): mod q - 1, then plus 1."""
        return self.random_mod(q - 1) + 1


_CPP = pathlib.Path(__file__).resolve().parents[2] / "cpp"
_NATIVE: list = []          # [library or None], loaded on first use


def _native():
    """The C twin's library, built with make when it is missing; None when
    it cannot be built or loaded."""
    if not _NATIVE:
        so = _CPP / "libcrypto12381_compat.so"
        lib = None
        try:
            if not so.exists():
                subprocess.run(["make", "-C", str(_CPP)], capture_output=True, check=True,
                               timeout=120)
            lib = ctypes.CDLL(str(so))
            lib.crypto12381_csprng_size.restype = ctypes.c_int
            lib.crypto12381_csprng_size.argtypes = []
            lib.crypto12381_csprng_seed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                                    ctypes.c_int]
            lib.crypto12381_csprng_seed.restype = None
            lib.crypto12381_csprng_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                                     ctypes.c_long]
            lib.crypto12381_csprng_bytes.restype = None
        except (OSError, subprocess.SubprocessError):
            lib = None
        _NATIVE.append(lib)
    return _NATIVE[0]


class NativeRandomEngine:
    """RandomEngine's stream from the C twin, through ctypes (raises
    OSError when its library is absent; create_random_engine falls back)."""

    def __init__(self, seed: bytes | str):
        if isinstance(seed, str):
            seed = seed.encode()
        self._lib = _native()
        if self._lib is None:
            raise OSError("cpp/libcrypto12381_compat.so cannot be built or loaded")
        self._state = ctypes.create_string_buffer(self._lib.crypto12381_csprng_size())
        self._lib.crypto12381_csprng_seed(self._state, seed, len(seed))

    def rand_bytes(self, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.crypto12381_csprng_bytes(self._state, out, n)
        return out.raw

    def rand_byte(self) -> int:
        return self.rand_bytes(1)[0]

    def random_mod(self, q: int) -> int:
        """RandomEngine.random_mod's draw: 2 nbits(q) bits, mod q."""
        return _draw_bits(self.rand_bytes, 2 * q.bit_length()) % q

    def random_mod_nonzero(self, q: int) -> int:
        return self.random_mod(q - 1) + 1


def create_random_engine(seed: bytes | str, native: bool = False):
    """The seeded engine: the C twin with native=True when its library
    loads, else RandomEngine (the same stream)."""
    if native and _native() is not None:
        return NativeRandomEngine(seed)
    return RandomEngine(seed)
