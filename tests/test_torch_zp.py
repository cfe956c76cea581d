"""The port's ZpVec arithmetic against the JAX package's ZpVec.

The same scalars, made once from a numpy seed (64 random values plus 0, 1
and r - 1), go through the JAX package's `ZpVec` + - * neg inverse on the
CPU and through the port's on the CPU, where the Fr kernels' wrappers run
their plain versions; the standard-domain limbs must be equal, and equal
to Python integers mod r.  Also the Fr field's Montgomery round trips and
the 16-bit <-> 32-bit limb packing of ZpVec.
"""

import jax
import numpy as np
import pytest

from crypto12381_tpu.api.batch import ZpVec as ZpJ
from crypto12381_tpu.params import R

EDGE = [0, 1, R - 1]

torch = T = FP = None               # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's test runs, not when the
    file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's test."""
    global torch, T, FP
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch.fields import fp as FP
    yield
    jax.clear_caches()


def rand_ints(seed, n, bound=R):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]


def _check_arithmetic_matches_jax_and_ints():
    a = EDGE + rand_ints(1, 64)
    b = EDGE[::-1] + rand_ints(2, 64)
    pa, pb = T.ZpVec.from_ints(a, device="cpu"), T.ZpVec.from_ints(b, device="cpu")
    ja, jb = ZpJ.from_ints(a), ZpJ.from_ints(b)
    cases = {
        "add": (pa + pb, ja + jb, [(x + y) % R for x, y in zip(a, b)]),
        "sub": (pa - pb, ja - jb, [(x - y) % R for x, y in zip(a, b)]),
        "mul": (pa * pb, ja * jb, [x * y % R for x, y in zip(a, b)]),
        "neg": (-pa, -ja, [-x % R for x in a]),
        "inverse": (pa.inverse(), ja.inverse(), [pow(x, R - 2, R) for x in a]),
    }
    for name, (got, want_jax, want_int) in cases.items():
        assert got.std.dtype == torch.int32 and tuple(got.std.shape) == (len(a), 18), name
        assert np.array_equal(got.std.numpy(), np.asarray(want_jax.std)), name
        assert list(got.to_ints()) == want_int, name
    assert int(cases["inverse"][0].to_ints()[0]) == 0              # inverse(0) = 0
    assert bool((pa * pa.inverse() == T.ZpVec.from_ints([1], device="cpu"))[1:].all())


def _check_montgomery_round_trips():
    """Fr's to_mont is x 2^256 mod r and from_mont undoes it; ZpVec's
    32-bit limbs hold its 16-bit limbs' value and unpack to them."""
    fr = FP.FR_CTX
    vals = EDGE + rand_ints(3, 16)
    z = T.ZpVec.from_ints(vals, device="cpu")
    x = z.limbs32()
    assert [fr.int_of(r) for r in x.numpy()] == vals
    assert torch.equal(T.ZpVec.from_limbs32(x).std, z.std)
    m = fr.to_mont(x)
    assert [fr.int_of(r) for r in m.numpy()] == [v * (1 << 256) % R for v in vals]
    assert list(fr.to_int(m)) == vals
    assert torch.equal(fr.from_mont(m), x)
    assert torch.equal(fr.from_int(vals), m)
    assert torch.equal(fr.mont_mul(m, fr.one((len(vals),))), m)


def test_zp_arithmetic_matches_jax():
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_arithmetic_matches_jax_and_ints()
    _check_montgomery_round_trips()
