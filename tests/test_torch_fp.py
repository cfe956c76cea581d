"""The port's Fp layer against the JAX package's fields/fp32.py.

The same field values, made once from a numpy seed, go through the JAX
function (on the CPU, through its XLA path) and through the port on the
CPU, where each kernel wrapper runs its plain version.  Results are
compared as canonical values, exactly: convert.from_jax_fp maps the JAX
package's loose R = 2^400 digits to the port's canonical R = 2^384 limbs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.fields import fp32 as F8
from crypto12381_tpu.params import P

CTX = F8.FP_CTX
EDGE = [0, 1, P - 1]
R_MOD = (1 << 384) % P              # the port's Montgomery R = 2^384
R_INV = pow(1 << 384, -1, P)

torch = convert = FP = None         # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected: every test worker collects every file, and the
    JAX suite's workers have no memory to spare.  Drops JAX's compiled
    functions after the file's tests."""
    global torch, convert, FP
    import torch
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.fields import fp as FP
    yield
    jax.clear_caches()


def rand_ints(seed, n, bound=P):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % bound for _ in range(n)]


def limbs(vals):
    """Raw limb tensors (the values ARE the Montgomery forms)."""
    return torch.from_numpy(np.stack([FP.limbs_of(v) for v in vals]))


def jax_of(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(j):
    return convert.from_jax_fp(np.asarray(j))


def _check_mont_mul_plain_matches_jax():
    """K1's plain version vs fp32._mont_mul_xla on 64 random rows plus the
    edge rows 0, 1, p-1, then on pre-sum operands up to 2p-2; the CPU
    wrapper runs the plain version, broadcasting included."""
    for presum in (False, True):
        bound = 2 * P - 1 if presum else P
        edge = EDGE + ([2 * P - 2, P] if presum else [])
        a_vals = edge + rand_ints(1, 64, bound)
        b_vals = edge[::-1] + rand_ints(2, 64, bound)
        a, b = limbs(a_vals), limbs(b_vals)
        got = FP.mont_mul_plain(a, b)
        want = port_of(F8._mont_mul_xla(CTX, jax_of(a), jax_of(b)))
        assert torch.equal(got, want)
        assert [FP.int_of(r) for r in got.numpy()] == [
            x * y * R_INV % P for x, y in zip(a_vals, b_vals)]
        assert torch.equal(FP.mont_mul(a, b), got)
        assert torch.equal(FP.mont_mul(a, b[:1]), FP.mont_mul_plain(a, b[:1].expand_as(a)))


def _check_add_sub_neg_inv_match_jax():
    a = limbs(EDGE + rand_ints(5, 32))
    b = limbs(EDGE[::-1] + rand_ints(6, 32))
    ja, jb = jax_of(a), jax_of(b)
    assert torch.equal(FP.add(a, b), port_of(F8.add(CTX, ja, jb)))
    assert torch.equal(FP.sub(a, b), port_of(F8.sub(CTX, ja, jb)))
    assert torch.equal(FP.neg(a), port_of(F8.neg(CTX, ja)))
    got = FP.inv(a[:6])
    assert torch.equal(got, port_of(F8.inv(CTX, ja[:6])))
    assert FP.int_of(got[0].numpy()) == 0          # inv(0) = 0


def _check_eq_is_zero_mul_small_add_raw():
    vals = EDGE + rand_ints(9, 16)
    a = limbs(vals)
    assert FP.is_zero(a).tolist() == [True] + [False] * (len(vals) - 1)
    assert FP.eq(a, a).all() and not FP.eq(a, FP.add(a, a[1:2])).any()
    for k in (0, 1, 3, 12):
        assert [FP.int_of(r) for r in FP.mul_small(a, k).numpy()] == [
            k * v % P for v in vals]
    assert [FP.int_of(r) for r in FP.add_raw(a, a).numpy()] == [2 * v for v in vals]


def _check_from_int_to_int_and_jax_roundtrip():
    """Host ints -> Montgomery tensors -> ints, and JAX Montgomery arrays ->
    port -> JAX, keep the field values."""
    vals = EDGE + rand_ints(10, 16)
    t = FP.from_int(vals)
    assert list(FP.to_int(t)) == vals
    assert FP.int_of(t[1].numpy()) == R_MOD            # Montgomery one
    assert torch.equal(FP.one((2,)), t[1].expand(2, -1))
    j = F8.from_int(CTX, vals)
    assert torch.equal(port_of(j), t)
    back = jnp.asarray(convert.to_jax_fp(t))
    assert [int(v) for v in F8.to_int(CTX, back)] == vals
    assert torch.equal(port_of(back), t)


def _check_pow_chains_match_jax():
    """The plain chain pow_fixed_plain at the exponents of the inverse
    (p-2), the square root ((p+1)/4), Euler's criterion ((p-1)/2) and the
    shared inverse/root chain ((p-3)/4) against host integers, and the
    root's against fp32.pow_fixed (the inverse's is held against fp32.inv
    above); inv and sqrt against those chains; is_qr and invsqrt (the last
    two chains) against fp32.is_qr and fp32.invsqrt and host integers.
    Rows 0, 1, p-1, a square and random values; on the CPU the wrappers
    run the plain chain."""
    vals = EDGE + [4] + rand_ints(11, 4)
    a = FP.from_int(vals)
    ja = jax_of(a)
    chains = {}
    for e in (P - 2, (P + 1) // 4, (P - 1) // 2, (P - 3) // 4):
        chains[e] = FP.pow_fixed_plain(a, e)
        assert list(FP.to_int(chains[e])) == [pow(v, e, P) for v in vals]
    assert torch.equal(chains[(P + 1) // 4], port_of(F8.pow_fixed(CTX, ja, (P + 1) // 4)))
    assert torch.equal(FP.inv(a), chains[P - 2])
    assert torch.equal(FP.sqrt(a), chains[(P + 1) // 4])
    qr = FP.is_qr(a)
    assert qr.tolist() == np.asarray(F8.is_qr(CTX, ja)).tolist()
    assert qr.tolist() == [pow(v, (P - 1) // 2, P) in (0, 1) for v in vals]
    inv_, root = FP.invsqrt(a)
    j_inv, j_root = F8.invsqrt(CTX, ja)
    assert torch.equal(inv_, port_of(j_inv)) and torch.equal(root, port_of(j_root))
    assert torch.equal(inv_, chains[P - 2])
    assert torch.equal(FP.mont_mul(root, root)[qr], a[qr])


def test_fp_layer_matches_jax():
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_mont_mul_plain_matches_jax()
    _check_pow_chains_match_jax()
    _check_add_sub_neg_inv_match_jax()
    _check_eq_is_zero_mul_small_add_raw()
    _check_from_int_to_int_and_jax_roundtrip()
