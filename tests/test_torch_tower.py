"""The port's tower layer against the JAX package's fields/tower.py and
fields/fp32k.py.

K2, K3 and K4's plain versions are held against `fp32k._fused_xla`, the
TPU programs run as XLA on the CPU; K8-K11's plain versions against the
JAX row-stacked composites `fp32k.*_c`, and the Fp12 operations against
`tower.py`, at B = 2.  Inputs are
made once from a numpy seed and fed to both through convert.py; results
are compared exactly as canonical values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.fields import fp32k as FKJ
from crypto12381_tpu.fields import tower as TWJ
from crypto12381_tpu.pairing import pairing as PAIRJ
from crypto12381_tpu.params import P

B = 2

torch = convert = FP = FK = TW = None      # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected: every test worker collects every file, and the
    JAX suite's workers have no memory to spare.  Drops JAX's compiled
    functions after the file's tests."""
    global torch, convert, FP, FK, TW
    import torch
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.fields import tower as TW
    yield
    jax.clear_caches()


def rand_fp(seed, shape):
    """Canonical random limbs (..., 12), plus edge values 0, 1, p-1 in the
    first rows when there are enough."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=tuple(shape) + (12,), dtype=np.uint64)
    w[..., 11] %= 0x1A0111EA                      # below p's top limb
    t = torch.from_numpy(w.astype(np.uint32).view(np.int32))
    flat = t.reshape(-1, 12)
    if flat.shape[0] >= 6:
        for r, v in enumerate([0, 1, P - 1]):
            flat[r] = torch.from_numpy(FP.limbs_of(v))
    return t


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(j):
    return convert.from_jax_fp(np.asarray(j))


def comps(t):
    """(n, ..., 12) port tensor -> list of (n, 50) JAX component arrays in
    fp32k's [re, im] / [c][re, im] / [h][c][re, im] order."""
    n = t.shape[0]
    return [J(c) for c in t.reshape(n, -1, 12).unbind(1)]


def from_comps(cs, shape):
    return port_of(np.stack([np.asarray(c) for c in cs], 1)).reshape(shape)


# ---------------------------------------------------------------- kernels


def _check_kernel_plain_versions_match_fused_xla():
    """K2, K3, K4's plain versions vs the TPU programs run as XLA, and the
    CPU wrappers run the plain versions."""
    n = 16
    for name in ("fp2_mul", "fp2_sqr", "fp6_mul"):
        shape = (n, 3, 2) if name == "fp6_mul" else (n, 2)
        a = rand_fp(1, shape)
        b = rand_fp(2, shape)
        b[3] = a[3]                                # equal operands too
        if name == "fp2_sqr":
            got = FK.fp2_sqr_plain(a)
            want = FKJ._fused_xla(name, comps(a))
            assert torch.equal(FK.fp2_sqr(a), got)
        else:
            got = getattr(FK, name + "_plain")(a, b)
            want = FKJ._fused_xla(name, comps(a) + comps(b))
            assert torch.equal(getattr(FK, name)(a, b), got)
        assert torch.equal(got, from_comps(want, got.shape)), name


# ------------------------------------------------------------- composites


def f12(seed):
    return rand_fp(seed, (B, 2, 3, 2))


def _check_composites_match_fp32k_and_pairing():
    """The Fp12 kernels' plain versions (K8-K11) against the JAX
    row-stacked composites and the JAX pairing's sparse product."""
    x, y = f12(5), f12(6)
    for name in ("fp12_mul", "fp12_sqr", "fp12_usqr"):
        args = (x, y) if name == "fp12_mul" else (x,)
        got = getattr(FK, name + "_plain")(*args)
        want = getattr(FKJ, name + "_c")(*[comps(t) for t in args])
        assert torch.equal(got, from_comps(want, got.shape)), name
    f = f12(7)
    line = [rand_fp(8 + i, (B, 2)) for i in range(3)]
    got = FK.fp12_sparse_mul_plain(f, torch.stack(line, -3))
    want = FKJ.sparse_mul_c(comps(f), [c for t in line for c in comps(t)])
    assert torch.equal(got, from_comps(want, got.shape))
    want2 = PAIRJ._mul_sparse(J(f), tuple(J(t) for t in line))
    assert torch.equal(got, port_of(want2))


def _check_fp12_ops_match_tower():
    """fp12_mul/sqr/usqr (usqr as raw algebra: random inputs are not in the
    cyclotomic subgroup), conj, inv and the p and p^2 Frobenius."""
    x, y = f12(11), f12(12)
    JX = J(x)
    assert torch.equal(TW.fp12_mul(x, y), port_of(TWJ.fp12_mul(JX, J(y))))
    for op in ("fp12_sqr", "fp12_usqr", "fp12_conj", "fp12_inv"):
        assert torch.equal(getattr(TW, op)(x), port_of(getattr(TWJ, op)(JX))), op
    for n in (1, 2):
        assert torch.equal(TW.fp12_frob(x, n), port_of(TWJ.fp12_frob(JX, n)))
    assert bool(TW.fp12_is_one(TW.fp12_mul(x, TW.fp12_inv(x))).all())


def _check_fp2_and_fp6_ops_match_tower():
    a, b = rand_fp(14, (B, 2)), rand_fp(15, (B, 2))
    assert torch.equal(TW.fp2_inv(a), port_of(TWJ.fp2_inv(J(a))))
    (m,) = TW.fp2_mul_many([(a, b)])
    assert torch.equal(m, port_of(TWJ.fp2_mul(J(a), J(b))))
    for g, w in zip(TW.fp2_sqr_many([a, b]), TWJ.fp2_sqr_many([J(a), J(b)])):
        assert torch.equal(g, port_of(w))
    s = rand_fp(16, (B,))
    assert torch.equal(TW.fp2_mul_fp(a, s), port_of(TWJ.fp2_mul_fp(J(a), J(s))))
    c = rand_fp(17, (B, 3, 2))
    assert torch.equal(TW.fp6_inv(c), port_of(TWJ.fp6_inv(J(c))))


def _check_frob_gammas_match_tower():
    for n in (1, 2, 3):
        got = torch.from_numpy(TW.frob_gammas(n))
        assert torch.equal(got, port_of(TWJ._frob_gammas(n))), n


def test_tower_layer_matches_jax():
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_kernel_plain_versions_match_fused_xla()
    _check_composites_match_fp32k_and_pairing()
    _check_fp12_ops_match_tower()
    _check_fp2_and_fp6_ops_match_tower()
    _check_frob_gammas_match_tower()
