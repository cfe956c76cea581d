"""The port's Fp12 kernels K8-K11 (fields/fused.py, csrc/fp12.cu) against
the JAX package.

Each plain version is held against the TPU program of the same name run
as XLA on the CPU (`fp32k._fused_xla`) and against the JAX row-stacked
composite (`fp32k.*_c`, and `pairing._mul_sparse` for the sparse line), on
16 rows made from a numpy seed with rows of all 0, all 1 and all p-1 at
both ends (all p-1 gives the largest pre-sums); the port's CPU tower
operations and `_mul_sparse` must run the plain versions, at any batch
shape and with broadcast operands; `pair_batch(..., device="cpu")` at
B = 2 must give the JAX package's GT bytes (its integer oracle `pyref`).
Results are compared exactly as canonical values.  K10 is a polynomial
that squares only in the cyclotomic subgroup; random inputs hold it as
that polynomial.  The cyclotomic power of one launch
(`fp12_cyc_pow_fixed`, the final exponentiation's g^|x|) is held against
the JAX `_pow_abs_x` under jax.jit on random rows and against pyref's
`fp12_pow` on cyclotomic ones; K11 over a stack of k lines against the
JAX `_mul_sparse` applied k times, a masked line and a broadcast c3 among
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.compat import codec as CODECJ
from crypto12381_tpu.fields import fp32k as FKJ
from crypto12381_tpu.pairing import pairing as PAIRJ
from crypto12381_tpu.params import X_ABS, P, R
from crypto12381_tpu.pyref import curve as CJ
from crypto12381_tpu.pyref import field as FJ
from crypto12381_tpu.pyref import pairing as PYREF

N = 16

torch = T = convert = codec = FP = FK = TW = PAIR = C = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected (every test worker collects every file).  Drops
    JAX's compiled functions after the file's tests."""
    global torch, T, convert, codec, FP, FK, TW, PAIR, C
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import fused as FK
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    yield
    jax.clear_caches()


def rand_fp(seed, shape):
    """(N, *shape, 12) canonical random limbs; rows 0-2 all 0, 1 and p-1,
    and rows N-3 to N-1 all p-1, 1 and 0."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(N,) + tuple(shape) + (12,), dtype=np.uint64)
    w[..., 11] %= 0x1A0111EA                      # below p's top limb
    t = torch.from_numpy(w.astype(np.uint32).view(np.int32))
    for r, v in enumerate([0, 1, P - 1]):
        t[r] = t[N - 1 - r] = torch.from_numpy(FP.limbs_of(v))
    return t


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(j):
    return convert.from_jax_fp(np.asarray(j))


def comps(t):
    """(n, ..., 12) port tensor -> list of (n, 50) JAX component arrays in
    fp32k's [h][c][re, im] order."""
    return [J(c) for c in t.reshape(t.shape[0], -1, 12).unbind(1)]


def from_comps(cs, shape):
    return port_of(np.stack([np.asarray(c) for c in cs], 1)).reshape(shape)


def operands(name):
    """The port operands of `name`: Fp12 x (and y, or the line (c0, c3, c5)
    as (N, 3, 2, 12)); y's row 3 equals x's (x y with equal operands)."""
    x = rand_fp(1, (2, 3, 2))
    if name == "fp12_mul":
        y = rand_fp(2, (2, 3, 2))
        y[3] = x[3]
        return x, y
    if name == "fp12_sparse_mul":
        return x, rand_fp(3, (3, 2))
    return (x,)


def jax_composite(name, args):
    """The JAX row-stacked composite on the port's operands."""
    if name == "fp12_sparse_mul":
        return FKJ.sparse_mul_c(comps(args[0]), comps(args[1]))
    return getattr(FKJ, name + "_c")(*[comps(t) for t in args])


@pytest.mark.parametrize("name", ["fp12_mul", "fp12_sqr", "fp12_usqr", "fp12_sparse_mul"])
def test_fp12_plain_versions_match_jax(name):
    """The plain version equals the JAX program run as XLA, the JAX
    composite, and what the port's CPU tower operation (or _mul_sparse)
    and the CPU wrapper give, also at another batch shape and with a
    broadcast operand."""
    args = operands(name)
    got = getattr(FK, name + "_plain")(*args)
    assert got.shape == args[0].shape and got.dtype == torch.int32
    want = FKJ._fused_xla(name, [c for t in args for c in comps(t)])
    assert torch.equal(got, from_comps(want, got.shape))
    assert torch.equal(got, from_comps(jax_composite(name, args), got.shape))
    assert torch.equal(getattr(FK, name)(*args), got)
    if name == "fp12_sparse_mul":
        line = tuple(args[1].unbind(-3))
        port = PAIR._mul_sparse(args[0], line)
        assert torch.equal(port, port_of(PAIRJ._mul_sparse(J(args[0]), tuple(J(c) for c in line))))
        # a line broadcast over the batch, as _absorb's c3 is
        wide = PAIR._mul_sparse(args[0].reshape(4, 4, 2, 3, 2, 12),
                                (line[0].reshape(4, 4, 2, 12), line[1][:1], line[2].reshape(4, 4, 2, 12)))
        c3 = line[1][:1].expand(N, 2, 12)
        assert torch.equal(wide.reshape(got.shape),
                           FK.fp12_sparse_mul_plain(args[0], torch.stack([line[0], c3, line[2]], -3)))
    else:
        port = getattr(TW, name)(*args)
        # a (4, 4) batch, and the first operand's row 0 broadcast against every row
        wide = getattr(TW, name)(*[t.reshape((4, 4) + t.shape[1:]) for t in args])
        assert torch.equal(wide.reshape(got.shape), got)
        if name == "fp12_mul":
            bc = TW.fp12_mul(args[0][:1], args[1])
            assert torch.equal(bc, FK.fp12_mul_plain(args[0][:1].expand_as(args[1]), args[1]))
    assert torch.equal(port, got)


@pytest.mark.parametrize("case", ["pow_abs_x", "pow_cyclotomic", "lines"])
def test_fp12_power_and_lines_match_jax(case):
    """pow_abs_x: the plain power x^|x| equals the JAX `_pow_abs_x` under
    jax.jit on random rows (as a polynomial), and the CPU wrapper and the
    port's `_pow_abs_x` give it.  pow_cyclotomic: on cyclotomic rows (the
    easy part f^((p^6 - 1)(p^2 + 1)) of random f) it equals pyref's
    `fp12_pow(x, |x|)`.  lines: the plain product by a stack of k = 3 lines
    equals the JAX `_mul_sparse` applied line by line, with one line masked
    to 1 on every row (c0 = 1, c3 = c5 = 0), one row of another masked, and
    c3 broadcast over the rows as `_absorb` gives it; so do the CPU wrapper
    and `pairing._mul_lines`."""
    if case == "pow_abs_x":
        x = rand_fp(21, (2, 3, 2))
        got = FK.fp12_cyc_pow_fixed_plain(x, X_ABS)
        assert torch.equal(got, port_of(jax.jit(PAIRJ._pow_abs_x)(J(x))))
        assert torch.equal(FK.fp12_cyc_pow_fixed(x, X_ABS), got)
        assert torch.equal(PAIR._pow_abs_x(x), got)
    elif case == "pow_cyclotomic":
        f = rand_fp(22, (2, 3, 2))[3:7]                  # no zero row
        m = TW.fp12_mul(TW.fp12_conj(f), TW.fp12_inv(f))
        m = TW.fp12_mul(TW.fp12_frob(m, 2), m)
        got = TW.fp12_to_host(FK.fp12_cyc_pow_fixed_plain(m, X_ABS))
        assert got == [FJ._fp12_canon(FJ.fp12_pow(h, X_ABS)) for h in TW.fp12_to_host(m)]
    else:
        k = 3
        f = rand_fp(23, (2, 3, 2))
        c0, c5 = (rand_fp(24 + i, (k, 2)).transpose(0, 1) for i in range(2))
        c3 = rand_fp(26, (k, 2))[:1].transpose(0, 1)        # (k, 1, 2, 12)
        inf = torch.zeros(k, N, dtype=torch.bool)
        inf[1] = True
        inf[2, 3] = True
        m = inf[..., None, None]
        lines = torch.stack([torch.where(m, TW.fp2_one(), c0), torch.where(m, 0, c3),
                             torch.where(m, 0, c5)], -3)         # (k, N, 3, 2, 12)
        want = J(f)
        for i in range(k):
            want = PAIRJ._mul_sparse(want, tuple(J(c) for c in lines[i].unbind(-3)))
        got = FK.fp12_sparse_mul_plain(f, lines)
        assert torch.equal(got, port_of(want))
        assert torch.equal(FK.fp12_sparse_mul(f, lines), got)
        assert torch.equal(PAIR._mul_lines(f, c0, c3, c5, inf), got)


def test_pair_batch_cpu_matches_jax_gt_bytes():
    """pair_batch on the CPU (every Fp12 operation through the plain
    versions of K8-K11) at B = 2 gives the GT bytes of the JAX package's
    integer pairing and codec."""
    rng = np.random.default_rng(13)
    ks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4)]
    g1 = [C.g1_mul(C.G1_GEN, ks[0]), C.g1_mul(C.G1_GEN, ks[1])]
    g2 = [C.g2_mul(C.G2_GEN, ks[2]), C.g2_mul(C.G2_GEN, ks[3])]
    f = T.pair_batch(g1, g2, device="cpu")
    got = [codec.gt_serialize(h) for h in TW.fp12_to_host(f)]
    want = [CODECJ.gt_serialize(PYREF.pairing(CJ.g1_mul(CJ.G1_GEN, ks[i]),
                                              CJ.g2_mul(CJ.G2_GEN, ks[2 + i])))
            for i in range(2)]
    assert got == want
