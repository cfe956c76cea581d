"""The port's curve and pairing layers against the JAX package, the golden
vectors and the import contract.

G2 doubling and mixed addition, the line coefficients and the whole
`pairing_affine` are held exactly (as canonical values) against the JAX
package on the same inputs, made from a numpy seed; the GT bytes against
tests/vectors/reference.json.  The JAX pairing runs under jax.jit at
B = 2 in a child process (the one slow test here).
"""

import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crypto12381_tpu.curves import g2 as G2J
from crypto12381_tpu.curves import weierstrass as WJ
from crypto12381_tpu.pairing import pairing as PAIRJ
from crypto12381_tpu.params import R

ROOT = pathlib.Path(__file__).resolve().parent.parent
VEC = json.loads((ROOT / "tests" / "vectors" / "reference.json").read_text())

torch = T = convert = codec = G2 = W = FP = TW = C = PAIR = None     # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs, not when
    the file is collected: every test worker collects every file, and the
    JAX suite's workers have no memory to spare.  Drops JAX's compiled
    functions after the file's tests."""
    global torch, T, convert, codec, G2, W, FP, TW, C, PAIR
    import torch
    import crypto12381_tpu_torch as T
    from crypto12381_tpu_torch import convert
    from crypto12381_tpu_torch.compat import codec
    from crypto12381_tpu_torch.curves import g2 as G2
    from crypto12381_tpu_torch.curves import weierstrass as W
    from crypto12381_tpu_torch.fields import fp as FP
    from crypto12381_tpu_torch.fields import tower as TW
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.pairing import pairing as PAIR
    yield
    jax.clear_caches()


def J(t):
    return jnp.asarray(convert.to_jax_fp(t))


def port_of(j):
    return convert.from_jax_fp(np.asarray(j))


def rand_fp2(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, 2, 12), dtype=np.uint64)
    w[..., 11] %= 0x1A0111EA                      # below p's top limb
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def rand_point(seed, n=2):
    return tuple(rand_fp2(seed + i, n) for i in range(3))


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]


def affine_tensors(g1, g2):
    px = FP.from_int([p[0] for p in g1])
    py = FP.from_int([p[1] for p in g1])
    qx = torch.stack([FP.from_int([q[0][0] for q in g2]), FP.from_int([q[0][1] for q in g2])], -2)
    qy = torch.stack([FP.from_int([q[1][0] for q in g2]), FP.from_int([q[1][1] for q in g2])], -2)
    return (px, py), (qx, qy)


# ------------------------------------------------------------------ G2


def _check_g2_double_madd_generator_match_jax():
    A = rand_point(1)
    AJ = tuple(J(c) for c in A)
    for g, w in zip(G2.double(A), G2J.double(AJ)):
        assert torch.equal(g, port_of(w))
    Q = (rand_fp2(7, 2), rand_fp2(8, 2))
    for g, w in zip(G2.madd(A, Q), WJ.madd(G2J.ops(), AJ, tuple(J(c) for c in Q))):
        assert torch.equal(g, port_of(w))
    B = rand_point(4)                             # the generic complete add
    for g, w in zip(W.add(G2.ops(), A, B), WJ.add(G2J.ops(), AJ, tuple(J(c) for c in B))):
        assert torch.equal(g, port_of(w))
    x, y, z = G2.generator((2,))
    assert list(FP.to_int(x[:, 0])) == [C.G2_GEN[0][0]] * 2
    assert bool(TW.fp2_eq(z, TW.fp2_one((2,))).all())
    x2, y2, _ = G2.from_affine_fp2(([C.G2_GEN[0][0]] * 2, [C.G2_GEN[0][1]] * 2),
                                   ([C.G2_GEN[1][0]] * 2, [C.G2_GEN[1][1]] * 2))
    assert torch.equal(x2, x) and torch.equal(y2, y)


def _check_line_coeffs_match_jax():
    A = rand_point(10)
    AJ = tuple(J(c) for c in A)
    Q = (rand_fp2(13, 2), rand_fp2(14, 2))
    for got, want in ((PAIR._line_dbl_coeffs(A), PAIRJ._line_dbl_coeffs(AJ)),
                      (PAIR._line_add_coeffs(A, Q),
                       PAIRJ._line_add_coeffs(AJ, tuple(J(c) for c in Q)))):
        for g, w in zip(got, want):
            assert torch.equal(g, port_of(w))


# ------------------------------------------------------------- pairing


#: The JAX pairing under jax.jit, in a child process: the compile of the
#: whole pairing graph takes some 4 GB, which a long-lived test worker
#: would otherwise keep.
JAX_PAIRING = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from crypto12381_tpu.pairing import pairing as PAIR
d = np.load(sys.argv[1])
a = {k: jnp.asarray(d[k]) for k in ("px", "py", "qx", "qy")}
out = jax.jit(lambda p, q: PAIR.pairing_affine(p, q))((a["px"], a["py"]), (a["qx"], a["qy"]))
np.save(sys.argv[2], np.asarray(out))
"""


def _check_pairing_affine_matches_jax_jit(tmp_path):
    ks = scalars(20, 4)
    g1 = [C.g1_mul(C.G1_GEN, ks[0]), C.g1_mul(C.G1_GEN, ks[1])]
    g2 = [C.g2_mul(C.G2_GEN, ks[2]), C.g2_mul(C.G2_GEN, ks[3])]
    p_aff, q_aff = affine_tensors(g1, g2)
    got = PAIR.pairing_affine(p_aff, q_aff)
    np.savez(tmp_path / "in.npz", **{k: convert.to_jax_fp(t) for k, t in
                                     zip(("px", "py", "qx", "qy"), p_aff + q_aff)})
    out = subprocess.run([sys.executable, "-c", JAX_PAIRING, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npy")], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert torch.equal(got, port_of(np.load(tmp_path / "out.npy")))


def _check_pair_batch_reference_bytes_and_infinity_masks():
    """GT bytes of e(G1, G2) and e(7 G1, 11 G2) equal the reference's; as
    tests/test_pairing.py, e(O, .) = e(., O) = 1, by mask and by None."""
    f = T.pair_batch([C.G1_GEN, C.g1_mul(C.G1_GEN, 7), C.G1_GEN, C.G1_GEN, None],
                     [C.G2_GEN, C.g2_mul(C.G2_GEN, 11), C.G2_GEN, C.G2_GEN, C.G2_GEN],
                     p_inf=[False, False, True, False, False],
                     q_inf=[False, False, False, True, False], device="cpu")
    h = TW.fp12_to_host(f)
    assert codec.gt_serialize(h[0]).hex() == VEC["gt_e_g1_g2"]
    assert codec.gt_serialize(h[1]).hex() == VEC["gt_e_7g_11h"]
    assert TW.fp12_is_one(f).tolist() == [False, False, True, True, True]
    (p_aff, q_aff) = affine_tensors([C.G1_GEN], [C.G2_GEN])
    e = PAIR.pairing_affine(p_aff, q_aff, p_inf=torch.tensor([True]))
    assert bool(TW.fp12_is_one(e).all())


def _check_pair_batch_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.pair_batch([C.G1_GEN], [C.G2_GEN])


# ------------------------------------------------------- import contract


def _check_port_imports_no_jax():
    """Every module of the port, found by walking the package, and
    chip_smoke import neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, chip_smoke, crypto12381_tpu_torch as T\n"
        "names = [m.name for m in pkgutil.walk_packages(T.__path__, T.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print('jax' in sys.modules, 'crypto12381_tpu' in sys.modules, ','.join(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    jax_loaded, pkg_loaded, names = out.stdout.split()
    assert (jax_loaded, pkg_loaded) == ("False", "False")
    names = set(names.split(","))
    for mod in ("convert", "compat.codec", "compat.csprng", "api.batch", "api.sets",
                "api.elements", "curves.g1", "curves.g2", "curves.endo", "msm.pippenger",
                "msm.rounds", "msm.sorted", "ops.scalar_decomp", "pairing.pairing",
                "schemes.ps", "schemes.bbs", "schemes.bbs_plus", "schemes.sss",
                "hashing.keccak", "host.pairing", "schemes.bbs04", "schemes.ac_bbs",
                "schemes.ac_rbbs", "schemes.ac_rps", "api.algebra", "schemes.mhac_bbs",
                "hashing.sswu", "host.sswu", "iso11_data", "parallel.sharding",
                "utils.profiling"):
        assert "crypto12381_tpu_torch." + mod in names, mod


def _check_chip_smoke_fails_without_card_or_package(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, with no card (as
    here) and from a directory that holds nothing else of the repo."""
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_pairing_layer_matches_jax_and_contract(tmp_path):
    """One test for the file's checks (the tier-1 run's worker schedule
    depends on the number of tests collected)."""
    _check_g2_double_madd_generator_match_jax()
    _check_line_coeffs_match_jax()
    (tmp_path / "jax").mkdir()
    _check_pairing_affine_matches_jax_jit(tmp_path / "jax")
    _check_pair_batch_reference_bytes_and_infinity_masks()
    _check_port_imports_no_jax()
    if not torch.cuda.is_available():    # the no-card behaviour, checked here
        _check_pair_batch_needs_a_card_by_default()
        (tmp_path / "alone").mkdir()
        _check_chip_smoke_fails_without_card_or_package(tmp_path / "alone")
