"""The port's host pairing and host GT and G2 elements against the JAX
package and the reference vectors.

Held exactly: the host tower's final exponentiation (easy part, then one
power by (p^4 - p^2 + 1) / r) against the JAX pyref's single power by
(p^12 - 1) / r on a random Fp12 value; `pair` and `GTPair` (products of
pairs under one final exponentiation) against the JAX `pair`/`GTPair` and
reference.json's e(g1, g2), e(7 g1, 11 g2), e(g1, g2)^5 and the double-ate
product; the `GTElement` operations (*, /, ** and ^, inverse, ==, hash,
one, in_subgroup, parse and serialize) and the `G2Element` group law
(*, /, inverse, ==, product, in_subgroup) against the JAX host elements.
"""

import json
import pathlib

import numpy as np
import pytest

from crypto12381_tpu.api import elements as EJ
from crypto12381_tpu.params import P, R
from crypto12381_tpu.pyref import curve as CJ
from crypto12381_tpu.pyref import field as FJ
from crypto12381_tpu.pyref import pairing as PJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = json.loads((ROOT / "tests" / "vectors" / "reference.json").read_text())

E = HF = C = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import the port when this file's first test runs."""
    global E, HF, C
    from crypto12381_tpu_torch.api import elements as E
    from crypto12381_tpu_torch.host import curve as C
    from crypto12381_tpu_torch.host import field as HF
    yield


def _rand_fp12(seed):
    rng = np.random.default_rng(seed)
    c = [(int.from_bytes(rng.bytes(48), "big") % P, int.from_bytes(rng.bytes(48), "big") % P)
         for _ in range(6)]
    return HF.fp12_from_coeffs_w(tuple(c))


def test_tower_and_final_exp_match_pyref():
    """fp12 product, square, inverse, Frobenius and power equal the JAX
    pyref's; the split final exponentiation equals its single power."""
    x, y = _rand_fp12(1), _rand_fp12(2)
    canon = FJ._fp12_canon
    assert HF.fp12_mul(x, y) == canon(FJ.fp12_mul(x, y))
    assert HF.fp12_sqr(x) == canon(FJ.fp12_sqr(x))
    assert HF.fp12_inv(x) == canon(FJ.fp12_inv(x))
    assert HF.fp12_frob(x) == canon(FJ.fp12_frob(x))
    assert HF.fp12_pow(x, 12345) == canon(FJ.fp12_pow(x, 12345))
    assert HF.fp12_pow(x, -7) == canon(FJ.fp12_pow(x, -7))
    assert HF.fp12_final_exp(x) == canon(PJ.final_exp(x))


@pytest.mark.parametrize("case", ["e_g1_g2", "e_7g_11h", "pow5", "double_ate"])
def test_pair_matches_reference_and_jax(case):
    """pair / GTPair values (and their bytes) against reference.json and
    the JAX host pairing."""
    g1 = E.G1Element(C.G1_GEN)
    g2 = E.G2Element(C.G2_GEN)
    g1j, g2j = EJ.G1Element.generator(), EJ.G2Element.generator()
    if case == "e_g1_g2":
        got, want, ref = E.pair(g1, g2), EJ.pair(g1j, g2j), "gt_e_g1_g2"
    elif case == "e_7g_11h":
        got, want = E.pair(g1 ** 7, g2 ** 11), EJ.pair(g1j ** 7, g2j ** 11)
        ref = "gt_e_7g_11h"
    elif case == "pow5":
        got, want, ref = E.pair(g1, g2) ** 5, EJ.pair(g1j, g2j) ** 5, "gt_e_pow5"
    else:
        got = E.pair(g1 ** 2, g2) * E.pair(g1, g2 ** 3)
        want = EJ.pair(g1j ** 2, g2j) * EJ.pair(g1j, g2j ** 3)
        ref = "gt_double_ate"
        assert isinstance(got, E.GTPair) and len(got.pairs) == 2
    assert got.serialize().hex() == REF[ref] == want.serialize().hex()


def test_gt_and_g2_elements_match_jax():
    """The GTElement operations and the rest of G2Element against the JAX
    host elements, by bytes and verdicts."""
    ks = [3, 5, R - 2]
    g2 = [E.G2Element(C.g2_mul(C.G2_GEN, k)) for k in ks]
    g2j = [EJ.G2Element(CJ.g2_mul(CJ.G2_GEN, k)) for k in ks]
    ser = lambda xs: [x.serialize() for x in xs]  # noqa: E731
    assert ser([g2[0] * g2[1], g2[0] / g2[1], g2[2].inverse(),
                E.G2Element.product(g2), g2[0] / g2[0]]) == ser(
        [g2j[0] * g2j[1], g2j[0] / g2j[1], g2j[2].inverse(), EJ.G2Element.product(g2j),
         g2j[0] / g2j[0]])
    assert (g2[0] == g2[0]) and not (g2[0] == g2[1]) and hash(g2[0]) == hash(E.G2Element(g2[0].pt))
    assert g2[0].in_subgroup() and E.G2Element(None).in_subgroup()
    x, y = (5, 1), None                 # a point of E'(Fp2) outside G2
    while y is None:
        x = (x[0] + 1, x[1])
        y = FJ.fp2_sqrt(FJ.fp2_add(FJ.fp2_mul(FJ.fp2_sqr(x), x), (4, 4)))
    assert E.G2Element((x, y)).in_subgroup() is EJ.G2Element((x, y)).in_subgroup() is False

    g1, g1j = E.G1Element(C.G1_GEN), EJ.G1Element.generator()
    a, b = E.pair(g1, g2[0]).value(), E.pair(g1 ** 7, g2[1]).value()
    aj, bj = EJ.pair(g1j, g2j[0]).value(), EJ.pair(g1j ** 7, g2j[1]).value()
    assert ser([a * b, a / b, a ** 11, a ^ E.ZpNumber(13), a.inverse(), E.GTElement.one(),
                a * E.pair(g1, g2[1]), a / E.pair(g1, g2[1])]) == ser(
        [aj * bj, aj / bj, aj ** 11, aj ^ EJ.ZpNumber(13), aj.inverse(), EJ.GTElement.one(),
         aj * EJ.pair(g1j, g2j[1]), aj / EJ.pair(g1j, g2j[1])])
    back = E.GTElement.parse(a.serialize())
    assert back == a and hash(back) == hash(a)
    assert a == E.pair(g1, g2[0]) and not (a == b)
    assert a.in_subgroup() and aj.in_subgroup()
    rnd = E.GTElement(_rand_fp12(3))
    assert rnd.in_subgroup() is EJ.GTElement(_rand_fp12(3)).in_subgroup() is False
    assert E.pair(E.G1Element(None), g2[0]) == E.GTElement.one()
