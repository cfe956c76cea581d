"""The port's symbolic notation (api/algebra.py) and the symbolic half of
its set API (api/sets.py) against the JAX package's.

Every case of tests/test_algebra.py runs twice, once on the JAX
package's `algebra`, `sets` and `elements` modules and once on the
port's, with the same inputs: each run checks the case's own expected
values, and the two runs' values are held equal exactly (ints, host
points, bytes).  Besides those: product sets, `hash_(...) | ...`,
`select_in` over a product set and the non-star G1 and G2 draws, and
`create_random_engine`'s signature.  Host code only: no tensor is made.
"""

import importlib

import pytest

JAX_MODS = ("crypto12381_tpu.api.algebra", "crypto12381_tpu.api.sets",
            "crypto12381_tpu.api.elements")
PORT_MODS = ("crypto12381_tpu_torch.api.algebra", "crypto12381_tpu_torch.api.sets",
             "crypto12381_tpu_torch.api.elements")


def _mods(which):
    return tuple(importlib.import_module(m) for m in (JAX_MODS if which == "jax" else PORT_MODS))


def case_symbol_substitution(ALG, S, E):
    x, y = ALG.symbols("x y")
    f = x + y - 1
    ff = f(x, y)                 # substituting symbols is the identity
    f2 = f(x.be(y + 3))          # x = y + 3 -> 2y + 2
    out = (ff(1, 2), f2(y.be(5)))
    assert out == (2, 12)
    return out


def case_ranged_substitution(ALG, S, E):
    x, y = ALG.symbols("x y")
    rng = (x + y - 1)(x.be(y + 3))(y.in_[1, 3])
    out = (rng[0], rng[1], len(rng))
    assert out == (4, 6, 2)
    return out


def case_symbolic_subscript_and_ranges(ALG, S, E):
    x, i = ALG.symbols("x i")
    arr = ALG.algebraic([1, 2, 3, 4, 5])
    rr = (arr[i] + arr[i + 1])(i.in_[0, x])(x.be(3))
    arr3 = (arr[4 - i])(i.in_[0, 5])
    ccc = arr[i](i.in_[x])(x.be(3))
    out = (list(rr), list(arr3), list(ccc))
    assert out[0][2] == 3 + 4 and out[1][1] == 4 and out[2][1] == 2
    return out


def case_except(ALG, S, E):
    x, i = ALG.symbols("x i")
    arr = ALG.algebraic([1, 2, 3, 4, 5])
    s = arr[i](i.in_[2].except_(x))(x.be(1))
    assert list(s) == [1]        # i in {0, 1} \ {1} = {0}
    return list(s)


def case_subscript_substitute_functions(ALG, S, E):
    i = ALG.Symbol("i")
    arr = ALG.algebraic([10, 20, 30])
    out = (ALG.substitute(ALG.subscript(arr, i), i=0), ALG.subscript(arr, 2))
    assert out == (10, 30)
    return out


def case_sum_prod(ALG, S, E):
    i, j = ALG.symbols("i j")
    arr = ALG.algebraic([1, 2, 3, 4])
    out = (ALG.Sum[4](arr[i]), ALG.Prod[i.in_[1, 5]](i), ALG.Sum[i.in_[4].except_(2)](arr[i]),
           ALG.Prod[j.in_(range(3)).except_(0)](1))
    assert out == (10, 24, 1 + 2 + 4, 1)
    with pytest.raises(ValueError, match="empty"):
        ALG.Sum[i.in_[2].except_(0, 1)](arr[i])
    return out


def case_multi_range_nesting_last_outermost(ALG, S, E):
    ii, k = ALG.symbols("ii k")
    table = (ii * 10 + k)(ii.in_[2], k.in_[3])
    out = [list(r) for r in table]
    assert table[2][1] == 1 * 10 + 2 and table[0][0] == 0   # table[k][ii]
    return out


def case_sequence_adaptors(ALG, S, E):
    out = (ALG.sequence(5).filter(lambda v: v % 2 == 0).transform(lambda v: v * v).materialize(),
           ALG.sequence(2, 5).materialize(), ALG.algebraic([1, 2, 3]).except_(2).materialize(),
           ALG.materialize(ALG.transform([1, 2], lambda v: -v)),
           ALG.filter_([1, 2, 3], lambda v: v > 1).materialize(),
           ALG.except_([1, 2, 3], 1, 3).materialize())
    assert out == ([0, 4, 16], [2, 3, 4], [1, 3], [-1, -2], [2, 3], [2])
    return out


def case_symbolic_sum_prod_in_sets(ALG, S, E):
    i_, = ALG.symbols("i_")
    vals = ALG.algebraic([E.ZpNumber(v) for v in (3, 5, 7, 11)])
    rows = ALG.algebraic([[E.ZpNumber(1), E.ZpNumber(2)], [E.ZpNumber(3), E.ZpNumber(4)]])
    k_, i = ALG.symbols("k_ i")
    out = (S.sum_(vals[i_], i_.in_[4]), S.sum_(vals[i_], i_.in_[1, 4]),
           S.product_(vals[i_], i_.in_[4].except_(2)), S.sum_(rows[k_][1], k_.in_[2]),
           S.sum_(vals[i] * 2, 3), S.sum_(vals[i_], i_.in_[0]))
    out = tuple(v.value for v in out)
    assert out == (26, 23, 165, 6, 30, 0)
    with pytest.raises(ValueError, match="empty product"):
        S.product_(vals[i_], i_.in_[0])
    return out


def case_symbolic_g1_pow_product_fuses(ALG, S, E):
    g = E.G1Element.generator()
    i_, = ALG.symbols("i_")
    es = ALG.algebraic([E.ZpNumber(2), E.ZpNumber(3), E.ZpNumber(4)])
    sym = S.product_(g ** es[i_], i_.in_[3])
    assert isinstance(sym, E.G1Element)
    assert sym == (g ** 2).point() * (g ** 3) * (g ** 4)
    assert sym == g ** 9
    return sym.pt


def case_packed_struct_parse_serialize(ALG, S, E):
    @S.packed
    class Sig:
        h = S.G1
        s = S.G1
        e = S.Zp

    @S.packed
    class Pair:
        gs = S.G1 ** 2
        ez = S.Zp | S.G2

    r = S.create_random_engine("packed")
    h, s = select_in_g1(S, r), select_in_g1(S, r)
    e = S.select_in(S.Zp, r)
    blob = S.serialize(h, s, e)
    assert isinstance(blob, S.SerializedPack) and isinstance(blob, bytes)
    assert Sig.SERIALIZED_SIZE == 49 + 49 + 48 == len(blob)
    sig = blob.to(Sig)
    assert sig.h == h and sig.s == s and sig.e == e
    sig2 = S.parse(Sig, bytes(blob))
    assert sig2 == sig and bytes(sig2.serialize()) == bytes(blob)
    g2 = S.select_in(S.G2, r)
    pblob = S.serialize([h, s], e, g2)
    assert Pair.SERIALIZED_SIZE == 2 * 49 + 48 + 97 == len(pblob)
    pr = S.parse(Pair, pblob)
    assert pr.gs == (h, s) and pr.ez == (e, g2) and bytes(pr.serialize()) == bytes(pblob)
    with pytest.raises(ValueError):
        S.SerializedPack(blob[:-1]).to(Sig)
    return bytes(blob), bytes(pblob)


def select_in_g1(S, r):
    return S.select_in(S.G1, r).point()


def case_sets_and_hash(ALG, S, E):
    """Product sets, select_in over them, hash_ with `|`, hash to G1."""
    ps = S.Zp | S.G1 * S.G2
    assert ps.serialized_size == 48 + 49 + 97 and ((S.Zp ** 2) ** 3).serialized_size == 6 * 48
    r = S.create_random_engine("sets")
    z, g1, g2 = S.select_in(ps, r)
    zz = S.select_in(S.Zp ** 2, r)
    blob = S.serialize(z, g1, g2, zz)
    back = S.parse(ps, S.Zp ** 2, blob)
    assert back[0] == z and back[1] == g1 and back[2] == g2 and back[3:] == zz
    h1 = S.hash_(z, g1) | g2 | [zz[0], zz[1]]
    h2 = S.hash_([z, g1, g2], b"") | zz
    assert h1.digest() == h2.digest()
    with pytest.raises(TypeError):
        S.hash_(5)
    pt = S.hash_(b"abc").to(S.G1)
    return blob, h1.to(S.Zp).value, pt.pt


CASES = {f.__name__[5:]: f for f in (
    case_symbol_substitution, case_ranged_substitution, case_symbolic_subscript_and_ranges,
    case_except, case_subscript_substitute_functions, case_sum_prod,
    case_multi_range_nesting_last_outermost, case_sequence_adaptors,
    case_symbolic_sum_prod_in_sets, case_symbolic_g1_pow_product_fuses,
    case_packed_struct_parse_serialize, case_sets_and_hash)}


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_jax(case):
    """The case's own checks on both packages, and equal values."""
    assert CASES[case](*_mods("port")) == CASES[case](*_mods("jax"))


def test_host_draws_and_engine_signature():
    """select_in of G1 and G2 (non-star), G1Pow.select, the G2 generator and
    identity, on one stream from the C twin of the CSPRNG
    (create_random_engine(seed, native=True)), equal the JAX package's."""
    from crypto12381_tpu.compat import csprng as CSJ
    from crypto12381_tpu_torch.compat import csprng as CS

    _, SJ, EJ = _mods("jax")
    _, S, E = _mods("port")
    out = []
    for mod, el, cs in ((SJ, EJ, CSJ), (S, E, CS)):
        r = cs.create_random_engine("draws", native=True)
        g1 = mod.select_in(mod.G1, r)
        g2 = mod.select_in(mod.G2, r, 2)
        p = el.G1Pow.select(r)
        out.append((g1.exp, [q.pt for q in g2], p.exp, el.G2Element.generator().pt,
                    el.G2Element.identity().pt, el.G2Element.select(r).pt,
                    (g1 ^ 3).exp, (el.G1Element.generator() ^ 5).exp))
    assert out[0] == out[1]
