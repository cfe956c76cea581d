"""The port's MHAC-BBS (multi-holder anonymous credentials) against the
JAX package and the reference vector.

Held exactly (bytes and verdicts): tests/vectors/mhac_bbs_flow.json
through the port's host functions (iss_setup(4), Prv = {0, 2}, t = 3,
n = 6, S = {0, 2, 5}, Rev = {1}); on one CSPRNG stream, each host
function against the JAX host function, at the reference's parameters
and at a second set where two public attributes are revealed; the
port's `cred_pres_batch` at B = 3 against three JAX host `cred_pres`
calls on an engine with the same seed; and every row of
`verify_pres_batch` against the JAX host `verify_pres`, on valid rows
and on a row carrying another row's z (tests/test_batch.py's case).
The JAX `cred_pres_batch` and `verify_pres_batch` are not run: their CPU
compiles outlast a test.  All on the CPU (`device="cpu"`).
"""

import functools
import json
import pathlib

import pytest

from crypto12381_tpu.api import sets as SJ
from crypto12381_tpu.schemes import mhac_bbs as MHJ

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: (m, Prv, t, n, S, Rev): the reference test's, and one revealing two
#: public attributes with a single private one
CONFIGS = {"reference": (4, [0, 2], 3, 6, [0, 2, 5], [1]),
           "two_revealed": (5, [1], 2, 3, [0, 2], [0, 3])}

torch = S = MH = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this file's first test runs."""
    global torch, S, MH
    import torch
    from crypto12381_tpu_torch.api import sets as S
    from crypto12381_tpu_torch.schemes import mhac_bbs as MH
    yield


@functools.lru_cache(maxsize=None)
def _issued(package: str, config: str, seed: str):
    """Issuer setup, attributes, credential, group and type on one stream,
    through one package's host functions; the stream is left after them."""
    mod, sets = (MHJ, SJ) if package == "jax" else (MH, S)
    m, Prv, t, n, grp_S, Rev = CONFIGS[config]
    r = sets.create_random_engine(seed)
    st = mod.iss_setup(m, r)
    Pub = [i for i in range(m) if i not in Prv]
    ai = mod.generate_attributes(st.pp, t, n, Prv, r)
    creds = mod.cred_iss(st.pp, st.keys.sk, t, ai.commitments, Pub, ai.public_attributes, r)
    group = mod.make_pres_group(creds, grp_S)
    ptype = mod.make_pres_type(st.pp, Rev, Prv, ai.public_attributes)
    return st, ai, creds, group, ptype, r


def _presentations(package, config, seed, k):
    mod = MHJ if package == "jax" else MH
    st, ai, creds, group, ptype, r = _issued(package, config, seed)
    Prv = CONFIGS[config][1]
    return [mod.cred_pres(st.pp, creds, group, ptype, Prv, ai.public_attributes,
                          ai.private_attributes_share, r) for _ in range(k)]


def test_flow_vector_and_no_card_default():
    """mhac_bbs_flow.json byte for byte through the port's host functions;
    without a card the batched entry points raise."""
    vec = json.loads((ROOT / "tests" / "vectors" / "mhac_bbs_flow.json").read_text())
    st, ai, creds, group, ptype, r = _issued("port", "reference", "seed")
    assert st.pp.g1_g2.hex() == vec["g1g2"] and [x.hex() for x in st.pp.h] == vec["h"]
    assert st.keys.sk.hex() == vec["sk"] and st.keys.pk.hex() == vec["pk"]
    assert [a.hex() for a in ai.public_attributes] == vec["pub_attrs"]
    assert [[s.hex() for s in row] for row in ai.private_attributes_share] == vec["shares"]
    assert [c.hex() for c in ai.commitments] == vec["C"]
    assert creds.A.hex() == vec["cred_A"] and [d.hex() for d in creds.D] == vec["D"]
    assert [s.hex() for s in creds.e_share] == vec["e_share"]
    assert [x.hex() for x in group.lam] == vec["group_lam"] and group.D.hex() == vec["group_D"]
    assert ptype.C_rev.hex() == vec["C_rev"] and ptype.C_pub.hex() == vec["C_pub"]
    Prv = CONFIGS["reference"][1]
    pres = MH.cred_pres(st.pp, creds, group, ptype, Prv, ai.public_attributes,
                        ai.private_attributes_share, r)
    assert pres.fixed_part.hex() == vec["pres_fixed"]
    assert [z.hex() for z in pres.z] == vec["pres_z"]
    assert [z.hex() for z in pres.z_hid_pub] == vec["pres_z_hid_pub"]
    assert MH.verify_pres(st.pp, st.keys.pk, ptype, Prv, ai.public_attributes,
                          pres) is vec["verify"] is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="verify_pres_batch runs on a CUDA card"):
            MH.verify_pres_batch(st.pp, st.keys.pk, ptype, Prv, ai.public_attributes, [pres])
        with pytest.raises(RuntimeError, match="cred_pres_batch runs on a CUDA card"):
            MH.cred_pres_batch(st.pp, [creds], [group], [ptype], Prv, [ai.public_attributes],
                               [ai.private_attributes_share], r)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_host_functions_match_jax(config):
    """Every host function's bytes on one stream, and verify_pres on a
    valid and a tampered presentation, equal the JAX package's."""
    port, jax_ = _issued("port", config, "mhac-host"), _issued("jax", config, "mhac-host")
    (st, ai, creds, group, ptype, _), (stj, aij, credsj, groupj, ptypej, _) = port, jax_
    assert (st.pp.g1_g2, st.pp.h, st.keys.sk, st.keys.pk) == (
        stj.pp.g1_g2, stj.pp.h, stj.keys.sk, stj.keys.pk)
    assert (ai.public_attributes, ai.private_attributes_share, ai.commitments) == (
        aij.public_attributes, aij.private_attributes_share, aij.commitments)
    assert (creds.A, creds.e_share, creds.D) == (credsj.A, credsj.e_share, credsj.D)
    assert (group.S, group.lam, group.D) == (groupj.S, groupj.lam, groupj.D)
    assert (ptype.Rev, ptype.C_rev, ptype.C_pub) == (ptypej.Rev, ptypej.C_rev, ptypej.C_pub)
    p = _presentations("port", config, "mhac-host", 2)
    pj = _presentations("jax", config, "mhac-host", 2)
    assert [(x.fixed_part, x.z, x.z_hid_pub) for x in p] == [
        (x.fixed_part, x.z, x.z_hid_pub) for x in pj]
    Prv = CONFIGS[config][1]
    bad = MH.Pres(p[0].fixed_part, list(p[1].z), list(p[0].z_hid_pub))
    for x in (p[0], bad):
        want = MHJ.verify_pres(stj.pp, stj.keys.pk, ptypej, Prv, aij.public_attributes, x)
        assert MH.verify_pres(st.pp, st.keys.pk, ptype, Prv, ai.public_attributes, x) is want
        assert want is (x is p[0])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cred_pres_batch_matches_jax(config):
    """cred_pres_batch at B = 3 equals three JAX host cred_pres calls on an
    engine with the same seed."""
    st, ai, creds, group, ptype, _ = _issued("port", config, "mhac-batch")
    stj, aij, credsj, groupj, ptypej, _ = _issued("jax", config, "mhac-batch")
    Prv = CONFIGS[config][1]
    got = MH.cred_pres_batch(st.pp, [creds] * 3, [group] * 3, [ptype] * 3, Prv,
                             [ai.public_attributes] * 3, [ai.private_attributes_share] * 3,
                             S.create_random_engine("mhac-pres"), device="cpu")
    rj = SJ.create_random_engine("mhac-pres")
    want = [MHJ.cred_pres(stj.pp, credsj, groupj, ptypej, Prv, aij.public_attributes,
                          aij.private_attributes_share, rj) for _ in range(3)]
    assert [(x.fixed_part, x.z, x.z_hid_pub) for x in got] == [
        (bytes(x.fixed_part), [bytes(z) for z in x.z], [bytes(z) for z in x.z_hid_pub])
        for x in want]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_verify_pres_batch_matches_jax(config):
    """Every row of verify_pres_batch equals the JAX host verify_pres: two
    valid rows and, between them, one carrying another row's z."""
    st, ai, creds, group, ptype, _ = _issued("port", config, "mhac-verify")
    p = _presentations("port", config, "mhac-verify", 3)
    rows = [p[0], MH.Pres(p[1].fixed_part, list(p[2].z), list(p[1].z_hid_pub)), p[2]]
    stj, aij, _, _, ptypej, _ = _issued("jax", config, "mhac-verify")
    Prv = CONFIGS[config][1]
    want = [MHJ.verify_pres(stj.pp, stj.keys.pk, ptypej, Prv, aij.public_attributes, x)
            for x in rows]
    assert want == [True, False, True]
    got = MH.verify_pres_batch(st.pp, st.keys.pk, ptype, Prv, ai.public_attributes, rows,
                               device="cpu")
    assert got.dtype == bool and got.tolist() == want
