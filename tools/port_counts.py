#!/usr/bin/env python3
"""Count, on the CPU, what one call of each of the port's paths issues,
to predict a run on the card without one.

    python3 tools/port_counts.py [B] [PATH,...]   # B rows or messages, default 4;
                                                  # only the named paths

The paths and their shapes are chip_smoke.py's, at B messages or rows: PS
`sign_batch`/`verify_batch` (messages b"bench-%06d"), BBS and BBS+
`sign_batch`/`verify_batch` (`setup(16)`, 112-byte messages of 4 Zp
blocks, the last one a single block), Shamir `share_batch` (t = 1,000 at
n = 16 points: the counts do not depend on n) and `reconstruct_batch`
(t = 1,000), the G2 GS ladder `G2Vec ** ZpVec`, `GTVec ** ZpVec`,
`pair_vec` and the two-pair `pair_prod`; the SHA3-512 sponge with
`hash_to_zp` (`keccak`: rows of 0 to 1,100 bytes), BBS04 `verify_batch`
and `open_batch` (`key_gen(16)`, messages of 0 to 300 bytes), AC-BBS and
AC-RBBS `verify_batch` (n = 32, I = {0, 3}), AC-RPS `verify_batch`
(n = 64, I = {0, 1, 3}) and multi-message PS `verify_n_batch` (messages
of 1 to 4 units), their host signatures and presentations tiled to B
rows; MHAC-BBS `cred_pres_batch` and `verify_pres_batch` (`mhac_pres`,
`mhac_verify`: the reference test's parameters, one credential's
presentations) and `hash_to_g1` (`hash_g1`: B digests).  For each call:
the torch ops it
dispatches and the non-view ones, and the kernel launches it would make,
each kernel's plain version counted as ONE op and one launch (its own ops
hidden), as its CUDA kernel is on the card; the card's wrappers add a few
views and empties per launch.  Launch and op counts do not depend on B.
Also the host seconds of PS signing's per-message hash and CSPRNG draw
over 512 messages.

Then the rounds MSM (`G1Vec.msm` at n = 2^20) at its full size, on
chip_smoke.py's scalars: the affine call, the projective call and the
call at 2^17 with 1,024 equal scalars.  There every kernel is a stand-in
that returns zeros of its output's shape (the schedule depends on the
scalars alone), so the counts are exact and the results are not; the
launches are given by row count too, and with them the rounds R and the
compaction sizes.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import functools
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes  # noqa: E402

import chip_smoke as CS  # noqa: E402

import crypto12381_tpu_torch as T  # noqa: E402
from crypto12381_tpu_torch.api.sets import G1, Zp, create_random_engine, hash_, select_in  # noqa: E402
from crypto12381_tpu_torch.fields import fp as FP  # noqa: E402
from crypto12381_tpu_torch.fields import fused as FK  # noqa: E402

#: aten ops that only make a view (as chip_smoke.py counts them)
VIEW_OPS = {"select", "slice", "unsqueeze", "view", "expand", "unbind", "alias", "as_strided",
            "_unsafe_view", "t", "transpose", "permute", "squeeze", "detach", "_reshape_alias",
            "split", "chunk"}
LAUNCHES: collections.Counter = collections.Counter()
ROWS: dict = collections.defaultdict(collections.Counter)
OPS: collections.Counter = collections.Counter()
_depth = [0]
#: while set, every kernel is a stand-in returning zeros of its output's shape
STAND_IN = [False]
SSS_T, SSS_N = 1000, 16
#: the paths of _scheme_calls, counted also by row count
SLICE_PATHS = ("keccak", "bbs04_verify", "bbs04_open", "ac_bbs_verify", "ac_rbbs_verify",
               "ac_rps_verify", "ps_n_verify", "mhac_pres", "mhac_verify", "hash_g1")
#: int32 words of one row of each kernel's first operand
ROW_WORDS = {"fp_mont_mul": 12, "fr_mont_mul": 8, "fp_pow_fixed": 12, "fr_pow_fixed": 8,
             "fp2_mul": 24, "fp2_sqr": 24, "fp6_mul": 72, "g1_add": 36, "g1_dbl": 36,
             "g1_madd": 36, "fp12_mul": 144, "fp12_sqr": 144, "fp12_usqr": 144,
             "fp12_cyc_pow_fixed": 144, "fp12_sparse_mul": 144, "g2_add": 72, "g2_madd": 72,
             "g2_dbl": 72}


def _as_launch(name, fn):
    """fn counted as one launch of `name` (and by row count), its own ops
    hidden from OPS."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        if _depth[0] == 0:
            LAUNCHES[name] += 1
            OPS[name] += 1
            ts = [t for t in a if isinstance(t, torch.Tensor)]
            if name.startswith("g1_"):            # (..., 3, 12) out of any operand rows
                shape = torch.broadcast_shapes(*[t.shape[:-2] for t in ts]) + (3, 12)
            elif name.startswith("g2_"):          # (..., 3, 2, 12) likewise
                shape = torch.broadcast_shapes(*[t.shape[:-3] for t in ts]) + (3, 2, 12)
            elif name.startswith("fp12_"):        # the Fp12 operand's shape (its wrapper
                shape = ts[0].shape               # broadcasts; a sparse line is narrower)
            else:
                shape = torch.broadcast_shapes(*[t.shape for t in ts])
            rows = math.prod(shape) // ROW_WORDS[name]
            ROWS[name][rows] += 1
        _depth[0] += 1
        try:
            with _disable_current_modes():
                if STAND_IN[0]:
                    return torch.zeros(shape, dtype=torch.int32)
                return fn(*a, **k)
        finally:
            _depth[0] -= 1
    return wrapper


class _Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, a=(), kw=None):
        OPS[func.__name__.split(".")[0]] += 1
        return func(*a, **(kw or {}))


def _calls(b: int):
    """(name, call) for each path, after the set-up calls they need."""
    call = functools.partial
    rng = create_random_engine("bench-ps")
    keys = T.key_gen(rng)
    msgs = [b"bench-%06d" % i for i in range(b)]
    sigs = T.sign_batch(keys.sk, msgs, rng, device="cpu")
    yield "ps_sign", call(T.sign_batch, keys.sk, msgs, rng, device="cpu")
    yield "ps_verify", call(T.verify_batch, keys.pk, msgs, sigs, device="cpu")
    for mod, seed in ((T.bbs, b"bench-bbs"), (T.bbs_plus, b"bench-bbs-plus")):
        r = create_random_engine(seed)
        pp = mod.setup(16, r)
        k = mod.key_gen(pp, r)
        raw = [((seed + b"-%06d" % i) * 7)[:112] for i in range(b - 1)] + [seed + b"-short"]
        ms = [T.bbs.encode_message(m) for m in raw] if mod is T.bbs else raw
        s = mod.sign_batch(pp, k.sk, ms, r, device="cpu")
        name = mod.__name__.rsplit(".", 1)[1]
        yield f"{name}_sign", call(mod.sign_batch, pp, k.sk, ms, r, device="cpu")
        yield f"{name}_verify", call(mod.verify_batch, pp, k.pk, ms, s, device="cpu")
    r = create_random_engine("bench-sss")
    secret = select_in(Zp, r).serialize()
    shares = T.sss.share(SSS_T, SSS_T, secret, r)
    yield "sss_share", call(T.sss.share_batch, SSS_T, SSS_N, secret, r, device="cpu")
    yield "sss_reconstruct", call(T.sss.reconstruct_batch, range(1, SSS_T + 1), shares,
                                  device="cpu")
    e = T.ZpVec.from_ints(range(3, b + 3), device="cpu")
    g1, g2 = T.G1Vec.generator((b,), device="cpu"), T.G2Vec.generator((b,), device="cpu")
    yield "g2_pow", call(g2.__pow__, e)
    yield "gt_pow", call(T.GTVec.one((b,), device="cpu").__pow__, e)
    yield "pair_vec", call(T.pair_vec, g1, g2)
    yield "pair_prod", call(T.pair_prod, (g1, g2), (g1, g2))
    yield from _scheme_calls(b)


def _scheme_calls(b: int):
    """(name, call) for the paths of this slice at chip_smoke.py's
    parameters, with two distinct host signatures or presentations tiled
    to b rows (the counts do not depend on the rows' values)."""
    from crypto12381_tpu_torch.api.batch import hash_to_zp
    from crypto12381_tpu_torch.hashing import keccak as KC

    call = functools.partial
    lens = [(CS.KECCAK_MAX * i) // max(1, b - 1) for i in range(b)]
    data = torch.zeros(b, CS.KECCAK_MAX, dtype=torch.uint8).numpy()
    yield "keccak", lambda: hash_to_zp(KC.sha3_512_batch(data, lens, device="cpu"))
    r = create_random_engine("bench-bbs04")
    keys = T.bbs04.key_gen(CS.BBS04_MEMBERS, r)
    msgs = [bytes(2), bytes(CS.BBS04_MAX_MSG)]
    sigs = [T.bbs04.sign(keys.gpk, keys.gsk[i], msgs[i], r) for i in range(2)]
    msgs, sigs = [msgs[i % 2] for i in range(b)], [sigs[i % 2] for i in range(b)]
    yield "bbs04_verify", call(T.bbs04.verify_batch, keys.gpk, msgs, sigs, device="cpu")
    yield "bbs04_open", call(T.bbs04.open_batch, keys.gmsk, sigs, device="cpu")
    for mod, n, I in ((T.ac_bbs, CS.AC_N, [0, 3]), (T.ac_rbbs, CS.AC_N, [0, 3]),
                      (T.ac_rps, CS.RPS_N, [0, 1, 3])):
        r = create_random_engine("seed")
        k = mod.keygen(n, r)
        attr = mod.generate_attributes(k.pk, n, r)
        sig = mod.issue(k, attr, r)
        if mod is T.ac_bbs:
            pres = [mod.pres(b"\x00", attr, sig, I, k.pk, r) for _ in range(2)]
        elif mod is T.ac_rbbs:
            rc = mod.redact(attr, sig, I, k.pk)
            pres = [mod.pres(b"\x00", sig, rc, r) for _ in range(2)]
        else:
            rc = mod.redact(attr, sig, I, k.pk)
            pres = [mod.pres(b"\x00", attr, sig, I, rc, k.pk, r) for _ in range(2)]
        name = mod.__name__.rsplit(".", 1)[1]
        yield f"{name}_verify", call(mod.verify_batch, b"\x00", attr, I,
                                     [pres[i % 2] for i in range(b)], k.pk, device="cpu")
    r = create_random_engine("bench-ps-n")
    kn = T.ps.key_gen_n(CS.PS_N_UNITS, r)
    ms = [bytes(1 + (31 * CS.PS_N_UNITS - 1) * (i % 2)) for i in range(b)]
    ss = [T.ps.sign_n(kn, m, r) for m in ms]
    yield "ps_n_verify", call(T.ps.verify_n_batch, kn, ms, ss, device="cpu")
    yield from _mhac_hash_calls(b)


def _mhac_hash_calls(b: int):
    """(name, call) for MHAC-BBS presentation and verification at
    chip_smoke.py's parameters, and the hash to G1 of b digests."""
    import hashlib

    from crypto12381_tpu_torch.api.batch import hash_to_g1

    mh, call = T.mhac_bbs, functools.partial
    r = create_random_engine("seed")
    st = mh.iss_setup(CS.MHAC_M, r)
    Pub = [i for i in range(CS.MHAC_M) if i not in CS.MHAC_PRV]
    ai = mh.generate_attributes(st.pp, CS.MHAC_T, CS.MHAC_N, CS.MHAC_PRV, r)
    creds = mh.cred_iss(st.pp, st.keys.sk, CS.MHAC_T, ai.commitments, Pub, ai.public_attributes,
                        r)
    grp = mh.make_pres_group(creds, CS.MHAC_S)
    ptype = mh.make_pres_type(st.pp, CS.MHAC_REV, CS.MHAC_PRV, ai.public_attributes)
    args = (st.pp, [creds] * b, [grp] * b, [ptype] * b, CS.MHAC_PRV, [ai.public_attributes] * b,
            [ai.private_attributes_share] * b)
    pres = mh.cred_pres_batch(*args, r, device="cpu")
    yield "mhac_pres", call(mh.cred_pres_batch, *args, r, device="cpu")
    yield "mhac_verify", call(mh.verify_pres_batch, st.pp, st.keys.pk, ptype, CS.MHAC_PRV,
                              ai.public_attributes, pres, device="cpu")
    d = torch.tensor([list(hashlib.sha3_512(bytes([i])).digest()) for i in range(b)],
                     dtype=torch.uint8)
    yield "hash_g1", call(hash_to_g1, d)


def _rounds_calls():
    """(name, call) for the rounds MSM paths of chip_smoke.py, at full size
    on its scalars; the points are the generator (the schedule does not
    depend on them)."""
    n, nf = CS.MSMR_N, CS.MSMR_FALLBACK_N
    limbs, ident, _ = CS.msm_rounds_scalars(n)
    gen = T.G1Vec.generator((n,), device="cpu")
    X, Y, Z = (c.clone() for c in gen.p)
    X[ident], Z[ident] = 0, 0
    e = T.ZpVec(torch.from_numpy(limbs))
    eq = limbs[:nf].copy()
    eq[:CS.MSMR_EQUAL] = limbs[1]
    yield "msm_rounds", functools.partial(T.G1Vec((X, Y, Z), z_is_one=True).msm, e)
    yield "msm_rounds_proj", functools.partial(T.G1Vec((X, Y, Z)).msm, e)
    yield "msm_rounds_fallback", functools.partial(
        T.G1Vec((X[:nf], Y[:nf], Z[:nf]), z_is_one=True).msm, T.ZpVec(torch.from_numpy(eq)))


def _count(name, call, b, rows=False):
    OPS.clear()
    LAUNCHES.clear()
    ROWS.clear()
    with _Count():
        call()
    total = sum(OPS.values())
    views = sum(v for k, v in OPS.items() if k in VIEW_OPS)
    by_rows = {k: dict(sorted(v.items())) for k, v in sorted(ROWS.items())}
    print(f"{name}: B={b} torch_ops={total} non_view_ops={total - views} "
          f"launches={dict(sorted(LAUNCHES.items()))}"
          + (f" launch_rows={by_rows}" if rows else ""), flush=True)
    return by_rows


def main() -> None:
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    only = set(sys.argv[2].split(",")) if len(sys.argv) > 2 else None
    for name in ("fp2_mul", "fp2_sqr", "fp6_mul", "g1_add", "g1_dbl", "g1_madd", "fp12_mul",
                 "fp12_sqr", "fp12_usqr", "fp12_cyc_pow_fixed", "fp12_sparse_mul", "g2_add",
                 "g2_madd", "g2_dbl"):
        setattr(FK, name + "_plain", _as_launch(name, getattr(FK, name + "_plain")))
    for F in (FP.FP_CTX, FP.FR_CTX):
        F.mont_mul_plain = _as_launch(f"{F.name}_mont_mul", F.mont_mul_plain)
        F.pow_fixed_plain = _as_launch(f"{F.name}_pow_fixed", F.pow_fixed_plain)

    for name, call in _calls(b):
        if only is None or name in only:
            _count(name, call, b, rows=name in ("g2_pow", "gt_pow", "pair_vec", "pair_prod")
                   or name in SLICE_PATHS)
    if only is not None:
        return

    draws = create_random_engine("bench-ps")
    t0 = time.perf_counter()
    for i in range(512):
        hash_(b"bench-%06d" % i).to(Zp)
        select_in(~G1, draws)
    print(f"ps sign host draws and hashes for 512 messages: {time.perf_counter() - t0:.3f} s")

    STAND_IN[0] = True
    for name, call in _rounds_calls():
        rows = _count(name, call, CS.MSMR_N if name != "msm_rounds_fallback" else
                      CS.MSMR_FALLBACK_N, rows=True)
        k5 = rows.get("g1_madd", {})
        print(f"{name}: rounds={sum(k5.values())} k5_rows_descending="
              f"{dict(sorted(k5.items(), reverse=True))}", flush=True)
    STAND_IN[0] = False


if __name__ == "__main__":
    main()
