#!/usr/bin/env python3
"""Count, on the CPU, what one call of each of the port's scheme paths
issues, to predict a run on the card without one.

    python3 tools/port_counts.py [B]      # B messages, default 4

The paths and their shapes are chip_smoke.py's, at B messages: PS
`sign_batch`/`verify_batch` (messages b"bench-%06d"), BBS and BBS+
`sign_batch`/`verify_batch` (`setup(16)`, 112-byte messages of 4 Zp
blocks, the last one a single block), and Shamir `share_batch` (t = 1,000
at n = 16 points: the counts do not depend on n) and `reconstruct_batch`
(t = 1,000).  For each call: the torch ops it dispatches and the non-view
ones, and the kernel launches it would make, each kernel's plain version
counted as ONE op and one launch (its own ops hidden), as its CUDA kernel
is on the card; the card's wrappers add a few views and empties per
launch.  Launch and op counts do not depend on B.  Also the host seconds
of PS signing's per-message hash and CSPRNG draw over 512 messages.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import functools
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes  # noqa: E402

import crypto12381_tpu_torch as T  # noqa: E402
from crypto12381_tpu_torch.api.sets import G1, Zp, create_random_engine, hash_, select_in  # noqa: E402
from crypto12381_tpu_torch.fields import fp as FP  # noqa: E402
from crypto12381_tpu_torch.fields import fused as FK  # noqa: E402

#: aten ops that only make a view (as chip_smoke.py counts them)
VIEW_OPS = {"select", "slice", "unsqueeze", "view", "expand", "unbind", "alias", "as_strided",
            "_unsafe_view", "t", "transpose", "permute", "squeeze", "detach", "_reshape_alias",
            "split", "chunk"}
LAUNCHES: collections.Counter = collections.Counter()
OPS: collections.Counter = collections.Counter()
_depth = [0]
SSS_T, SSS_N = 1000, 16


def _as_launch(name, fn):
    """fn counted as one launch of `name`, its own ops hidden from OPS."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        if _depth[0] == 0:
            LAUNCHES[name] += 1
            OPS[name] += 1
        _depth[0] += 1
        try:
            with _disable_current_modes():
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


def main() -> None:
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    for name, kernel in (("fp2_mul", "fp2_mul_plain"), ("fp2_sqr", "fp2_sqr_plain"),
                         ("fp6_mul", "fp6_mul_plain"), ("g1_add", "g1_add_plain"),
                         ("g1_dbl", "g1_dbl_plain"), ("g1_madd", "g1_madd_plain")):
        setattr(FK, kernel, _as_launch(name, getattr(FK, kernel)))
    for F in (FP.FP_CTX, FP.FR_CTX):
        F.mont_mul_plain = _as_launch(f"{F.name}_mont_mul", F.mont_mul_plain)
        F.pow_fixed_plain = _as_launch(f"{F.name}_pow_fixed", F.pow_fixed_plain)

    for name, call in _calls(b):
        OPS.clear()
        LAUNCHES.clear()
        with _Count():
            call()
        total = sum(OPS.values())
        views = sum(v for k, v in OPS.items() if k in VIEW_OPS)
        print(f"{name}: B={b} torch_ops={total} non_view_ops={total - views} "
              f"launches={dict(sorted(LAUNCHES.items()))}", flush=True)

    draws = create_random_engine("bench-ps")
    t0 = time.perf_counter()
    for i in range(512):
        hash_(b"bench-%06d" % i).to(Zp)
        select_in(~G1, draws)
    print(f"ps sign host draws and hashes for 512 messages: {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
