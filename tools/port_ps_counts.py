#!/usr/bin/env python3
"""Count, on the CPU, what one call of the port's PS `sign_batch` and
`verify_batch` issues, to predict a run on the card without one.

    python3 tools/port_ps_counts.py [B]      # B messages, default 4

For each call: the torch ops it dispatches and the non-view ones, and the
kernel launches it would make, each kernel's plain version counted as ONE
op and one launch (its own ops hidden), as its CUDA kernel is on the card;
the card's wrappers add a few views and empties per launch.  Also the
host seconds of sign's per-message hash and CSPRNG draw over 512
messages.  Launch and op counts do not depend on B.  Imports nothing of
the JAX package.
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


def main() -> None:
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    for name, kernel in (("fp2_mul", "fp2_mul_plain"), ("fp2_sqr", "fp2_sqr_plain"),
                         ("fp6_mul", "fp6_mul_plain"), ("g1_add", "g1_add_plain"),
                         ("g1_dbl", "g1_dbl_plain"), ("g1_madd", "g1_madd_plain")):
        setattr(FK, kernel, _as_launch(name, getattr(FK, kernel)))
    FP.FP_CTX.mont_mul_plain = _as_launch("fp_mont_mul", FP.FP_CTX.mont_mul_plain)
    FP.FP_CTX.pow_fixed_plain = _as_launch("fp_pow_fixed", FP.FP_CTX.pow_fixed_plain)

    rng = create_random_engine("bench-ps")
    keys = T.key_gen(rng)
    msgs = [b"bench-%06d" % i for i in range(b)]
    sigs = T.sign_batch(keys.sk, msgs, rng, device="cpu")
    for name, call in (("sign", lambda: T.sign_batch(keys.sk, msgs, rng, device="cpu")),
                       ("verify", lambda: T.verify_batch(keys.pk, msgs, sigs, device="cpu"))):
        OPS.clear()
        LAUNCHES.clear()
        with _Count():
            call()
        total = sum(OPS.values())
        views = sum(v for k, v in OPS.items() if k in VIEW_OPS)
        print(f"{name}: B={b} torch_ops={total} non_view_ops={total - views} "
              f"launches={dict(LAUNCHES)}", flush=True)

    draws = create_random_engine("bench-ps")
    t0 = time.perf_counter()
    for i in range(512):
        hash_(b"bench-%06d" % i).to(Zp)
        select_in(~G1, draws)
    print(f"sign host draws and hashes for 512 messages: {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
