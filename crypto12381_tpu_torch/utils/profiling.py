"""Timing and profiling helpers: a microsecond timer, a torch.profiler
trace, and the bound and roofline share of a kernel against the card's
peaks.

Counterpart of the JAX package's `utils/profiling.py`.  The reference's
only instrumentation is a microsecond timer in two example tests; `timed`
prints the same line.  `device_trace` traces the host and the CUDA card
with torch.profiler, and `bound` and `roofline` hold a measured time
against the two limits of one H100 SXM5 at its full 700 W: HBM3 at
3.35e12 bytes/s, and 132 SMs x 64 INT32 lanes x 1.98 GHz boost =
1.673e13 32-bit integer multiply-adds/s (NVIDIA H100 data sheet and
Hopper architecture white paper).  A card set below 700 W runs below
them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

#: HBM3 bytes/s of one H100 SXM5
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer multiply-adds/s of one H100 SXM5
INT32_MULADDS_PER_S = 132 * 64 * 1.98e9


class timed:
    """Context manager and decorator printing the wall-clock microseconds,
    as the reference's timer does ("<label>: finish in N μs").

        with timed("keygen"):
            keys = key_gen(rng)

        @timed("verify")
        def run(): ...

    The line goes to standard error.  As a decorator it synchronizes the
    CUDA stream before the clock stops whenever CUDA is initialized, so
    that the time covers the card's work and not only its launch."""

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed_us: float | None = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_us = (time.perf_counter() - self.t0) * 1e6
        prefix = f"{self.label}: " if self.label else ""
        print(f"{prefix}finish in {self.elapsed_us:.0f} μs", file=sys.stderr, flush=True)
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with timed(self.label or fn.__name__):
                out = fn(*a, **kw)
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                return out

        return wrapped


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """torch.profiler over the host and, where there is one, the CUDA card;
    yields the profile.  With a logdir, the Chrome trace of the window is
    written to <logdir>/trace.json at its end (chrome://tracing or
    Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def bound(bytes_moved: float, muladds: float) -> tuple[float, str]:
    """The least seconds the card could take for some work: the larger of
    its bytes over the HBM rate and its 32-bit multiply-adds over the
    integer rate, and which of the two ("bytes" or "operations") it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = muladds / INT32_MULADDS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def roofline(name: str, elems: int, seconds: float, muladds_per_elem: float,
             bytes_per_elem: float = 0.0) -> dict:
    """A kernel's roofline record: the measured rate, the multiply-add and
    byte rates it implies, each as a share of its peak, the bound of the
    same work and the share of it the measured time reaches."""
    rate = elems / seconds
    muladds = rate * muladds_per_elem
    hbm = rate * bytes_per_elem
    least, by = bound(elems * bytes_per_elem, elems * muladds_per_elem)
    return {
        "kernel": name,
        "rate_per_s": rate,
        "int32_muladds_per_s": muladds,
        "hbm_bytes_per_s": hbm,
        "int32_frac_of_peak": muladds / INT32_MULADDS_PER_S,
        "hbm_frac_of_peak": hbm / HBM_BYTES_PER_S,
        "bound_s": least,
        "bound_by": by,
        "frac_of_bound": least / seconds,
    }
