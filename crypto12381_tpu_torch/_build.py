"""Build, load and launch the port's CUDA kernels.

Each source in csrc/ is compiled at first use by `nvcc` into its own shared
library with a plain C interface, in a directory under the checkout's
`build/` named by a hash of the sources and flags, and loaded with ctypes.
All sources compile in parallel, one `nvcc` each.  Nothing here runs when
the module is imported.

Every C entry point takes its tensors' device pointers (a power chain then
also a public exponent: a host pointer to its words and its bit length; a
kernel over stacked operands their count k), the row count and a CUDA
stream, launches on that stream, and returns `cudaGetLastError()`;
`launch` raises if that is not 0 and otherwise adds one to the kernel's
launch count in `LAUNCHES`, to its count at that row count in
`LAUNCH_ROWS`, for a power chain to its count at that row count and
exponent in `LAUNCH_EXPONENTS`, and for a stacked kernel to its count at
that row count and k in `LAUNCH_STACKS`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "crypto12381_tpu_torch"

#: library name -> (source file, {C function: number of tensor pointers})
_LIBS_SPEC = {
    "fp": ("fp.cu", {"fp_mont_mul": 3, "fr_mont_mul": 3, "fp_pow_fixed": 2, "fr_pow_fixed": 2}),
    "tower": ("tower.cu", {"fp2_mul": 3, "fp2_sqr": 2, "fp6_mul": 3}),
    "curve": ("g1.cu", {"g1_madd": 3, "g1_add": 3, "g1_dbl": 2}),
    "fp12": ("fp12.cu", {"fp12_mul": 3, "fp12_sqr": 2, "fp12_usqr": 2, "fp12_sparse_mul": 3,
                         "fp12_cyc_pow_fixed": 2}),
    "curve2": ("g2.cu", {"g2_madd": 3, "g2_add": 3, "g2_dbl": 2}),
}
_HEADERS = ("fp381.cuh", "tower.cuh", "curve.cuh")
#: C functions that take a public exponent after their tensors
EXPONENT_FNS = frozenset({"fp_pow_fixed", "fr_pow_fixed", "fp12_cyc_pow_fixed"})
#: C functions that take the count k of an operand stacked k deep (K11's
#: lines) after their tensors
STACK_FNS = frozenset({"fp12_sparse_mul"})
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per C function, counted by `launch`
LAUNCHES = {fn: 0 for _, fns in _LIBS_SPEC.values() for fn in fns}
#: launches per C function and row count, counted by `launch`
LAUNCH_ROWS = {fn: collections.Counter() for fn in LAUNCHES}
#: launches per power-chain function and (row count, exponent), counted by `launch`
LAUNCH_EXPONENTS = {fn: collections.Counter() for fn in EXPONENT_FNS}
#: launches per stacked kernel and (row count, k), counted by `launch`
LAUNCH_STACKS = {fn: collections.Counter() for fn in STACK_FNS}

_loaded: dict[str, ctypes.CDLL] = {}
#: library name -> nvcc's output (ptxas register and spill report)
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_ROWS[k].clear()
    for c in (*LAUNCH_EXPONENTS.values(), *LAUNCH_STACKS.values()):
        c.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted({s for s, _ in _LIBS_SPEC.values()} | set(_HEADERS)):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, pathlib.Path]:
    """Compile every library that is not built yet, all in parallel, and
    return name -> path.  Raises with nvcc's output if any compile fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in _LIBS_SPEC}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        src = _CSRC / _LIBS_SPEC[name][0]
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            tmp.replace(paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, n_ptr in _LIBS_SPEC[name][1].items():
            f = getattr(lib, fn)
            exp = [ctypes.c_void_p, ctypes.c_int] if fn in EXPONENT_FNS else []
            stack = [ctypes.c_int] if fn in STACK_FNS else []
            f.argtypes = ([ctypes.c_void_p] * n_ptr + exp + stack
                          + [ctypes.c_int64, ctypes.c_void_p])
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def _exponent_args(fn: str, exponent) -> list:
    """The exponent arguments of `fn`: [] for a kernel that takes none, else
    a host array of e's (bits + 31) // 32 words and e's bit length.  The C
    entry point alone holds the largest length it takes and refuses a
    longer e (csrc/fp381.cuh `exponent_of`)."""
    if (exponent is not None) != (fn in EXPONENT_FNS):
        raise ValueError(f"{fn}: an exponent is {'' if fn in EXPONENT_FNS else 'not '}expected")
    if exponent is None:
        return []
    e = int(exponent)
    if e < 1:
        raise ValueError(f"{fn}: the exponent must be at least 1")
    n_words = (e.bit_length() + 31) // 32
    words = (ctypes.c_uint32 * n_words)(*[(e >> (32 * k)) & 0xFFFFFFFF for k in range(n_words)])
    return [ctypes.cast(words, ctypes.c_void_p), e.bit_length()]


def launch(lib_name: str, fn: str, tensors, n: int, exponent: int | None = None,
           stack: int | None = None) -> None:
    """Launch `fn` over n rows on the current stream of the tensors' card.
    tensors: contiguous, 16-byte aligned int32 CUDA tensors on one device
    (inputs, then the output), n rows each; rows may differ in width between
    tensors (a mixed add reads a projective and an affine point).
    exponent: the public exponent of a power chain (EXPONENT_FNS), shared
    by every row; the kernel gets it by value at the launch.
    stack: the count k >= 1 of a stacked operand (STACK_FNS), whose tensor
    holds k n rows."""
    dev = tensors[0].device
    for t in tensors:
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.int32
                or not t.is_contiguous() or t.numel() % max(n, 1) or t.data_ptr() % 16):
            raise ValueError(f"{fn}: needs contiguous, 16-byte aligned int32 tensors of "
                             f"{n} rows on one CUDA device")
    exp = _exponent_args(fn, exponent)
    if (stack is not None) != (fn in STACK_FNS) or (stack is not None and stack < 1):
        raise ValueError(f"{fn}: a stack count >= 1 is {'' if fn in STACK_FNS else 'not '}"
                         f"expected")
    f = getattr(library(lib_name), fn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = f(*[t.data_ptr() for t in tensors], *exp, *([stack] if stack else []), n, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[fn] += 1
    LAUNCH_ROWS[fn][n] += 1
    if exponent is not None:
        LAUNCH_EXPONENTS[fn][(n, int(exponent))] += 1
    if stack is not None:
        LAUNCH_STACKS[fn][(n, stack)] += 1
