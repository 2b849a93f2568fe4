"""Build native sources at first use and load them with ctypes.

The CUDA kernels (``ops/csrc/*.cu``) are compiled by ``nvcc`` into one
shared library with a plain C interface, and the native ingest tier
(``fleetrec_tpu/native/*.cpp``, read by path) by ``g++``.  Each library
lands in ``fleetrec_tpu_torch/_build/`` (ignored by git) under a name keyed
by a hash of its sources and its command line, so an edited source builds
anew and an unchanged one is loaded as it is.  The compiler's output is
kept beside the library as ``<name>.log`` (``-Xptxas -v`` puts each
kernel's registers, shared memory and spills there).

A failed build raises ``BuildError``; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """A native source did not compile, or its compiler is missing."""


def build_shared(name: str, sources: Sequence[str], cmd: Sequence[str]) -> str:
    """Compile ``sources`` with ``cmd`` (compiler and flags, without ``-o``
    and the sources) into ``BUILD_DIR/<name>-<hash>.so``; return its path.

    Concurrent builders (test workers) each write a private temporary file
    and rename it into place, so a reader never sees a partial library."""
    h = hashlib.sha256("\0".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp, *sources], capture_output=True,
                          text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join([*cmd, "-o", tmp, *sources]) + "\n")
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise BuildError(f"building {name} failed (exit {proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then the
    toolkit's default install."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.cache
def kernels() -> ctypes.CDLL:
    """The port's CUDA kernels, built for sm_90a at first use.  Callers
    (ops/gather.py, ops/mlp_fused.py) declare their entry points'
    argtypes."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    return ctypes.CDLL(build_shared("fleetrec_kernels", sources,
                                    [nvcc(), *NVCC_FLAGS]))


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        fn = kernels().fr_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
