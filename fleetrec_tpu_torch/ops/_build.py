"""Build native sources at first use and load them with ctypes.

Every library is built the same way: each source compiles to an object
in its own compiler process, all started together, and one link joins
them.  The CUDA kernels (``ops/csrc/*.cu``) are compiled by ``nvcc`` into
one shared library with a plain C interface; the native ingest tier
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """A native source did not compile, or its compiler is missing."""


def build_shared(name: str, sources: Sequence[str], cmd: Sequence[str],
                 link: Sequence[str]) -> str:
    """Build ``sources`` into ``BUILD_DIR/<name>-<hash>.so``; return its path.

    Each source compiles to an object with ``cmd -c`` (``cmd`` is the
    compiler and its flags), all in parallel; ``link`` (the linker and its
    flags, without ``-o`` and the objects) joins the objects.

    Concurrent builds (test workers) each write private temporary files
    and rename the library into place, so a reader never sees a partial
    library."""
    h = hashlib.sha256("\0".join([*cmd, "|", *link]).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    steps = [[[*cmd, "-c", "-o", o, s] for o, s in zip(objs, sources)],
             [[*link, "-o", tmp, *objs]]]
    try:
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as log:
            for step in steps:
                procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
                         for c in step]
                texts = [p.communicate()[0] for p in procs]
                for c, text in zip(step, texts):
                    log.write(" ".join(c) + "\n" + text)
                for c, p, text in zip(step, procs, texts):
                    if p.returncode != 0:
                        raise BuildError(f"building {name} failed (exit "
                                         f"{p.returncode}):\n{' '.join(c)}\n"
                                         f"{text[-4000:]}")
        os.replace(tmp, out)
    finally:
        for f in glob.glob(f"{glob.escape(tmp)}*"):
            os.remove(f)
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


def kernel_sources() -> list:
    """The CUDA sources of the port's kernels."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


@functools.cache
def kernels() -> ctypes.CDLL:
    """The port's CUDA kernels, built for sm_90a at first use.  Callers
    (ops/gather.py, ops/mlp_fused.py) declare their entry points'
    argtypes."""
    cc = nvcc()
    return ctypes.CDLL(build_shared("fleetrec_kernels", kernel_sources(),
                                    [cc, *NVCC_FLAGS], [cc, "-shared"]))


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        fn = kernels().fr_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
