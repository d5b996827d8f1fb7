"""Builds the port's CUDA kernels from ``csrc/`` and binds them.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), the objects are linked into one
shared library with a plain C interface, and the library is loaded with
``ctypes``.  The build happens on first use, never at import, into the
git-ignored ``_build/`` directory beside this file; the library's name
carries a digest of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :class:`Kernel` raises
when that is not 0 and otherwise adds one to its launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas=-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()   # Kernel.launches, bumped from any thread
_lib: Optional[ctypes.CDLL] = None
_REGISTRY: Dict[str, "Kernel"] = {}
# what the last build printed (ptxas register / spill lines)
build_log = ""
builds = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc")) if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $PATH and "
        "/usr/local/cuda): the port's kernels are built from "
        f"{CSRC} on first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libray_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernel library unless it is already built
    (``builds`` counts the builds this process ran).

    Raises with the compiler's output when a source does not build."""
    global build_log, builds
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, _obj, p in procs:
            out = p.communicate()[0].decode(errors="replace")
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        out_tmp = tmp / lib.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(out_tmp),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("linking the kernel library failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(out_tmp, lib)
        builds += 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    ``launches`` grows by one for every launch the entry point
    accepted; a run reads it to show that its path went through the
    kernel."""

    def __init__(self, symbol: str, *argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        _REGISTRY[symbol] = self

    def __call__(self, *args) -> None:
        fn = self._fn
        if fn is None:
            # a fresh function object (indexing, unlike getattr, does
            # not share the library's cached one), typed in full before
            # it is published: a thread that finds _fn set never calls
            # an untyped one, and two threads binding at once do no harm
            fn = load()[self.symbol]
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = fn(*args)
        if rc != 0:
            msg = load().rtt_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        # worker threads launch too (the fleet's concurrent_steps mode):
        # += is not atomic, so count under the lock
        with _count_lock:
            self.launches += 1


def query(symbol: str, *ints: int) -> int:
    """A size the library computes for a shape (a workspace's bytes):
    no launch, so no count."""
    fn = getattr(load(), symbol)
    fn.argtypes = [ctypes.c_int] * len(ints)
    fn.restype = ctypes.c_longlong
    return int(fn(*ints))


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return {name: k.launches for name, k in _REGISTRY.items()}


def reset_launches() -> None:
    with _count_lock:
        for k in _REGISTRY.values():
            k.launches = 0


# argument type shorthands for the wrappers
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
