"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch/`` at the root of the checkout.  A library's file name
carries a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads from the last build.  :func:`build_all` starts one
``nvcc`` per source at once; :func:`library` builds (or finds) one source
and loads it with ``ctypes``.  Nothing here runs at import time, and a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("window_filter", "knn_topk", "partition_assign")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists already;
    returns ``(target, process or None)``."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: pathlib.Path, job) -> str:
    """Wait for one ``nvcc``, move its library into place; returns its
    log (``-Xptxas -v`` register and spill lines)."""
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every source in parallel; returns ``{name: {"path", "seconds",
    "log"}}`` (``seconds`` is the wall time of the whole parallel build)."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    logs = {name: _finish(name, *jobs[name]) for name in SOURCES}
    dt = time.perf_counter() - t0
    return {name: {"path": str(jobs[name][0]), "seconds": dt, "log": logs[name]}
            for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = ctypes.CDLL(str(out))
            _LIBS[name] = lib
        return lib


def bind(lib: ctypes.CDLL, symbol: str, n_ptrs: int, n_ints: int):
    """Declare a launch function ``int f(void* x n_ptrs, int x n_ints,
    void* stream)`` and return it.  Pointers and the stream are
    ``c_void_p`` so ctypes does not cut them to 32 bits."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
