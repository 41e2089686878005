"""Build a CUDA source of ``csrc/`` with nvcc and bind it with ctypes.

Each source has a plain C interface: device pointers, ints, and the CUDA
stream as ``void*``; every entry point returns ``cudaGetLastError()`` after
its launch.  The shared library is compiled at first use into the package's
``_build/`` directory (not tracked by git), under a name that carries a hash
of the source and flags, so an edited source is never served stale.  Nothing
here runs at import time: a host without nvcc imports the package, and only
a launch on a CUDA tensor needs the compiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "load_library",
           "check_launch", "ptr", "stream_of", "count_launch", "launch_tally"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# writes each kernel's registers, shared memory and spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# A mesh's shards launch from threads of their own (``parallel/mesh.py``):
# one lock per library makes their first calls run nvcc once, while the
# different sources still build at the same time; one lock keeps the launch
# counts whole.
_LOCKS_LOCK = threading.Lock()
_BUILD_LOCKS: dict[str, threading.Lock] = {}
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels are built from csrc/ at first launch on a CUDA tensor")
    return path


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed, load it, and declare the
    ``argtypes`` of each entry point in ``signatures`` (``restype`` int).

    Returns the library; ``lib.build_seconds`` is the compile time in this
    process (0.0 when an earlier build was reused).
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(part.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    with _LOCKS_LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.nvcc.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        entry = getattr(lib, fn)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    lib.build_seconds = seconds
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer for a ``c_void_p`` argument (``None``: NULL),
    as a plain int: ctypes converts it faster than a ``c_void_p`` object."""
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` counts it,
    and so does this thread's :func:`launch_tally` when one is open."""
    with _COUNT_LOCK:
        wrapper.launches += 1
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[wrapper.__name__] = tally.get(wrapper.__name__, 0) + 1


@contextlib.contextmanager
def launch_tally():
    """Count this thread's kernel launches, by wrapper name, while open;
    yields the dict of counts."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = outer
