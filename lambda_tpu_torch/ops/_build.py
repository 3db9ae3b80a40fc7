"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library under
``build/lambda_tpu_torch/`` at the repository root, keyed by a hash of the
source and the shared headers, and loaded with ``ctypes``.  Nothing is
built at import time: the first launch builds.  Separate sources build
in parallel (``load`` from several threads).  Every launch runs under
:func:`launch_stream`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "lambda_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_lock = threading.Lock()          # guards _name_locks
_name_locks: dict = {}            # one build at a time per source
# compiler output of each build (ptxas register / spill report), by name
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "first use and need the CUDA toolkit")


def build_key(name: str) -> str:
    """The build's key: a hash of ``csrc/<name>.cu``, the shared headers
    (``csrc/*.cuh``) and the compiler flags."""
    text = (_CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = _CSRC / f"{name}.cu"
        tag = build_key(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{name}-{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".so.tmp.{os.getpid()}")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                str(src)],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stderr}")
            build_logs[name] = r.stdout + r.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


@contextlib.contextmanager
def launch_stream(dev: torch.device):
    """The raw handle of ``dev``'s current CUDA stream, with ``dev`` the
    current device while the block runs.  A hand-written launch (and its
    ``cudaFuncSetAttribute``) acts in the current device's context, so a
    launch into another card's stream -- a mesh cell on cuda:1 while
    cuda:0 is current -- has to be made under that card.  The guard is a
    device exchange on the host: no launch, no synchronisation."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream
