"""Build and load the port's CUDA C++ kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library that the wrappers
bind with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds.  Libraries land in ``build/repro_torch_kernels/`` at the root of
the checkout (gitignored), named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags: a changed source builds anew, an
unchanged one is reused.  The build happens at first use, never at
import, so CPU-only hosts import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use on a GPU host")
    return exe


def library_path(source: str) -> Path:
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build(source: str) -> tuple:
    """Compile ``csrc/<source>`` unless its hashed library exists.

    Returns (library path, compiler log); the log holds ``ptxas -v``'s
    register and shared-memory report, empty when the library was reused.
    """
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first call."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path, _ = build(source)
            lib = _loaded[source] = ctypes.CDLL(str(path))
        return lib
