"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
``_build/lib<name>_<hash>.so`` inside the package, at first use, and
loaded with ``ctypes``. The hash covers the source, the headers beside
it (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. A
failed build raises: there is no fallback for a CUDA tensor.

The sources have a plain C interface (no PyTorch headers), which keeps a
build to seconds; the wrappers in ``ops/`` set each function's
``argtypes`` and ``restype``.

Flags: every source gets ``NVCC_FLAGS``, plus its entry in
``SOURCE_FLAGS``. The stencil kernels and the FMA probe equal their
plain versions bit for bit only without mul+add contraction
(``--fmad=false``); the paged-attention kernels are held to a tolerance,
so they keep nvcc's default contraction into FMA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",          # registers, shared memory, spills: into the log
)
SOURCE_FLAGS: Dict[str, tuple] = {
    # no mul+add contraction into FMA: the stencil kernels and the FMA
    # probe equal their plain PyTorch versions bit for bit
    "stencil": ("--fmad=false",),
    "fma_rate": ("--fmad=false",),
}


def flags(name: str) -> tuple:
    """nvcc flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
_BUILD_TIMEOUT_S = 600

# name -> {"path", "seconds", "built", "log"} for each library loaded
BUILD_INFO: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}   # one per source: builds overlap
_locks_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels of hpx_tpu_torch are built on the machine with the GPU")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    header beside it (``csrc/*.cuh``, which a source may include) and the
    flags: a changed header never loads a stale build."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> str:
    """Compile csrc/<name>.cu into ``out``; return nvcc's output."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Safe to call from several threads; different sources build in
    parallel."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        t0 = time.perf_counter()
        built = not path.exists()
        log = _build(name, path) if built else ""
        lib = ctypes.CDLL(str(path))
        BUILD_INFO[name] = {"path": str(path), "built": built, "log": log,
                            "seconds": time.perf_counter() - t0}
        _libs[name] = lib
        return lib
