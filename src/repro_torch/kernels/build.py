"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout (or the
directory ``set_build_dir`` names). A library's
file name carries a hash of its source, the shared headers and the
compiler flags, so an edited source builds anew and an unchanged one loads
from disk. The build happens at first use, all missing sources compiled
together (one ``nvcc`` each, started at once); nothing is built when a
module is imported, and nothing here runs for tensors on the CPU.

Builds and loads are safe across threads: one module lock serializes
``build_all`` and ``library``, so a second caller waits for the first
build and then loads its result instead of starting its own, and each
``nvcc`` writes a temporary file named by process and thread before it is
renamed into place.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_decode", "paged_flash_decode",
           "paged_mla_decode", "grouped_gemm", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def set_build_dir(path) -> Path:
    """Point the build directory at ``path`` (made when missing) for every
    later build and load in this process. A worker process that joins
    after another one built the libraries there loads them and runs no
    ``nvcc``; libraries already loaded stay loaded."""
    global BUILD_DIR
    with _LOCK:
        BUILD_DIR = Path(path).resolve()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def build_all() -> Dict:
    """Compile every kernel library that is not on disk yet, in parallel.

    Returns ``{"built": [names], "seconds": wall time, "ptxas": {name:
    register/shared-memory report}}``; raises with the compiler's output
    when a build fails. A caller that finds another thread building waits
    for it, and then finds the libraries on disk."""
    with _LOCK:
        return _build_missing()


def _build_missing() -> Dict:
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(
            f".tmp{os.getpid()}.{threading.get_ident()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"built": sorted(procs), "seconds": time.monotonic() - t0,
            "ptxas": reports}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if name not in SOURCES:
        raise KeyError(f"unknown kernel library {name!r}")
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build_missing()
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, kernel: str, code: int) -> None:
    """Raise when a C entry returned a non-zero CUDA error code."""
    if code:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
