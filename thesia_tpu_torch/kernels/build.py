"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources under ``thesia_tpu_torch/csrc/`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/libthesia_kernels_<hash>.so csrc/*.cu

The library is built at first use into ``thesia_tpu_torch/_build/`` (not
tracked), named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing file.  A missing ``nvcc`` or a
failed compile raises; nothing falls back.
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

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last library() call did: {"path", "seconds", "compiled", "log"}
build_info: dict = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.thesia_spec_fft.argtypes = [
        p, i64, i64, i64, i64, i64, p, p, i64, p, p, p, p, i64, i64, i64, i64, i64, i64, p, p,
    ]
    lib.thesia_spec_fft.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first when needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        so = BUILD_DIR / f"libthesia_kernels_{source_hash()}.so"
        log = ""
        compiled = not so.exists()
        if compiled:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        build_info.update(
            path=str(so), seconds=time.perf_counter() - t0, compiled=compiled, log=log
        )
        _lib = lib
        return lib
