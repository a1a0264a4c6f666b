"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources under ``thesia_tpu_torch/csrc/`` (``spec_fft.cu``, K1/K2;
``dynamics.cu``, K9/K8; ``images.cu``, K6) compile into one shared library
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
import re
import shutil
import subprocess
import sys
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
# what the last library() call did: {"path", "seconds", "compiled", "log"};
# the log is nvcc's, kept beside the library, also when it was built before
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
        p, i64, i64, p, i64, i64, i64, i64, i64, i64, p, p, i64, p, p, p, p, p, i64, i64, i64,
        i64, i64, i64, p, p, p, p,
    ]
    lib.thesia_spec_fft.restype = ctypes.c_int
    f64 = ctypes.c_double
    lib.thesia_lufs_stats.argtypes = [
        p, p, i64, i64, i64, i64, i64, i64, i64, i64, p, p, p, f64, f64, p, p, p, p, p, p, p, p,
        p, p, p, p, p, p,
    ]
    lib.thesia_lufs_stats.restype = ctypes.c_int
    lib.thesia_limiter_gain.argtypes = [p, i64, i64, i64, f64, f64, i64, p, i64, i64, p, p, p, i64, p]
    lib.thesia_limiter_gain.restype = ctypes.c_int
    f32 = ctypes.c_float
    lib.thesia_guard_peak.argtypes = [p, i64, i64, f32, p, p, p, p]
    lib.thesia_guard_peak.restype = ctypes.c_int
    lib.thesia_guard_apply.argtypes = [p, i64, i64, f32, i64, f64, p, p, p, p, p]
    lib.thesia_guard_apply.restype = ctypes.c_int
    lib.thesia_quantize_mips.argtypes = [p, i64, i64, i64, i64, i64, i64, i64, p, p, i64, p, p, i64, p]
    lib.thesia_quantize_mips.restype = ctypes.c_int


def ptxas_report(log: str) -> list[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name (``registers<L,
    mel|linear>`` for the register schedule with L lanes a frame, n_fft = 64
    L; ``shared<mel|linear>``; ``k10_apply<mode>``; csrc/dynamics.cu's and
    csrc/images.cu's others by name), registers, stack frame and spill bytes."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"spec_fft_kernel_regsILi(\d+)ELb([01])E", line)
            s = re.search(r"spec_fft_kernelILb([01])E", line)
            d = re.search(r"(k9_sums|k9_carry|k9_energy|k9_gate|k9_tail|k8_spans|k8_carry|k8_gain|k10_peak|k6_quantize|k6_halve)", line)
            k10 = re.search(r"k10_applyILi(\d)E", line)
            variant = lambda flag: "mel" if flag == "1" else "linear"  # noqa: E731
            name = (f"registers<{1 << int(m.group(1))},{variant(m.group(2))}>" if m else
                    f"shared<{variant(s.group(1))}>" if s else
                    f"k10_apply<{k10.group(1)}>" if k10 else
                    d.group(1) if d else line.split("'")[1])
            cur = {"kernel": name}
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def instrumented_library(name: str, text: str, mod=None) -> ctypes.CDLL:
    """A library built from the sources with ``csrc/<name>`` replaced by
    ``text`` (an instrumented copy, which exports whatever the tool that made
    it reads), loaded and bound like ``library()``.  ``mod`` is the build
    module of the tree whose sources and build directory it uses (this one
    by default; a measurement tool may pass another checkout's)."""
    mod = mod or sys.modules[__name__]
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    so = mod.BUILD_DIR / f"lib{Path(name).stem}_instrumented_{mod.source_hash()}_{digest}.so"
    if not so.exists():
        mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cu")
        src.write_text(text)
        others = [str(p) for p in mod.sources() if p.name != name]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [mod.find_nvcc(), *mod.NVCC_FLAGS, "-o", str(tmp), str(src), *others]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    mod._bind(lib)
    return lib


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
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)
        elif so.with_suffix(".log").exists():  # the ptxas report of the build that made it
            log = so.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        build_info.update(
            path=str(so), seconds=time.perf_counter() - t0, compiled=compiled, log=log
        )
        _lib = lib
        return lib
