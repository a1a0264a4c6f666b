"""Where K6's kernels (csrc/images.cu) spend their time, by phase, on one CUDA
card (the card's machine has no ncu or nsys).

    python -m thesia_tpu_torch.tools.profile_images_phases

It builds an instrumented copy of ``csrc/images.cu`` into ``_build/``: each
thread reads ``clock64()`` at every phase boundary and keeps the cycles since
the last boundary in a register of that phase; at the kernel's end (its
``PHASE_END``) lane 0 of each warp adds its warp's sums to a device counter
of each phase.  The source marks its boundaries itself with ``PHASE_BEGIN``
/ ``PHASE(i)  // kernel phase`` / ``PHASE_END`` (empty macros outside this
tool); the comment after each mark names the kernel and the phase, so the
tool reads any design's phases from its source, and a source without marks
is refused.  A warp's cycles in a phase include the time the SM gave to
other warps meanwhile, and a barrier's wait counts in the phase it ends, so
the shares within a kernel, not the cycles, say where a warp waits.

At each of the main path's four images (``bench_images.SHAPES``, dB made on
the card from a seed) it prints one JSON line: each kernel's device ms
(torch.profiler around one call of the uninstrumented build), its phases'
shares and ms (its ms times the share), and the call's device ms
instrumented and not (``runtime.launch_ms``), after the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import sys

import torch

from .. import runtime
from ..kernels import build
from ..kernels import images as kimages
from . import bench_images
from .profile_dynamics import _kernel_events, _profiled

N_COUNTERS = 8
PRELUDE = f"""
__device__ unsigned long long g_phase_cycles[{N_COUNTERS}];
#define PHASE_BEGIN long long phase_t = clock64(); \\
    unsigned int phase_acc[{N_COUNTERS}] = {{0, 0, 0, 0, 0, 0, 0, 0}};
#define PHASE(i) {{ const long long now_ = clock64(); \\
    phase_acc[i] += (unsigned int)(now_ - phase_t); phase_t = now_; }}
#define PHASE_END {{ if ((threadIdx.x & 31) == 0) {{ \\
    _Pragma("unroll") for (int i_ = 0; i_ < {N_COUNTERS}; ++i_) \\
      if (phase_acc[i_]) atomicAdd(&g_phase_cycles[i_], (unsigned long long)phase_acc[i_]); }} }}
"""
READER = f"""
extern "C" int thesia_phase_cycles(unsigned long long* host) {{
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  unsigned long long zero[{N_COUNTERS}] = {{0}};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)e;
}}
"""
MARK = re.compile(r"^\s*PHASE\((\d+)\)\s*//\s*(k6_\w+)\s+(\w+)\s*$", re.M)


def phase_names(src: str) -> dict[int, tuple[str, str]]:
    """{counter: (kernel, phase)} of the source's marks; raises for a source
    without marks, a mark without its name, or a counter marked twice."""
    if "PHASE_BEGIN" not in src or "PHASE_END" not in src:
        raise ValueError("csrc/images.cu marks no phases (PHASE_BEGIN / PHASE(i) / PHASE_END)")
    marks = MARK.findall(src)
    if len(marks) != len(re.findall(r"^\s*PHASE\(\d+\)", src, re.M)):
        raise ValueError("every PHASE(i) mark of csrc/images.cu names '// kernel phase'")
    out = {}
    for i, kernel, phase in marks:
        if int(i) in out or not 0 <= int(i) < N_COUNTERS:
            raise ValueError(f"phase counter {i} marked twice or out of range")
        out[int(i)] = (kernel, phase)
    return out


def instrumented_source(src: str) -> str:
    """csrc/images.cu with the phase counters."""
    phase_names(src)
    head = "#include <stdint.h>\n"
    if src.count(head) != 1:
        raise ValueError("csrc/images.cu: no single '#include <stdint.h>'")
    return src.replace(head, head + PRELUDE) + READER


def kernel_ms(fn) -> dict[str, float]:
    """Device ms by csrc/images.cu kernel name of one call of ``fn``."""
    out: dict = {}
    for e in _kernel_events(_profiled(fn)):
        m = re.search(r"k6_\w+", e.name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + e.device_time_total / 1e3
    return out


def profile_shape(lib, names: dict, shape: tuple, dev) -> dict:
    name, c, frames, f, i0, rows, height, levels = shape
    db, lo, span = bench_images.shape_inputs(name, c, frames, f, dev)
    call = functools.partial(kimages.quantize_mips, db, lo, span, frames, i_start=i0, n_rows=rows,
                             height=height, min_value=bench_images.MIN_VALUE, mip_levels=levels)
    by_kernel = kernel_ms(call)
    plain_ms = runtime.launch_ms(call).ms
    cycles = (ctypes.c_ulonglong * N_COUNTERS)()
    plain = build.library()
    build._lib = lib
    try:
        call()
        if lib.thesia_phase_cycles(cycles):  # clears the warm-up's counts
            raise RuntimeError("reading the phase counters failed")
        call()
        if lib.thesia_phase_cycles(cycles):
            raise RuntimeError("reading the phase counters failed")
        phased_ms = runtime.launch_ms(call).ms
    finally:
        build._lib = plain
    phases: dict = {}
    for i, (kernel, phase) in names.items():
        phases.setdefault(kernel, {})[phase] = cycles[i]
    kernels = {}
    for kernel, ms in by_kernel.items():
        entry = {"ms": round(ms, 4)}
        total = sum(phases.get(kernel, {}).values())
        if total:
            entry["share"] = {k: round(v / total, 4) for k, v in phases[kernel].items()}
            entry["phase_ms"] = {k: round(ms * v / total, 4) for k, v in phases[kernel].items()}
        kernels[kernel] = entry
    return {"shape": name, "kernels": kernels, "call_ms": round(plain_ms, 4),
            "instrumented_call_ms": round(phased_ms, 4)}


def main(argv: list[str]) -> int:
    import argparse

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    build.library()
    src = (build.CSRC_DIR / "images.cu").read_text()
    names = phase_names(src)
    lib = build.instrumented_library("images.cu", instrumented_source(src))
    for shape in bench_images.SHAPES:
        print(json.dumps(profile_shape(lib, names, shape, dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
