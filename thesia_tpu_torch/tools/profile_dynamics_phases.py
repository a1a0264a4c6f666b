"""Where K9's and K8's kernels (csrc/dynamics.cu) spend their time, by phase,
on one CUDA card (the card's machine has no ncu or nsys); optionally in turns
with another checkout's kernels.

    python -m thesia_tpu_torch.tools.profile_dynamics_phases [--other DIR]

For each tree it builds an instrumented copy of ``csrc/dynamics.cu`` into
that tree's ``_build/``: at each phase boundary every warp reads
``clock64()`` and lane 0 adds the cycles since the last boundary to a device
counter of that phase.  The source marks its boundaries itself with
``PHASE_BEGIN`` / ``PHASE(i)`` (empty macros outside this tool; ``PHASES``
names them); a source without marks is refused.  A warp's cycles in a
phase include the time the SM gave to other warps meanwhile, so the shares
within a kernel, not the cycles, say where a warp waits.  Each kernel's device ms comes from
torch.profiler around one call of the uninstrumented build, and a phase's
ms is its kernel's ms times its share.

Inputs (``profile_dynamics.inputs``): K9 on each (sr, channels) group of the
5-min 48 kHz stereo song + 60-s 16 kHz memo and on the 1-hour 16 kHz
lecture, K8 on the song scaled by 3.6 and on the lecture scaled to a peak
of 2.  One JSON line per tree and input: each kernel's device ms, its
phases' shares and ms, and the call's device ms instrumented and not
(``runtime.launch_ms``), after the card's name and power limit.  With
``--other DIR`` (a checkout whose source marks its phases, loaded as in
``profile_dynamics``) the other tree runs first, then this one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import sys

import torch

from .. import runtime
from ..kernels import build
from .profile_dynamics import inputs, kernel_device_ms, tree_modules

N_COUNTERS = 32
PRELUDE = f"""
__device__ unsigned long long g_phase_cycles[{N_COUNTERS}];
#define PHASE_BEGIN long long phase_t = clock64();
#define PHASE(i) {{ const long long now_ = clock64(); if ((threadIdx.x & 31) == 0) {{ \\
    atomicAdd(&g_phase_cycles[i], (unsigned long long)(now_ - phase_t)); }} phase_t = now_; }}
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

# counter -> (kernel, phase) of the source's own marks
PHASES = {
    0: ("k9_sums", "load"), 1: ("k9_sums", "weights"), 2: ("k9_sums", "scan"),
    3: ("k9_carry", "tables"), 4: ("k9_carry", "load"), 5: ("k9_carry", "scan"),
    6: ("k9_carry", "store"),
    8: ("k9_energy", "load"), 9: ("k9_energy", "starts"), 11: ("k9_energy", "rerun"),
    12: ("k9_energy", "segments"),
    13: ("k9_gate", "load"), 14: ("k9_gate", "bins"),
    16: ("k8_spans", "load"), 17: ("k8_spans", "hold"), 18: ("k8_spans", "release"),
    20: ("k8_gain", "load"), 21: ("k8_gain", "hold"), 22: ("k8_gain", "release"),
    23: ("k8_gain", "box"), 24: ("k8_gain", "store"),
}

def instrumented_source(src: str) -> str:
    """csrc/dynamics.cu with the phase counters; raises for a source that
    does not mark its phases."""
    head = "#include <stdint.h>\n"
    if src.count(head) != 1:
        raise ValueError("csrc/dynamics.cu: no single '#include <stdint.h>'")
    if "PHASE_BEGIN" not in src or "PHASE(" not in src:
        raise ValueError("csrc/dynamics.cu marks no phases (PHASE_BEGIN / PHASE(i))")
    return src.replace(head, head + PRELUDE) + READER


def profile_case(label: str, tree, lib, case: dict) -> dict:
    kw = case.get("kw", {})
    fn = {"K9": tree.kdyn.lufs_stats, "K8": tree.kdyn.limiter_gain}[case["program"]]
    call = lambda: fn(*case["args"], **kw)  # noqa: E731
    n = 20
    plain = tree.build.library()
    by_kernel: dict = {}
    for name, ms in kernel_device_ms(call).items():
        kernel = name.split("<")[0]
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + ms
    plain_ms = runtime.launch_ms(call, n=n).ms
    cycles = (ctypes.c_ulonglong * N_COUNTERS)()
    tree.build._lib = lib
    try:
        call()
        if lib.thesia_phase_cycles(cycles):  # clears the warm-up's counts
            raise RuntimeError("reading the phase counters failed")
        call()
        if lib.thesia_phase_cycles(cycles):
            raise RuntimeError("reading the phase counters failed")
        phased_ms = runtime.launch_ms(call, n=n).ms
    finally:
        tree.build._lib = plain
    kernels: dict = {}
    for i, (kernel, phase) in PHASES.items():
        kernels.setdefault(kernel, {})[phase] = cycles[i]
    out = {}
    for kernel, ms in by_kernel.items():
        phases = kernels.get(kernel)
        entry = {"ms": round(ms, 4)}
        total = sum(phases.values()) if phases else 0
        if total:
            entry["share"] = {k: round(v / total, 4) for k, v in phases.items()}
            entry["phase_ms"] = {k: round(ms * v / total, 4) for k, v in phases.items()}
        out[kernel] = entry
    return {"tree": label, "program": case["program"], "input": case["label"], "kernels": out,
            "call_ms": round(plain_ms, 4), "instrumented_call_ms": round(phased_ms, 4)}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout whose thesia_tpu_torch runs in turns with this one")
    a = ap.parse_args(argv)
    order = ["other", "this"] if a.other else ["this"]
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    trees = {"this": tree_modules("", None)}
    if a.other:
        trees["other"] = tree_modules("other_thesia_tpu_torch", a.other)
    libs = {}
    for key, tree in trees.items():
        tree.build = importlib.import_module(tree.kdyn.__name__.rsplit(".", 1)[0] + ".build")
        tree.build.library()
        text = instrumented_source((tree.build.CSRC_DIR / "dynamics.cu").read_text())
        libs[key] = build.instrumented_library("dynamics.cu", text, tree.build)
    cases = inputs(torch.device("cuda"))
    for i, label in enumerate(order):
        for case in cases:
            print(json.dumps(profile_case(f"{label}#{i}", trees[label], libs[label], case)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
