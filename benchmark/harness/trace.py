"""The traced run's device trace: torch.profiler on the card's activity only
(no host operators), and its reduction to busy time, time by kernel name,
the longest idle gaps, and the count of each hand kernel.

The profiler starts before set-up in a warm-up step, whose events it drops,
so its device tracing is live before the first kernel of the process (a
profiler started after many untraced kernels has been seen to lose some);
the window is its one active step, and it stays active after the window
until the shape warmer, which the window's commands may have handed work,
is idle: the kernels it counts against the port's launch counters are all
that ran from the window's start on, while busy time and time by name are
the window's own.  The raw Chrome trace goes to the run's temporary
directory and is deleted once read.
"""

from __future__ import annotations

import json
import os
import time

# kernel-name patterns of the port's hand kernels: one device kernel of each
# name a launch of its wrapper
HAND_KERNELS = {
    "spec_fft": "spec_fft_kernel",
    "k6": "k6_quantize",
    "k9": "k9_sums",
    "k8": "k8_gain",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, workdir: str):
        import torch

        self.path = os.path.join(workdir, "trace.json")
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path),
        )
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self._prof.start()

    def window_start(self) -> None:
        self._prof.step()
        self.t0_ns = time.time_ns()

    def window_end(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.step()
        self._prof.stop()

    def read(self) -> dict:
        """Reduce the trace: ``busy_s`` (the union of every kernel, copy and
        memset interval on every stream within the window), ``window_s``,
        ``by_name`` {kernel or copy name: seconds within the window},
        ``hand`` {HAND_KERNELS key: count from the window's start to the
        stop}, ``intervals`` [(start_ns, end_ns, name)] of the window on the
        host's clock."""
        with open(self.path) as f:
            trace = json.load(f)
        os.remove(self.path)
        base_ns = int(trace.get("baseTimeNanoseconds", 0))
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        iv = sorted((base_ns + int(float(e["ts"]) * 1e3),
                     base_ns + int((float(e["ts"]) + float(e.get("dur", 0))) * 1e3), e["name"])
                    for e in events)
        if iv and not (self.t0_ns - 2e9 <= iv[0][0] <= self.t1_ns + 2e9):
            # a trace clock other than the host's: line its first event up
            # with the window's start
            shift = self.t0_ns - iv[0][0]
            iv = [(a + shift, b + shift, n) for a, b, n in iv]
        hand = {k: sum(pat in n for _a, _b, n in iv) for k, pat in HAND_KERNELS.items()}
        iv = [(a, min(b, self.t1_ns), n) for a, b, n in iv if a < self.t1_ns]
        busy = 0
        cur_a = cur_b = None
        for a, b, _n in iv:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        by_name: dict[str, float] = {}
        for a, b, n in iv:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        return {"busy_s": busy / 1e9, "window_s": (self.t1_ns - self.t0_ns) / 1e9,
                "by_name": by_name, "hand": hand, "intervals": iv,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns}


def kernel_seconds(trace: dict, pattern: str) -> float:
    return sum(s for n, s in trace["by_name"].items() if pattern in n)


def idle_gaps(trace: dict, phases: list[tuple[str, int, int]], top: int = 10) -> list:
    """The ``top`` longest stretches of the window in which no device
    operation ran, each named by the host phase (a turn's step) that held
    its midpoint: [[name, seconds], ...]."""
    gaps = []
    prev = trace["t0_ns"]
    for a, b, _n in trace["intervals"] + [(trace["t1_ns"], trace["t1_ns"], "")]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        mid = (a + b) // 2
        name = next((p for p, s, e in phases if s <= mid < e), "between turns")
        out.append([name, length / 1e9])
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its parameter list, at most ``width`` long."""
    cut = name.find("(", name.find("::") if "::" in name else 0)
    if cut > 0 and not name.startswith("Memcpy") and not name.startswith("Memset"):
        name = name[:cut]
    return name.removeprefix("void ")[:width]


def top_ops(trace: dict, top: int = 10) -> list:
    """The ``top`` device operations by total seconds: [[name, seconds]]."""
    by_short: dict[str, float] = {}
    for n, s in trace["by_name"].items():
        by_short[short_name(n)] = by_short.get(short_name(n), 0.0) + s
    return [[n, s] for n, s in sorted(by_short.items(), key=lambda kv: -kv[1])[:top]]
