"""K8 (limiter gains) and K9 (LUFS + stats) on one CUDA card: the kernels
against their plain versions and the native streaming routes, at the main
path's width.

    python -m thesia_tpu_torch.tools.profile_dynamics    # from the repository root

Inputs: the 5-min 48 kHz stereo song and the 60-s 16 kHz memo of
``signals``; K8 runs on the song scaled by 3.6 (about +6 dBFS peaks, so the
limiter engages).  For each program: the wall time of the batched device
route (median of 5 synchronized calls after one warm-up; rows, kernel and
the result's copy back), of the native route (``calc_stats`` per track in a
thread pool, as TrackList runs it; ``PerfectLimiter.calc_gain_seq``), the
device kernels of one warm batched call under torch.profiler (their count,
the largest by name, the device total) and its peak device memory; then per
(sr, channels) group the kernel's wrapper alone (``kernels/dynamics.py``)
and its plain version (``stats_device.lufs_program`` /
``limiter_gain_program``) on the same device rows: device kernels launched
by one call (csrc/dynamics.cu's, by name: each K9 or K8 group must launch at
most six; all kernels of the window for the plain version), device ms and the
wrapper's host us by ``runtime.launch_ms``.  Prints the card's name and
power limit, then one JSON line per measurement.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import runtime
from ..dynamics import stats_device
from ..kernels import dynamics as kernels
from ..dynamics.limiter import PerfectLimiter
from ..dynamics.stats import calc_stats
from . import signals


def wall_s(fn, reps: int = 5) -> float:
    """Median wall seconds of ``reps`` synchronized calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def device_profile(fn, top: int = 8) -> dict:
    """Device-side time of one call by event name (ms), its total, and the
    call's peak device memory above what was allocated before it (MB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            device[evt.key[:80]] = device.get(evt.key[:80], 0.0) + evt.self_device_time_total / 1e3
    largest = dict(sorted(device.items(), key=lambda kv: -kv[1])[:top])
    return {"device_ms": round(sum(device.values()), 3),
            "peak_mb": round((torch.cuda.max_memory_allocated() - base) / 1e6, 1),
            "largest_ms": {k: round(v, 3) for k, v in largest.items()}}


def device_kernels(fn) -> list[str]:
    """Names of the device kernels in a profile around one call of ``fn``, in
    order (those other threads launch meanwhile too)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "Memcpy" not in e.name
            and "Memset" not in e.name]


def dynamics_kernels(names: list[str]) -> list[str]:
    """The names of csrc/dynamics.cu's kernels (K9's and K8's) among ``names``."""
    return [n for n in names if "k9_" in n or "k8_" in n]


MAX_KERNELS_PER_GROUP = 6


def group_rows(items, device):
    """[(sr, rows, ns)] of K9's (sr, channels) groups, rows as
    ``lufs_stats_batched`` builds them."""
    groups: dict = {}
    for key, wavs, sr in items:
        groups.setdefault((sr, wavs.shape[0]), []).append((key, wavs))
    out = []
    for (sr, n_ch), members in groups.items():
        length = max(w.shape[1] for _k, w in members)
        rows = stats_device._rows_on_device(members, n_ch, length, device)
        ns = torch.tensor([w.shape[1] for _k, w in members], dtype=torch.int64, device=device)
        out.append((sr, rows, ns))
    return out


def kernel_vs_plain(label: str, kernel, plain) -> dict:
    """Device kernels, device ms and host us of one kernel call and of the
    plain version on the same rows; raises if the kernel launches more than
    MAX_KERNELS_PER_GROUP device kernels."""
    names = dynamics_kernels(device_kernels(kernel))
    if len(names) > MAX_KERNELS_PER_GROUP:
        raise AssertionError(f"{label}: {len(names)} device kernels: {names}")
    ms, host_us = runtime.launch_ms(kernel)
    plain_ms, _ = runtime.launch_ms(plain, n=20, warmup=1)
    return {"group": label, "kernel_device_kernels": len(names),
            "kernel_names": sorted(set(n[:60] for n in names)), "kernel_ms": round(ms, 4),
            "kernel_host_us": round(host_us, 1), "plain_device_kernels": len(device_kernels(plain)),
            "plain_ms": round(plain_ms, 3)}


def main() -> int:
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    rng = np.random.default_rng(0)
    items = [(0, signals.song(rng), signals.SONG_SR), (1, signals.voice_memo(rng), signals.MEMO_SR)]

    def native_stats(its):
        with concurrent.futures.ThreadPoolExecutor() as pool:
            return list(pool.map(lambda it: calc_stats(it[1], it[2]), its))

    for label, its in (("song+memo", items), ("song", items[:1])):
        run = lambda its=its: stats_device.calc_stats_batched(its, dev)  # noqa: E731
        print(json.dumps({
            "program": "K9", "tracks": label,
            "device_wall_s": round(wall_s(run), 4),
            "native_wall_s": round(wall_s(lambda its=its: native_stats(its)), 4),
            "batched_device_kernels": len(device_kernels(run)),
            **device_profile(run)}), flush=True)
    for sr, rows, ns in group_rows(items, dev):
        print(json.dumps({"program": "K9", **kernel_vs_plain(
            f"{sr} Hz x {rows.shape[1]}", lambda: kernels.lufs_stats(rows, ns, sr),
            lambda: stats_device.lufs_program(rows, ns, sr))}), flush=True)

    gained = (np.float32(3.6) * items[0][1]).astype(np.float32)
    run = lambda: stats_device.limiter_gain_seqs_batched([(0, gained, signals.SONG_SR)], dev)  # noqa: E731
    limiter = PerfectLimiter(signals.SONG_SR)
    print(json.dumps({
        "program": "K8", "tracks": "song x 3.6",
        "device_wall_s": round(wall_s(run), 4),
        "native_wall_s": round(wall_s(lambda: limiter.calc_gain_seq(gained), reps=3), 4),
        "max_abs_vs_native": float(np.abs(run()[0] - limiter.calc_gain_seq(gained)).max()),
        "batched_device_kernels": len(device_kernels(run)),
        **device_profile(run)}), flush=True)
    p = stats_device.limiter_params(signals.SONG_SR)
    rows = stats_device._rows_on_device([(0, gained)], gained.shape[0],
                                        gained.shape[1] + p["attack"] + 1, dev)
    args = (1.0, p["slew"])
    kw = {"hold_length": p["hold_length"], "box_lengths": p["box_lengths"]}
    print(json.dumps({"program": "K8", **kernel_vs_plain(
        f"{signals.SONG_SR} Hz x {rows.shape[1]}", lambda: kernels.limiter_gain(rows, *args, **kw),
        lambda: stats_device.limiter_gain_program(rows, *args, **kw))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
