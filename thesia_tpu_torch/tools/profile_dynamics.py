"""K8 (limiter gains) and K9 (LUFS + stats) on one CUDA card against the native
streaming routes, at the main path's width.

    python -m thesia_tpu_torch.tools.profile_dynamics    # from the repository root

Inputs: the 5-min 48 kHz stereo song and the 60-s 16 kHz memo of
``signals``; K8 runs on the song scaled by 3.6 (about +6 dBFS peaks, so the
limiter engages).  For each program: the wall time of the device route
(median of 5 synchronized calls after one warm-up; upload, program and the
result's copy back), of the native route (``calc_stats`` per track in a
thread pool, as TrackList runs it; ``PerfectLimiter.calc_gain_seq``), the
device time of one warm call under torch.profiler (device-side events only,
the largest by name) and its peak device memory.  Prints the card's name and
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
            **device_profile(run)}), flush=True)

    gained = (np.float32(3.6) * items[0][1]).astype(np.float32)
    run = lambda: stats_device.limiter_gain_seqs_batched([(0, gained, signals.SONG_SR)], dev)  # noqa: E731
    limiter = PerfectLimiter(signals.SONG_SR)
    print(json.dumps({
        "program": "K8", "tracks": "song x 3.6",
        "device_wall_s": round(wall_s(run), 4),
        "native_wall_s": round(wall_s(lambda: limiter.calc_gain_seq(gained), reps=3), 4),
        "max_abs_vs_native": float(np.abs(run()[0] - limiter.calc_gain_seq(gained)).max()),
        **device_profile(run)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
