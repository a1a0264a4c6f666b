"""K8 (limiter gains) and K9 (LUFS + stats) on one CUDA card: the kernels
against their plain versions and the native streaming routes, at the main
path's width; optionally in turns with another checkout's kernels.

    python -m thesia_tpu_torch.tools.profile_dynamics [--other DIR] [--profiler-check] [--counts]

Inputs: the 5-min 48 kHz stereo song and the 60-s 16 kHz memo of
``signals`` (seed 0), and the 1-hour 16 kHz lecture (seed 1); K8 runs on the
song scaled by 3.6 (about +6 dBFS peaks, so the limiter engages) and on the
lecture scaled to a peak of 2.  First, for each program on song + memo and
on the song: the wall time of the batched device
route (median of 5 synchronized calls after one warm-up; rows, kernel and
the result's copy back), of the native route (``calc_stats`` per track in a
thread pool, as TrackList runs it; ``PerfectLimiter.calc_gain_seq``), the
device kernels of one warm batched call under torch.profiler (their count,
the largest by name, the device total) and its peak device memory.  Then,
for each tree in turn, one line per input of the kernel's wrapper
(``kernels/dynamics.py``; K9 per (sr, channels) group): device kernels
launched by one call (csrc/dynamics.cu's, by name: each K9 or K8 group must
launch at most six), their device ms by name (torch.profiler), the call's
device ms and the wrapper's host us by ``runtime.launch_ms``, the bound of
its work, and its largest difference from the first tree's output; the
first turn of this tree adds the plain version (``stats_device.lufs_program``
/ ``limiter_gain_program``) on the same device rows: its device kernels and
ms.  ``--other DIR`` loads DIR/thesia_tpu_torch as a second package (its own
sources and build; unpack a parent with ``git archive``), and the turns
are other, this, this, other.  Prints the card's name and power limit
first, then one JSON line per measurement.  ``--profiler-check`` first counts csrc/dynamics.cu's
kernels in profiles taken after 20 unprofiled calls of the plain versions,
with and without a warm-up step; ``--counts`` prints only the device kernels
a call of each launches (one JSON line, for a fresh process).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import re
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from .. import runtime
from ..dynamics import stats_device
from ..kernels import dynamics as kernels
from ..dynamics.limiter import PerfectLimiter
from ..dynamics.stats import calc_stats
from . import signals
from .bench_spec_fft import import_tree


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
    device = {}
    for evt in _profiled(fn).key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            device[evt.key[:80]] = device.get(evt.key[:80], 0.0) + evt.self_device_time_total / 1e3
    largest = dict(sorted(device.items(), key=lambda kv: -kv[1])[:top])
    return {"device_ms": round(sum(device.values()), 3),
            "peak_mb": round((torch.cuda.max_memory_allocated() - base) / 1e6, 1),
            "largest_ms": {k: round(v, 3) for k, v in largest.items()}}


def _profiled(fn, warmup: bool = True):
    """torch.profiler around one call of ``fn``; with ``warmup`` a profiler
    schedule runs ``fn`` once in a warm-up step and profiles a second call,
    which loses fewer kernels.  A profile taken after many kernels ran
    unprofiled in the process (the plain versions' thousands) loses some of
    the call's kernels, the first ones or all, though it synchronizes before
    its start and its end (``--profiler-check``): count kernels in a fresh
    process (``--counts``)."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if not warmup:
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return prof
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def _kernel_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Memcpy" not in e.name
            and "Memset" not in e.name]


def device_kernels(fn, warmup: bool = True) -> list[str]:
    """Names of the device kernels in a profile around one call of ``fn``, in
    order (those other threads launch meanwhile too)."""
    return [e.name for e in _kernel_events(_profiled(fn, warmup))]


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


def kernel_device_ms(fn) -> dict:
    """Device ms by kernel name of one call of ``fn`` (csrc/dynamics.cu's)."""
    out: dict = {}
    for e in _kernel_events(_profiled(fn)):
        if dynamics_kernels([e.name]):
            key = re.search(r"k[89]_\w+(<[^>]*>)?", e.name).group(0)
            out[key] = round(out.get(key, 0.0) + e.device_time_total / 1e3, 4)
    return out


def profiler_check(cases, reps: int = 3) -> dict:
    """csrc/dynamics.cu's kernels counted in ``reps`` profiles of each case's
    call, each after 20 unprofiled calls of its plain version
    (runtime.launch_ms), without and with the warm-up step."""
    out = {}
    for case in cases:
        fn, plain = {"K9": (kernels.lufs_stats, stats_device.lufs_program),
                     "K8": (kernels.limiter_gain, stats_device.limiter_gain_program)}[case["program"]]
        call = lambda: fn(*case["args"], **case.get("kw", {}))  # noqa: E731
        counts: dict = {}
        for warmup in (False, True):
            for _ in range(reps):
                runtime.launch_ms(lambda: plain(*case["args"], **case.get("kw", {})), n=20,
                                  warmup=1, may_wait=True)
                counts.setdefault(f"warmup={warmup}", []).append(
                    len(dynamics_kernels(device_kernels(call, warmup))))
        out[case["label"]] = counts
    return out


def inputs(dev, lecture: bool = True) -> list[dict]:
    """The measured calls: K9 per (sr, channels) group of song + memo and on
    the lecture, K8 on the scaled song and lecture (the lecture's only with
    ``lecture``); each {"label", "program", "args", "work"} with device
    rows."""
    rng = np.random.default_rng(0)
    items = [(0, signals.song(rng), signals.SONG_SR), (1, signals.voice_memo(rng), signals.MEMO_SR)]
    hour = signals.lecture(np.random.default_rng(1)) if lecture else None
    out = []
    for label, its in (("song+memo", items), ("lecture", [(0, hour, signals.LECTURE_SR)])):
        if its[0][1] is None:
            continue
        for sr, rows, ns in group_rows(its, dev):
            out.append({"label": f"{label} {sr} Hz x {rows.shape[1]}", "program": "K9",
                        "group": f"{sr}x{rows.shape[1]}", "args": (rows, ns, sr),
                        "work": kernels.lufs_work(ns.tolist(), rows.shape[1], sr)})
    k8 = [("song x 3.6", np.float32(3.6) * items[0][1], signals.SONG_SR)]
    if lecture:
        k8.append(("lecture to peak 2", hour * np.float32(2.0 / np.abs(hour).max()),
                   signals.LECTURE_SR))
    for label, wav, sr in k8:
        wav = wav.astype(np.float32)
        p = stats_device.limiter_params(sr)
        rows = stats_device._rows_on_device([(0, wav)], wav.shape[0],
                                            wav.shape[1] + p["attack"] + 1, dev)
        out.append({"label": f"{label} {sr} Hz x {rows.shape[1]}", "program": "K8",
                    "group": f"{sr}x{rows.shape[1]}", "args": (rows, 1.0, p["slew"]),
                    "kw": {"hold_length": p["hold_length"], "box_lengths": p["box_lengths"]},
                    "work": kernels.limiter_work(1, rows.shape[1], rows.shape[2],
                                                 len(p["box_lengths"]))})
    return out


def counts(dev) -> dict:
    """The device kernels one call launches, by input: csrc/dynamics.cu's for
    the kernels (``lufs_stats`` per (sr, channels) group of song + memo,
    ``limiter_gain`` on the song), all of them for the plain versions.  Meant
    for a fresh process, where torch.profiler misses none."""
    out: dict = {"lufs_stats": {}, "lufs_program": {}, "limiter_gain": {},
                 "limiter_gain_program": {}}
    cases = inputs(dev, lecture=False)
    for case in cases:  # the kernels first, before the plain versions' traffic
        fn = {"K9": kernels.lufs_stats, "K8": kernels.limiter_gain}[case["program"]]
        out[fn.__name__][case["group"]] = len(dynamics_kernels(
            device_kernels(lambda: fn(*case["args"], **case.get("kw", {})))))
    for case in cases:
        plain = {"K9": stats_device.lufs_program,
                 "K8": stats_device.limiter_gain_program}[case["program"]]
        out[plain.__name__][case["group"]] = len(device_kernels(
            lambda: plain(*case["args"], **case.get("kw", {}))))
    return out


def tree_modules(name: str, root: str | None) -> SimpleNamespace:
    prefix = import_tree(name, root)
    return SimpleNamespace(kdyn=importlib.import_module(f"{prefix}.kernels.dynamics"),
                           sd=importlib.import_module(f"{prefix}.dynamics.stats_device"))


def _outputs(out) -> list[torch.Tensor]:
    return [t.double() for t in (out if isinstance(out, tuple) else (out,))]


def _max_diff(a: list, b: list) -> float:
    d = 0.0
    for x, y in zip(a, b):
        both = torch.isfinite(x) & torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), torch.isfinite(y)):
            return float("inf")
        d = max(d, float((x[both] - y[both]).abs().max()) if both.any() else 0.0)
    return d


def kernel_turn(label: str, tree: SimpleNamespace, case: dict, reference: dict,
                plain: bool) -> dict:
    """One tree's kernel on one input: device kernels, ms by kernel, device
    ms, host us, bound, difference from the first tree; with ``plain`` the
    plain version's device kernels and ms.  Raises if the kernel launches
    more than MAX_KERNELS_PER_GROUP device kernels."""
    kw = case.get("kw", {})
    fn, plain_fn = {"K9": (tree.kdyn.lufs_stats, tree.sd.lufs_program),
                    "K8": (tree.kdyn.limiter_gain, tree.sd.limiter_gain_program)}[case["program"]]
    kernel = lambda: fn(*case["args"], **kw)  # noqa: E731
    out = _outputs(kernel())
    names = dynamics_kernels(device_kernels(kernel))
    if len(names) > MAX_KERNELS_PER_GROUP:
        raise AssertionError(f"{case['label']}: {len(names)} device kernels: {names}")
    ms, host_us, _ = runtime.launch_ms(kernel, n=20 if "lecture" in case["label"] else 50)
    bound, by = runtime.bound_ms(case["work"]["bytes"], case["work"]["flop"], runtime.F64_FLOP_PER_S)
    line = {"tree": label, "program": case["program"], "input": case["label"],
            "kernel_device_kernels": len(names), "kernel_device_ms_by_name": kernel_device_ms(kernel),
            "kernel_ms": round(ms, 4), "kernel_host_us": round(host_us, 1),
            "bound_ms": round(bound, 4), "bound_by": by, "share_of_bound": round(bound / ms, 4)}
    if case["label"] in reference:
        line["max_abs_vs_first_tree"] = _max_diff(out, reference[case["label"]])
    else:
        reference[case["label"]] = out
    if plain:
        plain_call = lambda: plain_fn(*case["args"], **kw)  # noqa: E731
        line["max_abs_vs_plain"] = _max_diff(out, _outputs(plain_call()))
        line["plain_device_kernels"] = len(device_kernels(plain_call))
        plain_t = runtime.launch_ms(plain_call, n=20, warmup=1, may_wait=True)
        line["plain_ms"] = round(plain_t.ms, 3)
        line["plain_host_waited"] = plain_t.host_waited
    return line


def routes(dev) -> None:
    """The batched device routes against the native ones (song + memo, the song)."""
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


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout whose thesia_tpu_torch runs in turns with this one")
    ap.add_argument("--counts", action="store_true",
                    help="only the device kernels a call launches, as one JSON line")
    ap.add_argument("--profiler-check", action="store_true",
                    help="count the kernels in profiles without and with the warm-up step")
    a = ap.parse_args(argv)
    order = ["other", "this", "this", "other"] if a.other else ["this"]
    dev = runtime.resolve_device("cuda")
    if a.counts:
        print(json.dumps({"device_kernels": counts(dev)}), flush=True)
        return 0
    print(runtime.card_description(), flush=True)
    routes(dev)
    trees = {"this": tree_modules("", None)}
    if a.other:
        trees["other"] = tree_modules("other_thesia_tpu_torch", a.other)
    cases = inputs(dev)
    if a.profiler_check:
        print(json.dumps({"profiler_check": profiler_check(cases)}), flush=True)
    reference: dict = {}
    for i, label in enumerate(order):
        for case in cases:
            line = kernel_turn(f"{label}#{i}", trees[label], case, reference,
                               plain=label == "this" and i == order.index("this"))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
