"""The span-tree arithmetic (``benchmark/harness/spantree.py``) on a
synthetic span log and device trace: descendants across threads, self time,
device-idle time put down to the deepest open span with the shape warmer's
trees left out, and a skewed clock that makes the idle readers give None.
Then the readers built on the log on the tiny CPU run with tracing on."""

import json
from types import SimpleNamespace

import pytest

from bench_tiny import ROOT, run_tiny, tiny_root
from benchmark.harness import spantree
from benchmark.harness.cells import resolve

MS = 1_000_000
T0 = 10_000 * MS


def rec(name, sid, parent, root, thread, a_ms, b_ms):
    return (name, sid, parent, root, thread, T0 + a_ms * MS, T0 + b_ms * MS)


# a command on the main thread hands work to a worker (two nested spans, one
# of them launching K6) and, meanwhile, a second thread runs a span of its
# own; a warm job the command queued runs on the warmer's thread; a last
# command is open from 80 to 95 ms
LOG = [
    rec("command.add_tracks", 1, None, 1, "MainThread", 0, 60),
    rec("decode", 2, 1, 1, "pool-0", 5, 30),
    rec("stats", 3, 2, 1, "pool-0", 10, 20),
    rec("launch.k6", 4, 3, 1, "pool-0", 12, 12),
    rec("spec.stream", 5, 1, 1, "streamer", 25, 50),
    rec("warm.spec_full", 6, 1, 6, "shape-warmer", 50, 75),
    rec("spec.recompute", 7, 6, 6, "shape-warmer", 52, 70),
    rec("command.get_global_lufs", 8, None, 8, "MainThread", 80, 95),
    rec("stats", 9, 8, 8, "MainThread", 82, 90),
]
# device busy 12.5-14 ms (K6) and 40-41 ms (a copy); window 0-100 ms
TRACE = {"t0_ns": T0, "t1_ns": T0 + 100 * MS,
         "intervals": [(T0 + 12_500_000, T0 + 14 * MS, "void k6_quantize(...)"),
                       (T0 + 40 * MS, T0 + 41 * MS, "Memcpy DtoH")]}


def _run(log, trace=TRACE, turns=None):
    run = SimpleNamespace(trace=trace, turns=turns or [SimpleNamespace(
        kind="open", phases=[("open.add_tracks", T0, T0 + 60 * MS),
                             ("open.summary", T0 + 60 * MS, T0 + 100 * MS)])])
    run.of = lambda *kinds: [t for t in run.turns if t.kind in kinds]
    run._span_window = spantree.Window(log, trace["t0_ns"], trace["t1_ns"])
    return run


def test_descendants_cross_threads_and_leave_out_the_warm_tree():
    win = spantree.Window(LOG, T0, T0 + 100 * MS)
    by_id = win.by_id
    assert {r[1] for r in win.descendants(by_id[1])} == {2, 3, 4, 5}
    assert {r[1] for r in win.descendants(by_id[2])} == {3, 4}
    assert win.is_warm(by_id[7]) and not win.is_warm(by_id[3])
    assert [win.depth(by_id[i]) for i in (1, 2, 3, 4, 6, 7)] == [0, 1, 2, 3, 1, 2]
    # the add: 60 ms less the union of decode (5-30) and the stream (25-50)
    assert win.self_ns(by_id[1]) == 15 * MS
    assert win.self_ns(by_id[2]) == 15 * MS and win.self_ns(by_id[8]) == 7 * MS


def test_idle_time_goes_to_the_deepest_open_span():
    run = _run(LOG)
    pieces = spantree.idle(run)
    named = [((a - T0) / MS, (b - T0) / MS, None if r is None else r[0]) for a, b, r in pieces]
    assert named == [(0, 5, "command.add_tracks"), (5, 10, "decode"), (10, 12.5, "stats"),
                     (14, 20, "stats"), (20, 25, "decode"), (25, 40, "spec.stream"),
                     (41, 50, "spec.stream"),
                     (50, 60, "command.add_tracks"), (60, 80, None),
                     (80, 82, "command.get_global_lufs"), (82, 90, "stats"),
                     (90, 95, "command.get_global_lufs"), (95, 100, None)]
    # the warm job (50-75) is left out: 60-80 has no span of the program
    idle = 100 - 1.5 - 1
    assert spantree.idle_unspanned_pct(run) == pytest.approx(100 * 25 / idle)


def test_an_idle_gap_without_a_span_log_or_device_trace_is_not_read():
    copies = {**TRACE, "intervals": TRACE["intervals"][1:]}
    assert spantree.idle_unspanned_pct(_run([], copies)) == 100.0  # no hand kernel to check
    run = _run(LOG)
    run.trace = None
    assert spantree.idle(run) is None and spantree.idle_unspanned_pct(run) is None


@pytest.mark.parametrize("skew_ms,ok", [(0.0, True), (-0.05, True), (-0.5, False), (3.0, True),
                                        (-3000.0, False)])
def test_the_clock_check(skew_ms, ok):
    """The device event 0.5 ms after its launch at 12 ms: a trace clock early
    by more than 0.1 ms against the spans' fails the check (the median of
    one lag), and the idle readers give None; late is a longer lag."""
    shift = int((skew_ms - 0.5) * MS)
    trace = {**TRACE, "intervals": [(a + shift, b + shift, n) for a, b, n in TRACE["intervals"]]}
    run = _run(LOG, trace)
    got_ok, lags = spantree.clock_check(run._span_window, trace)
    # 3 s early, the event leaves the window: a launch without its kernel
    assert got_ok is ok and lags["k6"] == ([int(skew_ms * MS)] if skew_ms > -12 else [])
    assert (spantree.idle(run) is not None) is ok
    assert (spantree.idle_unspanned_pct(run) is not None) is ok


@pytest.mark.parametrize("excursion_ms,ok", [(-4.1, True), (-12.0, False)])
def test_an_excursion_of_the_cards_clock(excursion_ms, ok):
    """Nine launches 0.06 ms before their kernels, 30 ms apart, and one
    kernel drawn back by the card's clock: the median holds, and only an
    excursion past CLOCK_SLACK_NS fails the check."""
    launches = [rec("launch.k6", 100 + i, None, 100 + i, "w", 30 * i + 1, 30 * i + 1)
                for i in range(10)]
    kernels = [(T0 + (30 * i + 1) * MS + 60_000 + (int(excursion_ms * MS) if i == 5 else 0),
                T0 + (30 * i + 2) * MS, "k6_quantize") for i in range(10)]
    trace = {**TRACE, "t1_ns": T0 + 400 * MS, "intervals": sorted(kernels)}
    got_ok, lags = spantree.clock_check(_run(launches, trace)._span_window, trace)
    assert got_ok is ok and sorted(lags["k6"])[0] < -4 * MS


def test_a_kernel_without_its_launch_fails_the_clock_check():
    run = _run([r for r in LOG if r[0] != "launch.k6"])
    assert spantree.clock_check(run._span_window, TRACE)[0] is False
    assert spantree.idle_unspanned_pct(run) is None


def test_the_readers_helpers_on_the_synthetic_log():
    run = _run(LOG)
    assert spantree.kind_ms(run, "open", lambda win, r: r[0] == "stats") == 18.0
    assert spantree.window_ms_a_turn(run, "spec.stream") == 25.0
    assert [r[1] for r in spantree.first_in_turns(run, "command.add_tracks")] == [1]
    assert spantree.kind_ms(run, "switch", lambda win, r: True) is None


NEW = ("apply_ms", "add_self_ms", "stream_mips_ms.open", "stream_mips_ms.switch",
       "tile_span_p95_ms.image", "tile_span_p95_ms.region", "tile_span_p95_ms.waveform",
       "region_fetches", "limiter_ms.normalize", "limiter_ms.guard",
       "summary_stats_ms.normalize", "summary_stats_ms.guard", "idle_unspanned_pct.open",
       "idle_unspanned_pct.switch")
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def root(tmp_path, monkeypatch):
    from thesia_tpu_torch import obs

    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")
    yield tiny_root(tmp_path)
    obs.tracing(False)
    obs.span_log()


@pytest.mark.parametrize("workload", CELLS)
def test_the_span_readers_on_the_tiny_cpu_run(root, workload):
    """Every new reader of the cell gives a number, but those the CPU route
    cannot feed: the idle share (no device trace) and the region tiles'
    percentile where no tile of the run was fetched from a region."""
    cell = resolve(workload, True, root)
    new = [m for m in cell.metrics if m in NEW]
    assert new
    result = run_tiny(root, workload, trace=True)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    for m in new:
        if m.startswith("idle_unspanned_pct"):
            assert m not in got
        elif m == "tile_span_p95_ms.region" and got["region_fetches"]["value"] == 0:
            assert m not in got
        else:
            assert got[m]["value"] >= 0, m
    for m in ("apply_ms", "add_self_ms", "tile_span_p95_ms.image", "tile_span_p95_ms.waveform",
              "summary_stats_ms.normalize", "summary_stats_ms.guard", "limiter_ms.normalize"):
        if m in new:
            assert got[m]["value"] > 0, m
    if "apply_ms" in new:
        # the apply's span lies inside the harness's own timing of the call
        assert got["apply_ms"]["value"] <= got["dispatch_ms"]["value"]
