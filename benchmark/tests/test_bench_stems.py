"""The readers of the five-stem session's metrics, ``decode_pool_ms`` and
``stats_group_tracks``, on hand-made span totals and K9 launch records, and
a reading of None where the program has neither (a program without the
``decode.pool`` span or the ``stats_device.group_log`` record)."""

from types import SimpleNamespace

import pytest

from bench_tiny import ROOT
from benchmark.harness.cells import load_reader
from benchmark.harness.readers import Run

MS = 1_000_000
T0 = 50_000 * MS


def _turn(kind, a_ms, b_ms):
    return SimpleNamespace(kind=kind, phases=[(f"{kind}.add_tracks", T0 + a_ms * MS, None),
                                              (f"{kind}.remove", T0 + (b_ms - 1) * MS,
                                               T0 + b_ms * MS)])


def _run(spans, turns):
    return Run(setup_s=1.0, window_s=1.0, turns=turns, tile_ms=[], spans=spans, tracks=[],
               states=[])


def test_decode_pool_ms_is_the_pools_wall_time_an_open():
    reader = load_reader(ROOT, "decode_pool_ms")
    turns = [_turn("open", 0, 100), _turn("open", 100, 200)]
    run = _run({"decode.pool": {"count": 2, "total_ms": 500.0},
                "decode": {"count": 10, "total_ms": 2200.0}}, turns)
    assert reader.UNIT == "ms" and reader.read(run) == pytest.approx(250.0)
    # the parent: per-thread decode spans and no pool span
    assert reader.read(_run({"decode": {"count": 10, "total_ms": 2200.0}}, turns)) is None


@pytest.fixture
def group_log(monkeypatch):
    from thesia_tpu_torch.dynamics import stats_device

    log = []
    monkeypatch.setattr(stats_device, "group_log", log)
    return log


def test_stats_group_tracks_counts_the_engines_launches_in_the_opens(group_log):
    reader = load_reader(ROOT, "stats_group_tracks")
    turns = [_turn("open", 0, 100), _turn("open", 100, 200)]
    group_log += [
        (T0 - 5 * MS, 5, False),  # set-up, before the window
        (T0 + 10 * MS, 5, False),
        (T0 + 20 * MS, 3, True),  # a warmer's launch
        (T0 + 120 * MS, 5, False),
        (T0 + 130 * MS, 1, False),
        (T0 + 250 * MS, 2, False),  # after the window
    ]
    assert reader.UNIT == "tracks" and reader.read(_run({}, turns)) == pytest.approx(11 / 3)
    # turns of another kind are not opens
    assert reader.read(_run({}, [_turn("spec", 0, 200)])) is None


def test_stats_group_tracks_reads_none_without_a_launch_or_the_record(group_log, monkeypatch):
    from thesia_tpu_torch.dynamics import stats_device

    reader = load_reader(ROOT, "stats_group_tracks")
    turns = [_turn("open", 0, 100)]
    group_log.append((T0 + 10 * MS, 2, True))
    assert reader.read(_run({}, turns)) is None
    monkeypatch.delattr(stats_device, "group_log")
    assert reader.read(_run({}, turns)) is None
