"""The port's span log (``thesia_tpu_torch/obs.py``): off, it logs nothing
and the totals are the original's; on, every span records its id, parent,
root, thread and times, a command is the root of every span it causes on
any thread it hands work to, and a warm job is a root of its own whose parent
is the command that queued it.  A CPU session driven through ``Commands``
yields the expected tree, the split spans and the region-fetch counter;
``profile_trace`` writes the spans into its Chrome trace."""

import asyncio
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from thesia_tpu_torch import obs
from thesia_tpu_torch.engine import images as port_images
from thesia_tpu_torch.engine.images import SpecImageStore
from thesia_tpu_torch.engine.service import Commands, EngineService
from thesia_tpu_torch.engine.session import EngineSession
from thesia_tpu_torch.io.wav import encode_wav_s16
from thesia_tpu_torch.render.colormap import default_colormap_rgba8

CMAP = default_colormap_rgba8().reshape(-1).tolist()
NAME, ID, PARENT, ROOT, THREAD, START, END = range(7)


@pytest.fixture
def traced():
    obs.span_log()
    obs.tracing(True)
    try:
        yield
    finally:
        obs.tracing(False)
        obs.span_log()


def _wav(path, sr, sec, freqs, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * sec)) / sr
    rows = [0.5 * np.sin(2 * np.pi * f * t) + 1e-3 * rng.standard_normal(t.size) for f in freqs]
    path.write_bytes(encode_wav_s16(np.clip(np.stack(rows), -1, 1).astype(np.float32), sr))
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_trace_wavs")
    return [_wav(d / "stereo_8k.wav", 8000, 2.0, (440.0, 550.0), 1),
            _wav(d / "mono_16k.wav", 16000, 1.5, (1000.0,), 2)]


def _call(commands, name, **body):
    status, payload = commands.call(name, body)
    assert status == 200, payload
    return payload


def _session(tmp_path):
    commands = Commands(EngineSession(device="cpu", settings_dir=tmp_path / "settings"))
    _call(commands, "init", colormapRgba=CMAP)
    return commands


def _by_id(log):
    return {r[ID]: r for r in log}


def _ancestors(by_id, rec):
    out = []
    while rec[PARENT] is not None and rec[PARENT] in by_id:
        rec = by_id[rec[PARENT]]
        out.append(rec)
    return out


def test_tracing_off_logs_nothing_and_keeps_the_totals():
    obs.tracing(False)
    obs.span_log()
    obs.reset()
    for _ in range(3):
        with obs.span("stage.x"):
            pass
    with obs.root_span("command.x"):
        obs.mark("launch.k6")
    obs.record("stage.y", 0.25)
    assert obs.span_log() == [] and obs.current() is None
    f = lambda: 1  # noqa: E731
    assert obs.carry(f) is f
    got = obs.summary()
    assert set(got) == {"stage.x", "command.x", "stage.y"}
    assert got["stage.x"]["count"] == 3 and got["command.x"]["count"] == 1
    assert got["stage.y"] == {"count": 1, "total_ms": 250.0, "p50_ms": 250.0, "p95_ms": 250.0,
                              "last_ms": 250.0}
    obs.reset()


def test_ids_parents_and_nesting_on_one_thread(traced):
    obs.reset()
    t0 = time.time_ns()
    with obs.root_span("command.a"):
        with obs.span("outer"):
            with obs.span("inner"):
                obs.mark("launch.k6")
        with obs.root_span("warm.job"):
            with obs.span("warm.inner"):
                pass
    t1 = time.time_ns()
    with obs.span("loose"):
        pass
    log = obs.span_log()
    assert obs.span_log() == []
    by_name = {r[NAME]: r for r in log}
    assert [r[NAME] for r in log] == ["launch.k6", "inner", "outer", "warm.inner", "warm.job",
                                      "command.a", "loose"]
    cmd, outer, inner, mark = (by_name[n] for n in ("command.a", "outer", "inner", "launch.k6"))
    assert cmd[PARENT] is None and cmd[ROOT] == cmd[ID]
    assert outer[PARENT] == cmd[ID] and inner[PARENT] == outer[ID]
    assert mark[PARENT] == inner[ID] and mark[START] == mark[END]
    assert {r[ROOT] for r in (outer, inner, mark)} == {cmd[ID]}
    warm, warm_inner = by_name["warm.job"], by_name["warm.inner"]
    assert warm[PARENT] == cmd[ID] and warm[ROOT] == warm[ID] and warm_inner[ROOT] == warm[ID]
    assert by_name["loose"][PARENT] is None and by_name["loose"][ROOT] == by_name["loose"][ID]
    assert len({r[ID] for r in log}) == len(log)
    assert all(r[THREAD] == threading.current_thread().name for r in log)
    assert t0 <= cmd[START] <= outer[START] <= inner[START] <= inner[END] <= outer[END] \
        <= cmd[END] <= t1
    # the totals see the same spans, the marks not
    assert obs.summary()["inner"]["count"] == 1 and "launch.k6" not in obs.summary()
    obs.reset()


def test_a_raising_span_is_logged_and_restores_its_parent(traced):
    with obs.span("outer"):
        with pytest.raises(ValueError):
            with obs.span("failing"):
                raise ValueError("x")
        with obs.span("after"):
            pass
    log = _by_id(obs.span_log())
    by_name = {r[NAME]: r for r in log.values()}
    assert by_name["failing"][PARENT] == by_name["after"][PARENT] == by_name["outer"][ID]


def test_carry_hands_the_span_to_another_thread(traced):
    seen = []

    def work():
        with obs.span("on.worker"):
            seen.append(threading.current_thread().name)

    with obs.root_span("command.x"):
        t = threading.Thread(target=obs.carry(work), name="helper")
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == ["helper"]
    by_name = {r[NAME]: r for r in obs.span_log()}
    assert by_name["on.worker"][PARENT] == by_name["command.x"][ID]
    assert by_name["on.worker"][ROOT] == by_name["command.x"][ID]
    assert by_name["on.worker"][THREAD] == "helper"


def _open(commands, wavs):
    _call(commands, "add_tracks", trackIds=[0, 1], paths=wavs)
    _call(commands, "apply_track_list_changes")
    commands.session.tm.images.drain(timeout=30)


def _write_worker(commands, wavs, monkeypatch):
    _open(commands, wavs)
    obs.span_log()
    _call(commands, "set_dB_range", dBRange=90.0)
    return {"command.set_dB_range"}, "spec.quantize", "write-lock-worker"


def _settings_switch(commands, wavs, monkeypatch):
    """The deferred switch runs on the switch pool, which hands its write to
    the write worker: the command's tree crosses both."""
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")
    _open(commands, wavs)
    obs.span_log()
    _call(commands, "set_common_normalize", target={"type": "LUFS", "target": -20.0})
    assert commands.session.settings_settled(timeout=30)
    return {"command.set_common_normalize"}, "normalize", "write-lock-worker"


def _prefetch(commands, wavs, monkeypatch):
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer

    monkeypatch.setattr(EngineSession, "_PREFETCH_MIN_FILE_BYTES", 0)
    monkeypatch.setattr(SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    obs.span_log()
    _call(commands, "add_tracks", trackIds=[0, 1], paths=wavs)
    assert commands.session.tm.spec_analyzer.prefetch_adopted == 2
    return {"command.add_tracks"}, "prefetch.upload", "wav-prefetch"


def _streamer(commands, wavs, monkeypatch):
    _call(commands, "add_tracks", trackIds=[0, 1], paths=wavs)
    obs.span_log()
    _call(commands, "apply_track_list_changes")
    assert commands.session.tm.images.drain(timeout=30)
    return {"command.apply_track_list_changes"}, "spec.stream", "spec-image-streamer"


def _warmer(commands, wavs, monkeypatch):
    """The add submits warm jobs from its header probe, the apply the
    neighbouring settings; the warmer runs them after both."""
    monkeypatch.setenv("THESIA_PRECOMPILE", "1")
    obs.span_log()
    _call(commands, "add_tracks", trackIds=[0, 1], paths=wavs)
    _call(commands, "apply_track_list_changes")
    assert commands.session.tm.shape_warmer.drain(timeout=60)
    assert commands.session.tm.images.drain(timeout=30)
    assert commands.session.tm.shape_warmer.job_ms
    return {"command.add_tracks", "command.apply_track_list_changes"}, "warm.", "shape-warmer"


HANDOFFS = {"write_worker": _write_worker, "settings_switch": _settings_switch,
            "prefetch": _prefetch, "streamer": _streamer, "warmer": _warmer}


@pytest.mark.parametrize("handoff", list(HANDOFFS))
def test_a_handoff_keeps_the_commands_tree(handoff, wavs, tmp_path, monkeypatch, traced):
    """The span on the worker thread has the command that handed the work
    over as an ancestor and, but for a warm job, as its root.  A warm job is
    a ``warm.<kind>`` root of its own: readers leave such trees out."""
    commands = _session(tmp_path)
    try:
        roots, name, thread = HANDOFFS[handoff](commands, wavs, monkeypatch)
        log = obs.span_log()
        jobs = commands.session.tm.shape_warmer.job_ms
    finally:
        commands.session.tm.images.shutdown()
    by_id = _by_id(log)
    worker = [r for r in log if r[NAME].startswith(name) and r[THREAD].startswith(thread)]
    assert worker, sorted({(r[NAME], r[THREAD]) for r in log})
    for rec in worker:
        command = by_id[by_id[rec[PARENT]][ROOT]] if name == "warm." else by_id[rec[ROOT]]
        assert command[NAME] in roots and command in _ancestors(by_id, rec)
        assert not command[THREAD].startswith(thread)
        if name == "warm.":
            assert rec[ROOT] == rec[ID] and rec[NAME].removeprefix("warm.") in jobs
    if name == "warm.":
        assert len(worker) == sum(len(ms) for ms in jobs.values())


def test_a_cpu_session_through_commands_yields_the_expected_tree(wavs, tmp_path, monkeypatch,
                                                                 traced):
    """add, apply, a spectrogram tile fetched while the image is still on the
    device (a region fetch), a waveform tile twice (encoded, then cached), a
    normalize turn under the Limiter that drives both tracks over 0 dBFS."""
    gate = threading.Event()
    real = SpecImageStore._stream_one

    def held(self, t):
        gate.wait(timeout=30)
        return real(self, t)

    monkeypatch.setattr(SpecImageStore, "_stream_one", held)
    commands = _session(tmp_path)
    obs.span_log()
    try:
        _call(commands, "set_common_guard_clipping", mode="Limiter")
        _call(commands, "add_tracks", trackIds=[0, 1], paths=wavs)
        _call(commands, "apply_track_list_changes")
        fetches0 = port_images.region_fetches
        _call(commands, "get_spectrogram_tile", idChStr="0_0", levelX=0, levelY=0, tileX=0,
              tileY=0)
        assert port_images.region_fetches == fetches0 + 1
        gate.set()
        assert commands.session.tm.images.drain(timeout=30)
        for _ in range(2):
            _call(commands, "get_waveform_tile", idChStr="0_0", level=0, tileIndex=0)
        _call(commands, "set_common_normalize", target={"type": "LUFS", "target": 2.0})
        log = obs.span_log()
    finally:
        gate.set()
        commands.session.tm.images.shutdown()
    by_id = _by_id(log)
    roots = {r[ID]: r for r in log if r[ROOT] == r[ID] and r[START] < r[END]}
    names = [r[NAME] for r in sorted(roots.values(), key=lambda r: r[START])]
    assert names == ["command.set_common_guard_clipping", "command.add_tracks",
                     "command.apply_track_list_changes", "command.get_spectrogram_tile",
                     "command.get_waveform_tile", "command.get_waveform_tile",
                     "command.set_common_normalize"]

    def under(root_name, k=0):
        root = [r for r in roots.values() if r[NAME] == root_name][k]
        return {r[NAME] for r in log if r[ROOT] == root[ID] and r is not root}

    assert {"decode", "stats.batched", "normalize", "spec.recompute"} <= \
        under("command.add_tracks")
    assert {"spec.quantize", "spec.quantize.range", "spec.quantize.k6",
            "spec.quantize.evict", "spec.stream", "spec.stream.copy",
            "spec.stream.mips"} <= under("command.apply_track_list_changes")
    assert {"tile.spectrogram_encode", "tile.region_d2h"} <= under("command.get_spectrogram_tile")
    assert under("command.get_waveform_tile", 0) == {"tile.waveform_encode"}
    assert under("command.get_waveform_tile", 1) == set()  # a cache hit
    turn = under("command.set_common_normalize")
    assert {"normalize", "guard.limiter", "gain_apply", "guard_clipping",
            "guard_clipping.Limiter", "spec.recompute", "spec.quantize"} <= turn
    limiter = next(r for r in log if r[NAME] == "guard.limiter")
    assert by_id[limiter[PARENT]][NAME] == "normalize"
    for r in log:
        if r[NAME] in ("spec.stream.copy", "spec.stream.mips"):
            assert by_id[r[PARENT]][NAME] == "spec.stream"
        if r[NAME].startswith("guard_clipping."):
            assert by_id[r[PARENT]][NAME] == "guard_clipping"
        if r[NAME] == "tile.region_d2h":
            assert by_id[r[PARENT]][NAME] == "tile.spectrogram_encode"


def test_the_metrics_route_shows_warm_jobs_and_region_fetches(wavs, tmp_path):
    commands = _session(tmp_path)
    try:
        resp = asyncio.run(EngineService(commands.session).handle_metrics(None))
    finally:
        commands.session.tm.images.shutdown()
    out = json.loads(resp.body)["result"]
    assert out["warm_jobs"] == {} and out["region_fetches"] == port_images.region_fetches
    assert out["command.init"]["count"] >= 1


def test_profile_trace_writes_the_spans_beside_the_host_events():
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            with obs.root_span("command.busy"):
                with obs.span("busy.inner"):
                    time.sleep(0.005)

    t = threading.Thread(target=busy, name="busy-thread")
    t.start()
    try:
        out = Path(obs.profile_trace(150.0))
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    try:
        trace = json.loads((out / "trace.json").read_text())
    finally:
        shutil.rmtree(out)
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    inner = [e for e in spans if e["name"] == "busy.inner"]
    assert inner and all(e["tid"] == t.native_id and e["ph"] == "X" for e in inner)
    ids = {e["args"]["id"] for e in spans}
    assert all(e["args"]["parent"] in ids for e in inner if e["args"]["parent"] is not None)
    # tracing is off again: only spans open when the capture ended log later
    assert not obs._tracing
    assert {r[NAME] for r in obs.span_log()} <= {"command.busy", "busy.inner"}
