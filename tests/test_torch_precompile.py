"""The port's shape warmer (thesia_tpu_torch/dsp/precompile.py), its device
warmup (runtime.device_warmup) and header probe (io/probe.py), against the
JAX package's where both have the function: every case of
tests/test_precompile.py, on the CPU (``device="cpu"``), plus the session's
hooks.  The control logic is pinned statement for statement in
tests/test_torch_hostcopies.py; here it runs.  conftest.py turns the warmer
off; the cases that need it on set THESIA_PRECOMPILE=1 with monkeypatch.
Cases marked gpu run the warm on a card and skip without one."""

import hashlib
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from thesia_tpu.common.freqscale import FreqScale as JaxFreqScale
from thesia_tpu.dsp import precompile as jax_precompile
from thesia_tpu.dsp.framing import SpecSetting as JaxSpecSetting
from thesia_tpu.io import probe as jax_probe
from thesia_tpu_torch import runtime
from thesia_tpu_torch.common.freqscale import FreqScale
from thesia_tpu_torch.dsp import precompile
from thesia_tpu_torch.dsp.framing import SpecSetting
from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer
from thesia_tpu_torch.engine.manager import TrackManager
from thesia_tpu_torch.engine.session import EngineSession
from thesia_tpu_torch.engine.track import TrackList
from thesia_tpu_torch.io import probe as port_probe
from thesia_tpu_torch.io.wav import encode_wav_s16
from thesia_tpu_torch.render.colormap import default_colormap_rgba8

CPU = torch.device("cpu")
CMAP = default_colormap_rgba8().reshape(-1).tolist()
LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}
WIN20 = {"winMillisec": 20.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}


@pytest.fixture
def warm_on(monkeypatch):
    monkeypatch.setenv("THESIA_PRECOMPILE", "1")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(settings):
    return [(s.win_ms, s.t_overlap, s.f_overlap, s.freq_scale.value) for s in settings]


# -- neighbour settings: the JAX package's, for the same inputs


SETTINGS = [
    (win_ms, t, scale)
    for win_ms in (10.0, 20.0, 30.0, 40.0, 80.0, 100.0)
    for t in (1, 3, 4, 32)
    for scale in ("Mel", "Linear")
]


@pytest.mark.parametrize("win_ms,t_overlap,scale", SETTINGS)
def test_neighbor_settings_are_the_jax_packages(win_ms, t_overlap, scale):
    port = precompile.neighbor_settings(
        SpecSetting(win_ms=win_ms, t_overlap=t_overlap, freq_scale=FreqScale(scale)))
    jax = jax_precompile.neighbor_settings(
        JaxSpecSetting(win_ms=win_ms, t_overlap=t_overlap, freq_scale=JaxFreqScale(scale)))
    assert _keys(port) == _keys(jax)
    for values in (precompile.T_OVERLAP_VALUES, precompile.WIN_MS_PRESETS):
        for v in (values[0] - 1, values[0], values[-1], values[-1] * 2, win_ms, t_overlap):
            assert precompile._detent_index(values, v) == jax_precompile._detent_index(values, v)


def test_neighbor_settings_cover_knobs():
    keys = {(s.win_ms, s.t_overlap, s.freq_scale) for s in precompile.neighbor_settings(SpecSetting())}
    assert (40.0, 1, FreqScale.Mel) in keys
    assert (40.0, 32, FreqScale.Mel) in keys
    assert (40.0, 4, FreqScale.Linear) in keys
    assert (20.0, 4, FreqScale.Mel) in keys
    assert (40.0, 4, FreqScale.Mel) not in keys


def test_neighbor_settings_nearest_knob_first():
    keys = [(s.win_ms, s.t_overlap, s.freq_scale) for s in precompile.neighbor_settings(SpecSetting())]
    tier1 = set(keys[:5])
    assert tier1 == {(40.0, 2, FreqScale.Mel), (40.0, 8, FreqScale.Mel), (20.0, 4, FreqScale.Mel),
                     (80.0, 4, FreqScale.Mel), (40.0, 4, FreqScale.Linear)}
    for far in ((40.0, 32, FreqScale.Mel), (40.0, 1, FreqScale.Mel), (10.0, 4, FreqScale.Mel)):
        assert keys.index(far) > 4
    assert len(keys) == len(set(keys)) == 9


def test_neighbor_settings_edge_detents():
    ns = precompile.neighbor_settings(SpecSetting(t_overlap=1, win_ms=10.0))
    tier1 = {(s.win_ms, s.t_overlap, s.freq_scale) for s in ns[:5]}
    assert {(10.0, 2, FreqScale.Mel), (10.0, 4, FreqScale.Mel), (20.0, 1, FreqScale.Mel),
            (40.0, 1, FreqScale.Mel)} <= tier1


# -- the warmer's control logic


def test_spec_groups_job_warms_what_the_engine_reads(warm_on):
    """The group job builds every distinct group's tables where the engine's
    calc_spec_multi looks for them, and the real call then reuses them."""
    an = SpectrogramAnalyzer(CPU)
    items = [(0, (2, 48000), 16000), (1, (1, 48000), 16000), (2, (1, 30000), 8000)]
    setting = SpecSetting()
    key, _run = precompile.spec_groups_job(an, items, setting)()
    assert key[0] == "spec_groups" and len(key[1]) == 2  # two sample rates
    w = precompile.ShapeWarmer()
    w.submit([precompile.spec_groups_job(an, items, setting)])
    assert w.drain(timeout=60.0)
    assert w.compiled_count == 1 and w.failed_count == 0
    cached = {sr: (an.window(*setting.calc_framing_params(sr)[1:]),
                   an.mel_fb(sr, setting.calc_framing_params(sr)[2])) for sr in (8000, 16000)}
    assert len(an._windows) == 2 and len(an._mel_fbs) == 2
    wavs = np.random.default_rng(0).uniform(-0.5, 0.5, (1, 30000)).astype(np.float32)
    res = an.calc_spec_multi(wavs, 8000, setting, cache_key=2, token=1)
    assert res.n_frames > 0
    hop, win, n_fft = setting.calc_framing_params(8000)
    assert an.window(win, n_fft) is cached[8000][0] and an.mel_fb(8000, n_fft) is cached[8000][1]


def test_warmer_supersede_and_dedup(warm_on):
    an = SpectrogramAnalyzer(CPU)
    job = precompile.spec_groups_job(an, [(0, (1, 30000), 8000), (1, (1, 9000), 8000)],
                                     SpecSetting(t_overlap=8))
    w = precompile.ShapeWarmer()
    w.submit([job])
    assert w.drain(timeout=60.0)
    n = w.compiled_count
    w.submit([job])  # the same key: no second run
    assert w.drain(timeout=60.0)
    assert w.compiled_count == n == 1
    # a newer submission supersedes the pending one between jobs
    started, release = [], threading.Event()

    def slow(i):
        def make():
            def run():
                started.append(i)
                release.wait(timeout=10)
            return (f"slow{i}", run)
        return make

    w.submit([slow(0), slow(1), slow(2)])
    t0 = time.time()
    while not started and time.time() - t0 < 5:
        time.sleep(0.01)
    w.submit([slow(9)])
    release.set()
    assert w.drain(timeout=10)
    assert started == [0, 9]


def test_disabled_by_env(monkeypatch):
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    assert not precompile.enabled()
    w = precompile.ShapeWarmer()
    w.submit([lambda: (_ for _ in ()).throw(RuntimeError)])
    assert w.drain(timeout=1.0)
    assert w.compiled_count == w.failed_count == 0
    assert w._thread is None


def test_a_failing_job_counts_and_warns(warm_on, caplog):
    def bad_run():
        raise RuntimeError("device lost")

    def bad_make():
        raise ValueError("no header")

    w = precompile.ShapeWarmer()
    with caplog.at_level("WARNING"):
        w.submit([lambda: ("bad", bad_run), bad_make, lambda: None, lambda: ("good", lambda: None)])
        assert w.drain(timeout=10)
    assert w.failed_count == 2 and w.compiled_count == 1
    assert sum("shape warm" in r.getMessage() for r in caplog.records) == 2


def test_warmer_interactive_pauses_job_starts(warm_on):
    w = precompile.ShapeWarmer()
    started, release = [], threading.Event()

    def slow_job(i):
        def make():
            def run():
                started.append(i)
                release.wait(timeout=10)
            return (f"job{i}", run)
        return make

    with w.interactive():
        w.submit([slow_job(0), slow_job(1)])
        time.sleep(0.3)
        assert started == []
    t0 = time.time()
    while not started and time.time() - t0 < 5:
        time.sleep(0.02)
    assert started == [0]
    with w.interactive():
        release.set()
        time.sleep(0.3)
        assert started == [0]
    assert w.drain(timeout=10)
    assert started == [0, 1]


def test_the_idle_warmer_exits_and_a_later_submit_restarts_it(warm_on, monkeypatch):
    w = precompile.ShapeWarmer()
    ran = []
    w.submit([lambda: ("a", lambda: ran.append("a"))])
    assert w.drain(timeout=10)
    t = w._thread
    t.join(timeout=10)  # idle exit after 5 s clears the handle
    assert not t.is_alive() and w._thread is None
    w.submit([lambda: ("b", lambda: ran.append("b"))])
    assert w.drain(timeout=10) and ran == ["a", "b"]


def test_jobs_wait_for_the_device_warmup(warm_on, monkeypatch):
    """On a card the jobs start once runtime.warmup_done(); until then the
    warmer (re)starts the background warmup and consumes no job."""
    state = {"done": False, "kicks": 0}
    monkeypatch.setattr(runtime, "warmup_done", lambda device="cuda": state["done"])

    def kick(background=False, device="cuda"):
        state["kicks"] += 1
        if state["kicks"] >= 2:
            state["done"] = True

    monkeypatch.setattr(runtime, "device_warmup", kick)
    w = precompile.ShapeWarmer()
    ran = []
    w.submit([lambda: ("a", lambda: ran.append(state["done"]))])
    assert w.drain(timeout=10)
    assert ran == [True] and state["kicks"] == 2


def test_warm_for_pending_add_submits_current_setting_first(warm_on, monkeypatch):
    """Mirrors the JAX case: the current setting's spectrogram job comes
    first (the single-track job for a lone add, the group job for several),
    then the neighbours, nearest knob first."""
    tm = TrackManager(CPU)
    tm.set_colormap_length(TrackList(CPU), 258)
    captured = []
    monkeypatch.setattr(tm.shape_warmer, "submit", lambda jobs: captured.append(list(jobs)))
    tm.warm_for_pending_add([], [("x.wav", (1, 48000), 16000)])
    keys = [make()[0] for make in captured.pop()]
    assert keys[0] == ("spec_full", precompile._spec_statics(16000, tm.setting), None)
    neighbours = precompile.neighbor_settings(tm.setting)
    assert keys[1:] == [("spec_full", precompile._spec_statics(16000, s), None) for s in neighbours]
    tm.warm_for_pending_add([], [("x.wav", (1, 48000), 16000), ("y.wav", (2, 48000), 16000)])
    assert captured.pop()[0]()[0][0] == "spec_groups"
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    tm.warm_for_pending_add([], [("x.wav", (1, 48000), 16000)])
    assert captured == []


def test_spec_full_job_runs_the_real_program(warm_on):
    an = SpectrogramAnalyzer(CPU)
    setting = SpecSetting(t_overlap=2)
    w = precompile.ShapeWarmer()
    w.submit([precompile.spec_full_job(an, (1, 50000), 8000, setting),
              precompile.spec_full_job(an, (1, 10), 8000, setting)])  # no frames: nothing
    assert w.drain(timeout=60.0)
    assert w.compiled_count == 1 and w.failed_count == 0
    wavs = np.random.default_rng(1).uniform(-0.5, 0.5, (1, 50000)).astype(np.float32)
    assert an.calc_spec_multi(wavs, 8000, setting, cache_key="sfj", token=0).n_frames > 0


def test_rfft_settings_warm_the_rfft_route(warm_on, monkeypatch):
    import thesia_tpu_torch.dsp.spectrogram as port_spec

    monkeypatch.setattr(port_spec, "_DFT_MAT_MAX_BYTES", 1024)
    an = SpectrogramAnalyzer(CPU)
    key, run = precompile.spec_full_job(an, (1, 20000), 8000, SpecSetting())()
    assert key[1][-1] is True  # the rfft route
    run()


# -- the device warmup's thread semantics


@pytest.fixture
def fresh_runtime(monkeypatch):
    monkeypatch.setattr(runtime, "_done", False)
    monkeypatch.setattr(runtime, "_thread", None)
    monkeypatch.setattr(runtime, "resolve_device", lambda d: torch.device("cuda", 0))


def test_device_warmup_costs_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(precompile, "warm_device", lambda d: pytest.fail("warmed the CPU"))
    runtime.device_warmup(device="cpu")
    runtime.device_warmup(background=True, device="cpu")
    assert runtime.warmup_done("cpu")


def test_device_warmup_retries_after_a_failure(fresh_runtime, monkeypatch, caplog):
    calls = []

    def warm(device):
        calls.append((device, runtime.is_warming(), threading.current_thread().name))
        if len(calls) == 1:
            raise RuntimeError("transient")

    monkeypatch.setattr(precompile, "warm_device", warm)
    with caplog.at_level("WARNING"):
        runtime.device_warmup(device="cuda")
    assert not runtime.warmup_done() and runtime._thread is None
    assert any("will retry" in r.getMessage() for r in caplog.records)
    runtime.device_warmup(device="cuda")
    assert runtime.warmup_done() and len(calls) == 2
    assert calls[1] == (torch.device("cuda", 0), True, "device-warmup")
    runtime.device_warmup(device="cuda")  # done: no third run
    assert len(calls) == 2


def test_a_foreground_warmup_joins_the_background_thread(fresh_runtime, monkeypatch):
    gate, calls = threading.Event(), []

    def warm(device):
        calls.append(device)
        gate.wait(timeout=10)

    monkeypatch.setattr(precompile, "warm_device", warm)
    runtime.device_warmup(background=True, device="cuda")
    t = runtime._thread
    assert t is not None and t.is_alive() and not runtime.warmup_done()
    runtime.device_warmup(background=True, device="cuda")  # the same thread
    assert runtime._thread is t
    threading.Timer(0.2, gate.set).start()
    runtime.device_warmup(device="cuda")  # joins
    assert runtime.warmup_done() and not t.is_alive() and len(calls) == 1


def test_the_warmup_waits_while_a_command_runs(fresh_runtime, monkeypatch, tmp_path):
    """warm_device yields between its steps to a foreground command (the
    session's writes enter runtime.foreground())."""
    steps = []

    def warm(device):
        runtime.yield_to_foreground()
        steps.append(device)

    monkeypatch.setattr(precompile, "warm_device", warm)
    with runtime.foreground():
        runtime.device_warmup(background=True, device="cuda")
        time.sleep(0.3)
        assert steps == [] and not runtime.warmup_done()
    runtime.device_warmup(device="cuda")  # joins
    assert len(steps) == 1 and runtime.warmup_done()
    sess = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    assert sess._write(lambda: runtime._foreground_depth) == 1
    assert runtime._foreground_depth == 0


# -- the session's hooks


def _wavs(tmp_path, specs, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for name, sr, ch, sec in specs:
        w = np.clip(0.3 * rng.standard_normal((ch, int(sr * sec))), -1, 1).astype(np.float32)
        (tmp_path / name).write_bytes(encode_wav_s16(w, sr))
        paths.append(str(tmp_path / name))
    return paths


def _images_hash(sess) -> str:
    imgs = sess.tm.spec_imgs
    h = hashlib.sha256()
    for k in sorted(imgs):
        h.update(np.ascontiguousarray(imgs[k]).tobytes())
    return h.hexdigest()


def _drive(sess, paths, defer):
    out = []
    sess.init(CMAP)
    sess.add_tracks([0, 1], paths)
    sess.apply_track_list_changes(defer=defer)
    assert sess.settings_settled(timeout=120)
    out.append(_images_hash(sess))
    for setting in (LINEAR, WIN20):
        sess.set_spec_setting(setting, defer=defer)
        assert sess.settings_settled(timeout=120)
        out.append(_images_hash(sess))
    return out


@pytest.mark.parametrize("defer", [False, True], ids=["sync", "deferred"])
def test_warmed_sessions_land_bit_equal_images(tmp_path, monkeypatch, defer):
    paths = _wavs(tmp_path, [("a.wav", 8000, 2, 3.0), ("b.wav", 16000, 1, 2.0)])
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    cold = EngineSession(device="cpu", settings_dir=tmp_path / "cold")
    want = _drive(cold, paths, defer)
    assert cold.tm.shape_warmer.compiled_count == 0
    monkeypatch.setenv("THESIA_PRECOMPILE", "1")
    warm = EngineSession(device="cpu", settings_dir=tmp_path / "warm")
    got = _drive(warm, paths, defer)
    assert warm.tm.shape_warmer.drain(timeout=120)
    assert got == want
    assert warm.tm.shape_warmer.compiled_count > 0 and warm.tm.shape_warmer.failed_count == 0
    for s in (cold, warm):
        s.tm.images.shutdown()


def test_the_deferred_switch_warms_its_setting_off_the_write_lock(tmp_path, warm_on, monkeypatch):
    sess = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    sess.init(CMAP)
    sess.add_tracks([0], _wavs(tmp_path, [("a.wav", 8000, 1, 2.0)]))
    sess.apply_track_list_changes(defer=False)
    seen = []
    orig = sess._precompile_setting

    def spy(setting, gen):
        seen.append((setting, sess.rw._writer))
        orig(setting, gen)

    monkeypatch.setattr(sess, "_precompile_setting", spy)
    sess.set_spec_setting(WIN20, defer=True)
    assert sess.settings_settled(timeout=60)
    assert [s.to_json() for s, _w in seen] == [WIN20] and seen[0][1] is False
    hop, win, n_fft = SpecSetting.from_json(WIN20).calc_framing_params(8000)
    assert (win, n_fft, sess.tm.spec_analyzer.device) in sess.tm.spec_analyzer._windows
    sess.set_spec_setting(LINEAR, defer=False)  # synchronous: no warm phase
    assert len(seen) == 1
    sess.tm.images.shutdown()


def test_warm_from_headers_under_a_concurrent_remove(tmp_path, warm_on, monkeypatch):
    """The header warm snapshots the tracklist under the read lock while
    another client's remove_tracks runs; neither fails, and the warm items
    hold only tracks that existed at the snapshot."""
    sess = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    sess.init(CMAP)
    paths = _wavs(tmp_path, [(f"t{i}.wav", 8000, 1, 1.0) for i in range(6)])
    sess.add_tracks(list(range(5)), paths[:5])
    submitted = []
    monkeypatch.setattr(sess.tm, "warm_for_pending_add",
                        lambda existing, probed: submitted.append((existing, probed)))
    errors = []

    def remover():
        try:
            for tid in range(5):
                sess.remove_tracks([tid])
        except Exception as e:  # pragma: no cover - the failure being tested
            errors.append(e)

    t = threading.Thread(target=remover)
    t.start()
    for _ in range(20):
        sess._warm_from_headers([paths[5]])
    t.join(timeout=60)
    assert not errors and len(submitted) == 20
    for existing, probed in submitted:
        assert probed == [(paths[5], (1, 8000), 8000)]
        assert {tid for tid, _s, _sr in existing} <= set(range(5))
    sess.tm.images.shutdown()


def test_init_supersedes_the_old_warmer(tmp_path, warm_on, monkeypatch):
    sess = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    sess.init(CMAP)
    sess.add_tracks([0], _wavs(tmp_path, [("a.wav", 8000, 1, 1.0)]))
    old = sess.tm
    submits = []
    monkeypatch.setattr(old.shape_warmer, "submit", lambda jobs: submits.append(list(jobs)))
    sess.init(CMAP)
    assert submits == [[]] and sess.tm is not old
    sess.tm.images.shutdown()


def test_debug_metrics_report_the_warmer(tmp_path, warm_on):
    import asyncio

    from thesia_tpu_torch.engine.service import EngineService

    svc = EngineService(EngineSession(device="cpu", settings_dir=tmp_path / "cfg"))
    svc.session.init(CMAP)
    svc.session.add_tracks([0], _wavs(tmp_path, [("a.wav", 8000, 1, 1.0)]))
    assert svc.session.tm.shape_warmer.drain(timeout=60)
    import json

    body = json.loads(asyncio.run(svc.handle_metrics(None)).body)["result"]
    warmer = body["shape_warmer"]
    assert set(warmer) == {"compiled", "idle", "failed"}
    assert warmer["compiled"] > 0 and warmer["idle"] is True and warmer["failed"] == 0
    assert set(body["warm_kernel_launches"]) == set(body["kernel_launches"])
    svc.session.tm.images.shutdown()


# -- the header probe, through both modules


def _probe_both(path):
    got = port_probe.probe_shape(path)
    assert got == jax_probe.probe_shape(path)
    return got


def test_probe_shape_wav_and_flac(tmp_path, samples_dir):
    w = np.zeros((2, 12345), np.float32)
    p = tmp_path / "probe.wav"
    p.write_bytes(encode_wav_s16(w, 22050))
    assert _probe_both(p) == (2, 12345, 22050)
    flac = samples_dir / "sample_44k1.flac"
    if flac.exists():
        from thesia_tpu_torch.io.decode import open_audio_file

        wavs, info = open_audio_file(flac)
        assert _probe_both(flac) == (wavs.shape[0], wavs.shape[1], info.sr)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00" * 64)
    assert _probe_both(bad) is None
    assert _probe_both(tmp_path / "missing.wav") is None


def _box(name, payload):
    return (8 + len(payload)).to_bytes(4, "big") + name + payload


def _trak(kind, timescale, duration):
    hdlr = _box(b"hdlr", b"\x00" * 8 + kind + b"\x00" * 13)
    mdhd = _box(b"mdhd", b"\x00" * 12 + timescale.to_bytes(4, "big")
                + duration.to_bytes(4, "big") + b"\x00" * 4)
    return _box(b"trak", _box(b"mdia", hdlr + mdhd))


def test_probe_m4a_skips_video_trak():
    video_first = _box(b"moov", _trak(b"vide", 90000, 90000 * 7) + _trak(b"soun", 44100, 44100 * 7))
    for mod in (port_probe, jax_probe):
        _n_ch, duration, sr = mod._probe_m4a(video_first)
        assert (sr, duration) == (44100, 44100 * 7)
        assert mod._probe_m4a(_box(b"moov", _trak(b"vide", 90000, 90000))) is None


def test_probe_shape_compressed_containers(samples_dir):
    from thesia_tpu_torch.io.decode import open_audio_file

    root = pathlib.Path(__file__).resolve().parent
    cases = [samples_dir / "sample_44k1.mp3", samples_dir / "sample_44k1-aac.m4a",
             samples_dir / "sample_44k1-alac.m4a", root / "fixtures" / "fixture_vorbis.ogg",
             root / "fixtures" / "fixture_opus.ogg"]
    checked = 0
    for path in cases:
        if not path.exists():
            continue
        got = _probe_both(path)
        assert got is not None, path
        n_ch, n, sr = got
        wavs, info = open_audio_file(path)
        assert n_ch == wavs.shape[0] and sr == info.sr, path
        assert abs(n - wavs.shape[1]) / wavs.shape[1] < 0.01, path
        if path.suffix == ".ogg":
            assert n == wavs.shape[1], path
        checked += 1
    assert checked >= 2  # the two Ogg fixtures are in the repository


@pytest.mark.parametrize("mutation", ["truncated", "zero_channels", "garbage_after_magic"])
def test_probe_of_malformed_headers_agrees(tmp_path, mutation):
    good = encode_wav_s16(np.zeros((1, 1000), np.float32), 8000)
    data = {"truncated": good[:30], "zero_channels": good[:22] + b"\x00\x00" + good[24:],
            "garbage_after_magic": good[:12] + b"\xff" * 64}[mutation]
    p = tmp_path / "m.wav"
    p.write_bytes(data)
    _probe_both(p)


# -- on the card


@pytest.mark.gpu
def test_the_device_warmup_launches_every_program_counted_apart(cuda):
    from thesia_tpu_torch.dsp import upload
    from thesia_tpu_torch.dynamics import stats_device
    from thesia_tpu_torch.kernels import pcm, spec_db

    for reset in (spec_db.reset_launches, pcm.reset_launches, stats_device.reset_launches,
                  upload.reset_counters):
        reset()
    with runtime.warming():
        precompile.warm_device(cuda)
    assert spec_db.spec_db.launches == {"mel": 0, "linear": 0}
    assert spec_db.spec_db.warm_launches == {"mel": 2, "linear": 2}
    assert pcm.deinterleave_flat.launches == pcm.deinterleave_s24.launches == 0
    assert pcm.deinterleave_flat.warm_launches == 2 and pcm.deinterleave_s24.warm_launches == 1
    assert stats_device.lufs_stats_batched.launches == 0
    assert stats_device.lufs_stats_batched.warm_launches == 2
    assert stats_device.limiter_gain_seqs_batched.warm_launches == 1
    assert upload.counters == {"uploads": 0, "bytes": 0} and not upload.history
    assert upload.warm_counters["uploads"] >= 4


@pytest.mark.gpu
def test_a_warmed_session_on_the_card_lands_bit_equal_images(cuda, tmp_path, monkeypatch):
    paths = _wavs(tmp_path, [("a.wav", 48000, 2, 4.0), ("b.wav", 16000, 1, 3.0)])
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    cold = EngineSession(settings_dir=tmp_path / "cold")
    want = _drive(cold, paths, True)
    monkeypatch.setenv("THESIA_PRECOMPILE", "1")
    runtime.device_warmup()
    warm = EngineSession(settings_dir=tmp_path / "warm")
    got = _drive(warm, paths, True)
    assert warm.tm.shape_warmer.drain(timeout=120)
    assert got == want and warm.tm.shape_warmer.failed_count == 0
    assert warm.tm.shape_warmer.compiled_count > 0
    for s in (cold, warm):
        s.tm.images.shutdown()

