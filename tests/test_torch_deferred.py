"""The port's deferred engine against the JAX package's, on the CPU.

1. tests/test_deferred_apply.py's eleven scenarios run through the JAX
   EngineSession and the port's EngineSession(device="cpu"), both with
   defer=True, on the same seeded tones.  Once both settle: the return values
   and metadata are equal, the images agree within the tests/torch_parity.py
   u16 contract, and the port's deferred images are bit-equal to its own
   synchronous run of the same steps.
2. tests/test_session.py's deferred cases on the port (the switch has no
   compile phase, so where the JAX test holds the compile, this one holds the
   switch worker or the write itself).
3. isComputing while a switch is pending or an image streams, and the epoch
   early exit: a range pass between a deferred apply's dispatch and its
   reconcile means the probe never runs (the JAX package probes anyway)."""

import concurrent.futures
import threading
import time

import numpy as np
import pytest

from test_torch_session import _check_images, _check_range
from thesia_tpu.engine import session as jax_session
from thesia_tpu.io.wav import encode_wav_f32, encode_wav_s16
from thesia_tpu_torch.engine import images as port_images
from thesia_tpu_torch.engine import session as port_session
from thesia_tpu_torch.render.colormap import default_colormap_rgba8

CMAP = default_colormap_rgba8()


def _write_tone(path, peak, sr=16000, sec=0.6, hz=440.0):
    t = np.arange(int(sr * sec), dtype=np.float64) / sr
    w = (peak * np.sin(2 * np.pi * hz * t)).astype(np.float32)[None, :]
    path.write_bytes(encode_wav_s16(w, sr))
    return str(path)


@pytest.fixture()
def corpus(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    return {
        "quiet": _write_tone(d / "quiet.wav", 0.1),
        "loud": _write_tone(d / "loud.wav", 0.98, hz=1337.0),
        "quiet2": _write_tone(d / "quiet2.wav", 0.1),  # same content as quiet
        "loud2": _write_tone(d / "loud2.wav", 0.98, hz=1337.0),  # same as loud
        "medium": _write_tone(d / "medium.wav", 0.5, hz=777.0),
    }


class _Maker:
    """Sessions of one implementation, each in its own settings dir."""

    def __init__(self, kind, tmp_path):
        self.kind = kind
        self.tmp_path = tmp_path

    def __call__(self, name):
        d = self.tmp_path / f"{self.kind}_{name}"
        d.mkdir()
        if self.kind == "jax":
            s = jax_session.EngineSession(settings_dir=d)
        else:
            s = port_session.EngineSession(device="cpu", settings_dir=d)
        s.init(CMAP)
        return s


def _hold_pool(s):
    """Queue a blocker on the switch pool; returns the event that frees it."""
    gate = threading.Event()
    s._spec_switch_pool.submit(gate.wait, 30)
    return gate


# -- the eleven scenarios: each returns (return values, deferred session,
#    synchronous session that took the same steps)

def sc_range_moved(mk, c):
    d, s = mk("d"), mk("s")
    for sess in (d, s):
        sess.add_tracks([0], [c["quiet"]])
        sess.apply_track_list_changes(defer=False)
        sess.add_tracks([1], [c["loud"]])
    out = [d.apply_track_list_changes(defer=True)]
    assert out[0] == ["1_0"]  # the old row follows via the reconcile
    assert d.settings_settled(timeout=60)
    out.append(s.apply_track_list_changes(defer=False))
    assert out[1] == ["0_0", "1_0"]
    return out, d, s


def sc_unmoved_skips_requantize(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    d.add_tracks([1], [c["quiet2"]])
    out = [d.apply_track_list_changes(defer=True)]
    rev = d.get_audio_render_metadata("0_0")["spectrogramRevision"]
    assert d.settings_settled(timeout=60)
    assert d.get_audio_render_metadata("0_0")["spectrogramRevision"] == rev
    s.add_tracks([0], [c["quiet"]])
    s.apply_track_list_changes(defer=False)
    s.add_tracks([1], [c["quiet2"]])
    out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_remove_shrinks_range(mk, c):
    d, s = mk("d"), mk("s")
    for sess in (d, s):
        sess.add_tracks([0, 1], [c["quiet"], c["loud"]])
        sess.apply_track_list_changes(defer=False)
        sess.remove_tracks([1])
    out = [d.apply_track_list_changes(defer=True)]
    assert out[0] == []
    assert d.settings_settled(timeout=60)
    out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_pending_reports_is_computing(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    assert d.tm.images.drain(timeout=30)
    d.add_tracks([1], [c["loud"]])
    gate = _hold_pool(d)
    try:
        out = [d.apply_track_list_changes(defer=True)]
        assert d.spec_switch_pending()
        assert d.get_audio_render_metadata("0_0")["isComputing"]
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    assert not d.spec_switch_pending()
    assert d.tm.images.drain(timeout=30)
    assert not d.get_audio_render_metadata("0_0")["isComputing"]
    s.add_tracks([0], [c["quiet"]])
    s.apply_track_list_changes(defer=False)
    s.add_tracks([1], [c["loud"]])
    out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_superseded_by_sync_range_pass(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    d.add_tracks([1], [c["loud"]])
    gate = _hold_pool(d)
    try:
        out = [d.apply_track_list_changes(defer=True)]
        d.set_db_range(90.0)  # force pass: requantizes all under the new range
        rev = d.get_audio_render_metadata("0_0")["spectrogramRevision"]
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    assert d.get_audio_render_metadata("0_0")["spectrogramRevision"] == rev
    s.add_tracks([0], [c["quiet"]])
    s.apply_track_list_changes(defer=False)
    s.add_tracks([1], [c["loud"]])
    out.append(s.apply_track_list_changes(defer=False))
    s.set_db_range(90.0)
    return out, d, s


def sc_rapid_double_deferred_apply(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    assert d.tm.images.drain(timeout=30)
    gate = _hold_pool(d)
    try:
        d.add_tracks([1], [c["loud"]])
        out = [d.apply_track_list_changes(defer=True)]
        d.add_tracks([2], [c["quiet2"]])
        out.append(d.apply_track_list_changes(defer=True))
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    for tid, name in ((0, "quiet"), (1, "loud"), (2, "quiet2")):
        s.add_tracks([tid], [c[name]])
        out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_fresh_only_reconcile_records_applied_range(mk, c):
    d, s = mk("d"), mk("s")
    out = []
    for sess, defer in ((d, True), (s, False)):
        sess.add_tracks([0], [c["loud"]])
        sess.apply_track_list_changes(defer=False)
        sess.remove_tracks([0])
        sess.add_tracks([1], [c["quiet"]])
        out.append(sess.apply_track_list_changes(defer=defer))
        if defer:
            assert sess.settings_settled(timeout=60)
        sess.add_tracks([2], [c["loud2"]])  # the range back to exactly R0
        out.append(sess.apply_track_list_changes(defer=defer))
        if defer:
            assert sess.settings_settled(timeout=60)
    return out, d, s


def sc_superseded_reconcile_chain_requantizes_mixed_rows(mk, c):
    d, s = mk("d"), mk("s")
    for sess in (d, s):
        sess.add_tracks([0, 1], [c["quiet"], c["loud"]])
        sess.apply_track_list_changes(defer=False)
    gate = _hold_pool(d)
    try:
        d.remove_tracks([1])
        d.add_tracks([2], [c["medium"]])
        out = [d.apply_track_list_changes(defer=True)]  # R0 -> R1
        d.add_tracks([3], [c["loud2"]])
        out.append(d.apply_track_list_changes(defer=True))  # back to R0
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    s.remove_tracks([1])
    s.add_tracks([2], [c["medium"]])
    out.append(s.apply_track_list_changes(defer=False))
    s.add_tracks([3], [c["loud2"]])
    out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_reconcile_skips_rows_added_after_dispatch(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    gate = _hold_pool(d)
    try:
        d.add_tracks([1], [c["loud"]])
        out = [d.apply_track_list_changes(defer=True)]
        d.add_tracks([2], [c["quiet2"]])  # no apply yet
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    assert {k[0] for k in d.tm.spec_imgs} == {0, 1}
    out.append(d.apply_track_list_changes(defer=True))
    assert d.settings_settled(timeout=60)
    for tid, name in ((0, "quiet"), (1, "loud"), (2, "quiet2")):
        s.add_tracks([tid], [c[name]])
        out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


def sc_concurrent_deferred_applies_end_uniform(mk, c):
    """Two threads race add+apply; once settled a forced same-range
    requantize changes no byte.  The interleaving differs between runs, so
    no return value is compared."""
    d, s = mk("d"), mk("s")
    d.add_tracks([0], [c["quiet"]])
    d.apply_track_list_changes(defer=False)
    sources = ["loud", "quiet2", "medium", "loud2"]
    next_id = 1
    for rnd in range(2):
        pair = [(next_id + i, c[sources[(2 * rnd + i) % 4]]) for i in range(2)]
        next_id += 2

        def add_apply(arg):
            tid, path = arg
            d.add_tracks([tid], [path])
            d.apply_track_list_changes(defer=True)

        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            list(ex.map(add_apply, pair))
        assert d.settings_settled(timeout=120)
        settled = {k: np.array(v) for k, v in d.tm.spec_imgs.items()}
        d.set_db_range(d.tm.db_range)
        forced = {k: np.array(v) for k, v in d.tm.spec_imgs.items()}
        assert settled.keys() == forced.keys()
        for k in settled:
            assert np.array_equal(settled[k], forced[k]), (rnd, k)
    for tid, name in enumerate(["quiet"] + sources):
        s.add_tracks([tid], [c[name]])
    s.apply_track_list_changes(defer=False)
    return None, d, s


def sc_first_apply_is_forcelike(mk, c):
    d, s = mk("d"), mk("s")
    d.add_tracks([0, 1], [c["quiet"], c["loud"]])
    out = [d.apply_track_list_changes(defer=True)]
    assert out[0] == ["0_0", "1_0"]
    assert d.settings_settled(timeout=0.5), "force route must settle at dispatch"
    s.add_tracks([0, 1], [c["quiet"], c["loud"]])
    out.append(s.apply_track_list_changes(defer=False))
    return out, d, s


SCENARIOS = [
    sc_range_moved, sc_unmoved_skips_requantize, sc_remove_shrinks_range,
    sc_pending_reports_is_computing, sc_superseded_by_sync_range_pass,
    sc_rapid_double_deferred_apply, sc_fresh_only_reconcile_records_applied_range,
    sc_superseded_reconcile_chain_requantizes_mixed_rows,
    sc_reconcile_skips_rows_added_after_dispatch,
    sc_concurrent_deferred_applies_end_uniform, sc_first_apply_is_forcelike,
]


def _snap(s):
    assert s.settings_settled(timeout=60) and s.tm.images.drain(timeout=60)
    ids = [f"{t}_0" for t in s.tracklist.all_ids()]
    out = {
        "images": {k: np.array(v) for k, v in s.tm.spec_imgs.items()},
        "metadata": {k: s.get_audio_render_metadata(k) for k in ids},
        "max_db": s.get_max_db(), "min_db": s.get_min_db(),
    }
    if isinstance(s, jax_session.EngineSession):
        out["db"] = {tid: np.asarray(r.db_padded)[:, : r.n_frames] for tid, r in s.tm.specs.items()}
        out["setting"] = s.tm.setting
        out["srs"] = {tid: s.tracklist[tid].sr for tid in s.tracklist.all_ids()}
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__[3:] for f in SCENARIOS])
def test_deferred_apply_scenario_matches_jax_and_the_sync_path(scenario, corpus, tmp_path):
    j_out, jd, js = scenario(_Maker("jax", tmp_path), corpus)
    p_out, pd, ps = scenario(_Maker("port", tmp_path), corpus)
    assert p_out == j_out
    j, p, p_sync = _snap(jd), _snap(pd), _snap(ps)
    if j_out is None:  # racing threads: revisions depend on the interleaving
        for m in (*j["metadata"].values(), *p["metadata"].values()):
            m.pop("spectrogramRevision")
    assert p["metadata"] == j["metadata"]
    _check_range(j, p)
    _check_images(j, p)
    # the port's deferred images are its synchronous images, bit for bit
    assert (p["max_db"], p["min_db"]) == (p_sync["max_db"], p_sync["min_db"])
    assert p["images"].keys() == p_sync["images"].keys()
    for k, img in p["images"].items():
        assert img.dtype == np.uint16 and np.array_equal(img, p_sync["images"][k]), k
    for sess in (jd, js, pd, ps):
        sess.tm.images.shutdown()


# -- tests/test_session.py's deferred cases, on the port ----------------------

def _one_track_session(tmp_path, name="cfg"):
    s = port_session.EngineSession(device="cpu", settings_dir=tmp_path / name)
    s.init(CMAP)
    w = np.random.default_rng(0).uniform(-0.5, 0.5, (1, 16000)).astype(np.float32)
    p = tmp_path / f"{name}.wav"
    p.write_bytes(encode_wav_f32(w, 8000))
    assert s.add_tracks([0], [str(p)]) == [0]
    s.apply_track_list_changes(defer=False)
    assert s.tm.images.drain(timeout=30)
    return s


def _gate_method(monkeypatch, obj, name):
    """Hold obj.name (called on the write worker) until released."""
    gate, entered = threading.Event(), threading.Event()
    orig = getattr(obj, name)

    def gated(*a, **kw):
        entered.set()
        assert gate.wait(20)
        return orig(*a, **kw)

    monkeypatch.setattr(obj, name, gated)
    return gate, entered


MEL20 = {"winMillisec": 20, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}


def test_deferred_settings_switch_returns_at_dispatch(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    gate, entered = _gate_method(monkeypatch, s.tm, "set_setting")
    md_before = s.get_audio_render_metadata("0_0")
    t0 = time.perf_counter()
    s.set_spec_setting(MEL20, defer=True)
    assert time.perf_counter() - t0 < 1.0
    assert entered.wait(10)
    assert s.get_spec_setting()["winMillisec"] == 20
    assert s.spec_switch_pending()
    md_mid = s.get_audio_render_metadata("0_0")
    assert md_mid["isComputing"] is True
    assert md_mid["spectrogramWidth"] == md_before["spectrogramWidth"]
    assert len(s.get_spectrogram_tile("0_0", 0, 0, 0, 0)) > 40  # the old revision serves
    gate.set()
    assert s.settings_settled(timeout=60)
    assert s.tm.images.drain(timeout=30)
    md_after = s.get_audio_render_metadata("0_0")
    assert md_after["isComputing"] is False
    assert md_after["spectrogramWidth"] != md_before["spectrogramWidth"]
    assert md_after["spectrogramRevision"] > md_before["spectrogramRevision"]


def test_deferred_settings_switch_latest_wins(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    applied = []
    orig_set = s.tm.set_setting

    def counting(tracklist, setting):
        applied.append(setting.win_ms)
        return orig_set(tracklist, setting)

    monkeypatch.setattr(s.tm, "set_setting", counting)
    gate = _hold_pool(s)
    for wm in (20, 80, 10):
        s.set_spec_setting(dict(MEL20, winMillisec=wm), defer=True)
    gate.set()
    assert s.settings_settled(timeout=60)
    assert applied == [10.0]  # superseded generations never dispatched
    assert s.get_spec_setting()["winMillisec"] == 10


def test_deferred_env_default(tmp_path, monkeypatch):
    """Unset or 1 defers (the JAX package's default); tests/conftest.py
    pins 0 so the rest of the suite runs synchronously."""
    s = _one_track_session(tmp_path)
    for value in ("1", None):
        if value is None:
            monkeypatch.delenv("THESIA_DEFER_SETTINGS", raising=False)
        else:
            monkeypatch.setenv("THESIA_DEFER_SETTINGS", value)
        gate = _hold_pool(s)
        s.set_spec_setting(dict(MEL20, winMillisec=20 if value else 40))
        assert s.spec_switch_pending()
        gate.set()
        assert s.settings_settled(timeout=60)
    assert s.get_spec_setting()["winMillisec"] == 40
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "0")
    s.set_spec_setting(MEL20)
    assert not s.spec_switch_pending() and s.tm.setting.win_ms == 20


def test_deferred_normalize_returns_at_dispatch(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    gate, entered = _gate_method(monkeypatch, s.tm, "update_all_specs_imgs")
    md_before = s.get_audio_render_metadata("0_0")
    t0 = time.perf_counter()
    s.set_common_normalize({"type": "LUFS", "target": -20.0}, defer=True)
    assert time.perf_counter() - t0 < 1.0
    assert entered.wait(10)
    assert s.get_common_normalize() == {"type": "LUFS", "target": -20.0}
    assert s.spec_switch_pending()
    assert s.get_audio_render_metadata("0_0")["isComputing"] is True
    gate.set()
    assert s.settings_settled(timeout=60)
    assert s.tm.images.drain(timeout=30)
    assert s.tracklist.common_normalize.to_json() == {"type": "LUFS", "target": -20.0}
    md_after = s.get_audio_render_metadata("0_0")
    assert md_after["isComputing"] is False
    assert md_after["spectrogramRevision"] > md_before["spectrogramRevision"]


def test_deferred_normalize_latest_wins(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    applied = []
    orig_set = type(s.tracklist).set_common_normalize

    def counting(tl, target):
        applied.append(target.to_json())
        return orig_set(tl, target)

    monkeypatch.setattr(type(s.tracklist), "set_common_normalize", counting)
    gate = _hold_pool(s)
    for target in (-10.0, -16.0, -23.0):
        s.set_common_normalize({"type": "LUFS", "target": target}, defer=True)
    gate.set()
    assert s.settings_settled(timeout=60)
    assert applied == [{"type": "LUFS", "target": -23.0}]
    assert s.get_common_normalize() == {"type": "LUFS", "target": -23.0}


def test_deferred_guard_switch_and_cross_kind_fifo(tmp_path, monkeypatch):
    """Normalize THEN guard, deferred: applied in order, final state equal to
    the synchronous sequence."""
    s = _one_track_session(tmp_path)
    gate, entered = _gate_method(monkeypatch, s.tm, "update_all_specs_imgs")
    s.set_common_normalize({"type": "PeakdB", "target": -1.0}, defer=True)
    s.set_common_guard_clipping("Limiter", defer=True)
    assert s.get_common_guard_clipping() == "Limiter"
    assert entered.wait(10)
    gate.set()
    assert s.settings_settled(timeout=60)
    assert s.tracklist.common_guard_clipping.value == "Limiter"
    assert s.tracklist.common_normalize.to_json() == {"type": "PeakdB", "target": -1.0}
    s2 = _one_track_session(tmp_path, "cfg2")
    s2.set_common_normalize({"type": "PeakdB", "target": -1.0}, defer=False)
    s2.set_common_guard_clipping("Limiter", defer=False)
    np.testing.assert_array_equal(s.tracklist[0].audio.wavs, s2.tracklist[0].audio.wavs)
    for a, b in zip(s.tm.spec_imgs.values(), s2.tm.spec_imgs.values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_deferred_guard_invalid_mode_raises_synchronously(tmp_path):
    s = _one_track_session(tmp_path)
    with pytest.raises(ValueError):
        s.set_common_guard_clipping("Bogus", defer=True)
    assert not s.spec_switch_pending()


def test_deferred_common_switch_failure_rolls_back(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    events = []
    s.add_listener(lambda name, p: events.append((name, p)))

    def boom(tl, mode):
        raise RuntimeError("simulated switch failure")

    monkeypatch.setattr(type(s.tracklist), "set_common_guard_clipping", boom)
    s.set_common_guard_clipping("Limiter", defer=True)
    assert s.settings_settled(timeout=60)  # must not hang on failure
    assert s.get_common_guard_clipping() == "ReduceGlobalLevel"
    assert ("settings-switch-failed", {"commonGuardClipping": "Limiter"}) in events


def test_deferred_spec_switch_failure_rolls_back_and_sync_raises(tmp_path, monkeypatch):
    s = _one_track_session(tmp_path)
    events = []
    s.add_listener(lambda name, p: events.append((name, p)))
    before = s.get_spec_setting()

    def boom(tracklist, setting):
        raise RuntimeError("simulated spec failure")

    monkeypatch.setattr(s.tm, "set_setting", boom)
    s.set_spec_setting(MEL20, defer=True)
    assert s.settings_settled(timeout=60)
    assert s.get_spec_setting() == before
    assert events and events[0][0] == "settings-switch-failed"
    with pytest.raises(RuntimeError, match="simulated spec failure"):
        s.set_spec_setting(MEL20, defer=False)
    assert s.get_spec_setting() == before and len(events) == 2


# -- isComputing and the epoch early exit --------------------------------------

def test_is_computing_while_streaming_or_pending(tmp_path, monkeypatch, corpus):
    """Metadata reports isComputing exactly while the store streams the
    track's image or a deferred switch is pending, as the JAX session."""
    s = port_session.EngineSession(device="cpu", settings_dir=tmp_path / "c")
    s.init(CMAP)
    s.add_tracks([0], [corpus["quiet"]])
    entered, release = threading.Event(), threading.Event()
    orig = port_images.SpecImageStore._yield_to_interactive

    def gated(store):
        if not release.is_set():
            entered.set()
            assert release.wait(10)
        orig(store)

    monkeypatch.setattr(port_images.SpecImageStore, "_yield_to_interactive", gated)
    s.apply_track_list_changes(defer=True)  # first apply: force route
    assert entered.wait(10)
    assert not s.spec_switch_pending()
    assert s.tm.images.is_computing(0)
    assert s.get_audio_render_metadata("0_0")["isComputing"] is True  # streaming
    release.set()
    assert s.tm.images.drain(timeout=30)
    assert s.get_audio_render_metadata("0_0")["isComputing"] is False
    gate = _hold_pool(s)
    s.set_common_normalize({"type": "LUFS", "target": -20.0})  # synchronous (conftest)
    assert s.tm.images.drain(timeout=30)
    assert s.get_audio_render_metadata("0_0")["isComputing"] is False
    s.set_common_normalize({"type": "LUFS", "target": -18.0}, defer=True)
    assert not s.tm.images.is_computing(0)
    assert s.get_audio_render_metadata("0_0")["isComputing"] is True  # pending
    gate.set()
    assert s.settings_settled(timeout=60) and s.tm.images.drain(timeout=30)
    assert s.get_audio_render_metadata("0_0")["isComputing"] is False


def test_epoch_early_exit_skips_the_probe(tmp_path, monkeypatch, corpus):
    """A set_db_range between a deferred apply's dispatch and its reconcile
    supersedes the apply's range epoch: the port's reconcile returns before
    running the probe (which would wait for every spectrogram), and the
    final images equal the synchronous path's."""
    d = port_session.EngineSession(device="cpu", settings_dir=tmp_path / "d")
    d.init(CMAP)
    d.add_tracks([0], [corpus["quiet"]])
    d.apply_track_list_changes(defer=False)
    d.add_tracks([1], [corpus["loud"]])
    probes = []
    orig = d.tm.apply_track_list_changes_deferred

    def counting(tracklist):
        updated, sr, info = orig(tracklist)
        probe, epoch, fresh = info

        def counted():
            probes.append(epoch)
            return probe()

        return updated, sr, (counted, epoch, fresh)

    monkeypatch.setattr(d.tm, "apply_track_list_changes_deferred", counting)
    gate = _hold_pool(d)
    try:
        assert d.apply_track_list_changes(defer=True) == ["1_0"]
        d.set_db_range(90.0)
    finally:
        gate.set()
    assert d.settings_settled(timeout=60)
    assert probes == []
    # without the range pass the same apply does run its probe
    d.add_tracks([2], [corpus["medium"]])
    d.apply_track_list_changes(defer=True)
    assert d.settings_settled(timeout=60) and len(probes) == 1

    s = port_session.EngineSession(device="cpu", settings_dir=tmp_path / "s")
    s.init(CMAP)
    for tid, name in ((0, "quiet"), (1, "loud")):
        s.add_tracks([tid], [corpus[name]])
        s.apply_track_list_changes(defer=False)
    s.set_db_range(90.0)
    s.add_tracks([2], [corpus["medium"]])
    s.apply_track_list_changes(defer=False)
    want = {k: np.asarray(v) for k, v in s.tm.spec_imgs.items()}
    got = {k: np.asarray(v) for k, v in d.tm.spec_imgs.items()}
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    assert (d.get_max_db(), d.get_min_db()) == (s.get_max_db(), s.get_min_db())
