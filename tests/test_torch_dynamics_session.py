"""The dynamics commands of the port's session against the JAX EngineSession
(synchronous, defer=False) on the same two WAVs: add -> apply ->
set_common_normalize (LUFS, RMSdB, PeakdB, then a target that drives both
tracks over 0 dBFS) -> set_common_guard_clipping (Clip, ReduceGlobalLevel,
Limiter), a snapshot after every step.  Two routes for the stats and limiter
gains, chosen by THESIA_DEVICE_DYNAMICS on both sides:

* "native" (0): the same native streaming code on both sides, so the
  getters, guard-clip strings, gained/guarded samples, limiter gains and
  waveform tiles are equal bit for bit;
* "device" (1): the port's torch float64 programs against the JAX package's
  XLA ones.  LUFS within 1e-9 and rms_db within 1e-5 (the JAX suite's bars,
  tests/test_dynamics_device.py), peaks and strings equal, samples and
  limiter gains within 1e-6 (waveform tiles decoded and held to the same).

Spectrogram dB, u16 images and tile bytes are held to the tests/torch_parity.py
contract in both.  Also: init restores the persisted dynamics settings as the
JAX package does, a failing switch rolls back, set_user_settings validates
alike, and the small getters agree."""

import json
import math

import numpy as np
import pytest

from test_torch_session import ID_CHS, _check_images, _check_range, _snapshot, _wav
from thesia_tpu.engine import session as jax_session
from thesia_tpu.engine import track as jax_track
from thesia_tpu.render import tiles as jax_tiles
from thesia_tpu_torch.engine import session as port_session
from thesia_tpu_torch.engine import track as port_track
from thesia_tpu_torch.render.colormap import default_colormap_rgba8

CMAP = default_colormap_rgba8().reshape(-1).tolist()
STEPS = [
    ("normalize", {"type": "LUFS", "target": -20.0}),
    ("normalize", {"type": "RMSdB", "target": -18.0}),
    ("normalize", {"type": "PeakdB", "target": -1.0}),
    ("normalize", {"type": "LUFS", "target": 2.0}),  # both tracks over 0 dBFS
    ("guard", "Clip"),
    ("guard", "ReduceGlobalLevel"),
    ("guard", "Limiter"),
]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dynamics_session_wavs")
    return [_wav(d / "stereo_8k.wav", 8000, 2.0, (440.0, 550.0), 1),
            _wav(d / "mono_16k.wav", 16000, 1.5, (1000.0,), 2)]


def _sessions(tmp_path):
    return (jax_session.EngineSession(settings_dir=tmp_path / "jax"),
            port_session.EngineSession(device="cpu", settings_dir=tmp_path / "port"))


def _dynamics(s):
    """What the dynamics commands return, and the samples behind them."""
    tl = s.tracklist
    return {
        "getters": {t: (s.get_global_lufs(t), s.get_rms_db(t), s.get_max_peak_db(t),
                        s.get_guard_clip_stats(t)) for t in (0, 1, 7)},
        "limiter_gain": {t: s.get_limiter_gain(t) for t in (0, 1, 7)},
        "modes": (s.get_common_normalize(), s.get_common_guard_clipping()),
        "wavs": {t: np.array(tl[t].audio.wavs) for t in (0, 1)},
        "drawn": {k: np.array(tl[int(k[0])].channel_for_drawing(int(k[2]))[0]) for k in ID_CHS},
        "kind": {t: tl[t].audio.guard_clip_result.kind for t in (0, 1)},
    }


@pytest.fixture(scope="module", params=["native", "device"])
def runs(request, wavs, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("THESIA_DEVICE_DYNAMICS", "0" if request.param == "native" else "1")
    out = {}
    try:
        for name, s in zip(("jax", "port"), _sessions(tmp_path_factory.mktemp("dyn_session"))):
            defer = {"defer": False} if name == "jax" else {}
            s.init(CMAP)
            s.add_tracks([0, 1], wavs)
            s.apply_track_list_changes(**defer)
            snaps = [("added", _snapshot(s, ID_CHS), _dynamics(s))]
            for kind, value in STEPS:
                if kind == "normalize":
                    s.set_common_normalize(value, **defer)
                else:
                    s.set_common_guard_clipping(value, **defer)
                snaps.append((f"{kind}={value}", _snapshot(s, ID_CHS), _dynamics(s)))
            out[name] = snaps
    finally:
        mp.undo()
    return request.param, out["jax"], out["port"]


def _close_json_number(a, b, tol):
    assert a["type"] == b["type"], (a, b)
    if a["type"] == "Finite":
        assert abs(a["value"] - b["value"]) <= tol, (a, b)


def test_dynamics_getters_and_strings(runs):
    route, jax_snaps, port_snaps = runs
    for (step, _js, jd), (_, _ps, pd) in zip(jax_snaps, port_snaps):
        assert pd["modes"] == jd["modes"], step
        assert pd["kind"] == jd["kind"], step
        for t in (0, 1, 7):
            (jl, jr, jp, jg), (pl, pr, pp, pg) = jd["getters"][t], pd["getters"][t]
            if route == "native":
                assert (pl, pr, pp) == (jl, jr, jp), (step, t)
            else:
                _close_json_number(pl, jl, 1e-9)
                _close_json_number(pr, jr, 1e-5)
                assert pp == jp, (step, t)
            assert pg == jg, (step, t)


def test_gained_and_guarded_samples(runs):
    """Bit for bit where both sides use the same gains; within 1e-6 through
    the two packages' device limiters (their gains agree to 1e-9)."""
    route, jax_snaps, port_snaps = runs
    for (step, _js, jd), (_, _ps, pd) in zip(jax_snaps, port_snaps):
        for t in (0, 1):
            a, b = pd["wavs"][t], jd["wavs"][t]
            if route == "native" or jd["kind"][t] != "gain_sequence":
                assert a.tobytes() == b.tobytes(), (step, t)
            else:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=step)
            pg, jg = pd["limiter_gain"][t], jd["limiter_gain"][t]
            assert (pg is None) == (jg is None), (step, t)
            if pg is not None:
                np.testing.assert_allclose(pg, jg, atol=0 if route == "native" else 1e-6, rtol=0)
        for k in ID_CHS:
            a, b = pd["drawn"][k], jd["drawn"][k]
            if route == "native" or jd["kind"][int(k[0])] != "gain_sequence":
                assert a.tobytes() == b.tobytes(), (step, k)
            else:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_metadata_and_waveform_tiles(runs):
    route, jax_snaps, port_snaps = runs
    for (step, js, jd), (_, ps, _pd) in zip(jax_snaps, port_snaps):
        assert ps["metadata"] == js["metadata"], step
        for key, want in js["waveform"].items():
            got = ps["waveform"][key]
            if route == "native" or jd["kind"][int(key[0][0])] != "gain_sequence":
                assert got == want, (step, key)
            else:
                dg, dw = jax_tiles.decode_waveform_tile(got), jax_tiles.decode_waveform_tile(want)
                assert dg["binCount"] == dw["binCount"]
                np.testing.assert_allclose(dg["bins"], dw["bins"], atol=1e-6, rtol=0)
    clipped = [s for s in jax_snaps if s[0] == "guard=Clip"][0]
    assert clipped[1]["metadata"]["0_0"]["isClipped"] and clipped[1]["metadata"]["1_0"]["isClipped"]


def test_spectrograms_images_and_tiles_within_the_contract(runs):
    _route, jax_snaps, port_snaps = runs
    for (step, js, _jd), (_, ps, _pd) in zip(jax_snaps, port_snaps):
        _check_range(js, ps)
        _check_images(js, ps)
        for args, want in js["tiles"].items():
            assert ps["tiles"][args][:40] == want[:40], (step, args)


def test_normalize_with_the_guard_idle_reuses_the_upload(wavs, tmp_path, monkeypatch):
    """While guard clipping changes no sample, the spectrogram reads the
    original upload with the gain applied in the kernel: no new upload.  Where
    it changes samples, K10 makes them on the device from the same upload,
    and a turn back finds the original still cached: no upload either."""
    from thesia_tpu_torch import obs

    monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "1")
    s = port_session.EngineSession(device="cpu", settings_dir=tmp_path)
    s.init(CMAP)
    s.add_tracks([0, 1], wavs)
    s.apply_track_list_changes()
    uploads = lambda: obs.summary().get("spec.h2d_upload", {}).get("count", 0)  # noqa: E731
    before = uploads()
    s.set_common_normalize({"type": "LUFS", "target": -20.0})
    assert uploads() == before
    assert all(s.tracklist[t].device_scalar_gain() not in (None, 1.0) for t in (0, 1))
    s.set_common_normalize({"type": "LUFS", "target": 2.0})  # ReduceGlobalLevel changes samples
    assert uploads() == before
    assert all(s.tracklist[t].device_scalar_gain() is None for t in (0, 1))
    s.set_common_normalize({"type": "LUFS", "target": -20.0})
    assert uploads() == before


# -- init, persistence, rollback ----------------------------------------------

@pytest.mark.parametrize("stored,valid", [
    ({"commonNormalize": {"type": "LUFS", "target": -14}, "commonGuardClipping": "Limiter",
      "blend": 0.25}, True),
    ({"commonNormalize": {"type": "PeakdB", "target": -0.5}, "commonGuardClipping": "Clip",
      "dBRange": 80.0}, True),
    ({"commonNormalize": {"type": "PeakdB", "target": 3.0}, "commonGuardClipping": "Loud"}, False),
    ({"commonNormalize": "LUFS", "blend": float("inf")}, False),
])
def test_init_restores_the_persisted_dynamics_settings(tmp_path, stored, valid):
    """init parses commonNormalize and commonGuardClipping from
    settings.json, applies them and persists what it applied, as the JAX
    package does; an invalid value falls back to its default."""
    results = []
    for name, s in zip(("jax", "port"), _sessions(tmp_path)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        (d / "settings.json").write_text(json.dumps(stored))
        user = s.init(CMAP)["userSettings"]
        written = json.loads((d / "settings.json").read_text())
        results.append((user, written, s.get_common_normalize(), s.get_common_guard_clipping()))
    assert results[1] == results[0]
    user = results[1][0]
    if valid:
        assert user["commonNormalize"] == stored["commonNormalize"]
        assert user["commonGuardClipping"] == stored["commonGuardClipping"]
    else:
        assert (user["commonNormalize"], user["commonGuardClipping"]) == ({"type": "Off"}, "ReduceGlobalLevel")


def test_init_restores_onto_loaded_tracks_alike(tmp_path, wavs):
    """A second init on a session with tracks tears down and restores."""
    outcomes = []
    for s in _sessions(tmp_path):
        s.init(CMAP)
        s.add_tracks([0], wavs[:1])
        s.set_user_settings({"commonNormalize": {"type": "RMSdB", "target": -12.0},
                             "commonGuardClipping": "Clip", "blend": 0.75})
        outcomes.append((s.init(CMAP), s.tracklist.is_empty, s.get_common_normalize()))
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("update", [
    {"blend": 0.3}, {"blend": float("nan")}, {"blend": True}, {"dBRange": -5},
    {"commonGuardClipping": "Limiter"}, {"commonGuardClipping": "Nope"},
    {"commonNormalize": {"type": "LUFS", "target": -16}}, {"commonNormalize": {"type": "X"}},
    {"specSetting": {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}},
    {"specSetting": {"winMillisec": 1e9, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}},
    {"unknownKey": 1},
])
def test_set_user_settings_validates_alike(tmp_path, update):
    outcomes = []
    for name, s in zip(("jax", "port"), _sessions(tmp_path)):
        try:
            s.set_user_settings(dict(update))
            outcomes.append(json.loads((tmp_path / name / "settings.json").read_text()))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("switch", ["guard", "normalize"])
def test_a_failing_switch_rolls_back(tmp_path, wavs, monkeypatch, switch):
    """track.py:247-264: a switch that fails on some track raises, and the
    mode and every track stay as they were."""
    results = []
    for mod, s in zip((jax_track, port_track), _sessions(tmp_path)):
        kw = {"defer": False} if mod is jax_track else {}
        s.init(CMAP)
        s.add_tracks([0, 1], wavs)
        s.set_common_normalize({"type": "LUFS", "target": 2.0}, **kw)
        before = {t: s.tracklist[t].audio.wavs.copy() for t in (0, 1)}
        orig = mod.AudioTrack.apply_gain

        def failing(self, gain, mode, *args, _orig=orig, _s=s, **kw):
            tl = _s.tracklist
            if (mode.value == "Clip") if switch == "guard" else (tl.common_normalize.type == "PeakdB"):
                if self is tl[1]:
                    raise RuntimeError("switch failed")
            return _orig(self, gain, mode, *args, **kw)

        monkeypatch.setattr(mod.AudioTrack, "apply_gain", failing)
        with pytest.raises(RuntimeError, match="switch failed"):
            if switch == "guard":
                s.set_common_guard_clipping("Clip", **kw)
            else:
                s.set_common_normalize({"type": "PeakdB", "target": -1.0}, **kw)
        monkeypatch.setattr(mod.AudioTrack, "apply_gain", orig)
        assert all(np.array_equal(s.tracklist[t].audio.wavs, before[t]) for t in (0, 1))
        results.append((s.get_common_guard_clipping(), s.get_common_normalize()))
    assert results[0] == results[1] == ("ReduceGlobalLevel", {"type": "LUFS", "target": 2.0})


def test_small_getters_and_reload(tmp_path, wavs):
    outcomes = []
    for s in _sessions(tmp_path):
        s.init(CMAP)
        s.add_tracks([0, 1], wavs)
        s.apply_track_list_changes(**({"defer": False} if isinstance(s, jax_session.EngineSession) else {}))
        out = [s.find_id_by_path(wavs[1]), s.find_id_by_path(str(tmp_path / "none.wav")),
               s.get_db_range(), s.get_max_track_hz(), s.get_longest_track_length_sec()]
        for t in (0, 1, 9):
            out += [s.get_channel_counts(t), s.get_length_sec(t), s.get_sample_rate(t),
                    s.get_format_info(t), s.get_path(t), s.get_file_name(t)]
        out.append(s.reload_tracks([0, 1]))
        with pytest.raises(KeyError):
            s.reload_tracks([5])
        outcomes.append(out)
    assert outcomes[1] == outcomes[0]
    assert math.isclose(outcomes[0][3], 8000.0)
