"""The port's slice as a whole: the same two WAVs (8 kHz stereo and 16 kHz
mono, so max_sr geometry and the zero rows above a lower-rate track are
exercised) go through the JAX EngineSession (CPU, synchronous) and the port's
EngineSession(device="cpu"): init -> add_tracks -> apply_track_list_changes
-> metadata -> tiles -> set_spec_setting(Linear) -> tiles.  Integer stages
are held bit-exact, dB-derived ones to the tests/torch_parity.py contract."""

import numpy as np
import pytest
import torch

from torch_parity import db_limit, u16_limit
from thesia_tpu.engine import session as jax_session
from thesia_tpu.engine import utils as jax_utils
from thesia_tpu.io.wav import encode_wav_s16
from thesia_tpu.render import tiles as jax_tiles
from thesia_tpu.render.mips import SpecImage
from thesia_tpu_torch.engine import session as port_session
from thesia_tpu_torch.engine import utils as port_utils
from thesia_tpu_torch.render.colormap import default_colormap_rgba8, quantize_min_value

LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}
ID_CHS = ("0_0", "0_1", "1_0")
TILES = [("0_0", 0, 0, 0, 0), ("0_1", 0, 1, 0, 0), ("1_0", 0, 0, 0, 0), ("1_0", 2, 1, 0, 0),
         ("0_0", 1, 0, 0, 0), ("1_0", 0, 0, 1, 0)]


def _wav(path, sr, sec, freqs, seed):
    """Sines plus white noise at -60 dBFS as a 16-bit WAV."""
    rng = np.random.default_rng(seed)
    n = int(sr * sec)
    t = np.arange(n) / sr
    rows = [0.5 * np.sin(2 * np.pi * f * t) + 1e-3 * rng.standard_normal(n) for f in freqs]
    path.write_bytes(encode_wav_s16(np.clip(np.stack(rows), -1, 1).astype(np.float32), sr))
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_session_wavs")
    return [
        _wav(d / "stereo_8k.wav", 8000, 2.0, (440.0, 550.0), 1),
        _wav(d / "mono_16k.wav", 16000, 1.5, (1000.0,), 2),
        _wav(d / "mono_8k.wav", 8000, 1.2, (300.0,), 3),
    ]


def _sessions(tmp_path):
    return (jax_session.EngineSession(settings_dir=tmp_path / "jax"),
            port_session.EngineSession(device="cpu", settings_dir=tmp_path / "port"))


def _snapshot(s, ids):
    tids = sorted({int(k.split("_")[0]) for k in ids})
    out = {
        # images first: the JAX store lands them in the background
        "images": {k: np.array(v) for k, v in s.tm.spec_imgs.items()},
        "metadata": {k: s.get_audio_render_metadata(k) for k in ids},
        "max_db": s.get_max_db(), "min_db": s.get_min_db(),
        "tiles": {a: s.get_spectrogram_tile(*a) for a in TILES if int(a[0][0]) in tids},
        "waveform": {(k, lv, i): s.get_waveform_tile(k, lv, i) for k in ids for lv, i in ((0, 0), (3, 0))},
    }
    if isinstance(s, jax_session.EngineSession):
        out["db"] = {tid: np.asarray(r.db_padded)[:, : r.n_frames] for tid, r in s.tm.specs.items()}
        out["setting"] = s.tm.setting
        out["srs"] = {tid: s.tracklist[tid].sr for tid in s.tracklist.all_ids()}
    return out


@pytest.fixture(scope="module")
def runs(wavs, tmp_path_factory):
    cmap = default_colormap_rgba8().reshape(-1).tolist()
    out = {}
    for name, s in zip(("jax", "port"), _sessions(tmp_path_factory.mktemp("torch_session"))):
        defer = {"defer": False} if name == "jax" else {}
        r = {"init": s.init(cmap), "add": s.add_tracks([0, 1], wavs[:2])}
        r["apply"] = s.apply_track_list_changes(**defer)
        r["Mel"] = _snapshot(s, ID_CHS)
        s.set_spec_setting(LINEAR, **defer)
        r["spec_setting"] = s.get_spec_setting()
        r["Linear"] = _snapshot(s, ID_CHS)
        out[name] = r
    return out["jax"], out["port"]


def test_init_add_and_apply_return_the_same(runs):
    j, p = runs
    for key in ("init", "add", "apply", "spec_setting"):
        assert p[key] == j[key], key


@pytest.mark.parametrize("stage", ["Mel", "Linear"])
def test_metadata_is_the_same(runs, stage):
    j, p = runs
    assert p[stage]["metadata"] == j[stage]["metadata"]


def _check_range(j, p):
    jmax, jmin = j["max_db"]["value"], j["min_db"]["value"]
    assert abs(p["max_db"]["value"] - jmax) <= db_limit(jmax, jmax)
    assert abs(p["min_db"]["value"] - jmin) <= db_limit(jmin, jmax)


def _check_images(j, p):
    """Per pixel, |u16 difference| within what the dB contract allows; rows
    above a lower-rate track's spectrogram are 0 on both sides.  Returns
    (share of differing pixels, largest step)."""
    assert j["images"].keys() == p["images"].keys()
    gmax, gmin = j["max_db"]["value"], j["min_db"]["value"]
    min_value = quantize_min_value(258)
    max_sr = max(j["srs"].values())
    differ, total, worst = 0, 0, 0
    for (tid, ch), want in j["images"].items():
        got = p["images"][(tid, ch)]
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint16
        db = j["db"][tid][ch]
        i0, i1 = j["setting"].freq_scale.hz_range_to_idx((0.0, max_sr / 2.0), j["srs"][tid], db.shape[1])
        n_rows = min(i1, db.shape[1]) - i0
        rows = db[:, i0 : i0 + n_rows].T
        row_max = np.max(db[np.isfinite(db)])
        step = np.abs(got.astype(np.int64) - want)
        assert (step[:n_rows] <= u16_limit(rows, row_max, gmax - gmin, min_value)).all()
        assert not want[n_rows:].any() and not got[n_rows:].any()
        differ += int((step > 0).sum())
        total += step.size
        worst = max(worst, int(step.max()))
    return differ / total, worst


@pytest.mark.parametrize("stage", ["Mel", "Linear"])
def test_range_and_images_within_the_contract(runs, stage):
    j, p = runs
    _check_range(j[stage], p[stage])
    _check_images(j[stage], p[stage])


@pytest.mark.parametrize("stage", ["Mel", "Linear"])
def test_tiles_agree_wherever_the_images_agree(runs, stage):
    """Headers are equal; identity tiles (level 0) are equal wherever the
    image pixels are; every tile is the JAX encoder's tile of the port's own
    image, so where the images agree the tiles do."""
    j, p = runs
    cmap = default_colormap_rgba8()
    rev = p[stage]["metadata"]["0_0"]["spectrogramRevision"]
    for args, want in j[stage]["tiles"].items():
        got = p[stage]["tiles"][args]
        assert got[:40] == want[:40], args
        tid, ch = map(int, args[0].split("_"))
        img = p[stage]["images"][(tid, ch)]
        assert got == jax_tiles.encode_spectrogram_tile(SpecImage(img), cmap, rev, *args[1:]), args
        if args[1:3] == (0, 0):
            d_got, d_want = jax_tiles.decode_spectrogram_tile(got), jax_tiles.decode_spectrogram_tile(want)
            h, w = d_got["height"], d_got["width"]
            y0, x0 = d_got["originY"], d_got["originX"]
            same = (img == j[stage]["images"][(tid, ch)])[y0 : y0 + h, x0 : x0 + w][::-1]
            assert (d_got["rgba"][same] == d_want["rgba"][same]).all(), args


def test_waveform_tiles_are_the_same(runs):
    j, p = runs
    for stage in ("Mel", "Linear"):
        assert p[stage]["waveform"] == j[stage]["waveform"]


def test_incremental_apply_remove_and_db_range(wavs, tmp_path):
    """An add that leaves max_sr alone takes the host range path (f32
    gmax - dB_range); set_db_range and remove_tracks follow."""
    cmap = default_colormap_rgba8().reshape(-1).tolist()
    js, ps = _sessions(tmp_path)
    steps = [
        ("init", lambda s, d: s.init(cmap)),
        ("add0", lambda s, d: s.add_tracks([0], wavs[:1])),
        ("apply0", lambda s, d: s.apply_track_list_changes(**d)),
        ("add2", lambda s, d: s.add_tracks([2], wavs[2:3])),
        ("apply2", lambda s, d: s.apply_track_list_changes(**d)),
        ("snap2", lambda s, d: _snapshot(s, ("0_0", "0_1", "2_0"))),
        ("range", lambda s, d: s.set_db_range(80.0)),
        ("snap_range", lambda s, d: _snapshot(s, ("0_0", "2_0"))),
        ("remove", lambda s, d: s.remove_tracks([0])),
        ("apply_rm", lambda s, d: s.apply_track_list_changes(**d)),
        ("snap_rm", lambda s, d: _snapshot(s, ("2_0",))),
    ]
    for name, step in steps:
        j = step(js, {"defer": False})
        p = step(ps, {})
        if name.startswith("snap"):
            assert p["metadata"] == j["metadata"], name
            _check_range(j, p)
            _check_images(j, p)
            assert p["waveform"] == j["waveform"]
        else:
            assert p == j, name
    assert ps.tm._range_dev is None  # the last apply took the host path


def test_session_needs_an_explicit_device(tmp_path):
    """The session runs on the card unless the caller names the CPU: without
    a card, EngineSession() raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert port_session.EngineSession(settings_dir=tmp_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_session.EngineSession(settings_dir=tmp_path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_session.EngineSession(device="cuda:0", settings_dir=tmp_path)
    assert port_session.EngineSession(device="cpu", settings_dir=tmp_path).device.type == "cpu"
    with pytest.raises(ValueError):
        port_session.EngineSession(device="meta", settings_dir=tmp_path)


def test_manager_and_analyzer_run_on_the_card_by_default():
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer
    from thesia_tpu_torch.engine.manager import TrackManager

    for cls in (TrackManager, SpectrogramAnalyzer):
        if torch.cuda.is_available():
            assert cls().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cls()
        assert cls("cpu").device == torch.device("cpu")


def test_argument_checks_match_the_jax_session(runs, tmp_path, wavs):
    for v in ("0_0", "12_3", "0", "0_0_0", "-1_0", "a_b", 5, None, "1_-2"):
        outcomes = []
        for mod in (jax_session, port_session):
            try:
                outcomes.append(mod.parse_id_ch_str(v))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], v
    for v in (0, "3", -1, 2**31, None, 1.5, "x"):
        outcomes = []
        for mod in (jax_session, port_session):
            try:
                outcomes.append(mod._as_index(v, "levelX"))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], v
    for v in (1.5, float("inf"), float("-inf"), float("nan")):
        assert port_session.json_number(v) == jax_session.json_number(v)
    ps = port_session.EngineSession(device="cpu", settings_dir=tmp_path)
    assert ps.add_tracks([0, 1], [wavs[0], str(tmp_path / "missing.wav")]) == [0]
    with pytest.raises(ValueError):
        ps.get_spectrogram_tile("0_0", -1, 0, 0, 0)
    with pytest.raises(KeyError):
        ps.get_spectrogram_tile("7_0", 0, 0, 0, 0)
    with pytest.raises(ValueError):
        ps.set_db_range(float("inf"))


def test_unique_filenames_are_the_same():
    cases = [
        {0: "/a/b/x.wav", 1: "/a/c/x.wav", 2: "/d/y.wav"},
        {0: "/a/b/x.wav", 1: "/z/b/x.wav"},
        {0: "/x.wav", 1: "/a/x.wav"},
        {3: "rel/one.wav"},
    ]
    for paths in cases:
        assert port_utils.unique_filenames(paths) == jax_utils.unique_filenames(paths)


def _player_run(s, wavs, defer_kw):
    """tests/test_session.py:134-151 plus the session's set_sr and guard
    calls into the player; the outcomes, minus wall-clock stamps."""
    events = []
    s.add_listener(lambda name, p: events.append(name))
    state = lambda: {k: v for k, v in s.player.state().items() if k != "eventTimeMs"}  # noqa: E731
    out = {"add": s.add_tracks([0, 1], wavs[:2]), "apply": s.apply_track_list_changes(**defer_kw)}
    out["sr_sync"] = s.player.requested_sr
    s.set_track_player(0, 0.25)
    out["set_track"] = state()
    s.resume_player()
    out["playing"] = s.player.state()["isPlaying"]
    s.pause_player()
    out["paused"] = state()
    s.seek_player(0.5)
    out["seek"] = state()
    s.seek_player(1e9)  # clamps to the longest track
    out["seek_far"] = state()
    s.set_volume_db(-6.0)
    out["volume"] = s.player.playback.volume
    s.set_track_player(7, 0.0)  # no such track: ignored
    out["unknown_track"] = state()
    s.remove_tracks([1])
    out["apply_deferred"] = s.apply_track_list_changes(defer=True)
    assert s.settings_settled(timeout=120)
    out["sr_deferred"] = s.player.requested_sr
    s.set_track_player(0, 0.1)
    s.set_common_normalize({"type": "LUFS", "target": 0.0}, defer=False)
    s.set_common_guard_clipping("Clip", defer=False)
    # the guard switch reloads the track: the player holds the clipped samples
    out["after_guard"] = state()
    out["reloaded"] = np.array_equal(s.player.playback.samples, s.tracklist[0].interleaved_samples())
    out["clipped"] = s.get_audio_render_metadata("0_0")["isClipped"]
    out["events"] = events.count("player-state-changed")
    return out


def test_player_commands_match_the_jax_session(wavs, tmp_path):
    cmap = default_colormap_rgba8().reshape(-1).tolist()
    js, ps = _sessions(tmp_path)
    runs = []
    for s, kw in ((js, {"defer": False}), (ps, {})):
        s.init(cmap)
        runs.append(_player_run(s, wavs, kw))
    j, p = runs
    assert p == j
    assert (p["sr_sync"], p["sr_deferred"]) == (16000, 8000)
    assert p["set_track"]["trackId"] == 0 and abs(p["set_track"]["positionSec"] - 0.25) < 1e-6
    assert p["playing"] and not p["paused"]["isPlaying"] and abs(p["seek"]["positionSec"] - 0.5) < 1e-6
    assert abs(p["volume"] - 10 ** (-6 / 20)) < 1e-6
    assert p["after_guard"]["trackId"] == 0 and p["reloaded"] and p["clipped"]
    assert p["events"] >= 5


def test_player_track_is_one_snapshot_of_the_audio(wavs, tmp_path):
    """The player loads interleaved samples, channels, rate and length from
    one track.audio (thesia_tpu/engine/session.py:181-195)."""
    ps = port_session.EngineSession(device="cpu", settings_dir=tmp_path)
    ps.add_tracks([0], wavs[:1])
    samples, n_ch, sr, sec = ps._player_get_track(0)
    audio = ps.tracklist[0].audio
    assert (n_ch, sr, sec) == (audio.n_ch, audio.sr, audio.sec)
    np.testing.assert_array_equal(samples, audio.wavs.T.reshape(-1))
    assert ps._player_get_track(5) is None


def test_player_argument_checks_dev_flag_and_dialog_path(tmp_path, monkeypatch):
    js, ps = _sessions(tmp_path)
    for call in (lambda s: s.seek_player(float("nan")), lambda s: s.set_track_player(0, float("inf")),
                 lambda s: s.set_volume_db(float("-inf")), lambda s: s.seek_player(None),
                 lambda s: s.seek_player("NaN"), lambda s: s.set_volume_db(None)):
        for s in (js, ps):
            with pytest.raises(ValueError):
                call(s)
    for value in (None, "1"):
        if value is None:
            monkeypatch.delenv("THESIA_TPU_DEV", raising=False)
        else:
            monkeypatch.setenv("THESIA_TPU_DEV", value)
        assert ps.is_dev() == js.is_dev() == (value is not None)
    assert ps.get_open_files_dialog_path() == js.get_open_files_dialog_path() == ""
    for s in (js, ps):
        s.set_open_files_dialog_path("/music/sessions")
    assert ps.get_open_files_dialog_path() == js.get_open_files_dialog_path() == "/music/sessions"
    assert (tmp_path / "port" / "paths.json").read_text() == (tmp_path / "jax" / "paths.json").read_text()
