"""Randomized soaks of the port's session in both modes, and a clean
interpreter exit with background work still in flight.

The random-ops soak follows tests/test_session_soak.py (without the player
and axis commands, which the port does not have) at a smaller size, once with
every switch synchronous and once deferred.  It settles through
``settings_settled`` and ``drain`` before the stuck-computing check: the JAX
soak run deferred checks isComputing while switches are still queued.  The
exit test starts a session, leaves a deferred apply, its reconcile, a switch
and the image streams in flight, and returns."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from thesia_tpu.io.wav import encode_wav_f32, encode_wav_s16
from thesia_tpu_torch.engine.session import EngineSession, format_id_ch
from thesia_tpu_torch.render.colormap import default_colormap_rgba8

OPS = 30
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(tmp_path, rng):
    paths = []
    for i, (sr, c, sec, enc) in enumerate([
        (8000, 1, 0.8, encode_wav_f32),
        (8000, 2, 1.5, encode_wav_s16),
        (16000, 1, 1.0, encode_wav_f32),
        (22050, 2, 0.6, encode_wav_s16),
    ]):
        w = (0.4 * rng.uniform(-1, 1, (c, int(sr * sec)))).astype(np.float32)
        p = tmp_path / f"s{i}.wav"
        p.write_bytes(enc(w, sr))
        paths.append(str(p))
    return paths


def _assert_settled_and_uniform(s, live):
    """Every queued switch applied, every image landed, nothing reports
    isComputing, and a forced same-range requantize changes no byte (an
    image left at a stale range by a missed reconcile would)."""
    assert s.settings_settled(timeout=120)
    assert s.tm.images.drain(timeout=60)
    for tid in live:
        md = s.get_audio_render_metadata(format_id_ch(tid, 0))
        assert md is not None and md["spectrogramWidth"] > 0
        assert md["isComputing"] is False, f"track {tid} stuck computing"
        body = s.get_spectrogram_tile(format_id_ch(tid, 0), 0, 0, 0, 0)
        assert isinstance(body, bytes) and len(body) >= 40
    settled = {k: np.array(v) for k, v in s.tm.spec_imgs.items()}
    assert {tid for tid, _ch in settled} == live
    s.set_db_range(s.tm.db_range)
    forced = s.tm.spec_imgs
    assert forced.keys() == settled.keys()
    for k in settled:
        assert np.array_equal(settled[k], np.asarray(forced[k])), k


@pytest.mark.parametrize("defer", [False, True], ids=["sync", "deferred"])
@pytest.mark.parametrize("seed", [1, 2])
def test_session_random_ops_soak(tmp_path, seed, defer):
    rng = np.random.default_rng(seed)
    paths = _corpus(tmp_path, rng)
    s = EngineSession(device="cpu", settings_dir=str(tmp_path / "cfg"))
    events = []  # failures only: every guard or normalize switch also emits player states
    s.add_listener(lambda name, payload: events.append((name, payload))
                   if name == "settings-switch-failed" else None)
    s.init(default_colormap_rgba8())
    live: set[int] = set()
    next_id = 0
    expected_errors = (ValueError, KeyError)

    def random_id():
        if live and rng.random() < 0.8:
            return int(rng.choice(sorted(live)))
        return int(rng.integers(0, next_id + 2))

    for _step in range(OPS):
        op = rng.integers(0, 12)
        try:
            if op == 0 or not live:
                tid = next_id
                next_id += 1
                live.update(s.add_tracks([tid], [str(rng.choice(paths))]))
                s.apply_track_list_changes(defer=defer)
            elif op == 1 and len(live) > 1:
                tid = int(rng.choice(sorted(live)))
                s.remove_tracks([tid])
                live.discard(tid)
                s.apply_track_list_changes(defer=defer)
            elif op == 2:
                s.reload_tracks([random_id()])
                s.apply_track_list_changes(defer=defer)
            elif op == 3:
                s.set_spec_setting({
                    "winMillisec": float(rng.choice([10.0, 20.0, 40.0])),
                    "tOverlap": int(rng.choice([1, 2, 4, 8])), "fOverlap": 1,
                    "freqScale": str(rng.choice(["Mel", "Linear"])),
                }, defer=defer)
            elif op == 4:
                s.set_db_range(float(rng.choice([40.0, 80.0, 100.0, 120.0])))
            elif op == 5:
                t = str(rng.choice(["Off", "LUFS", "PeakdB", "RMSdB"]))
                body = {"type": t} if t == "Off" else {"type": t, "target": float(rng.uniform(-30, -3))}
                s.set_common_normalize(body, defer=defer)
            elif op == 6:
                s.set_common_guard_clipping(
                    str(rng.choice(["Clip", "ReduceGlobalLevel", "Limiter"])), defer=defer)
            elif op == 7:
                tid = random_id()
                ch = int(rng.integers(0, 3))
                s.get_spectrogram_tile(format_id_ch(tid, ch), int(rng.integers(0, 6)),
                                       int(rng.integers(0, 3)), int(rng.integers(0, 9)),
                                       int(rng.integers(0, 3)))
                s.get_waveform_tile(format_id_ch(tid, ch), int(rng.integers(0, 20)),
                                    int(rng.integers(0, 6)))
            elif op == 8:
                s.get_audio_render_metadata(format_id_ch(random_id(), int(rng.integers(0, 2))))
            elif op == 9:
                s.set_db_range(float(rng.choice([np.inf, np.nan, -5.0, 0.0])))
            elif op == 10:
                s.set_user_settings({"specSetting": {
                    "winMillisec": float(rng.choice([1e9, np.nan])),
                    "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel",
                }})
            else:
                s.get_max_db()
                s.apply_track_list_changes(defer=defer)
        except expected_errors:
            pass  # the documented client-error contract

    s.apply_track_list_changes(defer=defer)
    _assert_settled_and_uniform(s, live)
    assert events == []
    s.tm.images.shutdown()


def test_deferred_settings_churn_soak(tmp_path, monkeypatch):
    """Deferred knob turns (the default mode) interleaved with adds,
    removes, dB changes and tiles settle to the last target of each kind,
    every live image landed and at the final range."""
    monkeypatch.delenv("THESIA_DEFER_SETTINGS")
    rng = np.random.default_rng(77)
    paths = []
    for i, (sr, sec) in enumerate([(8000, 2.0), (16000, 1.5), (8000, 1.0)]):
        p = tmp_path / f"soak{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.6, 0.6, (1, int(sr * sec))).astype(np.float32), sr))
        paths.append(str(p))
    s = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    events = []  # failures only: every guard or normalize switch also emits player states
    s.add_listener(lambda name, payload: events.append((name, payload))
                   if name == "settings-switch-failed" else None)
    s.init(default_colormap_rgba8())
    assert s.add_tracks([0], [paths[0]]) == [0]
    s.apply_track_list_changes()
    live, next_id = {0}, 1
    last_setting = last_norm = last_guard = None
    for _step in range(24):
        op = rng.integers(7)
        if op == 5:
            last_norm = [{"type": "Off"}, {"type": "LUFS", "target": float(rng.uniform(-30, 5))},
                         {"type": "PeakdB", "target": float(rng.uniform(-12, 0))}][rng.integers(3)]
            s.set_common_normalize(last_norm)
        elif op == 6:
            last_guard = str(rng.choice(["Clip", "ReduceGlobalLevel", "Limiter"]))
            s.set_common_guard_clipping(last_guard)
        elif op == 0:
            last_setting = {"winMillisec": float(rng.choice([10, 20, 40, 80])),
                            "tOverlap": int(rng.choice([1, 2, 4, 8])), "fOverlap": 1,
                            "freqScale": str(rng.choice(["Mel", "Linear"]))}
            s.set_spec_setting(last_setting)
        elif op == 1 and len(live) < 3:
            tid = next_id
            next_id += 1
            if s.add_tracks([tid], [paths[tid % len(paths)]]) == [tid]:
                live.add(tid)
            s.apply_track_list_changes()
        elif op == 2 and len(live) > 1:
            tid = int(rng.choice(sorted(live)))
            s.remove_tracks([tid])
            live.discard(tid)
            s.apply_track_list_changes()
        elif op == 3:
            s.set_db_range(float(rng.uniform(40, 120)))
        else:
            try:
                s.get_spectrogram_tile(f"{int(rng.choice(sorted(live)))}_0", 0, 0, 0, 0)
            except KeyError:
                pass  # a track added without its apply yet has no image
    assert s.settings_settled(timeout=120)
    if last_setting is not None:
        assert s.get_spec_setting()["winMillisec"] == last_setting["winMillisec"]
        assert s.tm.setting.win_ms == last_setting["winMillisec"]
    if last_norm is not None:
        assert s.tracklist.common_normalize.to_json() == last_norm == s.get_common_normalize()
    if last_guard is not None:
        assert s.tracklist.common_guard_clipping.value == last_guard == s.get_common_guard_clipping()
    _assert_settled_and_uniform(s, live)
    assert events == []
    s.tm.images.shutdown()


EXIT_IN_FLIGHT = textwrap.dedent(
    """
    import tempfile
    from pathlib import Path
    import numpy as np
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_s16
    from thesia_tpu_torch.render.colormap import default_colormap_rgba8
    d = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    paths = []
    for i, (sr, ch, sec, amp) in enumerate(((16000, 2, 20.0, 0.2), (16000, 1, 20.0, 0.1),
                                           (16000, 1, 5.0, 0.9))):
        w = np.clip(amp * rng.standard_normal((ch, int(sr * sec))), -1, 1).astype(np.float32)
        (d / f"{i}.wav").write_bytes(encode_wav_s16(w, sr))
        paths.append(str(d / f"{i}.wav"))
    s = EngineSession(device="cpu", settings_dir=d / "config")
    s.init(default_colormap_rgba8().reshape(-1).tolist())
    s.add_tracks([0, 1], paths[:2])
    s.apply_track_list_changes()
    s.add_tracks([2], paths[2:])
    s.apply_track_list_changes()  # the reconcile goes to the switch pool
    s.set_common_normalize({"type": "LUFS", "target": -16.0})
    s.set_spec_setting({"winMillisec": 20.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"})
    print("RETURNED", s.spec_switch_pending(), flush=True)
    """
)


def test_the_interpreter_exits_cleanly_with_work_in_flight(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "THESIA_DEFER_SETTINGS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", EXIT_IN_FLIGHT], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RETURNED True" in proc.stdout
    assert "terminate called" not in proc.stderr and "FATAL" not in proc.stderr, proc.stderr
    assert "Traceback" not in proc.stderr, proc.stderr
