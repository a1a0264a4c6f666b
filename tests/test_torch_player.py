"""The port's player (thesia_tpu_torch/player/, host copies of
thesia_tpu/player/) through tests/test_player.py, tests/test_player_stream.py
and tests/test_remote_audio.py's cases (the service endpoints aside: the port
has no service yet), with the deterministic outputs held bit for bit against
the JAX package's player on the same inputs."""

import itertools
import struct
import threading
import time

import numpy as np
import pytest

from thesia_tpu.player import mixing as jax_mixing
from thesia_tpu.player import player as jax_player
from thesia_tpu.player import resampler as jax_resampler
from thesia_tpu.player import stream as jax_stream
from thesia_tpu_torch import native
from thesia_tpu_torch.player.mixing import render_block, source_sample_for_output
from thesia_tpu_torch.player.player import (
    MAX_PULL_FRAMES, REMOTE_STALE_SEC, PlaybackData, Player, encode_pcm_chunk,
)
from thesia_tpu_torch.player.resampler import StreamResampler
from thesia_tpu_torch.player.stream import (
    NullOutputDevice, OutputDevice, OutputEngine, PlaybackStreamSource, RemoteOutputDevice,
    RemoteStreamHandle, StreamConfig, SupportedConfigRange, convert_sample_format, mix_frames,
    select_output_config,
)


def _tracks(store):
    return lambda tid: store.get(tid)


def _run_until_stopped(p, seconds=2.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        p.tick()
        if not p.playback.is_playing:
            break
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# mixing (tests/test_player.py:15-49)


def test_mixing_rules():
    assert source_sample_for_output(np.array([0.1, 0.2, 0.3], np.float32), 1, 1, 0, 2) == np.float32(0.2)
    assert abs(source_sample_for_output(np.array([0.2, 0.4, 0.6, 0.8], np.float32), 2, 0, 0, 1) - 0.3) < 1e-7
    s = np.array([0.1, 0.9], np.float32)
    assert [source_sample_for_output(s, 2, 0, oc, 4) for oc in range(4)] == [
        np.float32(0.1), np.float32(0.9), np.float32(0.1), np.float32(0.9)]
    assert source_sample_for_output(np.array([0.5], np.float32), 1, 5, 0, 2) == 0.0
    assert source_sample_for_output(np.array([0.5], np.float32), 0, 0, 0, 2) == 0.0


@pytest.mark.parametrize("in_ch,out_ch", [(1, 2), (2, 1), (2, 4), (3, 2), (5, 2), (2, 2)])
def test_render_block_matches_the_scalar_path_and_the_jax_package(in_ch, out_ch):
    rng = np.random.default_rng(in_ch * 10 + out_ch)
    samples = rng.uniform(-1.5, 1.5, in_ch * 7).astype(np.float32)
    block = render_block(samples, in_ch, 2, 8, out_ch, volume=0.5)
    assert block.shape == (8, out_ch)
    for f in range(8):
        for oc in range(out_ch):
            exp = np.clip(source_sample_for_output(samples, in_ch, 2 + f, oc, out_ch) * 0.5, -1, 1)
            assert abs(block[f, oc] - np.float32(exp)) < 1e-6
    assert block.tobytes() == jax_mixing.render_block(samples, in_ch, 2, 8, out_ch, 0.5).tobytes()


# ---------------------------------------------------------------------------
# resampler (tests/test_player.py:52-143)


def _resample_tone(cls, sr_in, sr_out, f_tone, sec=2):
    n = sr_in * sec
    tone = np.sin(2 * np.pi * f_tone * np.arange(n) / sr_in).astype(np.float32)[None, :]
    rs = cls(sr_in, sr_out, 1)
    return np.concatenate([rs.process(tone[:, i : i + 4096]) for i in range(0, n, 4096)], axis=1)[0]


def test_resampler_tone_quality_and_equality_with_the_jax_package():
    """Tones survive 44.1k<->48k with every spur >= 80 dB below the carrier,
    and the port's output is the JAX package's within an ulp (its native
    library is built with -march=native, whose FMA contractions round the
    f64 sums differently; the port's is not)."""
    for sr_in, sr_out, f in [(44100, 48000, 1000.0), (48000, 44100, 18000.0)]:
        out = _resample_tone(StreamResampler, sr_in, sr_out, f)
        np.testing.assert_allclose(
            out, _resample_tone(jax_resampler.StreamResampler, sr_in, sr_out, f), atol=2e-7, rtol=0)
        mid = out[len(out) // 4 : len(out) // 4 + 32768]
        spec = np.abs(np.fft.rfft(mid * np.blackman(len(mid))))
        assert abs(np.argmax(spec) * sr_out / len(mid) - f) < 10
        spec /= spec.max()
        sb = int(np.argmax(spec))
        mask = np.ones(len(spec), bool)
        mask[max(0, sb - 40) : sb + 41] = False
        assert -20 * np.log10(max(spec[mask].max(), 1e-12)) >= 80.0
        assert abs(len(out) - 2 * sr_out) < sr_out * 0.002 * 2


def test_resampler_stopband_alias_rejection():
    for sr_in, sr_out, f in [(48000, 44100, 23000.0), (48000, 8000, 10000.0)]:
        out = _resample_tone(StreamResampler, sr_in, sr_out, f)
        ref = _resample_tone(StreamResampler, sr_in, sr_out, 1000.0)
        def peak(x):
            mid = x[len(x) // 4 : len(x) // 4 + 32768]
            return np.abs(np.fft.rfft(mid * np.blackman(len(mid)))).max()

        assert 20 * np.log10(peak(ref) / max(peak(out), 1e-12)) >= 60.0


def test_resampler_native_matches_numpy(monkeypatch):
    assert native.available()
    x = np.random.default_rng(5).uniform(-1, 1, (2, 20000)).astype(np.float32)
    rs_n = StreamResampler(44100, 48000, 2)
    out_n = rs_n.process(x)
    monkeypatch.setattr(native, "available", lambda: False)
    rs_p = StreamResampler(44100, 48000, 2)
    out_p = rs_p.process(x)
    np.testing.assert_allclose(out_n, out_p, atol=2e-7, rtol=0)
    assert rs_n._pos == rs_p._pos


def test_resampler_downsample():
    tone = np.sin(2 * np.pi * 440.0 * np.arange(24000) / 48000).astype(np.float32)[None, :]
    out = StreamResampler(48000, 8000, 1).process(tone)[0]
    assert abs(len(out) - 4000) < 160
    mid = out[500 : 500 + 2048]
    assert abs(np.argmax(np.abs(np.fft.rfft(mid * np.hanning(2048)))) * 8000 / 2048 - 440.0) < 10


# ---------------------------------------------------------------------------
# the state machine (tests/test_player.py:150-314)


def test_player_set_track_seek_pause_resume():
    store = {7: (np.zeros(2000, np.float32), 1, 1000, 2.0)}
    events = []
    p = Player(_tracks(store), events.append)
    p.max_sec = 2.0
    p.set_track(7, 0.5)
    assert p.playback.track_id == 7 and abs(p.playback.position_sec() - 0.5) < 1e-9
    assert not p.playback.is_playing
    p.resume()
    assert p.playback.is_playing
    p.pause()
    assert not p.playback.is_playing
    p.seek(5.0)
    assert abs(p.playback.position_sec() - 2.0) < 1e-9
    p.seek(-1.0)
    assert p.playback.position_sec() == 0.0
    p.set_track(99, None)
    assert p.playback.track_id is None and not p.playback.is_playing
    assert len(events) >= 4


def test_player_position_advances_and_ends():
    p = Player(_tracks({0: (np.zeros(1000, np.float32), 1, 100000, 0.01)}))
    p.max_sec = 0.01
    p.set_track(0, 0.0)
    p.resume()
    _run_until_stopped(p)
    assert not p.playback.is_playing
    assert abs(p.playback.position_sec() - 0.01) < 1e-9


def test_position_sec_clamps_and_volume():
    pd = PlaybackData(samples=np.zeros(6, np.float32), input_channels=2, sample_rate=3,
                      position_frame=100.0)
    assert pd.position_sec() == 1.0 and PlaybackData().position_sec() == 0.0
    p = Player(lambda _: None)
    j = jax_player.Player(lambda _: None, output="off")
    for db in (-6.0, -60.0, 0.0, 3.3, -0.1):
        p.set_volume_db(db)
        j.set_volume_db(db)
        assert p.playback.volume == j.playback.volume  # the JAX package's f32 gain
    p.set_volume_db(-6.0)
    assert abs(p.playback.volume - 10 ** (-6 / 20)) < 1e-6


def test_seek_after_end_no_spurious_end_event():
    events = []
    p = Player(_tracks({0: (np.zeros(1000, np.float32), 1, 100000, 0.01)}), emit=events.append)
    p.max_sec = 0.01
    p.set_track(0, 0.0)
    p.resume()
    _run_until_stopped(p)
    assert not p.playback.is_playing
    p.seek(0.0)
    baseline = len(events)
    p.tick()
    p.tick()
    assert len(events) == baseline, events[baseline:]
    p.resume()
    _run_until_stopped(p)
    assert not p.playback.is_playing and len(events) > baseline


def test_seek_without_track_emits_state():
    events = []
    Player(_tracks({}), emit=events.append).seek(5.0)
    assert events and events[-1]["positionSec"] == 0.0


class DeadDevice(OutputDevice):
    name = "dead"

    def supported_configs(self):
        return []

    def default_config(self):
        raise RuntimeError("no device")

    def is_alive(self):
        return False

    def open_stream(self, config, callback):
        raise RuntimeError("no device")


def test_wallclock_fallback_when_stream_unbuildable():
    p = Player(_tracks({0: (np.zeros(100, np.float32), 1, 1000, 0.1)}))
    assert p.output_engine is not None
    p.output_engine.set_device(DeadDevice())
    assert not p.output_engine.is_active()
    p.max_sec = 0.1
    p.set_track(0, 0.0)
    p.resume()
    _run_until_stopped(p, 3.0)
    assert not p.playback.is_playing
    assert abs(p.playback.position_sec() - 0.1) < 1e-6


# ---------------------------------------------------------------------------
# the output stream (tests/test_player_stream.py)


def make_playback(samples, n_ch, sr, playing=True, volume=1.0, cls=PlaybackData):
    p = cls()
    p.track_id = 0
    p.samples = np.asarray(samples, np.float32)
    p.input_channels = n_ch
    p.sample_rate = sr
    p.volume = volume
    p.is_playing = playing
    return p


def test_fill_stereo_identity_and_position_advance():
    frames = np.arange(400, dtype=np.float32) / 400.0
    p = make_playback(np.stack([frames, -frames], 1).reshape(-1), 2, 48000)
    src = PlaybackStreamSource(p, threading.Lock())
    out = src.fill(128, 2, 48000)
    np.testing.assert_array_equal(out[:, 0], frames[:128])
    np.testing.assert_array_equal(out[:, 1], -frames[:128])
    assert p.position_frame == 128.0
    np.testing.assert_array_equal(src.fill(128, 2, 48000)[:, 0], frames[128:256])
    assert p.position_frame == 256.0


def test_fill_mono_broadcast_volume_clamp_end_and_pause():
    src = PlaybackStreamSource(make_playback(np.full(1000, 0.8, np.float32), 1, 48000, volume=2.0),
                               threading.Lock())
    np.testing.assert_array_equal(src.fill(64, 2, 48000), np.ones((64, 2), np.float32))
    p = make_playback(np.ones(100, np.float32) * 0.5, 1, 8000)
    src = PlaybackStreamSource(p, threading.Lock())
    out = src.fill(256, 2, 8000)
    np.testing.assert_array_equal(out[:100], np.full((100, 2), 0.5, np.float32))
    np.testing.assert_array_equal(out[100:], 0.0)
    assert src.reached_end and not p.is_playing and p.position_frame == 100.0
    p = make_playback(np.ones(1000, np.float32), 1, 8000, playing=False)
    np.testing.assert_array_equal(PlaybackStreamSource(p, threading.Lock()).fill(64, 2, 8000), 0.0)
    assert p.position_frame == 0.0


def test_fill_equal_rate_is_the_jax_packages_fill():
    """The equal-rate path (slice, mix, volume, clamp) bit for bit."""
    wav = np.random.default_rng(9).uniform(-1.5, 1.5, 3 * 5000).astype(np.float32)
    outs = []
    for data_cls, src_cls in ((PlaybackData, PlaybackStreamSource),
                              (jax_player.PlaybackData, jax_stream.PlaybackStreamSource)):
        p = make_playback(wav, 3, 48000, volume=0.7, cls=data_cls)
        src = src_cls(p, threading.Lock())
        outs.append(b"".join(src.fill(700, ch, 48000).tobytes() for ch in (1, 2, 4, 2, 1)))
        outs.append(p.position_frame)
    assert outs[:2] == outs[2:]


def test_fill_resampled_matches_stream_resampler():
    """The sr-mismatch path equals feeding the StreamResampler directly;
    position at the exact rate ratio (tests/test_player_stream.py:86)."""
    sr_in, sr_out = 44100, 48000
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 8000).astype(np.float32)
    p = make_playback(wav, 1, sr_in)
    src = PlaybackStreamSource(p, threading.Lock())
    got = np.concatenate([src.fill(512, 1, sr_out)[:, 0] for _ in range(6)])
    rs = StreamResampler(sr_in, sr_out, 1)
    expect, fed = [], 0
    while sum(len(e) for e in expect) < len(got):
        chunk = np.zeros(1024, np.float32)
        avail = max(min(1024, len(wav) - fed), 0)
        chunk[:avail] = wav[fed : fed + avail]
        expect.append(rs.process(chunk[None, :])[0])
        fed += 1024
    np.testing.assert_allclose(got, np.clip(np.concatenate(expect)[: len(got)], -1, 1), atol=1e-6)
    assert p.position_frame == pytest.approx(6 * 512 * sr_in / sr_out)


def test_fill_seek_resets_resampler_via_cursor_version():
    wav = np.sin(np.arange(20000) * 0.01).astype(np.float32)
    p = make_playback(wav, 1, 44100)
    src = PlaybackStreamSource(p, threading.Lock())
    src.fill(512, 1, 48000)
    p.position_frame = 10000.0
    p.cursor_version += 1
    out = src.fill(512, 1, 48000)
    p2 = make_playback(wav, 1, 44100)
    p2.position_frame = 10000.0
    np.testing.assert_array_equal(out, PlaybackStreamSource(p2, threading.Lock()).fill(512, 1, 48000))


def test_mix_frames_and_sample_formats():
    np.testing.assert_allclose(mix_frames(np.array([[0.1, 0.3]], np.float32), 1)[0, 0], 0.2, atol=1e-7)
    np.testing.assert_array_equal(mix_frames(np.array([[0.1, 0.3]], np.float32), 4)[0],
                                  np.array([0.1, 0.3, 0.1, 0.3], np.float32))
    np.testing.assert_array_equal(mix_frames(np.array([[0.7]], np.float32), 2)[0],
                                  np.array([0.7, 0.7], np.float32))
    np.testing.assert_array_equal(mix_frames(np.array([[0.1, 0.2, 0.3, 0.4, 0.5]], np.float32), 2)[0],
                                  np.array([0.1, 0.2], np.float32))
    block = np.array([[-1.0, 0.0, 1.0, 0.25, -0.7]], np.float32)
    for fmt in ("f32", "i16", "u16", "i24", "u24"):
        got = convert_sample_format(block, fmt)
        want = jax_stream.convert_sample_format(block, fmt)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert list(convert_sample_format(block, "i16")[0][:3]) == [-32768, 0, 32767]
    assert list(convert_sample_format(block, "u16")[0][:3]) == [0, 32768, 65535]
    assert list(convert_sample_format(block, "i24")[0][:3]) == [-8388608, 0, 8388607]


class FakeDevice(OutputDevice):
    name = "fake"

    def __init__(self, ranges, default):
        self._ranges = ranges
        self._default = default
        self.alive = True
        self.open_count = 0
        self.fail_next_open = False
        self.handles = []

    def supported_configs(self):
        return self._ranges

    def default_config(self):
        return self._default

    def is_alive(self):
        return self.alive

    def open_stream(self, config, callback):
        self.open_count += 1
        if self.fail_next_open:
            self.fail_next_open = False
            raise RuntimeError("device busy")

        class _H:
            error = None
            closed = False

            def close(self_h):
                self_h.closed = True

        self.handles.append(_H())
        return self.handles[-1]


def test_select_output_config_nearest_with_at_least_tiebreak_and_tiers():
    dflt = StreamConfig(2, 44100, 512, "f32")
    dev = FakeDevice([SupportedConfigRange(2, 8000, 48000, "f32"),
                      SupportedConfigRange(2, 88200, 96000, "f32"),
                      SupportedConfigRange(1, 8000, 192000, "f32")], dflt)
    for req, want in ((44100, 44100), (96000, 96000), (60000, 48000), (68100, 88200), (192000, 96000)):
        assert select_output_config(dev, req).sample_rate == want
    assert select_output_config(dev, 0) == dflt
    dflt = StreamConfig(2, 48000, 512, "f32")
    cfg = select_output_config(FakeDevice([SupportedConfigRange(6, 8000, 96000, "f32")], dflt), 44100)
    assert (cfg.sample_rate, cfg.channels, cfg.sample_format) == (44100, 6, "f32")
    cfg = select_output_config(FakeDevice([SupportedConfigRange(2, 8000, 96000, "i16")], dflt), 44100)
    assert (cfg.sample_rate, cfg.sample_format) == (44100, "i16")
    assert select_output_config(FakeDevice([], dflt), 44100) == dflt


def test_fill_resampled_plays_full_tail_before_end():
    n = 44100 // 5
    wav = (0.5 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100)).astype(np.float32)
    p = make_playback(wav, 1, 44100)
    src = PlaybackStreamSource(p, threading.Lock())
    out_frames, ended = 0, False
    for _ in range(200):
        out = src.fill(256, 2, 48000)
        out_frames += int((np.abs(out).max(axis=1) > 0).sum())
        if src.reached_end:
            ended = True
            break
    assert ended and out_frames >= int(n * 48000 / 44100) - 64 and not p.is_playing


def test_resume_at_end_reemits_ended():
    events = []
    p = Player(_tracks({0: (np.zeros(1000, np.float32), 1, 100000, 0.01)}),
               lambda e: events.append(dict(e)))
    p.max_sec = 0.01
    p.set_track(0, 0.0)
    p.resume()
    _run_until_stopped(p)
    assert not p.playback.is_playing
    events.clear()
    p.resume()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not any(not e["isPlaying"] for e in events):
        p.tick()
        time.sleep(0.02)
    assert any(not e["isPlaying"] for e in events)


def test_output_engine_rebuilds_on_error_and_device_loss():
    p = make_playback(np.ones(100, np.float32), 1, 8000)
    dev = FakeDevice([SupportedConfigRange(2, 8000, 192000, "f32")], StreamConfig(2, 48000, 256, "f32"))
    eng = OutputEngine(p, threading.Lock(), device=dev)
    eng.ensure_stream(44100)
    assert eng.config.sample_rate == 44100 and dev.open_count == 1
    dev.fail_next_open = True
    eng.ensure_stream(48000)
    assert "device busy" in eng.error
    eng._last_poll = 0.0
    eng.poll()
    assert eng.error == "" and eng.config.sample_rate == 48000 and dev.open_count == 3


def test_null_device_paced_stream_consumes_in_real_time():
    calls = []

    def cb(n, ch, sr):
        calls.append((n, ch, sr))
        return np.zeros((n, ch), np.float32)

    h = NullOutputDevice(default_sr=8000).open_stream(StreamConfig(2, 8000, 160, "f32"), cb)
    time.sleep(0.12)
    h.close()
    assert h.error is None and 3 <= len(calls) <= 10 and calls[0] == (160, 2, 8000)


def test_player_with_stream_sink_end_to_end():
    sr = 8000
    wav = np.sin(np.arange(int(sr * 0.3)) * 0.1).astype(np.float32)
    events = []
    player = Player(lambda tid: (wav, 1, sr, len(wav) / sr) if tid == 0 else None,
                    emit=events.append, output="auto")
    assert player.output_engine is not None
    player.max_sec = len(wav) / sr
    player.set_sr(sr)
    assert player.requested_sr == sr
    player.set_track(0, 0.0)
    player.resume()
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline and not player.output_engine.source.reached_end:
        player.tick()
        time.sleep(0.02)
    player.tick()
    assert player.output_engine.source.reached_end and not player.playback.is_playing
    assert player.playback.position_sec() == pytest.approx(0.3, abs=0.01)
    assert any(not e["isPlaying"] and e["positionSec"] > 0.29 for e in events)


def test_fill_output_rate_change_reanchors_feed_cursor():
    sr, n = 32000, 32000 * 4
    p = make_playback((np.arange(n, dtype=np.float32) / n).astype(np.float32), 1, sr)
    src = PlaybackStreamSource(p, threading.Lock())
    src.fill(256, 1, 48000)
    for _ in range(20):
        src.fill(1024, 1, sr)
    pos_now = p.position_frame
    out = src.fill(256, 1, 48000)
    assert abs(float(out[200, 0]) - (pos_now + 200 * sr / 48000) / n) < 0.02


def test_engine_rebuild_serialized_under_lock():
    p = make_playback(np.zeros(1000, np.float32), 1, 8000)
    dev = FakeDevice([SupportedConfigRange(2, 8000, 48000, "f32")], StreamConfig(2, 48000, 256, "f32"))
    eng = OutputEngine(p, threading.Lock(), device=dev)
    stop = threading.Event()

    def churn(fn):
        for i in itertools.count():
            if stop.is_set():
                return
            fn(8000 + (i % 3) * 8000)

    threads = [threading.Thread(target=churn, args=(eng.ensure_stream,)),
               threading.Thread(target=churn, args=(lambda _sr: eng.poll(),))]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert dev.open_count >= 1 and len([h for h in dev.handles if not h.closed]) <= 1
    eng.close()


# ---------------------------------------------------------------------------
# remote (browser) audio (tests/test_remote_audio.py, the service aside)


def _decode(chunk: bytes) -> dict:
    n, ch, sr, flags, pos, ver, _pad = struct.unpack_from("<IIIIdII", chunk, 0)
    return {"n": n, "ch": ch, "sr": sr, "playing": bool(flags & 1), "ended": bool(flags & 2),
            "pos": pos, "ver": ver, "data": np.frombuffer(chunk, np.float32, offset=32).reshape(n, ch)}


def _player_with_remote(store, remote_sr=48000, channels=2, cls=Player):
    p = cls(_tracks(store))
    assert p.attach_remote_audio(remote_sr, channels)["sampleFormat"] == "f32"
    return p


def test_wire_format_golden():
    data = np.array([[0.5, -0.5], [1.0, -1.0]], np.float32)
    chunk = encode_pcm_chunk(data, 48000, 1.25, 7, True, False)
    assert chunk == jax_player.encode_pcm_chunk(data, 48000, 1.25, 7, True, False)
    d = _decode(chunk)
    assert len(chunk) == 48 and (d["n"], d["ch"], d["sr"]) == (2, 2, 48000)
    assert d["playing"] and not d["ended"] and d["pos"] == 1.25 and d["ver"] == 7
    np.testing.assert_array_equal(d["data"], data)


def test_pull_equals_engine_fill_byte_for_byte():
    """tests/test_remote_audio.py:62: every pulled chunk is render_block of
    the track samples, and the same bytes as the JAX package's player."""
    sr = 48000
    samples = np.random.default_rng(1).uniform(-1.2, 1.2, 2 * sr).astype(np.float32)
    store = {0: (samples, 1, sr, 2.0)}
    players = [_player_with_remote(store), _player_with_remote(store, cls=jax_player.Player)]
    chunks = []
    for p in players:
        p.max_sec = 2.0
        p.set_volume_db(-6.0)
        p.set_track(0, 0.25)
        p.resume()
        chunks.append([p.pull_pcm(480) for _ in range(2)])
    assert chunks[0] == chunks[1]  # headers and PCM
    vol = players[0].playback.volume
    d1, d2 = _decode(chunks[0][0]), _decode(chunks[0][1])
    assert d1["data"].tobytes() == render_block(samples, 1, 12000, 480, 2, vol).tobytes()
    assert d2["data"].tobytes() == render_block(samples, 1, 12480, 480, 2, vol).tobytes()
    assert d2["pos"] == pytest.approx((12000 + 960) / sr) and d1["playing"] and not d1["ended"]


def test_pull_resampled_track():
    samples = (0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 8000)).astype(np.float32)
    p = _player_with_remote({0: (samples, 1, 8000, 1.0)}, remote_sr=48000)
    p.max_sec = 1.0
    p.set_track(0, 0.0)
    p.resume()
    d = _decode(p.pull_pcm(4800))
    assert d["sr"] == 48000 and d["ch"] == 2 and d["pos"] == pytest.approx(0.1)
    body = d["data"][1024:]
    assert np.max(np.abs(body)) > 0.2 and np.max(np.abs(d["data"])) <= 1.0
    np.testing.assert_array_equal(body[:, 0], body[:, 1])


def test_seek_bumps_cursor_version_paused_pull_and_end():
    sr = 48000
    samples = np.linspace(-0.5, 0.5, 2 * sr, dtype=np.float32)
    p = _player_with_remote({0: (samples, 1, sr, 2.0)})
    p.max_sec = 2.0
    p.set_track(0, 0.0)
    p.resume()
    v0 = _decode(p.pull_pcm(480))["ver"]
    p.seek(1.0)
    d = _decode(p.pull_pcm(480))
    assert d["ver"] == v0 + 1
    assert d["data"].tobytes() == render_block(samples, 1, sr, 480, 2, p.playback.volume).tobytes()
    p2 = _player_with_remote({0: (np.ones(sr, np.float32) * 0.5, 1, sr, 1.0)})
    p2.max_sec = 1.0
    p2.set_track(0, 0.5)
    d = _decode(p2.pull_pcm(480))
    assert not d["playing"] and d["pos"] == pytest.approx(0.5) and not d["data"].any()
    p3 = _player_with_remote({0: (np.ones(480, np.float32) * 0.25, 1, sr, 0.01)})
    p3.max_sec = 0.01
    p3.set_track(0, 0.0)
    p3.resume()
    d = _decode(p3.pull_pcm(480))
    assert d["ended"] and not d["playing"] and d["pos"] == pytest.approx(0.01)


def test_detach_bounds_and_attach_validation():
    p = _player_with_remote({0: (np.zeros(48000, np.float32), 1, 48000, 1.0)})
    p.set_track(0, 0.0)
    for bad in (0, MAX_PULL_FRAMES + 1):
        with pytest.raises(ValueError):
            p.pull_pcm(bad)
    p.detach_remote_audio()
    assert not p.remote_attached()
    with pytest.raises(ValueError):
        p.pull_pcm(480)
    p.detach_remote_audio()
    assert p.output_engine is not None and p.output_engine.is_active()
    q = Player(_tracks({}))
    for sr, ch in ((1000, 2), (48000, 7)):
        with pytest.raises(ValueError):
            q.attach_remote_audio(sr, ch)


def test_stale_remote_client_falls_back_to_local_output():
    store = {0: (np.zeros(96000, np.float32), 1, 48000, 2.0)}
    p = _player_with_remote(store)
    p.max_sec = 2.0
    p.set_track(0, 0.0)
    p.resume()
    p.pull_pcm(480)
    handle = p.output_engine.handle
    assert isinstance(handle, RemoteStreamHandle)
    p.tick()
    assert p.remote_attached()
    handle.last_pull_monotonic -= REMOTE_STALE_SEC + 1.0
    p.tick()
    assert not p.remote_attached()
    p2 = _player_with_remote(store)
    p2.max_sec = 2.0
    p2.set_track(0, 0.0)
    p2.output_engine.handle.last_pull_monotonic -= REMOTE_STALE_SEC + 1.0
    p2.tick()
    assert p2.remote_attached()


def test_latest_attach_wins_and_remote_config_selection():
    p = _player_with_remote({0: (np.zeros(48000, np.float32), 1, 48000, 1.0)})
    assert p.attach_remote_audio(44100, 2)["sampleRate"] == 44100
    assert p.output_engine.config.sample_rate == 44100
    dev = RemoteOutputDevice(44100, 2)
    for req in (0, 8000, 44100, 192000):
        cfg = select_output_config(dev, req)
        assert cfg.sample_rate == 44100 and cfg.sample_format == "f32"


def test_off_mode_detach_stale_and_failed_attach_restore_off():
    sr = 48000
    store = {0: (np.zeros(2 * sr, np.float32), 1, sr, 2.0)}
    p = Player(_tracks(store), output="off")
    assert p.output_engine is None
    p.attach_remote_audio(sr, 2)
    p.detach_remote_audio()
    assert p.output_engine is None and not p.remote_attached()
    p.max_sec = 2.0
    p.set_track(0, 0.0)
    p.resume()
    time.sleep(0.03)
    p.tick()
    assert p.playback.position_sec() > 0.0
    q = Player(_tracks(store), output="off")
    q.attach_remote_audio(sr, 2)
    q.max_sec = 2.0
    q.set_track(0, 0.0)
    q.resume()
    q.pull_pcm(480)
    q.output_engine.handle.last_pull_monotonic -= REMOTE_STALE_SEC + 1.0
    anchor = q._anchor
    q.tick()
    assert q.output_engine is None and q._anchor >= anchor
    assert q.attach_remote_audio(sr, 2)["sampleRate"] == sr and q.remote_attached()
    r = Player(_tracks({}), output="off")
    with pytest.raises(ValueError):
        r.attach_remote_audio(1000, 2)
    assert r.output_engine is None


def test_closed_remote_handle_pull_raises():
    p = _player_with_remote({0: (np.zeros(48000, np.float32), 1, 48000, 1.0)})
    p.set_track(0, 0.0)
    handle = p.output_engine.handle
    assert handle.config.sample_rate == 48000
    p.detach_remote_audio()
    with pytest.raises(ValueError):
        handle.pull(480)


def test_threaded_pull_vs_detach_attach_churn():
    p = _player_with_remote({0: (np.zeros(30 * 48000, np.float32), 1, 48000, 30.0)})
    p.max_sec = 30.0
    p.set_track(0, 0.0)
    p.resume()
    stop = threading.Event()
    failures: list = []

    def puller():
        while not stop.is_set():
            try:
                d = _decode(p.pull_pcm(512))
            except ValueError:
                continue
            except Exception as e:  # noqa: BLE001
                failures.append(f"pull: {type(e).__name__}: {e}")
                return
            if d["sr"] not in (44100, 48000) or d["ch"] != 2 or d["n"] != 512:
                failures.append(f"malformed chunk: {d['sr']} {d['ch']} {d['n']}")
                return

    def churner():
        rng = np.random.default_rng(5)
        while not stop.is_set():
            try:
                r = rng.random()
                if r < 0.4:
                    p.attach_remote_audio(int(rng.choice([44100, 48000])), 2)
                elif r < 0.7:
                    p.detach_remote_audio()
                else:
                    p.seek(float(rng.uniform(0, 20)))
            except ValueError:
                pass
            except Exception as e:  # noqa: BLE001
                failures.append(f"churn: {type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=puller) for _ in range(2)] + [threading.Thread(target=churner)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not failures, failures[:3]
