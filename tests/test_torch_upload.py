"""The port's add path as the JAX package runs it, on the CPU:

1. K4 (thesia_tpu_torch/kernels/pcm.py) against the JAX programs
   ``_deinterleave_flat`` and ``_deinterleave_s24`` (and ``_s16_to_f32``,
   the int16 conversion inside the first) and the
   port's host decode, bit for bit, for s16/s24/f32 and 1-3 channels with a
   trailing partial frame; the plain versions agree too.
2. ``upload_interleaved_pcm`` / ``prefetch_matches`` (tests/test_dsp.py:521-573).
3. The session's big-WAV prefetch: adoption, images equal to a session
   without it and to the JAX session's (tests/test_session.py:321-429), the
   shared read, failures counted in ``prefetch_failed``, a failed decode, and
   one upload per track per add (K9 reads the cached device wav).
4. An add with its prefetch in flight when the interpreter exits.

The JAX package's ``_as_s16_grid`` route is not ported (PERF.md), so
tests/test_dsp.py:453-496 have no counterpart here.

Tests marked gpu run the pinned copy stream and K4 on a card and skip
without one."""

import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_session import _check_images, _check_range, _snapshot
from thesia_tpu.dsp import spectrogram as jax_spec
from thesia_tpu.engine import session as jax_session
from thesia_tpu_torch.dsp import spectrogram as port_spec
from thesia_tpu_torch.dsp import upload
from thesia_tpu_torch.dsp.framing import SpecSetting
from thesia_tpu_torch.dynamics import stats_device
from thesia_tpu_torch.engine import session as port_session
from thesia_tpu_torch.io.wav import decode_wav, encode_wav_s16, probe_wav
from thesia_tpu_torch.kernels import pcm
from thesia_tpu_torch.render.colormap import default_colormap_rgba8
from thesia_tpu_torch.tools.signals import wav_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMAP = default_colormap_rgba8()
CPU = torch.device("cpu")
WIDTH = {"s16": 2, "s24": 3, "f32": 4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _payload(fmt, c, n, seed):
    """A WAV of n frames plus a trailing partial frame, its payload and the
    host decode (planar f32)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, (c, n)).astype(np.float32)
    w[:, 0] = -1.0  # the extremes of every format
    w[:, 1] = 1.0
    full = wav_bytes(w, 8000, fmt)
    # a partial frame the decode drops: one more sample of channel 0 (of a
    # mono track, part of one)
    extra = WIDTH[fmt] if c > 1 else WIDTH[fmt] - 1
    payload = full[44 : 44 + n * c * WIDTH[fmt]] + bytes(range(1, extra + 1))
    chunks = full[8:36] + b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        chunks += b"\0"
    data = b"RIFF" + struct.pack("<I", len(chunks)) + chunks
    planar, _sr, _codec = decode_wav(data)
    assert planar.shape == (c, n)
    return data, probe_wav(data)[4], planar


def _jax_k4(fmt, payload, c, n):
    raw = np.frombuffer(payload, np.uint8)[: n * WIDTH[fmt] * c]
    if fmt == "s24":
        return np.asarray(jax_spec._deinterleave_s24(jnp.asarray(raw[None]), c=c, bucket=n))
    flat = raw.view("<i2" if fmt == "s16" else "<f4")
    return np.asarray(jax_spec._deinterleave_flat(jnp.asarray(flat[None]), c=c, bucket=n))


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("fmt", ["s16", "s24", "f32"])
def test_k4_matches_the_jax_programs_and_the_host_decode(fmt, c):
    n = 4001
    _data, payload, planar = _payload(fmt, c, n, seed=10 * c + WIDTH[fmt])
    flat = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    pcm.reset_launches()
    got = port_spec._deinterleave(flat[: flat.numel() - flat.numel() % WIDTH[fmt]], c, fmt)
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == (c, n)
    np.testing.assert_array_equal(got.numpy(), planar)
    np.testing.assert_array_equal(got.numpy(), _jax_k4(fmt, payload, c, n))
    if fmt == "s24":
        assert pcm.deinterleave_s24.launches == 1
        ref = pcm.deinterleave_s24_reference(flat[: n * 3 * c], c)
    else:
        assert pcm.deinterleave_flat.launches == 1
        typed = flat[: n * WIDTH[fmt] * c].view(torch.int16 if fmt == "s16" else torch.float32)
        ref = pcm.deinterleave_flat_reference(typed, c)
    assert torch.equal(ref, got)


def test_the_s16_conversion_is_the_jax_programs():
    """deinterleave_flat of int16 converts as the JAX package's _s16_to_f32
    (x * 2**-15), extremes included."""
    rng = np.random.default_rng(3)
    ints = rng.integers(-32768, 32768, 15000, np.int64).astype(np.int16)
    ints[:2] = (-32768, 32767)
    got = pcm.deinterleave_flat(torch.from_numpy(ints), 1)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(jax_spec._s16_to_f32(jnp.asarray(ints))))
    np.testing.assert_array_equal(got.numpy()[0], ints.astype(np.float32) / 32768.0)
    with pytest.raises(TypeError):
        pcm.deinterleave_flat(torch.zeros(4, dtype=torch.uint8), 2)
    with pytest.raises(TypeError):
        pcm.deinterleave_s24(torch.zeros(6, dtype=torch.int16), 1)
    with pytest.raises(ValueError):
        pcm.deinterleave_flat(torch.zeros((2, 4), dtype=torch.int16), 2)


@pytest.mark.parametrize("fmt", ["s16", "s24", "f32"])
def test_prefetch_interleaved_pcm_bitexact(fmt, monkeypatch):
    """tests/test_dsp.py:521-573 on the port, against the JAX package's
    upload and probe: the device wav is the host decode bit for bit, and a
    corrupted decode is rejected by the probe."""
    monkeypatch.setattr(port_spec.SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    monkeypatch.setattr(jax_spec.SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    n, c = 50_000, 2
    data, payload, planar = _payload(fmt, c, n, seed=61)
    an = port_spec.SpectrogramAnalyzer("cpu")
    upload.reset_counters()
    res = an.upload_interleaved_pcm(payload, c, fmt)
    assert res is not None and upload.counters == {"uploads": 1, "bytes": n * c * WIDTH[fmt]}
    dev, got_n, probe = res
    assert got_n == n and dev.shape == (c, n)
    np.testing.assert_array_equal(dev.numpy(), planar)
    assert an.prefetch_matches(probe, planar)
    jdev, jn, jprobe = jax_spec.SpectrogramAnalyzer().upload_interleaved_pcm(payload, c, fmt)
    assert jn == n
    np.testing.assert_array_equal(np.asarray(jdev)[:, :n], dev.numpy())
    np.testing.assert_array_equal(jprobe[0], probe[0])
    np.testing.assert_array_equal(jprobe[1], probe[1])
    bad = planar.copy()
    bad[probe[0][3] % c, probe[0][3] // c] += np.float32(1e-3)
    assert not an.prefetch_matches(probe, bad)
    assert not jax_spec.SpectrogramAnalyzer.prefetch_matches(jprobe, bad)
    assert an._wav_cache == {}  # the prefetch installs nothing itself


def test_upload_interleaved_pcm_declines_what_it_cannot_take():
    an = port_spec.SpectrogramAnalyzer("cpu")
    payload = bytes(1024)
    assert an.upload_interleaved_pcm(payload, 1, "s16") is None  # under the threshold
    an._PREFETCH_MIN_BYTES = 0
    assert an.upload_interleaved_pcm(payload, 1, "u8") is None
    assert an.upload_interleaved_pcm(payload, 0, "s16") is None
    dev = torch.zeros((1, 10))
    with pytest.raises(ValueError):
        an.adopt_wav(0, dev, 11, 1)
    an.adopt_wav(None, dev, 10, 1)
    an.adopt_wav(0, dev, 10, None)
    assert an._wav_cache == {} and an.prefetch_adopted == 0


def _big_wav(tmp_path, name, seed, c=2, n=120_000, sr=8000):
    """Sines plus white noise at -60 dBFS as a 16-bit WAV (the signals of
    tests/test_torch_session.py: the global range then sits dB_range below
    the max, where the u16 contract of tests/torch_parity.py applies)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    w = np.stack([0.5 * np.sin(2 * np.pi * (300.0 + 110.0 * ch) * t) + 1e-3 * rng.standard_normal(n)
                  for ch in range(c)]).astype(np.float32)
    p = tmp_path / name
    p.write_bytes(encode_wav_s16(w, sr))
    return p


@pytest.fixture
def prefetch_everything(monkeypatch):
    """Every WAV takes the prefetch, in both packages (as the JAX tests set
    the thresholds)."""
    for cls in (port_session.EngineSession, jax_session.EngineSession):
        monkeypatch.setattr(cls, "_PREFETCH_MIN_FILE_BYTES", 0)
    for cls in (port_spec.SpectrogramAnalyzer, jax_spec.SpectrogramAnalyzer):
        monkeypatch.setattr(cls, "_PREFETCH_MIN_BYTES", 0)


def _port(tmp_path, name):
    s = port_session.EngineSession(device="cpu", settings_dir=tmp_path / name)
    s.init(CMAP)
    return s


def test_wav_prefetch_upload_adopted_and_bitexact(tmp_path, monkeypatch, prefetch_everything):
    """tests/test_session.py:321-373 on the port: the prefetch is adopted, the
    cache entry is it, the spectrogram reuses it, and the images equal a
    session without the prefetch bit for bit and the JAX session's (which
    prefetches too) within the contract."""
    p = _big_wav(tmp_path, "pf.wav", 51)
    adopted = []
    orig_adopt = port_spec.SpectrogramAnalyzer.adopt_wav

    def spy(self, cache_key, dev, n, token):
        adopted.append((cache_key, id(dev)))
        return orig_adopt(self, cache_key, dev, n, token)

    monkeypatch.setattr(port_spec.SpectrogramAnalyzer, "adopt_wav", spy)
    s = _port(tmp_path, "cfg")
    s.add_tracks([0], [str(p)])
    an = s.tm.spec_analyzer
    assert adopted and adopted[0][0] == 0
    assert id(an._wav_cache[0][0]) == adopted[0][1]
    assert (an.prefetch_adopted, an.prefetch_failed) == (1, 0)
    dev, token = an._wav_cache[0]
    assert dev.shape == (2, 120_000) and token == s.tracklist[0].original.version
    np.testing.assert_array_equal(dev.numpy(), s.tracklist[0].original.wavs)
    s.apply_track_list_changes()
    assert an._wav_cache[0][0] is dev  # reused, not replaced
    imgs_pf = {k: np.asarray(v) for k, v in s.tm.spec_imgs.items()}

    s2 = _port(tmp_path, "cfg2")
    s2._PREFETCH_MIN_FILE_BYTES = 1 << 60
    s2.add_tracks([0], [str(p)])
    s2.apply_track_list_changes()
    assert s2.tm.spec_analyzer.prefetch_adopted == 0
    for k, img in s2.tm.spec_imgs.items():
        np.testing.assert_array_equal(imgs_pf[k], np.asarray(img))

    js = jax_session.EngineSession(settings_dir=tmp_path / "jax")
    js.init(CMAP)
    js.add_tracks([0], [str(p)])
    js.apply_track_list_changes(defer=False)
    j, port = _snapshot(js, ("0_0", "0_1")), _snapshot(s, ("0_0", "0_1"))
    assert port["metadata"] == j["metadata"]
    _check_range(j, port)
    _check_images(j, port)


def test_wav_prefetch_read_failure_falls_back(tmp_path, monkeypatch, prefetch_everything):
    """tests/test_session.py:376-429 on the port: a failing prefetch leaves
    the ordinary upload of the decoded samples in the cache and counts in
    prefetch_failed; a failing shared read makes the decoder read the file."""
    p = _big_wav(tmp_path, "race.wav", 52, c=1, n=60_000)
    s = _port(tmp_path, "cfg")

    def boom(read_fut):
        read_fut.result()
        raise OSError("simulated prefetch read/upload failure")

    monkeypatch.setattr(port_session.EngineSession, "_prefetch_one", lambda self, rf: boom(rf))
    assert s.add_tracks([0], [str(p)]) == [0]
    dev, _tok = s.tm.spec_analyzer._wav_cache[0]
    np.testing.assert_array_equal(dev.numpy(), s.tracklist[0].original.wavs)
    assert (s.tm.spec_analyzer.prefetch_adopted, s.tm.spec_analyzer.prefetch_failed) == (0, 1)

    import concurrent.futures

    def bad_read(self, track_ids, paths):
        pool = concurrent.futures.ThreadPoolExecutor(1)

        def fail():
            raise OSError("simulated read failure")

        rf = pool.submit(fail)
        uf = pool.submit(lambda: None)
        return {tid: (rf, uf) for tid in track_ids}

    monkeypatch.setattr(port_session.EngineSession, "_start_wav_prefetch", bad_read)
    assert s.add_tracks([1], [str(p)]) == [1]
    np.testing.assert_array_equal(s.tracklist[1].original.wavs, s.tracklist[0].original.wavs)


def test_a_prefetch_that_does_not_match_its_decode_is_not_adopted(tmp_path, monkeypatch,
                                                                   prefetch_everything):
    p = _big_wav(tmp_path, "m.wav", 53)
    monkeypatch.setattr(port_spec.SpectrogramAnalyzer, "prefetch_matches",
                        staticmethod(lambda probe, wavs: False))
    s = _port(tmp_path, "cfg")
    assert s.add_tracks([0], [str(p)]) == [0]
    an = s.tm.spec_analyzer
    assert (an.prefetch_adopted, an.prefetch_failed) == (0, 1)
    np.testing.assert_array_equal(an._wav_cache[0][0].numpy(), s.tracklist[0].original.wavs)


def test_a_track_that_fails_to_decode_drops_its_prefetch(tmp_path, prefetch_everything):
    """A .wav that does not decode: no track, nothing adopted, nothing failed
    (the upload is cancelled or ignored, as in the JAX package)."""
    good = _big_wav(tmp_path, "good.wav", 54)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVE" + bytes(100))
    s = _port(tmp_path, "cfg")
    assert s.add_tracks([0, 1], [str(bad), str(good)]) == [1]
    an = s.tm.spec_analyzer
    assert (an.prefetch_adopted, an.prefetch_failed) == (1, 0)
    assert list(an._wav_cache) == [1]


@pytest.mark.parametrize("prefetch", [False, True])
def test_one_upload_per_track_per_add(tmp_path, monkeypatch, prefetch):
    """Two tracks, so K9 runs batched on the device route: each track's
    samples are uploaded once (its prefetch or the stats-time upload), K9's
    rows are device copies of the cached device wav, and the spectrogram
    reads the same entry.  Stats equal a session without device sources."""
    paths = [str(_big_wav(tmp_path, "a.wav", 55)), str(_big_wav(tmp_path, "b.wav", 56, c=1))]
    if prefetch:
        monkeypatch.setattr(port_session.EngineSession, "_PREFETCH_MIN_FILE_BYTES", 0)
        monkeypatch.setattr(port_spec.SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    s = _port(tmp_path, "cfg")
    upload.reset_counters()
    stats_device.reset_launches()
    assert s.add_tracks([0, 1], paths) == [0, 1]
    s.apply_track_list_changes()
    assert upload.counters["uploads"] == 2
    assert stats_device.lufs_stats_batched.launches == 1 + 1  # (sr, n_ch) groups
    assert stats_device.rows_from == {"device_wav": 2, "upload": 0}
    an = s.tm.spec_analyzer
    assert an.prefetch_adopted == (2 if prefetch else 0)
    for tid in (0, 1):
        assert an._wav_cache[tid][1] == s.tracklist[tid].original.version
    # the same stats as K9 on host-uploaded rows
    items = [(t, s.tracklist[t].original.wavs, s.tracklist[t].sr) for t in (0, 1)]
    want = stats_device.calc_stats_batched(items, CPU)
    assert [s.tracklist[t].original.stats for t in (0, 1)] == [want[0], want[1]]


EXIT_IN_FLIGHT = """
import sys, threading, tempfile
from pathlib import Path
import numpy as np
from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer
from thesia_tpu_torch.engine.session import EngineSession
from thesia_tpu_torch.io.wav import encode_wav_s16
from thesia_tpu_torch.render.colormap import default_colormap_rgba8
EngineSession._PREFETCH_MIN_FILE_BYTES = 0
SpectrogramAnalyzer._PREFETCH_MIN_BYTES = 0
d = Path(tempfile.mkdtemp())
w = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 400_000)).astype(np.float32)
(d / "a.wav").write_bytes(encode_wav_s16(w, 16000))
s = EngineSession(device="cpu", settings_dir=d / "c")
s.init(default_colormap_rgba8())
threading.Thread(target=s.add_tracks, args=([0], [str(d / "a.wav")])).start()
print("RETURNED", flush=True)
"""


def test_an_add_with_its_prefetch_in_flight_exits_cleanly(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", EXIT_IN_FLIGHT], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RETURNED" in proc.stdout
    assert "terminate called" not in proc.stderr and "Traceback" not in proc.stderr, proc.stderr


# -- on the card


@pytest.mark.gpu
def test_pinned_upload_through_the_ring_on_the_card(cuda, monkeypatch):
    """An upload of several chunks from a read-only view at an odd offset:
    equal bytes, one upload counted, the copy-stream events recorded, and the
    tensor readable on the current stream."""
    monkeypatch.setattr(upload, "CHUNK_BYTES", 1 << 16)
    upload._copiers.clear()
    blob = bytes(3) + np.random.default_rng(7).integers(0, 256, 5 * (1 << 16) + 333,
                                                         dtype=np.uint8).tobytes()
    src = np.frombuffer(memoryview(blob)[3:], np.uint8)
    assert not src.flags.writeable
    upload.reset_counters()
    up = upload.upload(src, cuda)
    got = up.tensor_for()
    assert upload.counters == {"uploads": 1, "bytes": src.nbytes} and len(upload.history) == 1
    assert np.array_equal(got.cpu().numpy(), src)
    assert upload.copy_stream_ms() >= 0.0
    f = np.random.default_rng(8).standard_normal((3, 70_001)).astype(np.float32)
    assert torch.equal(upload.upload(f, cuda).tensor_for().cpu(), torch.from_numpy(f))
    upload._copiers.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["s16", "s24", "f32"])
def test_k4_and_the_prefetch_on_the_card(cuda, fmt, monkeypatch):
    monkeypatch.setattr(port_spec.SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    _data, payload, planar = _payload(fmt, 2, 30_001, seed=71)
    an = port_spec.SpectrogramAnalyzer(cuda)
    dev, n, probe = an.upload_interleaved_pcm(payload, 2, fmt)
    assert dev.is_cuda and n == 30_001
    assert torch.equal(dev.cpu(), torch.from_numpy(planar))
    an.adopt_wav(0, dev, n, 1)
    assert an.device_wav(planar, 0, 1) is dev
    flat = torch.from_numpy(np.frombuffer(payload, np.uint8)[: n * 2 * WIDTH[fmt]].copy())
    for device in (cuda, CPU):
        got = port_spec._deinterleave(flat.to(device), 2, fmt)
        assert torch.equal(got.cpu(), torch.from_numpy(planar))
