"""The port's dsp modules (thesia_tpu_torch/dsp) against the JAX package's:
framing and STFT helpers bit for bit, reflect padding bit for bit against the
JAX device padding, operands bit for bit, and the analyzer's dB within the
tests/torch_parity.py contract against _spec_full (one track) and
calc_specs_batched (two tracks of different length and rate).  Each side gets
its own SpecSetting (the port's FreqScale is its own enum)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import thesia_tpu.dsp.spectrogram as jax_spec
import thesia_tpu_torch.dsp.spectrogram as port_spec
from torch_parity import assert_db_close, db_limit
from thesia_tpu.common import windows as jax_windows
from thesia_tpu.common.freqscale import FreqScale as JaxFreqScale
from thesia_tpu.dsp import framing as jax_framing
from thesia_tpu.dsp import stft as jax_stft
from thesia_tpu_torch.common.freqscale import FreqScale
from thesia_tpu_torch.dsp import framing as port_framing
from thesia_tpu_torch.dsp import stft as port_stft
from thesia_tpu_torch.kernels.spec_db import dft_matrices

SETTINGS = [
    (win_ms, t_ov, f_ov, scale)
    for win_ms in (1.0, 10.0, 40.0, 93.3, 500.0)
    for t_ov in (1, 4, 32)
    for f_ov in (1, 2)
    for scale in ("Mel", "Linear")
]
RATES = (8000, 11025, 16000, 22050, 44100, 48000, 96000)


def _settings(scale: str = "Mel"):
    """(JAX setting, port setting) for one frequency scale."""
    return (jax_framing.SpecSetting(freq_scale=JaxFreqScale(scale)),
            port_framing.SpecSetting(freq_scale=FreqScale(scale)))


@pytest.mark.parametrize("sr", RATES)
def test_spec_setting_framing_is_the_same(sr):
    for win_ms, t_ov, f_ov, scale in SETTINGS:
        d = {"winMillisec": win_ms, "tOverlap": t_ov, "fOverlap": f_ov, "freqScale": scale}
        a = jax_framing.SpecSetting.from_json(d)
        b = port_framing.SpecSetting.from_json(d)
        assert a.calc_framing_params(sr) == b.calc_framing_params(sr)
        assert a.calc_sr_win_nfft(sr).__dict__ == b.calc_sr_win_nfft(sr).__dict__
        assert a.to_json() == b.to_json()
    for bad in ({"winMillisec": 0.0}, {"winMillisec": 2001.0}, {"tOverlap": 65}, {"fOverlap": 9}):
        d = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel", **bad}
        with pytest.raises(ValueError):
            jax_framing.SpecSetting.from_json(d).validated()
        with pytest.raises(ValueError):
            port_framing.SpecSetting.from_json(d).validated()


def test_next_power_of_two_and_frame_count_are_the_same():
    for n in range(0, 5000, 7):
        assert port_framing.next_power_of_two(n) == jax_framing.next_power_of_two(n)
    for n in (0, 1, 2, 5, 79, 80, 81, 319, 320, 321, 4001, 48000):
        for win, hop in ((320, 80), (321, 107), (1920, 480), (7, 7), (2, 1)):
            assert port_stft.stft_frame_count(n, win, hop) == jax_stft.stft_frame_count(n, win, hop)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 159, 160, 161, 1000])
def test_reflect_indices_are_the_same(n):
    for pad in (0, 1, 5, 160, 960):
        want = jax_stft.reflect_indices(n, pad, pad)
        np.testing.assert_array_equal(
            port_stft.reflect_indices_torch(n, pad, pad, "cpu").numpy(), want
        )


@pytest.mark.parametrize("n", [161, 300, 4001])
def test_reflect_padding_equals_the_jax_device_padding(n):
    """n > pad: the JAX device path pads by plain reflection
    (_build_padded_row); the port's cyclic gather must give the same bits."""
    pad = 160
    rng = np.random.default_rng(n)
    raw = rng.standard_normal((2, n)).astype(np.float32)
    bucket = jax_spec.wav_size_bucket(n + 2 * pad)
    buf = np.zeros((2, bucket), np.float32)
    buf[:, :n] = raw
    want = np.asarray(jax_spec._build_padded(jnp.asarray(buf), jnp.int32(n), pad=pad, bucket=bucket))
    got = port_spec.reflect_pad_rows(torch.from_numpy(raw), pad).numpy()
    np.testing.assert_array_equal(got, want[:, : n + 2 * pad])


def test_reflect_padding_of_short_rows_equals_the_host_path():
    """n <= pad: the JAX short-track path pads on the host (cyclic)."""
    rng = np.random.default_rng(1)
    for n in (1, 2, 3, 50, 160):
        raw = rng.standard_normal((1, n)).astype(np.float32)
        want = jax_stft.reflect_pad_1d(raw, 160, 160)
        np.testing.assert_array_equal(port_spec.reflect_pad_rows(torch.from_numpy(raw), 160).numpy(), want)


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000])
def test_operands_carried_across_are_the_ports_own(sr):
    s = port_framing.SpecSetting()
    _hop, win, n_fft = s.calc_framing_params(sr)
    ja = jax_spec.SpectrogramAnalyzer()
    cw_j, sw_j = (np.asarray(a) for a in ja._dft_mats(win, n_fft))
    mel_j = np.asarray(ja.mel_fb(sr, n_fft))
    ta = port_spec.SpectrogramAnalyzer("cpu")
    window = ta.window(win, n_fft)
    assert not port_spec.use_rfft_for(win, n_fft)
    np.testing.assert_array_equal(window.numpy(), jax_windows.calc_normalized_win(jax_windows.WindowType.Hann, win, n_fft))
    cw_p, sw_p = dft_matrices(window, n_fft)
    for want, own in ((cw_j, cw_p), (sw_j, sw_p), (mel_j, ta.mel_fb(sr, n_fft))):
        assert own.dtype == torch.float32
        np.testing.assert_array_equal(own.numpy(), want)


def _signal(rng, sr, sec, ch):
    """Sines plus white noise at -60 dBFS, on the s16 grid."""
    n = int(sr * sec)
    t = np.arange(n) / sr
    rows = [0.5 * np.sin(2 * np.pi * (440.0 + 110.0 * c) * t) + 1e-3 * rng.standard_normal(n)
            for c in range(ch)]
    return (np.round(np.clip(np.stack(rows), -1, 1) * 32767) / 32768).astype(np.float32)


def _check_result(jres, tres):
    """dB, -inf and per-row bounds of one track, within the contract."""
    want = np.asarray(jres.db_padded)[:, : jres.n_frames]
    assert tres.n_frames == jres.n_frames and tres.db.shape == want.shape
    assert_db_close(want, tres.db.numpy())
    jmin, jmax = jres.min_max_db()
    tmin, tmax = tres.min_max_db()
    assert abs(tmax - jmax) <= db_limit(jmax, jmax)
    assert abs(tmin - jmin) <= db_limit(jmin, jmax)


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
@pytest.mark.parametrize(
    "sr,sec,ch", [(8000, 2.0, 2), (16000, 1.3, 1), (16000, 0.015, 1), (8000, 0.004, 2)],
    ids=["8k-stereo", "16k-mono", "16k-short", "8k-shorter-than-pad"],
)
def test_analyzer_matches_spec_full(scale, sr, sec, ch):
    """One track, long (the JAX device path) and shorter than the window
    (the JAX _calc_short host path)."""
    js, s = _settings(scale)
    w = _signal(np.random.default_rng(sr + ch), sr, sec, ch)
    jres = jax_spec.SpectrogramAnalyzer().calc_spec_multi(w, sr, js)
    tres = port_spec.SpectrogramAnalyzer("cpu").calc_spec_multi(w, sr, s)
    _check_result(jres, tres)


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
def test_batched_matches_calc_specs_batched(scale):
    js, s = _settings(scale)
    rng = np.random.default_rng(7)
    items = [("a", _signal(rng, 8000, 2.0, 2), 8000, 1), ("b", _signal(rng, 16000, 1.3, 1), 16000, 2)]
    jout = jax_spec.SpectrogramAnalyzer().calc_specs_batched(items, js)
    tout = port_spec.SpectrogramAnalyzer("cpu").calc_specs_batched(items, s)
    assert set(jout) == set(tout) == {"a", "b"}
    for key in jout:
        _check_result(jout[key], tout[key])


def test_rfft_branch_matches(monkeypatch):
    """Above THESIA_DFT_MAT_MAX_BYTES both sides switch to a framed rfft."""
    monkeypatch.setattr(jax_spec, "_DFT_MAT_MAX_BYTES", 0)
    monkeypatch.setattr(port_spec, "_DFT_MAT_MAX_BYTES", 0)
    js, s = _settings()
    w = _signal(np.random.default_rng(2), 8000, 1.0, 1)
    ta = port_spec.SpectrogramAnalyzer("cpu")
    assert port_spec.use_rfft_for(320, 512)
    _check_result(jax_spec.SpectrogramAnalyzer().calc_spec_multi(w, 8000, js),
                  ta.calc_spec_multi(w, 8000, s))


def test_wav_cache_is_keyed_on_the_token(monkeypatch):
    ta = port_spec.SpectrogramAnalyzer("cpu")
    w = _signal(np.random.default_rng(3), 8000, 0.5, 1)
    a = ta.device_wav(w, "k", 1)
    assert ta.device_wav(w, "k", 1) is a
    assert ta.device_wav(w, "k", 2) is not a
    assert ta.device_wav(w, "k", None) is not ta._wav_cache["k"][0]
    monkeypatch.setattr(ta, "_wav_cache_budget", w.nbytes)
    ta.device_wav(w, "other", 1)
    assert list(ta._wav_cache) == ["other"]


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
def test_fft_evaluation_stays_inside_the_contract(scale):
    """The kernel evaluates |DFT| as an FFT, not as the JAX package's folded
    DFT GEMM.  An FFT evaluation on the CPU (the rfft branch) at the 48 kHz
    default shape (win 1920, n_fft 2048) against the JAX GEMM route
    (_spec_full) stays inside the tests/torch_parity.py contract."""
    js, s = _settings(scale)
    hop, win, n_fft = s.calc_framing_params(48000)
    assert (win, n_fft) == (1920, 2048) and not port_spec.use_rfft_for(win, n_fft)
    w = _signal(np.random.default_rng(48000), 48000, 1.0, 2)
    jres = jax_spec.SpectrogramAnalyzer().calc_spec_multi(w, 48000, js)
    ta = port_spec.SpectrogramAnalyzer("cpu")
    padded = port_spec.reflect_pad_rows(torch.from_numpy(w), win // 2)
    mel = ta.mel_fb(48000, n_fft) if scale == "Mel" else None
    got = port_spec._spec_db_rfft(padded, hop, win, jres.n_frames, ta.window(win, n_fft), n_fft, mel)
    assert_db_close(np.asarray(jres.db_padded)[:, : jres.n_frames], got.numpy())
