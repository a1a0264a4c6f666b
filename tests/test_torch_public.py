"""The public functions of thesia_tpu/ that the port carried last, each held
against its JAX counterpart on the same seeded input: the STFT helpers
(``perform_stft``, ``reflect_indices``, ``reflect_pad_1d``), the host
quantizer (``render/visualize.py``), ``SpectrogramAnalyzer.calc_spec`` and
``clear_wav_cache``, ``SpecResult.shape``/``to_numpy``/``channel_numpy``,
the small accessors of ``Audio``, ``AudioTrack``, ``TrackList`` and
``SpecImageStore``, ``stats_device.device_dynamics_ok`` and the packages'
``__all__``."""

import numpy as np
import pytest

import thesia_tpu.dsp as jax_dsp
import thesia_tpu.dsp.spectrogram as jax_spec
import thesia_tpu.render as jax_render
import thesia_tpu_torch.dsp as port_dsp
import thesia_tpu_torch.dsp.spectrogram as port_spec
import thesia_tpu_torch.render as port_render
from torch_parity import assert_db_close, db_limit
from thesia_tpu.common.freqscale import FreqScale as JaxFreqScale
from thesia_tpu.dsp import framing as jax_framing
from thesia_tpu.dsp import stft as jax_stft
from thesia_tpu.dynamics import stats_device as jax_stats_device
from thesia_tpu.engine import audio as jax_audio
from thesia_tpu.engine import track as jax_track
from thesia_tpu.io.wav import encode_wav_f32
from thesia_tpu.render import visualize as jax_visualize
from thesia_tpu_torch.common.freqscale import FreqScale
from thesia_tpu_torch.dsp import framing as port_framing
from thesia_tpu_torch.dsp import stft as port_stft
from thesia_tpu_torch.dynamics import stats_device as port_stats_device
from thesia_tpu_torch.engine import audio as port_audio
from thesia_tpu_torch.engine import track as port_track
from thesia_tpu_torch.render import colormap as port_colormap
from thesia_tpu_torch.render import visualize as port_visualize


def _settings(scale="Mel"):
    return (jax_framing.SpecSetting(freq_scale=JaxFreqScale(scale)),
            port_framing.SpecSetting(freq_scale=FreqScale(scale)))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 160, 1000])
def test_reflect_indices_and_pad_are_the_originals(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    for left, right in ((0, 0), (3, 5), (160, 160), (2 * n + 1, n)):
        np.testing.assert_array_equal(port_stft.reflect_indices(n, left, right),
                                      jax_stft.reflect_indices(n, left, right))
        np.testing.assert_array_equal(port_stft.reflect_pad_1d(x, left, right),
                                      jax_stft.reflect_pad_1d(x, left, right))
        np.testing.assert_array_equal(
            port_stft.reflect_indices_torch(n, left, right, "cpu").numpy(),
            port_stft.reflect_indices(n, left, right))


@pytest.mark.parametrize("win,hop,n_fft", [(320, 80, 512), (64, 64, 64), (100, 25, 256)])
def test_perform_stft_matches_the_jax_function(win, hop, n_fft):
    """Both are f32 products of the same window-folded matrices, summed in
    different orders: the complex values agree to a few ulps of each
    frame's largest magnitude."""
    rng = np.random.default_rng(win)
    wav = rng.uniform(-1, 1, 3000).astype(np.float32)
    want = jax_stft.perform_stft(wav, win, hop, n_fft)
    got = port_stft.perform_stft(wav, win, hop, n_fft, device="cpu")
    assert got.shape == want.shape == (jax_stft.stft_frame_count(3000, win, hop), n_fft // 2 + 1)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale).all()
    window = np.hanning(win).astype(np.float32)
    assert np.abs(port_stft.perform_stft(wav, win, hop, n_fft, window, device="cpu")
                  - jax_stft.perform_stft(wav, win, hop, n_fft, window)).max() <= 1e-4


@pytest.mark.parametrize("colormap_length", [None, 6, 258, 1000])
def test_convert_spectrogram_to_img_is_the_original(colormap_length):
    rng = np.random.default_rng(17)
    spec = rng.uniform(-120, 5, (40, 70)).astype(np.float32)
    spec[3, 5] = -np.inf
    spec[7, 2] = np.nan
    for freq_range in ((0, 70), (10, 50), (60, 90), (80, 100)):
        for db_range in ((-100.0, 0.0), (-60.0, -1.5), (-np.inf, -np.inf)):
            np.testing.assert_array_equal(
                port_visualize.convert_spectrogram_to_img(spec, freq_range, db_range, colormap_length),
                jax_visualize.convert_spectrogram_to_img(spec, freq_range, db_range, colormap_length))
    assert port_visualize.quantize_min_value is port_colormap.quantize_min_value
    for length in (None, 1, 6, 258, 65535, 70000):
        assert port_visualize.quantize_min_value(length) == jax_visualize.quantize_min_value(length)


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
def test_calc_spec_and_the_spec_result_views(scale):
    js, s = _settings(scale)
    rng = np.random.default_rng(5)
    wavs = rng.uniform(-1, 1, (2, 6000)).astype(np.float32)
    jres = jax_spec.SpectrogramAnalyzer().calc_spec_multi(wavs, 8000, js)
    pa = port_spec.SpectrogramAnalyzer("cpu")
    tres = pa.calc_spec_multi(wavs, 8000, s, cache_key="k", token=1)
    assert tres.shape == jres.shape
    for got, want in ((tres.to_numpy(), jres.to_numpy()),
                      (tres.channel_numpy(1), jres.channel_numpy(1))):
        assert got.shape == want.shape == jres.shape
        assert_db_close(want[None], got[None])
    one = pa.calc_spec(wavs[1], 8000, s)
    want = np.asarray(jax_spec.SpectrogramAnalyzer().calc_spec(wavs[1], 8000, js))
    assert tuple(one.shape) == want.shape
    assert_db_close(want[None], one.numpy()[None])
    jmax = float(want[np.isfinite(want)].max())
    assert abs(float(one.max()) - jmax) <= db_limit(jmax, jmax)
    assert pa._wav_cache
    pa.clear_wav_cache()
    assert not pa._wav_cache
    ja = jax_spec.SpectrogramAnalyzer()
    ja.calc_spec_multi(wavs, 8000, js, cache_key="k", token=1)
    ja.clear_wav_cache()
    assert not ja._wav_cache


def test_audio_track_and_list_accessors(tmp_path):
    rng = np.random.default_rng(9)
    wavs = rng.uniform(-1, 1, (2, 1234)).astype(np.float32)
    pa, ja = port_audio.Audio(wavs, 8000), jax_audio.Audio(wavs, 8000)
    assert len(pa) == len(ja) == 1234
    for ch in (0, 1):
        np.testing.assert_array_equal(pa.channel(ch), ja.channel(ch))
    path = tmp_path / "a.wav"
    path.write_bytes(encode_wav_f32(wavs, 8000))
    ptl, jtl = port_track.TrackList("cpu"), jax_track.TrackList()
    assert ptl.add_tracks([3], [str(path)]) == jtl.add_tracks([3], [str(path)]) == [3]
    for tid in (0, 3, 4):
        assert ptl.has(tid) == jtl.has(tid)
    np.testing.assert_array_equal(ptl[3].channel(1), jtl[3].channel(1))


def test_image_store_track_ids(tmp_path):
    from thesia_tpu.engine.manager import TrackManager as JaxManager
    from thesia_tpu_torch.engine.manager import TrackManager as PortManager

    rng = np.random.default_rng(10)
    paths = []
    for i, (sr, c) in enumerate([(8000, 2), (16000, 1), (8000, 1)]):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.9, 0.9, (c, sr)).astype(np.float32), sr))
        paths.append(str(p))
    got = []
    for tl, tm in ((port_track.TrackList("cpu"), PortManager("cpu")),
                   (jax_track.TrackList(), JaxManager())):
        tm.add_tracks(tl, tl.add_tracks([0, 2, 5], paths))
        tm.apply_track_list_changes(tl)
        tm.remove_tracks(tl, tl.remove_tracks([2]))
        tm.apply_track_list_changes(tl)
        got.append(sorted(tm.images.track_ids()))
    assert got[0] == got[1] == [0, 5]


def test_device_dynamics_ok_answers_for_the_device():
    assert port_stats_device.device_dynamics_ok("cpu") is jax_stats_device.device_dynamics_ok() is True


def test_package_all_matches_the_jax_package():
    assert port_dsp.__all__ == jax_dsp.__all__
    assert port_render.__all__ == [n for n in jax_render.__all__
                                   if n != "convert_spectrogram_to_img_device"]
    for mod in (port_dsp, port_render):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    assert port_dsp.SpectrogramAnalyzer is port_spec.SpectrogramAnalyzer
    with pytest.raises(AttributeError):
        port_dsp.no_such_name  # noqa: B018
