"""The port's dynamics modules (thesia_tpu_torch/dsp/decibel.py and
thesia_tpu_torch/dynamics/) against the JAX package's, on the same seeded
numpy inputs:

* decibel: the torch array functions and the scalar copies, edge cases
  (0, -0.0, NaN, negatives, NaN and -0.0 references) with the same NaN/-inf
  semantics;
* envelope, limiter, loudness, stats, normalize, guard: the same numpy and
  native code on both sides, so bit for bit;
* stats_device: the torch float64 programs (K8, K9) against the JAX float64
  programs and the native streaming code, under the JAX suite's own bars
  (tests/test_dynamics_device.py): <= 1e-9 on LUFS and gain sequences,
  max_peak / max_peak_db equal, rms_db within 1e-5;
* the synth48k LUFS golden anchor of tests/goldens/goldens.json;
* the policy gate and that a failing device program raises instead of
  handing its work to the host."""

import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import SYNTH48K_SR, synth48k_wavs
from thesia_tpu.dsp import decibel as jax_db
from thesia_tpu.dynamics import envelope as jax_env
from thesia_tpu.dynamics import guard as jax_guard
from thesia_tpu.dynamics import limiter as jax_lim
from thesia_tpu.dynamics import loudness as jax_loud
from thesia_tpu.dynamics import normalize as jax_norm
from thesia_tpu.dynamics import stats as jax_stats
from thesia_tpu.dynamics import stats_device as jax_dev
from thesia_tpu_torch.dsp import decibel as port_db
from thesia_tpu_torch.dynamics import envelope as port_env
from thesia_tpu_torch.dynamics import guard as port_guard
from thesia_tpu_torch.dynamics import limiter as port_lim
from thesia_tpu_torch.dynamics import loudness as port_loud
from thesia_tpu_torch.dynamics import normalize as port_norm
from thesia_tpu_torch.dynamics import stats as port_stats
from thesia_tpu_torch.dynamics import stats_device as port_dev

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens" / "goldens.json"
CPU = torch.device("cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_floats(a, b):
    """Equal, NaN in the same places."""
    assert (a == b) or (math.isnan(a) and math.isnan(b)), (a, b)


# -- decibel ------------------------------------------------------------------

EDGE = np.array([0.0, -0.0, np.nan, -1.0, -1e-30, 1e-30, 1e-7, 0.5, 1.0, 3.0, np.inf, -np.inf],
                np.float32)


@pytest.mark.parametrize("ref", [1.0, 2.0, 0.0, -0.0, -1.0, math.nan])
@pytest.mark.parametrize("amin", [0.0, 1e-5])
@pytest.mark.parametrize("fn", ["db_from_amp", "db_from_power"])
def test_decibel_arrays_keep_the_edge_semantics(fn, ref, amin):
    want = np.asarray(getattr(jax_db, fn)(jnp.asarray(EDGE), ref, amin))
    got = getattr(port_db, fn)(torch.from_numpy(EDGE), ref, amin).numpy()
    assert got.dtype == want.dtype
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (np.isneginf(got) == np.isneginf(want)).all() and (np.isposinf(got) == np.isposinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    if ref == 1.0 and amin == 0.0:
        assert np.isneginf(got[0]) and np.isnan(got[1]) and np.isnan(got[2]) and np.isnan(got[3])


@pytest.mark.parametrize("fn", ["amp_from_db", "power_from_db"])
def test_decibel_inverses(fn):
    x = np.linspace(-120.0, 20.0, 141).astype(np.float32)
    want = np.asarray(getattr(jax_db, fn)(jnp.asarray(x), 0.5))
    got = getattr(port_db, fn)(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_decibel_scalars_are_copies():
    values = [0.0, -0.0, math.nan, -1.0, 1e-300, 0.25, 1.0, 7.0, math.inf]
    for fn in ("db_from_amp_scalar", "db_from_power_scalar"):
        for x in values:
            for ref in (1.0, 0.0, -0.0, math.nan, 3.0):
                for amin in (0.0, 1e-10):
                    _same_floats(getattr(port_db, fn)(x, ref, amin), getattr(jax_db, fn)(x, ref, amin))
    with pytest.raises(ValueError):
        port_db.db_from_amp(torch.ones(2), 1.0, -1.0)


# -- envelope -----------------------------------------------------------------

def test_envelope_is_a_copy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000)
    for window in (1, 2, 7, 240, 4999, 6000):
        _same(port_env.sliding_max(x, window), jax_env.sliding_max(x, window))
        _same(port_env.sliding_min(x, window), jax_env.sliding_min(x, window))
    for length in (1, 3, 100):
        _same(port_env.box_filter_signal(x, length, 1.0), jax_env.box_filter_signal(x, length, 1.0))
    _same(port_env.box_stack_signal(x, 240, 3, 1.0), jax_env.box_stack_signal(x, 240, 3, 1.0))
    for layers in (1, 3, 6, 9):
        _same(port_env.optimal_ratios(layers), jax_env.optimal_ratios(layers))
        assert port_env.stack_layer_lengths(240, port_env.optimal_ratios(layers)) == \
            jax_env.stack_layer_lengths(240, jax_env.optimal_ratios(layers))
    streams = [(port_env.BoxStackFilter(50, 3), jax_env.BoxStackFilter(50, 3)),
               (port_env.PeakHold(8000, 3.0), jax_env.PeakHold(8000, 3.0))]
    for p, j in streams:
        p.reset(1.0)
        j.reset(1.0)
        for v in x[:300]:
            assert p.step(float(v)) == j.step(float(v))


# -- limiter ------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("sr", [8000, 48000])
def test_limiter_is_a_copy(monkeypatch, native, sr):
    """The native streaming limiter and, with the native library switched
    off on both sides, the numpy formulation."""
    if not native:
        from thesia_tpu import native as jax_native
        from thesia_tpu_torch import native as port_native

        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    rng = np.random.default_rng(sr)
    wavs = (rng.uniform(-1, 1, (2, 12000)) * 2.5).astype(np.float32)
    wavs[1, 100] = np.nan
    p, j = port_lim.PerfectLimiter(sr), jax_lim.PerfectLimiter(sr)
    assert (p.attack, p.hold_length, p.release_samples) == (j.attack, j.hold_length, j.release_samples)
    _same(p.calc_gain_seq(wavs), j.calc_gain_seq(wavs))
    for a, b in zip(p.process(wavs), j.process(wavs)):
        _same(a, b)
    x = rng.uniform(0.2, 1.0, 3000)
    _same(port_lim.exponential_release_scan(x, 37.0), jax_lim.exponential_release_scan(x, 37.0))
    assert port_lim.LimiterManager().get_or_insert(sr).attack == p.attack


# -- loudness -----------------------------------------------------------------

@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_loudness_is_a_copy(sr):
    for a, b in zip(port_loud.k_weighting_coeffs(sr), jax_loud.k_weighting_coeffs(sr)):
        _same(a, b)
    rng = np.random.default_rng(sr)
    t = np.arange(int(sr * 2.5)) / sr
    wavs = np.stack([0.4 * np.sin(2 * np.pi * 997 * t), 0.1 * rng.standard_normal(len(t))]).astype(np.float32)
    for hist in (True, False):
        _same_floats(port_loud.integrated_lufs(wavs, sr, histogram=hist),
                     jax_loud.integrated_lufs(wavs, sr, histogram=hist))
    _same(port_loud.momentary_loudness(wavs, sr), jax_loud.momentary_loudness(wavs, sr))
    _same(port_loud.HIST_BOUNDARIES, jax_loud.HIST_BOUNDARIES)
    _same(port_loud.HIST_ENERGIES, jax_loud.HIST_ENERGIES)


# -- stats, normalize, guard --------------------------------------------------

def _tracks():
    rng = np.random.default_rng(5)
    quiet = (1e-5 * np.ones((1, 48000))).astype(np.float32)
    nan = (rng.uniform(-1.5, 1.5, (2, 20000))).astype(np.float32)
    nan[0, 10] = np.nan
    return [
        ((rng.uniform(-1, 1, (2, 48000)) * 0.5).astype(np.float32), 48000),
        ((rng.uniform(-1, 1, (1, 30000)) * 1.8).astype(np.float32), 16000),
        (quiet, 48000), (nan, 8000), (np.zeros((1, 0), np.float32), 8000),
        ((0.3 * rng.standard_normal((1, 500))).astype(np.float32), 16000),
    ]


def test_stats_are_a_copy():
    for wavs, sr in _tracks():
        p, j = port_stats.calc_stats(wavs, sr), jax_stats.calc_stats(wavs, sr)
        for field in ("global_lufs", "rms_db", "max_peak", "max_peak_db"):
            _same_floats(getattr(p, field), getattr(j, field))
        _same_floats(port_stats.nan_safe_abs_max(wavs), jax_stats.nan_safe_abs_max(wavs))
        if wavs.size:
            for row in wavs:
                assert str(port_stats.GuardClippingStats.from_wav_before_clip(row)) == \
                    str(jax_stats.GuardClippingStats.from_wav_before_clip(row))
    for gain in (1.0, 0.5, 0.123456):
        assert str(port_stats.GuardClippingStats.from_global_gain(gain)) == \
            str(jax_stats.GuardClippingStats.from_global_gain(gain))
    seq = np.array([1.0, 0.5, 0.7, 1.0], np.float32)
    assert port_stats.GuardClippingStats.from_gain_seq(seq) == \
        port_stats.GuardClippingStats(**vars(jax_stats.GuardClippingStats.from_gain_seq(seq)))


@pytest.mark.parametrize("doc", [
    {"type": "Off"}, {"type": "LUFS", "target": -14}, {"type": "RMSdB", "target": -20.5},
    {"type": "PeakdB", "target": -1.0}, {"type": "PeakdB", "target": 0.5}, {"type": "LUFS"},
    {"type": "LUFS", "target": float("nan")}, {"type": "dB", "target": 1}, {},
])
def test_normalize_targets_parse_alike(doc):
    outcomes = []
    for mod in (port_norm, jax_norm):
        try:
            outcomes.append(mod.NormalizeTarget.from_json(dict(doc)).to_json())
        except (ValueError, KeyError, TypeError) as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


def test_normalize_gains_are_bitwise_equal():
    stats = [port_stats.calc_stats(w, sr) for w, sr in _tracks()[:3]]
    for st in stats:
        jst = jax_stats.AudioStats(**vars(st))
        for kind, target in (("LUFS", -14.0), ("LUFS", -23.3), ("RMSdB", -18.0), ("PeakdB", -1.0),
                             ("Off", 0.0)):
            p = port_norm.calc_normalize_gain(port_norm.NormalizeTarget(kind, target), st)
            j = jax_norm.calc_normalize_gain(jax_norm.NormalizeTarget(kind, target), jst)
            _same_floats(p, j)


@pytest.mark.parametrize("mode", ["Clip", "ReduceGlobalLevel", "Limiter"])
def test_guard_clipping_is_bitwise_equal(mode):
    """Every mode, and the Limiter with a precomputed gain sequence used
    verbatim: the same gain sequence gives the same samples bit for bit."""
    rng = np.random.default_rng(9)
    gain_seq = rng.uniform(0.3, 1.0, 48000)
    for wavs, sr in _tracks()[:4]:
        for seq in (None, gain_seq[: wavs.shape[1]]):
            po, pr = port_guard.guard_clipping(wavs, sr, port_guard.GuardClippingMode(mode), gain_seq=seq)
            jo, jr = jax_guard.guard_clipping(wavs, sr, jax_guard.GuardClippingMode(mode), gain_seq=seq)
            _same(po, jo)
            assert pr.kind == jr.kind and pr.shape == jr.shape
            _same_floats(float(pr.global_gain), float(jr.global_gain))
            for a, b in ((pr.wav_before_clip, jr.wav_before_clip), (pr.gain_seq, jr.gain_seq)):
                assert (a is None) == (b is None)
                if a is not None:
                    _same(a, b)
            assert [str(s) for s in pr.per_channel_stats()] == [str(s) for s in jr.per_channel_stats()]
    assert [m.display() for m in port_guard.GuardClippingMode] == \
        [m.display() for m in jax_guard.GuardClippingMode]


# -- stats_device: K8 and K9 ----------------------------------------------------

@pytest.mark.parametrize("sr", [8000, 44100, 48000])
def test_limiter_program_matches_jax_and_native(sr):
    rng = np.random.default_rng(sr)
    wavs = (rng.uniform(-1, 1, (2, 30000)) * 2.5).astype(np.float32)
    got = port_dev.limiter_gain_seqs_batched([("k", wavs, sr)], CPU)["k"]
    assert got.shape == (30000,) and got.dtype == np.float64
    np.testing.assert_allclose(got, port_lim.PerfectLimiter(sr).calc_gain_seq(wavs), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got, jax_dev.limiter_gain_seqs_batched([("k", wavs, sr)])["k"],
                               atol=1e-9, rtol=0)


def test_limiter_program_batches_mixed_lengths_and_rates():
    rng = np.random.default_rng(0)
    items = [(k, (rng.uniform(-1, 1, (c, n)) * amp).astype(np.float32), sr)
             for k, (c, n, amp, sr) in enumerate([(1, 9000, 3.0, 16000), (2, 15000, 1.5, 16000),
                                                  (1, 4000, 8.0, 16000), (2, 7000, 2.0, 8000)])]
    port_dev.reset_launches()
    got = port_dev.limiter_gain_seqs_batched(items, CPU)
    assert port_dev.limiter_gain_seqs_batched.launches == 2  # one program per rate
    jax_got = jax_dev.limiter_gain_seqs_batched(items)
    for k, wavs, sr in items:
        want = port_lim.PerfectLimiter(sr).calc_gain_seq(wavs)
        np.testing.assert_allclose(got[k], want, atol=1e-9, rtol=0)
        np.testing.assert_allclose(got[k], jax_got[k], atol=1e-9, rtol=0)


def test_limiter_program_silence_spike_and_nan():
    sr = 8000
    w = np.zeros((2, 5000), np.float32)
    w[0, 1000] = 4.0
    w[1, 1000] = np.nan  # a NaN channel must not disable limiting of the other
    got = port_dev.limiter_gain_seqs_batched([(0, w, sr)], CPU)[0]
    np.testing.assert_allclose(got, port_lim.PerfectLimiter(sr).calc_gain_seq(w), atol=1e-9, rtol=0)
    assert got.min() < 0.3 and got[-1] > 0.9
    quiet = port_dev.limiter_gain_seqs_batched([(0, np.full((1, 3000), 0.5, np.float32), sr)], CPU)[0]
    assert (quiet == 1.0).all()


@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_lufs_program_matches_jax_and_host(sr):
    rng = np.random.default_rng(sr)
    t = np.arange(int(sr * 2.5)) / sr
    sine = (0.4 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    noise = (0.1 * rng.standard_normal(len(t))).astype(np.float32)
    for wavs in (sine[None], np.stack([sine, noise]), noise[None] * 0.001,
                 np.stack([sine, noise, sine, noise])):  # a surround channel weighs 1.41
        want = jax_loud.integrated_lufs(wavs, sr)
        got = port_dev.integrated_lufs_device(wavs, sr, CPU)
        jax_got = jax_dev.integrated_lufs_device(wavs, sr)
        for other in (want, jax_got):
            assert (np.isinf(got) and np.isinf(other)) or abs(got - other) < 1e-9


def test_lufs_program_below_the_gates_and_too_short():
    sr = 48000
    assert np.isneginf(port_dev.integrated_lufs_device(np.full((1, sr), 1e-5, np.float32), sr, CPU))
    short = np.full((1, 100), 0.5, np.float32)
    assert port_dev.lufs_stats_batched([(0, short, sr)], CPU) == {}
    assert np.isneginf(port_dev.integrated_lufs_device(short, sr, CPU))


def test_calc_stats_batched_matches_jax_and_host():
    rng = np.random.default_rng(7)
    items = [
        (k, (rng.uniform(-1, 1, (c, n)) * a).astype(np.float32), sr)
        for k, (c, n, a, sr) in enumerate(
            [(2, 48000, 0.5, 48000), (1, 30000, 0.9, 48000), (2, 20000, 0.2, 16000),
             (1, 36000, 0.7, 48000), (1, 500, 0.4, 16000)]  # the last: no gating block
        )
    ]
    port_dev.reset_launches()
    got = port_dev.calc_stats_batched(items, CPU)
    assert port_dev.lufs_stats_batched.launches == 3  # (48k, 2), (48k, 1), (16k, 2)
    jax_got = jax_dev.calc_stats_batched(items)
    for k, wavs, sr in items:
        for want in (port_stats.calc_stats(wavs, sr), jax_got[k]):
            assert (np.isinf(got[k].global_lufs) and np.isinf(want.global_lufs)) or \
                abs(got[k].global_lufs - want.global_lufs) < 1e-9
            assert got[k].max_peak == want.max_peak
            assert got[k].max_peak_db == want.max_peak_db
            assert abs(got[k].rms_db - want.rms_db) < 1e-5
    assert got[4] == port_stats.calc_stats(items[4][1], 16000)  # the host path, bit for bit


def test_synth48k_lufs_golden_anchor():
    """tests/test_goldens.py:67-76 reads these anchors off the JAX session;
    the port's device program and its host copy meet them on the same
    track (tests/synth.py)."""
    golden = json.loads(GOLDENS.read_text())["synth48k"]["stats"]
    wavs = synth48k_wavs()
    for st in (port_dev.calc_stats_batched([(0, wavs, SYNTH48K_SR), (1, wavs[:, :96000], SYNTH48K_SR)],
                                           CPU)[0],
               port_stats.calc_stats(wavs, SYNTH48K_SR)):
        assert abs(st.global_lufs - golden["global_lufs"]) < 1e-9
        assert st.rms_db == pytest.approx(golden["rms_db"], abs=1e-6)
        assert st.max_peak == golden["max_peak"]
        assert st.max_peak_db == golden["max_peak_db"]


# -- policy and failures -----------------------------------------------------------

def test_policy(monkeypatch):
    """Unset, the device programs run (measured faster on the H100, PERF.md);
    THESIA_DEVICE_DYNAMICS keeps the JAX package's meaning."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    assert port_dev.device_dynamics_preferred() is True
    for value, want in (("0", False), ("false", False), ("", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", value)
        assert port_dev.device_dynamics_preferred() is want
        assert jax_dev.device_dynamics_preferred() is want


def _two_wavs(tmp_path):
    from thesia_tpu_torch.io.wav import encode_wav_f32

    rng = np.random.default_rng(3)
    paths = []
    for i, (c, n, sr) in enumerate([(2, 12000, 8000), (1, 9000, 8000)]):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.5, 0.5, (c, n)).astype(np.float32), sr))
        paths.append(str(p))
    return paths


def test_a_failing_device_program_raises(monkeypatch, tmp_path):
    """No silent fallback: where the policy picks the device, a failing K9 or
    K8 propagates; where it picks the host, neither runs."""
    from thesia_tpu_torch.dynamics.guard import GuardClippingMode
    from thesia_tpu_torch.dynamics.normalize import NormalizeTarget
    from thesia_tpu_torch.engine.track import TrackList

    paths = _two_wavs(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("device program failed")

    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    monkeypatch.setattr(port_dev, "lufs_program", boom)
    with pytest.raises(RuntimeError, match="device program failed"):
        TrackList("cpu").add_tracks([0, 1], paths)
    monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
    tl = TrackList("cpu")
    assert tl.add_tracks([0, 1], paths) == [0, 1]
    monkeypatch.setattr(port_dev, "limiter_gain_program", boom)
    tl.common_guard_clipping = GuardClippingMode.Limiter
    tl.set_common_normalize(NormalizeTarget("LUFS", 2.0))  # the native limiter
    assert tl[0].audio.guard_clip_result.gain_seq.min() < 1.0
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS")
    with pytest.raises(RuntimeError, match="device program failed"):
        tl.set_common_normalize(NormalizeTarget("LUFS", 3.0))
    assert tl.common_normalize == NormalizeTarget("LUFS", 2.0)  # rolled back


def test_tracklist_batched_limiter_matches_per_track(tmp_path):
    """The TrackList Limiter plan through K8 (two tracks) against the
    per-track native path (tests/test_dynamics_device.py:100-135)."""
    from thesia_tpu_torch.dynamics.guard import GuardClippingMode
    from thesia_tpu_torch.dynamics.normalize import NormalizeTarget
    from thesia_tpu_torch.engine.track import TrackList

    paths = _two_wavs(tmp_path)
    tl = TrackList("cpu")
    tl.common_guard_clipping = GuardClippingMode.Limiter
    tl.common_normalize = NormalizeTarget(type="LUFS", target=2.0)
    port_dev.reset_launches()
    ids = tl.add_tracks([0, 1], paths)
    assert port_dev.limiter_gain_seqs_batched.launches == 1
    for tid in ids:
        batched = tl[tid].audio
        tl[tid].normalize(tl.common_normalize, tl.common_guard_clipping)  # per track: native
        single = tl[tid].audio
        assert batched.guard_clip_result.kind == single.guard_clip_result.kind == "gain_sequence"
        np.testing.assert_allclose(batched.guard_clip_result.gain_seq, single.guard_clip_result.gain_seq,
                                   atol=1e-7)
        np.testing.assert_allclose(batched.wavs, single.wavs, atol=1e-6)
        assert batched.wavs.max() <= 1.0 and batched.wavs.min() >= -1.0
