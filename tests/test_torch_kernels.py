"""The fused framed FFT -> |.| -> (mel) -> dB kernel module of the port
(thesia_tpu_torch/kernels/spec_db.py): its plain version against the Pallas
kernels it replaces (tests/pallas_spec.py, interpret mode on the CPU), the
parts the CPU can check (twiddle table, launch plan, packed filterbank,
argument checks, a numpy model of the kernel's FFT schedule), and the
wrapper's device contract.  Tests marked gpu launch the CUDA kernel and skip
without a card.

Sibling test modules are imported by their own names (pytest puts tests/ on
sys.path): on a machine whose site-packages ship a ``tests`` package,
``tests.<module>`` would not resolve."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import thesia_tpu_torch.dsp.spectrogram as port_spec
from pallas_spec import spec_db_pallas, spec_db_pallas_linear
from torch_parity import KERNEL_DB_ABS, assert_db_close
from thesia_tpu_torch import runtime
from thesia_tpu_torch.dsp.framing import SpecSetting
from thesia_tpu_torch.dsp.stft import stft_frame_count
from thesia_tpu_torch.kernels import build
from thesia_tpu_torch.kernels import spec_db as spec_db_mod
from thesia_tpu_torch.kernels.spec_db import (
    CTA_COMPLEX, MAX_N_FFT, SCALED_TOL, SMEM_LIMIT, TOP60_TOL_DB, db_error, db_from_amplitude,
    dft_matrices, kernel_work, launch_plan, mel_pack, reset_launches, spec_db, spec_db_reference,
    twiddle_exponents, twiddle_table, within_tolerance,
)
from thesia_tpu_torch.tools import signals

T, WIN, F, M = 96, 320, 257, 80  # tests/test_dsp.py:313-318
N_FFTS = [1 << k for k in range(16)]  # every size the kernel takes


def _operands(seed: int, hop: int):
    """A random padded row whose frames (at stride hop) are the Pallas
    kernel's frames; one frame is all zeros (exact -inf)."""
    rng = np.random.default_rng(seed)
    row = rng.uniform(-0.1, 0.1, (T - 1) * hop + WIN).astype(np.float32)
    row[5 * hop : 5 * hop + WIN] = 0.0
    frames = np.lib.stride_tricks.sliding_window_view(row, WIN)[::hop][:T].copy()
    cw = (rng.uniform(-1, 1, (WIN, F)) * 0.01).astype(np.float32)
    sw = (rng.uniform(-1, 1, (WIN, F)) * 0.01).astype(np.float32)
    mel = np.abs(rng.uniform(0, 1, (F, M))).astype(np.float32)
    return row, frames, cw, sw, mel


def _spectrogram_operands(seed: int, n_fft: int, win: int, n_frames: int, hop: int, n_mel: int):
    """A padded row (frames 3..5 silent), a random positive window, and a
    banded filterbank (F, n_mel) whose column 1 is empty."""
    rng = np.random.default_rng(seed)
    row = rng.standard_normal((n_frames - 1) * hop + win).astype(np.float32)
    row[3 * hop : 5 * hop + win] = 0.0
    window = rng.uniform(0.1, 1.0, win).astype(np.float32) / n_fft
    n_freq = n_fft // 2 + 1
    mel = np.zeros((n_freq, n_mel), np.float32)
    for m in range(n_mel):
        lo = (m * n_freq) // n_mel
        hi = min(n_freq, lo + 1 + (m % 4))
        mel[lo:hi, m] = rng.uniform(0.2, 1.0, hi - lo)
    mel[:, min(1, n_mel - 1)] = 0.0
    return row, window, mel


@pytest.mark.parametrize("hop", [WIN, WIN // 4], ids=["hop=win", "hop=win/4"])
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_reference_matches_pallas_kernel(variant, hop):
    row, frames, cw, sw, mel = _operands(3, hop)
    if variant == "mel":
        want = spec_db_pallas(
            jnp.asarray(frames), jnp.asarray(cw), jnp.asarray(sw), jnp.asarray(mel),
            interpret=True,
        )
    else:
        want = spec_db_pallas_linear(
            jnp.asarray(frames), jnp.asarray(cw), jnp.asarray(sw), interpret=True
        )
    want = np.asarray(want)
    got = spec_db_reference(
        torch.from_numpy(row)[None], hop, WIN, T, torch.from_numpy(cw),
        torch.from_numpy(sw), torch.from_numpy(mel) if variant == "mel" else None,
    ).numpy()[0]
    assert np.isneginf(want[5]).all() and np.isneginf(got[5]).all()
    err = db_error(want[None], got[None])
    assert err["inf_equal"]
    assert err["max_abs"] <= KERNEL_DB_ABS, err


def test_cpu_tensor_runs_the_reference_and_launches_nothing():
    n_fft, hop = 512, WIN // 4
    row, window, mel = _spectrogram_operands(4, n_fft, WIN, T, hop, M)
    padded, w = torch.from_numpy(row)[None], torch.from_numpy(window)
    cw, sw = dft_matrices(w, n_fft)
    assert cw.shape == sw.shape == (WIN, n_fft // 2 + 1)
    reset_launches()
    for m in (torch.from_numpy(mel), None):
        want = spec_db_reference(padded, hop, WIN, T, cw, sw, m)
        assert torch.equal(spec_db(padded, hop, WIN, T, w, n_fft, m), want)
    assert spec_db.launches == {"mel": 0, "linear": 0}


@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_reference_with_gains_is_raw_times_gain_then_ungained(variant):
    """The plain version with per-row gains equals multiplying the rows by
    their gains and running the ungained plain version, bitwise (the JAX
    package's raw * gain before padding; padding only copies samples), on
    the wrapper's CPU route and on the rfft route alike."""
    n_fft, hop = 512, WIN // 4
    row, window, mel = _spectrogram_operands(12, n_fft, WIN, T, hop, M)
    padded = torch.from_numpy(np.stack([row, row[::-1].copy()]))
    w = torch.from_numpy(window)
    m = torch.from_numpy(mel) if variant == "mel" else None
    gains = torch.tensor([0.3, 1.7], dtype=torch.float32)
    premultiplied = padded * gains[:, None]
    cw, sw = dft_matrices(w, n_fft)
    want = spec_db_reference(premultiplied, hop, WIN, T, cw, sw, m)
    assert torch.equal(spec_db_reference(padded, hop, WIN, T, cw, sw, m, gains), want)
    assert torch.equal(spec_db(padded, hop, WIN, T, w, n_fft, m, gains=gains), want)
    ones = torch.ones(2, dtype=torch.float32)
    assert torch.equal(spec_db(padded, hop, WIN, T, w, n_fft, m, gains=ones),
                       spec_db(padded, hop, WIN, T, w, n_fft, m))
    assert torch.equal(
        port_spec._spec_db_rfft(padded, hop, WIN, T, w, n_fft, m, gains),
        port_spec._spec_db_rfft(premultiplied, hop, WIN, T, w, n_fft, m))


def test_wrapper_checks_the_gains():
    args = _good_args()
    with pytest.raises(ValueError, match="one per row"):
        spec_db(*args, gains=torch.ones(2))
    with pytest.raises(TypeError, match="float32"):
        spec_db(*args, gains=torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="is on meta"):
        spec_db(*args, gains=torch.ones(1, device="meta"))


def test_gained_work_adds_a_product_per_sample_and_a_float_per_row():
    plain = kernel_work(2, 9000, 30, 640, 1024)
    gained = kernel_work(2, 9000, 30, 640, 1024, gained=True)
    assert gained["bytes"] - plain["bytes"] == 4 * 2
    assert gained["flop"] - plain["flop"] == 2 * 30 * 640


def test_other_devices_raise():
    meta = torch.empty((1, 1000), device="meta")
    window = torch.empty((WIN,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spec_db(meta, 80, WIN, 5, window, 512)


def _good_args():
    row, window, mel = _spectrogram_operands(9, 512, WIN, 8, 80, 20)
    return [torch.from_numpy(row)[None], 80, WIN, 8, torch.from_numpy(window), 512,
            torch.from_numpy(mel)]


@pytest.mark.parametrize("change,error", [
    ({5: 500}, "power of two"),
    ({5: 1536}, "power of two"),
    ({5: 2 * MAX_N_FFT}, "power of two"),
    ({5: 256, 6: None}, "bad framing"),  # win 320 > n_fft
    ({0: "f64"}, "float32"),
    ({4: "f64"}, "float32"),
    ({0: "strided"}, "contiguous"),
    ({4: "meta"}, "is on meta"),
    ({6: "rows"}, "bins"),
    ({3: 1000}, "exceed"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, error):
    args = _good_args()
    for i, v in change.items():
        if v == "f64":
            args[i] = args[i].double()
        elif v == "strided":
            args[i] = torch.cat([args[i], args[i]], 1)[:, ::2]
        elif v == "meta":
            args[i] = args[i].to("meta")
        elif v == "rows":
            args[i] = args[i][:-1]
        else:
            args[i] = v
    spec_db(*_good_args())  # the unchanged arguments are taken
    with pytest.raises((ValueError, TypeError), match=error):
        spec_db(*args)


def test_db_from_amplitude_zero_is_exactly_neg_inf():
    x = torch.tensor([0.0, 1.0, 10.0, 1e-30], dtype=torch.float32)
    db = db_from_amplitude(x)
    assert torch.isneginf(db[0]) and not torch.isnan(db).any()
    assert db[1] == 0.0 and db[2] == 20.0


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_is_keyed_by_the_sources():
    names = [p.name for p in build.sources()]
    assert names == ["spec_fft.cu"]
    assert build.source_hash() == build.source_hash()
    assert len(build.source_hash()) == 16


@pytest.mark.parametrize("n_fft", [1, 2, 4, 8, 1024, 2048, MAX_N_FFT])
def test_twiddle_table_is_float64_rounded_once(n_fft):
    tw, m = twiddle_table(n_fft), twiddle_exponents(n_fft)
    ang = 2.0 * np.pi * m.astype(np.float64) / n_fft
    assert tw.shape == (len(m), 2) and tw.dtype == np.float32 and tw.flags.c_contiguous
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))
    # the layout csrc/spec_fft.cu reads: split, radix-2, then per span S the
    # planes W_S^j, W_S^2j, W_S^3j at span_planes(S)
    h = max(n_fft // 2, 1)
    np.testing.assert_array_equal(m[:h], np.arange(h))
    np.testing.assert_array_equal(m[h : h + h // 2], 2 * np.arange(h // 2))
    span = 4
    while span <= h:
        j = np.arange(span // 4)
        for k in (1, 2, 3):
            at = _span_planes(h, span) + (k - 1) * (span // 4)
            np.testing.assert_array_equal(m[at : at + span // 4], k * j * (n_fft // span))
        span *= 2
    assert len(m) == (3 * h - 3 if h >= 4 else h + h // 2)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_launch_plan(n_fft):
    h = max(n_fft // 2, 1)
    for mel in (False, True):
        plan = launch_plan(n_fft, 6001, 2, mel)
        g = plan["frames_per_cta"]
        assert g * h == max(CTA_COMPLEX, h)
        assert plan["threads"] % 32 == 0 and 128 <= plan["threads"] <= 1024
        want = 8 * g * h + (4 * g * (n_fft // 2 + 1) if mel else 0)
        assert plan["smem_bytes"] == want <= SMEM_LIMIT
        assert plan["grid"] == (-(-6001 // g), 2)
    if n_fft == MAX_N_FFT:  # the largest: 128 KB of FFT and 64 KB of magnitudes
        assert launch_plan(n_fft, 1, 1, True)["smem_bytes"] == 128 * 1024 + 4 * (h + 1)


def test_launch_plan_fills_the_card_at_the_main_path_shapes():
    """Default settings: the 60-s 16 kHz memo and the 5-min 48 kHz song give
    several CTAs for each of the H100's 132 SMs."""
    for sr, n_frames, rows in ((16000, 6001, 1), (48000, 30001, 2)):
        _hop, _win, n_fft = SpecSetting().calc_framing_params(sr)
        grid = launch_plan(n_fft, n_frames, rows, True)["grid"]
        assert grid[0] * grid[1] >= 5 * 132


def test_mel_pack_walks_the_bands():
    _row, _window, mel = _spectrogram_operands(11, 256, 200, 4, 50, 30)
    lo, off, w = mel_pack(torch.from_numpy(mel))
    assert lo.dtype == off.dtype == torch.int32 and w.dtype == torch.float32
    assert off[0] == 0 and off[2] == off[1]  # column 1 is empty
    dense = np.zeros_like(mel)
    for m in range(mel.shape[1]):
        a, b = int(off[m]), int(off[m + 1])
        dense[int(lo[m]) : int(lo[m]) + b - a, m] = w[a:b].numpy()
    np.testing.assert_array_equal(dense, mel)


@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_f32_dft_gemm_is_no_reference_at_the_contract(variant):
    """Why chip_smoke.py gates the kernel against the plain version evaluated
    in float64: at the 48 kHz default shape (win 1920, n_fft 2048), on 5 s of
    its synthetic song, the plain version in float32 lies more than
    TOP60_TOL_DB from its float64 self (its DFT matrices are rounded to f32),
    while an f32 FFT (torch.fft on the CPU, the algorithm of
    csrc/spec_fft.cu) meets the whole contract against it."""
    analyzer = port_spec.SpectrogramAnalyzer("cpu")
    hop, win, n_fft = SpecSetting().calc_framing_params(signals.SONG_SR)
    assert (win, n_fft) == (1920, 2048)
    wavs = signals.song(np.random.default_rng(0), seconds=5.0)
    window = analyzer.window(win, n_fft)
    mel = analyzer.mel_fb(signals.SONG_SR, n_fft) if variant == "mel" else None
    padded = port_spec.reflect_pad_rows(torch.from_numpy(wavs), win // 2)
    n_frames = stft_frame_count(wavs.shape[1], win, hop)

    def plain(dtype):
        cw, sw = dft_matrices(window, n_fft, dtype)
        m = None if mel is None else mel.to(dtype)
        return spec_db_reference(padded.to(dtype), hop, win, n_frames, cw, sw, m).float().numpy()

    ref = plain(torch.float64)
    gemm = db_error(ref, plain(torch.float32))
    fft = db_error(ref, port_spec._spec_db_rfft(padded, hop, win, n_frames, window, n_fft, mel).numpy())
    assert within_tolerance(fft), fft
    assert gemm["inf_equal"] and gemm["max_scaled"] <= SCALED_TOL, gemm
    assert gemm["max_abs_top60"] > TOP60_TOL_DB > 5 * fft["max_abs_top60"], (gemm, fft)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_kernel_work_counts_the_schedules_operations(n_fft):
    """kernel_work's f32 operations per frame: the window's products, the
    butterflies of the kernel's stages (_stages: 10 a radix-2, 34 a radix-4,
    eight radix-4 in a radix-16 task), 24 per bin pair of the real split (4 at
    k = 0), then a log2 and a scale per bin (linear) or a sqrt per bin, a
    multiply-add per filterbank weight and a log2 and a scale per column
    (mel)."""
    h = max(n_fft // 2, 1)
    win, n_freq, n_mel = max(1, n_fft - n_fft // 4), n_fft // 2 + 1, 5
    per_task = {2: 10, 4: 34, 16: 8 * 34}
    fft = sum(per_task[radix] * (h // radix) for radix, _span in _stages(h.bit_length() - 1))
    split = 4 + 24 * (h // 2)
    _row, _window, mel = _spectrogram_operands(1, n_fft, win, 2, 1, n_mel)
    nnz = int((mel != 0).sum())
    frames = 2 * 3
    assert kernel_work(2, 4 * n_fft, 3, win, n_fft)["flop"] == frames * (
        win + fft + split + 2 * n_freq)
    assert kernel_work(2, 4 * n_fft, 3, win, n_fft, torch.from_numpy(mel))["flop"] == frames * (
        win + fft + split + n_freq + 2 * nnz + 2 * n_mel)


def test_main_path_bounds_are_set_by_bytes():
    """At the main path's shapes both variants move more bytes than their f32
    operations can hide: the bound is the bytes at the card's HBM rate."""
    analyzer = port_spec.SpectrogramAnalyzer("cpu")
    for sr, rows, sec in ((48000, 2, 300.0), (16000, 1, 60.0)):
        hop, win, n_fft = SpecSetting().calc_framing_params(sr)
        n_frames = stft_frame_count(int(sr * sec), win, hop)
        row_len = int(sr * sec) + 2 * (win // 2)
        for mel in (analyzer.mel_fb(sr, n_fft), None):
            work = kernel_work(rows, row_len, n_frames, win, n_fft, mel)
            ms, by = runtime.bound_ms(work["bytes"], work["flop"])
            assert by == "bytes" and ms == work["bytes"] / runtime.HBM_BYTES_PER_S * 1e3


# -- a numpy model of csrc/spec_fft.cu's FFT schedule: the same swizzle, the
# same decimation-in-frequency stages in place (radix-2, radix-4, then
# radix-16 as two radix-4 stages in registers), the same bit-reversed
# read-back and real split.  It pins the index math the kernel uses (the CPU
# cannot run the kernel itself).

def _span_planes(h, span):
    """Offset of span's twiddle planes (span_planes in the kernel)."""
    return h + h // 2 + 3 * (span // 4) - 3


def _swz(p, log2h):
    sh = max(log2h - 4, 4)
    return p ^ ((((p >> 4) & 3) * 5) ^ ((p >> sh) & 15))


def _bitrev(k, bits):
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _stages(log2h):
    """[(radix, span)] of the kernel for a 2**log2h-point complex FFT."""
    span, out = 1 << log2h, []
    if log2h & 1:
        out.append((2, span))
        span //= 2
    if (log2h >> 1) & 1:
        out.append((4, span))
        span //= 4
    while span >= 16:
        out.append((16, span))
        span //= 16
    return out


def _tasks(radix, span, log2h, frames):
    """(frame, element positions) of every butterfly task of one stage, in
    the order of the kernel's thread index; positions (tasks, radix)."""
    h = 1 << log2h
    per = h // radix
    i = np.arange(frames * per)
    g, b = i // per, i % per
    if radix == 2:
        return g, np.stack([b, b + h // 2], 1)
    r = span // radix
    j, base = b % r, (b // r) * span + b % r
    return g, base[:, None] + r * np.arange(radix)[None]


def _radix4(v0, v1, v2, v3, w1, w2, w3):
    s02, d02, s13, d13 = v0 + v2, v0 - v2, v1 + v3, v1 - v3
    return s02 + s13, (s02 - s13) * w2, (d02 - 1j * d13) * w1, (d02 + 1j * d13) * w3


def _model_magnitudes(xw: np.ndarray, n_fft: int) -> np.ndarray:
    h = max(n_fft // 2, 1)
    log2h = h.bit_length() - 1
    tw = twiddle_table(n_fft)
    tw = tw[:, 0] + 1j * tw[:, 1]  # read at the kernel's offsets below
    x = np.zeros((xw.shape[0], 2 * h), np.float32)
    x[:, : xw.shape[1]] = xw
    z = np.zeros((xw.shape[0], h), np.complex64)
    z[:, _swz(np.arange(h), log2h)] = x[:, 0::2] + 1j * x[:, 1::2]
    for radix, span in _stages(log2h):
        _g, pos = _tasks(radix, span, log2h, 1)
        idx = _swz(pos, log2h)
        v = [z[:, idx[:, t]] for t in range(radix)]
        if radix == 2:
            v = [v[0] + v[1], (v[0] - v[1]) * tw[h + pos[:, 0]]]
        elif radix == 4:
            q, pl = span // 4, _span_planes(h, span)
            j = pos[:, 0] % q
            v = list(_radix4(*v, tw[pl + j], tw[pl + q + j], tw[pl + 2 * q + j]))
        else:
            r, pl1, pl2 = span // 16, _span_planes(h, span), _span_planes(h, span // 4)
            j0 = pos[:, 0] % r
            for q in range(4):
                j = j0 + q * r
                v[q], v[q + 4], v[q + 8], v[q + 12] = _radix4(
                    v[q], v[q + 4], v[q + 8], v[q + 12],
                    tw[pl1 + j], tw[pl1 + 4 * r + j], tw[pl1 + 8 * r + j])
            w = (tw[pl2 + j0], tw[pl2 + r + j0], tw[pl2 + 2 * r + j0])
            for m in range(4):
                v[4 * m : 4 * m + 4] = _radix4(*v[4 * m : 4 * m + 4], *w)
        for t in range(radix):
            z[:, idx[:, t]] = v[t]
    k = np.arange(n_fft // 2 + 1)
    a = z[:, _swz(_bitrev(k % h, log2h), log2h)]
    bc = np.conj(z[:, _swz(_bitrev((h - k) % h, log2h), log2h)])
    out = (a + bc) / 2 + tw[k % h] * (a - bc) / 2j
    z0 = z[:, 0]
    out[:, 0] = z0.real + z0.imag
    if n_fft >= 2:
        out[:, h] = z0.real - z0.imag
    return np.abs(out)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_fft_schedule_model_is_the_real_dft(n_fft):
    rng = np.random.default_rng(n_fft)
    win = max(1, n_fft - n_fft // 4)
    xw = rng.standard_normal((3, win)).astype(np.float32)
    want = np.abs(np.fft.rfft(xw.astype(np.float64), n=n_fft))
    got = _model_magnitudes(xw, n_fft)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    h = max(n_fft // 2, 1)
    assert sorted(_swz(np.arange(h), h.bit_length() - 1)) == list(range(h))


@pytest.mark.parametrize("n_fft", [1024, 2048])
def test_fft_schedule_has_no_bank_conflicts_in_the_stages(n_fft):
    """Per half-warp (16 threads of 8-byte accesses), the kernel's stage
    accesses of the main path's sizes hit 16 distinct banks."""
    h = n_fft // 2
    log2h = h.bit_length() - 1
    frames = CTA_COMPLEX // h

    def distinct(addr):
        return all(len(set(addr[i : i + 16] % 16)) == 16 for i in range(0, len(addr), 16))

    assert distinct(_swz(np.arange(frames * h) % h, log2h))  # windowed loads
    for radix, span in _stages(log2h):
        g, pos = _tasks(radix, span, log2h, frames)
        for t in range(radix):
            assert distinct(g * h + _swz(pos[:, t], log2h)), (radix, span, t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plain64(padded, hop, win, n_frames, window, n_fft, mel):
    cw, sw = dft_matrices(window, n_fft, torch.float64)
    mel = None if mel is None else mel.double()
    return spec_db_reference(padded.double(), hop, win, n_frames, cw, sw, mel).float()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_kernel_matches_reference_on_the_card(cuda, variant):
    """A silent stretch (frames 3..5: exact -inf) and an empty filterbank
    column (-inf in every frame), against the plain version in float64 and in
    float32, within the contract of tests/torch_parity.py."""
    n_fft, hop, n_frames = 512, WIN // 4, T
    row, window, mel = _spectrogram_operands(5, n_fft, WIN, n_frames, hop, M)
    put = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    m = put(mel) if variant == "mel" else None
    args = (put(row)[None], hop, WIN, n_frames, put(window), n_fft)
    reset_launches()
    got = spec_db(*args, m)
    torch.cuda.synchronize()
    assert spec_db.launches[variant] == 1
    got = got.cpu().numpy()
    assert np.isneginf(got[0, 3:6]).all() and not np.isneginf(got[0, 6:]).all()
    if variant == "mel":
        assert np.isneginf(got[0, :, 1]).all()
    assert_db_close(_plain64(*args, m).cpu().numpy(), got)
    cw, sw = dft_matrices(args[4], n_fft)
    assert_db_close(spec_db_reference(*args[:4], cw, sw, m).cpu().numpy(), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft", N_FFTS)
def test_kernel_covers_every_power_of_two_on_the_card(cuda, n_fft):
    win = max(1, n_fft - n_fft // 4)
    hop = max(1, win // 4)
    row, window, mel = _spectrogram_operands(n_fft, n_fft, win, 12, hop, 5)
    put = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (put(np.stack([row, row[::-1].copy()])), hop, win, 12, put(window), n_fft)
    for m in (put(mel), None):
        got = spec_db(*args, m)
        torch.cuda.synchronize()
        assert_db_close(_plain64(*args, m).cpu().numpy(), got.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_kernel_with_gains_on_the_card(cuda, variant):
    """Per-row gains 0.3 and 1.7 against the plain version with the same
    gains in float64 (the contract); null gains and gains of 1.0 give the
    ungained output bitwise; gains in the kernel give bitwise what the
    ungained kernel gives on rows multiplied beforehand ((x * g) * w)."""
    n_fft, hop, n_frames = 2048, 480, 40
    row, window, mel = _spectrogram_operands(13, n_fft, 1920, n_frames, hop, 60)
    put = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    padded = put(np.stack([row, row[::-1].copy()]))
    m = put(mel) if variant == "mel" else None
    args = (hop, 1920, n_frames, put(window), n_fft, m)
    gains = torch.tensor([0.3, 1.7], dtype=torch.float32, device=cuda)
    got = spec_db(padded, *args, gains=gains)
    null = spec_db(padded, *args)
    assert torch.equal(spec_db(padded, *args, gains=torch.ones_like(gains)), null)
    assert torch.equal(spec_db(padded * gains[:, None], *args), got)
    torch.cuda.synchronize()
    assert_db_close(_plain64(padded * gains.double()[:, None], *args).cpu().numpy(),
                    got.cpu().numpy())


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_the_reference(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(spec_db_mod, "spec_db_reference", boom)
    monkeypatch.setattr(torch.fft, "rfft", boom)
    rng = np.random.default_rng(6)
    wavs = (0.1 * rng.standard_normal((2, 16000))).astype(np.float32)
    analyzer = port_spec.SpectrogramAnalyzer(cuda)
    reset_launches()
    for scale in ("Mel", "Linear"):
        setting = SpecSetting.from_json(
            {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": scale})
        res = analyzer.calc_spec_multi(wavs, 16000, setting)
        torch.cuda.synchronize()
        assert res.db.is_cuda and res.db.shape[:2] == (2, 101)
    assert spec_db.launches == {"mel": 1, "linear": 1}
