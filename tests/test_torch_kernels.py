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

import thesia_tpu.dsp.spectrogram as jax_spec
import thesia_tpu_torch.dsp.spectrogram as port_spec
from pallas_spec import spec_db_pallas, spec_db_pallas_linear
from torch_parity import KERNEL_DB_ABS, assert_db_close, db_limit
from thesia_tpu_torch import runtime
from thesia_tpu_torch.dsp.framing import SpecSetting
from thesia_tpu_torch.dsp.stft import reflect_indices_torch, stft_frame_count
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


def _raw_rows(seed, n_long, n_short):
    """Two raw rows (the second valid for n_short samples, zero after) of
    sines and noise on the s16 grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_long) / 8000.0
    rows = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t), 0.3 * np.sin(2 * np.pi * 1234.5 * t)])
    rows += 1e-3 * rng.standard_normal(rows.shape)
    rows = (np.round(np.clip(rows, -1, 1) * 32767) / 32768).astype(np.float32)
    rows[1, n_short:] = 0.0
    return rows


@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_reference_pads_in_place_of_the_padded_copy(variant):
    """The plain version with raw rows and pad is bit-equal to the padded
    call (pad 0 on reflect_pad_rows' copy), from frame 0 and from a later
    t0; with per-row lengths each row reflects over its own samples; the
    bounds are the masked amin / amax over each row's valid frames."""
    n_fft, win, hop = 512, WIN, WIN // 4
    pad = win // 2
    rows = torch.from_numpy(_raw_rows(21, 4000, 2500))
    _row, window, mel = _spectrogram_operands(22, n_fft, win, 2, hop, M)
    w, m = torch.from_numpy(window), torch.from_numpy(mel) if variant == "mel" else None
    cw, sw = dft_matrices(w, n_fft)
    gains = torch.tensor([0.5, 1.25])
    n_frames = stft_frame_count(4000, win, hop)
    padded = port_spec.reflect_pad_rows(rows, pad)
    want = spec_db_reference(padded, hop, win, n_frames, cw, sw, m, gains)
    got, mn, mx = spec_db_reference(rows, hop, win, n_frames, cw, sw, m, gains, pad=pad,
                                    bounds=True)
    assert torch.equal(got, want)
    assert torch.equal(mn, want.amin(dim=(1, 2))) and torch.equal(mx, want.amax(dim=(1, 2)))
    assert torch.equal(spec_db(rows, hop, win, n_frames, w, n_fft, m, pad=pad, gains=gains), want)
    later = spec_db_reference(rows, hop, win, n_frames - 7, cw, sw, m, gains, pad=pad, t0=7)
    assert torch.equal(later, want[:, 7:])
    # per-row lengths: row 1 reflects over its first 2500 samples
    row_n = torch.tensor([4000, 2500], dtype=torch.int32)
    got, mn, mx = spec_db(rows, hop, win, n_frames, w, n_fft, m, pad=pad, gains=gains,
                          row_n=row_n, bounds=True)
    short = spec_db_reference(port_spec.reflect_pad_rows(rows[1:, :2500], pad), hop, win,
                              stft_frame_count(2500, win, hop), cw, sw, m, gains[1:])
    nf1 = short.shape[1]
    assert torch.equal(got[:1], want[:1]) and torch.equal(got[1:, :nf1], short)
    assert torch.equal(mn, torch.stack([want[0].amin(), short.amin()]))
    assert torch.equal(mx, torch.stack([want[0].amax(), short.amax()]))


@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_reference_matches_jax_spec_full_multi(variant):
    """Raw rows of two lengths with per-row gains through the JAX batch
    program (_spec_full_multi: reflect padding and masked per-row bounds in
    one XLA program) and through the plain version with pad, row_n and
    bounds: dB on each row's valid frames within tests/torch_parity.py, the
    bounds within its limit at their depth."""
    n_fft, win, hop = 512, 400, 100
    pad = win // 2
    raw = _raw_rows(23, 6000, 3700)
    ns = np.array([6000, 3700], np.int32)
    gains = np.array([0.7, 1.6], np.float32)
    analyzer = port_spec.SpectrogramAnalyzer("cpu")
    window = analyzer.window(win, n_fft)
    mel = analyzer.mel_fb(8000, n_fft) if variant == "mel" else None
    cw, sw = dft_matrices(window, n_fft)
    bucket = 8192
    t_max = (bucket - win) // hop + 1
    jraw = np.zeros((2, bucket), np.float32)
    jraw[:, :6000] = raw
    db_j, mn_j, mx_j = jax_spec._spec_full_multi(
        jnp.asarray(jraw), jnp.asarray(ns), jnp.asarray(gains), jnp.asarray(cw.numpy()),
        jnp.asarray(sw.numpy()), jnp.asarray((mel if mel is not None else torch.zeros(1)).numpy()),
        hop_length=hop, t_overlap=win // hop, use_mel=mel is not None, bucket=bucket, pad=pad)
    db_j = np.asarray(db_j)
    n_frames = stft_frame_count(6000, win, hop)
    assert n_frames <= t_max
    db_t, mn_t, mx_t = spec_db_reference(
        torch.from_numpy(raw), hop, win, n_frames, cw, sw, mel, torch.from_numpy(gains),
        pad=pad, row_n=torch.from_numpy(ns), bounds=True)
    for c, n in enumerate(ns):
        nf = stft_frame_count(int(n), win, hop)
        assert_db_close(db_j[c:c + 1, :nf], db_t[c:c + 1, :nf].numpy())
        row_max = float(mx_j[c])
        assert abs(float(mx_t[c]) - row_max) <= db_limit(row_max, row_max)
        assert abs(float(mn_t[c]) - float(mn_j[c])) <= db_limit(float(mn_j[c]), row_max)


def test_reference_matches_jax_spec_full():
    """One track (_spec_full: a shared length, one scalar gain, scalar
    bounds) against the plain version with pad and bounds."""
    n_fft, win, hop = 512, 400, 100
    pad = win // 2
    raw = _raw_rows(24, 5000, 5000)
    analyzer = port_spec.SpectrogramAnalyzer("cpu")
    window = analyzer.window(win, n_fft)
    mel = analyzer.mel_fb(8000, n_fft)
    cw, sw = dft_matrices(window, n_fft)
    bucket = 8192
    jraw = np.zeros((2, bucket), np.float32)
    jraw[:, :5000] = raw
    db_j, mn_j, mx_j = jax_spec._spec_full(
        jnp.asarray(jraw), 5000, jnp.float32(0.8), jnp.asarray(cw.numpy()),
        jnp.asarray(sw.numpy()), jnp.asarray(mel.numpy()), hop_length=hop, t_overlap=win // hop,
        use_mel=True, bucket=bucket, pad=pad)
    nf = stft_frame_count(5000, win, hop)
    db_t, mn_t, mx_t = spec_db_reference(torch.from_numpy(raw), hop, win, nf, cw, sw, mel,
                                         torch.full((2,), 0.8), pad=pad, bounds=True)
    assert_db_close(np.asarray(db_j)[:, :nf], db_t.numpy())
    row_max = float(mx_j)
    assert abs(float(mx_t.max()) - row_max) <= db_limit(row_max, row_max)
    assert abs(float(mn_t.min()) - float(mn_j)) <= db_limit(float(mn_j), row_max)


@pytest.mark.parametrize("win_ms,route_cuda,route_cpu", [
    (40.0, False, False), (200.0, False, True), (2000.0, True, True)])
def test_rfft_route_by_device(win_ms, route_cuda, route_cpu):
    """On a CUDA card only an n_fft above MAX_N_FFT takes torch.fft (the
    kernel builds no matrices); on the CPU the DFT matrices' byte budget
    decides, as in the JAX package."""
    setting = SpecSetting.from_json(
        {"winMillisec": win_ms, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"})
    _hop, win, n_fft = setting.calc_framing_params(48000)
    assert (n_fft > MAX_N_FFT) == route_cuda
    assert port_spec.use_rfft_for(win, n_fft, "cuda") == route_cuda
    assert port_spec.use_rfft_for(win, n_fft, "cpu") == route_cpu
    assert port_spec.use_rfft_for(win, n_fft) == route_cpu


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


def test_bounds_and_folded_padding_change_only_the_bytes():
    """The bounds write two f32 per row; a launch that pads in its loader
    reads the raw rows (n samples), not n + 2 pad; the FLOP count is the
    algorithm's, whatever the rows."""
    raw = kernel_work(2, 9000, 30, 640, 1024)
    bounded = kernel_work(2, 9000, 30, 640, 1024, bounds=True)
    padded = kernel_work(2, 9000 + 640, 30, 640, 1024)
    assert bounded["bytes"] - raw["bytes"] == 2 * 4 * 2
    assert padded["bytes"] - raw["bytes"] == 4 * 2 * 640
    assert raw["flop"] == bounded["flop"] == padded["flop"]


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
    assert names == ["dynamics.cu", "images.cu", "spec_fft.cu"]
    assert build.source_hash() == build.source_hash()
    assert len(build.source_hash()) == 16


def test_ptxas_report_names_each_kernel():
    """The build log's per-kernel lines, as chip_smoke.py's [build] phase
    prints them (registers and spills of each schedule and variant)."""
    log = """ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__x_11_spec_fft_cu_y20spec_fft_kernel_regsILi5ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__x_11_spec_fft_cu_y20spec_fft_kernel_regsILi5ELb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__x_11_spec_fft_cu_y15spec_fft_kernelILb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__x_11_spec_fft_cu_y15spec_fft_kernelILb0EEEvNS_4ArgsE
    16 bytes stack frame, 28 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
"""
    assert build.ptxas_report(log) == [
        {"kernel": "registers<32,mel>", "stack": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 166},
        {"kernel": "shared<linear>", "stack": 16, "spill_stores": 28, "spill_loads": 20,
         "registers": 110},
    ]


def test_phase_profile_finds_its_anchors_in_the_kernel():
    """tools/profile_spec_fft_phases.py instruments a copy of the kernel at
    fixed places of its source: each is there once, and a counter lands at
    every phase boundary of the register schedule."""
    from thesia_tpu_torch.tools import profile_spec_fft_phases as phases

    src = phases.instrumented_source((build.CSRC_DIR / "spec_fft.cu").read_text())
    for i in range(len(phases.PHASES)):
        assert src.count(f"atomicAdd(&g_phase_cycles[{i}]") == 1
    with pytest.raises(ValueError, match="anchor"):
        phases.instrumented_source("namespace {\n")


@pytest.mark.parametrize("n_fft", [1, 2, 4, 8, 1024, 2048, MAX_N_FFT])
def test_twiddle_table_is_float64_rounded_once(n_fft):
    tw, m = twiddle_table(n_fft), twiddle_exponents(n_fft)
    ang = 2.0 * np.pi * m.astype(np.float64) / n_fft
    assert tw.shape == (len(m), 2) and tw.dtype == np.float32 and tw.flags.c_contiguous
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))
    h = max(n_fft // 2, 1)
    if spec_db_mod.uses_registers(n_fft):
        # the layout the register schedule reads: W_32^e, then W_h^{b k1}
        # at k1 L + b, then the split's W^k for k <= h/2
        lanes = h // 32
        np.testing.assert_array_equal(m[:32], np.arange(32) * (n_fft // 32))
        k1, b = np.divmod(np.arange(h), lanes)
        np.testing.assert_array_equal(m[32:32 + h], 2 * b * k1)
        np.testing.assert_array_equal(m[32 + h:], np.arange(h // 2 + 1))
        return
    # the shared-memory schedule's: split, radix-2, then per span S the
    # planes W_S^j, W_S^2j, W_S^3j at span_planes(S)
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
    win = max(1, n_fft - n_fft // 4)
    for mel in (False, True):
        plan = launch_plan(n_fft, 6001, 2, mel, win, 5)
        if 64 <= n_fft <= 2048:  # h = 32 L in the registers of L lanes
            lanes = h // 32
            assert plan["schedule"] == "registers" and plan["lanes"] == lanes
            assert plan["frames_per_warp"] * lanes == 32
            assert plan["groups"] == 2 * -(-6001 // plan["frames_per_warp"])
            want = (spec_db_mod.REG_WARPS * spec_db_mod.reg_warp_buffer(lanes) * 8
                    + (32 + h + h // 2 + 1) * 8 + (win // 4 + 1) * 16)
            assert plan["smem_bytes"] == want <= SMEM_LIMIT
            continue
        g = plan["frames_per_cta"]
        assert plan["schedule"] == "shared" and g * h == max(CTA_COMPLEX, h)
        assert plan["threads"] % 32 == 0 and 128 <= plan["threads"] <= 1024
        want = 8 * g * h + (4 * g * (n_fft // 2 + 1) if mel else 0)
        assert plan["smem_bytes"] == want <= SMEM_LIMIT
        assert plan["grid"] == (-(-6001 // g), 2)
    if n_fft == MAX_N_FFT:  # the largest: 128 KB of FFT and 64 KB of magnitudes
        assert launch_plan(n_fft, 1, 1, True, win)["smem_bytes"] == 128 * 1024 + 4 * (h + 1)
    if n_fft == 128:  # the mel column sums sit past the magnitudes: up to h of them
        assert launch_plan(n_fft, 1, 1, True, win, 64)["schedule"] == "registers"
        assert launch_plan(n_fft, 1, 1, True, win, 65)["schedule"] == "shared"
        assert launch_plan(n_fft, 1, 1, False, win, 65)["schedule"] == "registers"
        assert launch_plan(n_fft, 1, 1, True, win, 5, SMEM_LIMIT)["schedule"] == "shared"


def test_launch_plan_fills_the_card_at_the_main_path_shapes():
    """Default settings: the 60-s 16 kHz memo and the 5-min 48 kHz song give
    at least one frame group for each warp that fits the H100 (132 SMs,
    three CTAs each), so the persistent CTAs all work."""
    for sr, n_frames, rows in ((16000, 6001, 1), (48000, 30001, 2)):
        _hop, win, n_fft = SpecSetting().calc_framing_params(sr)
        plan = launch_plan(n_fft, n_frames, rows, True, win, 300)
        assert plan["schedule"] == "registers"
        assert plan["groups"] >= 132 * 3 * plan["warps"]


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
    """kernel_work's f32 operations per frame, an algorithm count: the
    window's products, the butterflies of a radix-4 FFT with a radix-2 level
    first when log2 h is odd (the shared-memory schedule's stages, _stages:
    10 a radix-2, 34 a radix-4, eight radix-4 in a radix-16 task), 24 per
    bin pair of the real split (4 at k = 0), then a log2 and a scale per bin
    (linear) or a sqrt per bin, a multiply-add per filterbank weight and a
    log2 and a scale per column (mel)."""
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
        for mel in (analyzer.mel_fb(sr, n_fft), None):
            work = kernel_work(rows, int(sr * sec), n_frames, win, n_fft, mel, bounds=True)
            ms, by = runtime.bound_ms(work["bytes"], work["flop"])
            assert by == "bytes" and ms == work["bytes"] / runtime.HBM_BYTES_PER_S * 1e3


# -- numpy models of csrc/spec_fft.cu's two FFT schedules.  They pin the
# index math the kernel uses (the CPU cannot run the kernel itself).
#
# The register schedule (n_fft 64..2048, h = 32 L): lane j of a frame's L
# lanes holds z[L q + j], q < 32; a 32-point DIF in registers (radix-4
# levels, then radix-2), the twiddle W_h^{j k1}, the XOR-swizzled exchange
# through the warp's buffer, 32 / L DIFs of L points, Z back to the buffer,
# the real split.

W32_EXACT = {0: 1.0, 8: -1j, 16: -1.0, 24: 1j}


def _rev(k, bits):
    out = np.zeros_like(np.asarray(k))
    for b in range(bits):
        out |= ((np.asarray(k) >> b) & 1) << (bits - 1 - b)
    return out


def _reg_dif(v, w32):
    """csrc/spec_fft.cu dif_levels on the list v (len a power of two <= 32):
    radix-4 levels of span S (twiddle exponents E, 2E, 3E, E = q 32 / S; the
    four exact ones exact), then a radix-2 level when log2 len is odd."""
    n = len(v)
    mul = lambda d, e: d * (W32_EXACT[e] if e in W32_EXACT else w32[e])  # noqa: E731
    span = n
    while span >= 4:
        for base in range(0, n, span):
            for q in range(span // 4):
                i = [base + q + r * span // 4 for r in range(4)]
                s02, d02 = v[i[0]] + v[i[2]], v[i[0]] - v[i[2]]
                s13, d13 = v[i[1]] + v[i[3]], v[i[1]] - v[i[3]]
                e = q * (32 // span)
                v[i[0]] = s02 + s13
                v[i[1]] = mul(s02 - s13, 2 * e)
                v[i[2]] = mul(d02 - 1j * d13, e)
                v[i[3]] = mul(d02 + 1j * d13, 3 * e)
        span //= 4
    if span == 2:
        for base in range(0, n, 2):
            v[base], v[base + 1] = v[base] + v[base + 1], v[base] - v[base + 1]


def _group(lanes):
    """Layout::S: complex values of a group's region."""
    return 32 * lanes + 32 + (lanes & 15)


def _x_at(g, k1, b, lanes):
    """Layout::x_at: X[k1][b] of group g in the warp's buffer, rows of L + 1."""
    return g * _group(lanes) + k1 * (lanes + 1) + b


def _z_at(g, k, lanes):
    return g * _group(lanes) + k


def _m_at(g, k, lanes):
    s = _group(lanes)
    return 2 * g * s + ((g * lanes - 2 * g * s) & 31) + k


def _reg_model_magnitudes(xw: np.ndarray, n_fft: int) -> np.ndarray:
    """|rfft| of each row of xw (frames, win) by the register schedule, in
    complex128 with the kernel's f32 twiddle table."""
    h, lanes = n_fft // 2, n_fft // 64
    log2l = lanes.bit_length() - 1
    tw = twiddle_table(n_fft)
    tw = tw[:, 0] + 1j * tw[:, 1]
    w32, st, sp = tw[:32], tw[32:32 + h], tw[32 + h:]
    out = []
    for frame in xw:
        x = np.zeros(n_fft)
        x[: len(frame)] = frame
        z = x[0::2] + 1j * x[1::2]
        buf = np.zeros(_group(lanes), complex)  # this frame's group (0) of a warp's buffer
        for j in range(lanes):
            v = [z[lanes * q + j] for q in range(32)]
            _reg_dif(v, w32)
            for r in range(1, 32):
                v[r] = v[r] * st[_rev(r, 5) * lanes + j]
            for r in range(32):
                buf[_x_at(0, int(_rev(r, 5)), j, lanes)] = v[r]
        regs = {}
        for j in range(lanes):
            v = [buf[_x_at(0, j + lanes * i, b, lanes)] for i in range(32 // lanes)
                 for b in range(lanes)]
            for i in range(32 // lanes):
                seg = v[i * lanes:(i + 1) * lanes]
                _reg_dif(seg, w32)
                v[i * lanes:(i + 1) * lanes] = seg
            regs[j] = v
        for j, v in regs.items():
            for i in range(32 // lanes):
                for r in range(lanes):
                    buf[_z_at(0, j + lanes * i + 32 * int(_rev(r, log2l)), lanes)] = v[i * lanes + r]
        zk = lambda k: buf[_z_at(0, k, lanes)]  # noqa: E731
        mag = np.zeros(h + 1)
        z0 = zk(0)
        mag[0], mag[h] = abs(z0.real + z0.imag), abs(z0.real - z0.imag)
        for k in range(1, h // 2 + 1):
            a, b = zk(k), np.conj(zk(h - k))
            e, o = (a + b) / 2, (a - b) / 2j
            mag[k], mag[h - k] = abs(e + sp[k] * o), abs(e - sp[k] * o)
        out.append(mag)
    return np.array(out)


def _reg_accesses(n_fft):
    """The register schedule's shared accesses of one warp, per instruction:
    ("8" or "4" bytes, the 32 lanes' addresses) -- the exchange's writes and
    reads, Z's write-back and the epilogue's reads, the magnitudes' writes."""
    lanes = n_fft // 64
    log2l = lanes.bit_length() - 1
    warp = [(lane >> log2l, lane & (lanes - 1)) for lane in range(32)]
    acc = [("8", [_x_at(g, int(_rev(r, 5)), j, lanes) for g, j in warp]) for r in range(32)]
    acc += [("8", [_x_at(g, j + lanes * i, b, lanes) for g, j in warp])
            for i in range(32 // lanes) for b in range(lanes)]
    acc += [("8", [_z_at(g, j + lanes * i + 32 * int(_rev(r, log2l)), lanes) for g, j in warp])
            for i in range(32 // lanes) for r in range(lanes)]
    acc += [("8", [_z_at(g, j + lanes * q, lanes) for g, j in warp]) for q in range(16)]
    acc += [("8", [_z_at(g, 32 * lanes - (j + lanes * q) if j + lanes * q else 0, lanes)
                   for g, j in warp]) for q in range(16)]
    acc += [("4", [_m_at(g, j + lanes * q, lanes) for g, j in warp]) for q in range(17)]
    return acc


# The shared-memory schedule (the other sizes): the same swizzle, the same
# decimation-in-frequency stages in place (radix-2, radix-4, then radix-16
# as two radix-4 stages in registers), the same bit-reversed read-back and
# real split.

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
    """[(radix, span)] of the shared-memory schedule for a 2**log2h-point
    complex FFT."""
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


def _smem_model_magnitudes(xw: np.ndarray, n_fft: int) -> np.ndarray:
    h = max(n_fft // 2, 1)
    log2h = h.bit_length() - 1
    tw = twiddle_table(n_fft, registers=False)
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
    """The model of the schedule that runs n_fft (registers for 64..2048,
    shared memory otherwise) is the real DFT's magnitude."""
    rng = np.random.default_rng(n_fft)
    win = max(1, n_fft - n_fft // 4)
    xw = rng.standard_normal((3, win)).astype(np.float32)
    want = np.abs(np.fft.rfft(xw.astype(np.float64), n=n_fft))
    if spec_db_mod.uses_registers(n_fft):
        got = _reg_model_magnitudes(xw, n_fft)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        got = _smem_model_magnitudes(xw, n_fft)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        h = max(n_fft // 2, 1)
        assert sorted(_swz(np.arange(h), h.bit_length() - 1)) == list(range(h))
    assert got.shape == want.shape


@pytest.mark.parametrize("n_fft", [1024, 2048])
def test_fft_schedule_has_no_bank_conflicts_in_the_stages(n_fft):
    """The main path's sizes run the register schedule: each of its shared
    accesses hits distinct banks -- per half-warp of 8-byte accesses (16
    banks of 8 bytes), per warp of 4-byte ones (32 banks)."""
    assert spec_db_mod.uses_registers(n_fft)
    for width, addr in _reg_accesses(n_fft):
        addr = np.asarray(addr)
        if width == "8":
            assert all(len(set(hw % 16)) == 16 for hw in (addr[:16], addr[16:])), addr
        else:
            assert len(set(addr % 32)) == 32, addr


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512])
def test_register_exchange_is_a_bijection_without_bank_conflicts(n_fft):
    """The other register sizes (several frames a warp, each group's region
    starting on its own banks): every exchange slot is written once and
    read once, inside its group's region, and no access conflicts."""
    lanes = n_fft // 64
    acc = _reg_accesses(n_fft)
    writes = sorted(a for _w, addrs in acc[:32] for a in addrs)
    reads = sorted(a for _w, addrs in acc[32:64] for a in addrs)
    assert writes == reads and len(set(writes)) == 32 * 32
    assert max(writes) < (32 // lanes) * _group(lanes) == spec_db_mod.reg_warp_buffer(lanes)
    for width, addr in acc:
        addr = np.asarray(addr)
        banks = 16 if width == "8" else 32
        parts = (addr[:16], addr[16:]) if width == "8" else (addr,)
        assert all(len(set(p % banks)) == len(p) for p in parts), (lanes, addr)


def _reflect(p, n):
    """The kernel's reflect_index."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    j = p % period
    return period - j if j >= n else j


PAD = 12


@pytest.mark.parametrize("t0", [0, 3])
@pytest.mark.parametrize("n", [1, 2, PAD - 1, PAD, PAD + 1, 1000])
def test_loader_reflect_map_is_reflect_indices(n, t0):
    """Frame t of the kernel reads sample reflect((t0 + t) hop + s - pad, n)
    of its row (interior frames straight, the others through the map): the
    samples reflect_indices_torch gives the padded row, from frame t0 on."""
    win, hop = 2 * PAD, 5
    n_frames = max(1, (n + 2 * PAD - win) // hop + 1 - t0)
    got = np.array([[_reflect((t0 + t) * hop + s - PAD, n) for s in range(win)]
                    for t in range(n_frames)])
    padded = reflect_indices_torch(n, PAD, PAD + t0 * hop + win, "cpu").numpy()
    want = np.stack([padded[(t0 + t) * hop:(t0 + t) * hop + win] for t in range(n_frames)])
    np.testing.assert_array_equal(got, want)
    rows = torch.arange(n, dtype=torch.float32)[None]
    samples = spec_db_mod.frame_samples(rows, hop, win, n_frames, PAD, None, t0)
    np.testing.assert_array_equal(samples.unfold(-1, win, hop).numpy()[0], want.astype(np.float32))


def test_mel_schedule_sums_each_band_in_order():
    """The flattened filterbank of the register schedule: every column of a
    range exactly once, its band in order, the lists balanced across lanes
    and a multiple of 8 long; applied as the kernel applies it (fmaf in f32,
    a sum per column from 0) it gives mag @ mel."""
    analyzer = port_spec.SpectrogramAnalyzer("cpu")
    mel = analyzer.mel_fb(16000, 1024).numpy()
    mel[:, 3] = 0.0  # an empty column
    rng = np.random.default_rng(0)
    mag = rng.random(mel.shape[0]).astype(np.float32)
    for lanes, col0, n_cols in ((16, 0, mel.shape[1]), (32, 5, 200), (1, 0, 7)):
        sched = spec_db_mod.mel_schedule(mel, lanes, col0, n_cols)
        assert sched.shape[1:] == (lanes, 2) and sched.shape[0] % 8 == 0
        out = np.full(n_cols, np.nan, np.float32)
        for lane in range(lanes):
            acc = np.float32(0)
            for code, bits in sched[:, lane]:
                acc = np.float32(acc + np.float32(mag[code & 0xFFF] * np.int32(bits).view(np.float32)))
                if code >> 12:
                    assert np.isnan(out[(code >> 12) - 1])
                    out[(code >> 12) - 1] = acc
                    acc = np.float32(0)
        np.testing.assert_allclose(out, mag @ mel[:, col0:col0 + n_cols], rtol=1e-6, atol=1e-7)
        assert out[3 - col0] == 0.0 if col0 <= 3 < col0 + n_cols else True
        widths = [int((mel[:, m] != 0).sum()) or 1 for m in range(col0, col0 + n_cols)]
        assert sched.shape[0] < sum(widths) / lanes + max(widths) + 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plain64(padded, hop, win, n_frames, window, n_fft, mel, **kw):
    cw, sw = dft_matrices(window, n_fft, torch.float64)
    mel = None if mel is None else mel.double()
    return spec_db_reference(padded.double(), hop, win, n_frames, cw, sw, mel, **kw).float()


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
    """Padded rows (pad 0) and raw rows padded in the loader, both within
    the contract, bit-equal to each other, the bounds bit-equal to amin /
    amax of the output."""
    win = max(1, n_fft - n_fft // 4)
    hop = max(1, win // 4)
    row, window, mel = _spectrogram_operands(n_fft, n_fft, win, 12, hop, 5)
    put = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    raw = put(np.stack([row, row[::-1].copy()]))
    n_frames = stft_frame_count(raw.shape[1], win, hop)
    padded = port_spec.reflect_pad_rows(raw, win // 2)
    for m in (put(mel), None):
        got, mn, mx = spec_db(raw, hop, win, n_frames, put(window), n_fft, m, pad=win // 2,
                              bounds=True)
        torch.cuda.synchronize()
        assert torch.equal(got, spec_db(padded, hop, win, n_frames, put(window), n_fft, m))
        assert torch.equal(mn, got.amin(dim=(1, 2))) and torch.equal(mx, got.amax(dim=(1, 2)))
        assert_db_close(_plain64(raw, hop, win, n_frames, put(window), n_fft, m,
                                 pad=win // 2).cpu().numpy(), got.cpu().numpy())


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
    monkeypatch.setattr(port_spec, "reflect_pad_rows", boom)  # no padded copy on the card
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


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_folded_padding_equals_the_padded_launch_bitwise(cuda, variant):
    """The kernel on raw rows with pad (edge frames through the reflect map,
    interior frames straight) computes the bits it computes on a padded copy
    with pad 0, from frame 0 and from a later t0, with gains; each row's
    bounds are amin / amax of its valid frames, bitwise, also for a row
    shorter than the launch (row_n)."""
    n_fft, win, hop = 2048, 1920, 480
    raw = torch.from_numpy(_raw_rows(31, 48000, 30000)).to(cuda)
    analyzer = port_spec.SpectrogramAnalyzer(cuda)
    window = analyzer.window(win, n_fft)
    m = analyzer.mel_fb(48000, n_fft) if variant == "mel" else None
    pad = win // 2
    gains = torch.tensor([0.5, 1.5], device=cuda)
    n_frames = stft_frame_count(raw.shape[1], win, hop)
    padded = port_spec.reflect_pad_rows(raw, pad)
    want = spec_db(padded, hop, win, n_frames, window, n_fft, m, gains=gains)
    got, mn, mx = spec_db(raw, hop, win, n_frames, window, n_fft, m, pad=pad, gains=gains,
                          bounds=True)
    assert torch.equal(got, want)
    assert torch.equal(mn, got.amin(dim=(1, 2))) and torch.equal(mx, got.amax(dim=(1, 2)))
    assert torch.equal(spec_db(raw, hop, win, n_frames - 9, window, n_fft, m, pad=pad, t0=9,
                               gains=gains), want[:, 9:])
    row_n = torch.tensor([48000, 30000], dtype=torch.int32, device=cuda)
    got, mn, mx = spec_db(raw, hop, win, n_frames, window, n_fft, m, pad=pad, gains=gains,
                          row_n=row_n, bounds=True)
    nf1 = stft_frame_count(30000, win, hop)
    short = spec_db(port_spec.reflect_pad_rows(raw[1:, :30000], pad), hop, win, nf1, window,
                    n_fft, m, gains=gains[1:])
    assert torch.equal(got[:1], want[:1]) and torch.equal(got[1:, :nf1], short)
    assert torch.equal(mn, torch.stack([want[0].amin(), short.amin()]))
    assert torch.equal(mx, torch.stack([want[0].amax(), short.amax()]))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_kernel_ranges_are_the_whole_launch_bitwise(cuda, variant):
    """A "time" shard (a view of the padded rows from its first frame, pad
    0) and a "freq" shard (a column range) compute the whole launch's
    entries bit for bit: a frame's arithmetic does not depend on the CTA,
    warp or group slot that runs it."""
    n_fft, win, hop = 1024, 640, 160
    raw = torch.from_numpy(_raw_rows(32, 32000, 32000)).to(cuda)
    analyzer = port_spec.SpectrogramAnalyzer(cuda)
    window = analyzer.window(win, n_fft)
    m = analyzer.mel_fb(16000, n_fft) if variant == "mel" else None
    padded = port_spec.reflect_pad_rows(raw, win // 2)
    n_frames = stft_frame_count(raw.shape[1], win, hop)
    whole = spec_db(raw, hop, win, n_frames, window, n_fft, m, pad=win // 2)
    cols = whole.shape[2]
    for t0, t1 in ((0, 37), (37, 101), (101, n_frames)):
        view = padded[:, t0 * hop:(t1 - 1) * hop + win]
        assert torch.equal(spec_db(view, hop, win, t1 - t0, window, n_fft, m), whole[:, t0:t1])
    for c0, c1 in ((0, 1), (1, cols // 3), (cols // 3, cols)):
        got = spec_db(raw, hop, win, n_frames, window, n_fft, m, pad=win // 2, col0=c0,
                      n_cols=c1 - c0)
        assert torch.equal(got, whole[:, :, c0:c1])


@pytest.mark.gpu
def test_200ms_window_takes_the_kernel_within_the_contract(cuda, monkeypatch):
    """A 200 ms window at 48 kHz (win 9600, n_fft 16384) runs the kernel on
    the card, not torch.fft, within the contract of the float64 plain
    version."""
    def boom(*a, **k):
        raise AssertionError("torch.fft ran for a window the kernel takes")

    setting = SpecSetting.from_json(
        {"winMillisec": 200.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"})
    hop, win, n_fft = setting.calc_framing_params(48000)
    assert (win, n_fft) == (9600, 16384)
    wavs = _raw_rows(33, 96000, 96000)
    analyzer = port_spec.SpectrogramAnalyzer(cuda)
    monkeypatch.setattr(torch.fft, "rfft", boom)
    reset_launches()
    res = analyzer.calc_spec_multi(wavs, 48000, setting)
    torch.cuda.synchronize()
    assert spec_db.launches == {"mel": 0, "linear": 1}
    raw = torch.from_numpy(wavs).to(cuda)
    ref = _plain64(raw, hop, win, res.n_frames, analyzer.window(win, n_fft), n_fft, None,
                   pad=win // 2)
    err = db_error(ref.cpu().numpy(), res.db.cpu().numpy())
    assert within_tolerance(err), err
    assert torch.equal(res.row_min, res.db.amin(dim=(1, 2)))
    assert torch.equal(res.row_max, res.db.amax(dim=(1, 2)))
