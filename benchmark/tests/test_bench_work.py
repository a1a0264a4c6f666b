"""The frozen work counts: bytes are the sizes of the inputs read once and
the outputs written once, whatever a kernel pads."""

import pytest

from benchmark.harness import work
from benchmark.harness.ref.framing import SpecSetting
from benchmark.harness.ref.freqscale import FreqScale
from benchmark.harness.ref.melscale import calc_mel_fb_default


@pytest.mark.parametrize("sr,n_ch,n,scale", [(48000, 2, 14_400_000, FreqScale.Mel),
                                             (16000, 1, 960_000, FreqScale.Linear),
                                             (16000, 1, 57_600_000, FreqScale.Mel),
                                             (44100, 2, 1001, FreqScale.Linear)])
def test_spectrogram_bytes_are_the_raw_rows_and_the_db(sr, n_ch, n, scale):
    setting = SpecSetting(freq_scale=scale)
    hop, win, n_fft = setting.calc_framing_params(sr)
    frames = (n + 2 * (win // 2) - win) // hop + 1
    cols = calc_mel_fb_default(sr, n_fft).shape[1] if scale is FreqScale.Mel else n_fft // 2 + 1
    w = work.spectrogram_work(n_ch, n, sr, setting)
    # the raw rows once (not the padded rows nor the frames), the dB and the
    # two row bounds once
    assert w["bytes"] == 4 * n_ch * n + 4 * n_ch * frames * cols + 8 * n_ch
    assert w["flop"] > 2.5 * n_fft * n_ch * frames


def test_image_bytes_are_the_db_read_and_the_image_and_mips_written():
    n_ch, n_rows, height, n_frames = 2, 347, 347, 30001
    w = work.image_work(n_ch, n_rows, height, n_frames)
    widths = [n_frames]
    for _ in range(5):
        widths.append((widths[-1] + 1) // 2)
    mips = sum(widths[3:6])  # levels 3..chain_len (5 for 30001 columns)
    assert w["bytes"] == 4 * n_ch * n_rows * n_frames + 8 + 2 * n_ch * height * (n_frames + mips)
    # rows above a lower-rate track's top are written but never read
    taller = work.image_work(n_ch, n_rows, 3 * height, n_frames)
    assert taller["bytes"] - w["bytes"] == 2 * n_ch * 2 * height * (n_frames + mips)


def test_the_least_time_names_its_bound():
    assert work.least_ms(3.35e9, 0) == (1.0, "bytes")
    assert work.least_ms(0, 67e9) == (1.0, "flop")


def test_image_shapes_follow_the_engine():
    mel = SpecSetting()
    assert work.image_shape(16000, 16000, 57_600_000, mel) == (385, 385, 360001)
    n_rows, height, frames = work.image_shape(16000, 48000, 960_000, SpecSetting(
        freq_scale=FreqScale.Linear))
    assert (n_rows, height, frames) == (513, 1539, 6001)


def _run(rules, launched, warm=0):
    from benchmark.harness.drive import Turn
    from benchmark.harness.readers import Run

    state = {"spec": {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}
    turns = [Turn(kind, 0.0, tuple(r), launches={"quantize_mips": n})
             for kind, r, n in zip(("a", "b"), rules, launched)]
    # the engine's launch 1 ms, a warmer's launch 2 us
    intervals = [(0, 1_000_000, "k6_quantize(...)")] * sum(launched) + [
        (0, 2_000, "k6_quantize(...)")] * warm
    trace = {"by_name": {"k6_quantize(...)": 1e-3 * sum(launched) + 2e-6 * warm,
                         "spec_fft_kernel(...)": 5e-3}, "intervals": intervals}
    return Run(setup_s=1.0, window_s=1.0, turns=turns, tile_ms=[], spans={},
               tracks=[(1, 960_000, 16000)], states=[state, state],
               warm={"quantize_mips": warm}, trace=trace)


def test_the_roofline_counts_each_turn_by_its_deck_entry_rules():
    from benchmark.harness.readers import roofline_pct

    setting = SpecSetting(freq_scale=FreqScale.Mel)
    n_rows, height, frames = work.image_shape(16000, 16000, 960_000, setting)
    w = work.image_work(1, n_rows, height, frames)
    least_ms = work.least_ms(w["bytes"], w["flop"])[0]
    # a turn whose entry lists k6 and one that does not, each as launched
    assert roofline_pct(_run([["k6"], []], [1, 0]), "k6") == pytest.approx(
        100 * least_ms / 1e3 / 1e-3)
    # a launch the rules do not predict is a wrong count
    with pytest.raises(AssertionError, match="work model"):
        roofline_pct(_run([["k6"], []], [1, 1]), "k6")
    # a warmer's launch in the window: its time is left out with its work
    assert roofline_pct(_run([["k6"], []], [1, 0], warm=2), "k6") == pytest.approx(
        100 * least_ms / 1e3 / 1e-3)
