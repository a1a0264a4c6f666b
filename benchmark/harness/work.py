"""The yardstick of the roofline metrics: NVIDIA's H100 peaks and the work
each kernel launch needs, counted from shapes alone.

The peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W power
limit (the same numbers as ``thesia_tpu_torch/runtime.py``).  The counts are
of the work the algorithm needs, whatever implements it: the raw rows of
samples read once (not the padded frames, whether or not a kernel pads), the
dB and the u16 image and its requested mips written once.  Frozen from
``kernels/spec_db.py: kernel_work`` and ``kernels/images.py: images_work``.
"""

from __future__ import annotations

import math

import numpy as np

from .ref.framing import SpecSetting
from .ref.freqscale import FreqScale
from .ref.melscale import calc_mel_fb_default
from .ref.render import chain_len

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

K6_FLOP_PER_PIXEL = 7  # subtract, divide, FMA, sign test, half add, floor, clamp
K6_OPS_PER_MIP_PIXEL = 3  # two adds and a shift
DEVICE_MIP_FROM = 3  # the first mip level the engine asks of the device


def least_ms(n_bytes: float, flop: float) -> tuple[float, str]:
    """The least time for the work on one H100, and which bound sets it."""
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    f = flop / F32_FLOP_PER_S * 1e3
    return (b, "bytes") if b >= f else (f, "flop")


_mel: dict = {}


def _mel_nnz_cols(sr: int, n_fft: int) -> tuple[int, int]:
    """(nonzero weights, columns) of the mel filterbank at (sr, n_fft)."""
    if (sr, n_fft) not in _mel:
        fb = calc_mel_fb_default(sr, n_fft)
        _mel[(sr, n_fft)] = (int(np.count_nonzero(fb)), fb.shape[1])
    return _mel[(sr, n_fft)]


def spectrogram_work(n_ch: int, n: int, sr: int, setting: SpecSetting) -> dict:
    """One K1/K2 launch over a track's (n_ch, n) raw rows: bytes (the rows
    read once, the f32 dB and the two f32 row bounds a row written once) and
    flop (a frame: the window's products, a real FFT of n_fft points counted
    as 2.5 n log2 n, the magnitude (3 a bin), the filterbank's
    multiply-adds (2 a nonzero weight) or nothing for linear bins, 1 a dB
    column)."""
    hop, win, n_fft = setting.calc_framing_params(sr)
    frames = (n + 2 * (win // 2) - win) // hop + 1
    n_freq = n_fft // 2 + 1
    nnz, cols = _mel_nnz_cols(sr, n_fft) if setting.freq_scale is FreqScale.Mel else (0, n_freq)
    per_frame = win + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freq + 2 * nnz + cols
    return {"bytes": 4 * n_ch * n + 4 * n_ch * frames * cols + 8 * n_ch,
            "flop": per_frame * n_ch * frames}


def image_work(n_ch: int, n_rows: int, height: int, n_frames: int) -> dict:
    """One K6 launch: each f32 dB of the image's rows read once, each u16 of
    the image and of the mips the engine asks for (levels 3 up to the host
    chain's depth) written once."""
    levels = range(DEVICE_MIP_FROM, chain_len(n_frames) + 1)
    mip_px = 0
    for level in levels:
        w = n_frames
        for _ in range(level):
            w = (w + 1) >> 1
        mip_px += n_ch * height * w
    return {"bytes": 4 * n_ch * n_rows * n_frames + 8 + 2 * n_ch * height * n_frames + 2 * mip_px,
            "flop": K6_FLOP_PER_PIXEL * n_ch * n_rows * n_frames + K6_OPS_PER_MIP_PIXEL * mip_px}


def image_shape(sr: int, max_sr: int, n: int, setting: SpecSetting) -> tuple[int, int, int]:
    """(n_rows, height, n_frames) of a track's image: rows up to max_sr / 2."""
    hop, win, n_fft = setting.calc_framing_params(sr)
    frames = (n + 2 * (win // 2) - win) // hop + 1
    n_freq = _mel_nnz_cols(sr, n_fft)[1] if setting.freq_scale is FreqScale.Mel else n_fft // 2 + 1
    i0, i1 = setting.freq_scale.hz_range_to_idx((0.0, max_sr / 2.0), sr, n_freq)
    return max(min(i1, n_freq) - i0, 0), i1 - i0, frames
