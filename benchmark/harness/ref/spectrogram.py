"""The spectrogram, the global dB range and the u16 images of the plain
reference, in plain PyTorch.

What the port computes with its FFT kernel in float32, worked out again from
the samples: reflect padding of win // 2, frames of ``win`` at stride
``hop``, the periodic Hann window / n_fft, |rfft| of n_fft points, the mel
filterbank (or the linear bins), 20 log10 (-inf at 0); the range max_dB =
min(max, 0), min_dB = max(min, max_dB - dB range); images max_sr tall.

``precision`` "float64" is the reference (cuFFT in float64 on the card).
"tf32" is the benchmark's control: the precision just below the float32
with TF32 off that the port states (``THESIA_MATMUL_PRECISION=highest``),
the DFT and the filterbank as matrix products of operands rounded to TF32
(10 mantissa bits, to nearest) with float32 sums, as TF32 tensor cores
compute them; rounded explicitly, so the CPU computes the same control.
"""

from __future__ import annotations

import numpy as np
import torch

from .framing import SpecSetting
from .freqscale import FreqScale
from .melscale import calc_mel_fb_default

ROWS = 1 << 15  # frames a block


def reflect_indices(n: int, pad: int, device) -> torch.Tensor:
    if n == 1:
        return torch.zeros(n + 2 * pad, dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    j = torch.remainder(torch.arange(-pad, n + pad, dtype=torch.int64, device=device), period)
    return torch.where(j >= n, period - j, j)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def frame_count(n: int, win: int, hop: int) -> int:
    padded = n + 2 * (win // 2)
    return 0 if padded < win else (padded - win) // hop + 1


def _window(win: int, n_fft: int) -> np.ndarray:
    i = np.arange(win + 1, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2 * np.pi * i / win))[:win]
    return w / n_fft


def track_db(wavs: np.ndarray, sr: int, setting: SpecSetting, device,
             precision: str = "float64") -> torch.Tensor:
    """(C, n_frames, F) dB of (C, n) samples, on ``device``, float64 (the
    control's in float32)."""
    hop, win, n_fft = setting.calc_framing_params(sr)
    n = wavs.shape[-1]
    t = frame_count(n, win, hop)
    lowp = precision == "tf32"
    dt = torch.float32 if lowp else torch.float64
    x = torch.from_numpy(np.ascontiguousarray(wavs, np.float64)).to(device, dt)
    padded = x[:, reflect_indices(n, win // 2, device)]
    window = torch.from_numpy(_window(win, n_fft)).to(device, dt)
    mel = None
    if setting.freq_scale is FreqScale.Mel:
        mel = torch.from_numpy(calc_mel_fb_default(sr, n_fft).astype(np.float64)).to(device, dt)
    if lowp:
        k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
        ang = -2.0 * np.pi * torch.outer(torch.arange(win, dtype=torch.float64), k) / n_fft
        w64 = torch.from_numpy(_window(win, n_fft))[:, None]
        dft = to_tf32(torch.cat([torch.cos(ang) * w64, torch.sin(ang) * w64], 1).to(device, dt))
        if mel is not None:
            mel = to_tf32(mel)
    f = n_fft // 2 + 1 if mel is None else mel.shape[1]
    out = torch.empty((x.shape[0], t, f), dtype=dt, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c in range(x.shape[0]):
            frames = padded[c].unfold(0, win, hop)[:t]
            for r0 in range(0, t, ROWS):
                fr = frames[r0 : r0 + ROWS]
                if lowp:
                    re_im = to_tf32(fr) @ dft
                    h = re_im.shape[1] // 2
                    amp = torch.sqrt(re_im[:, :h] ** 2 + re_im[:, h:] ** 2)
                    if mel is not None:
                        amp = to_tf32(amp) @ mel
                else:
                    amp = torch.fft.rfft(fr * window, n=n_fft).abs()
                    if mel is not None:
                        amp = amp @ mel
                pos = amp > 0
                out[c, r0 : r0 + ROWS] = torch.where(
                    pos, 20.0 * torch.log10(torch.where(pos, amp, 1.0)), -torch.inf)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def global_range(dbs: list[torch.Tensor], db_range: float) -> tuple[float, float]:
    gmax = min(max(float(d.amax()) for d in dbs), 0.0)
    gmin = max(min(float(d.amin()) for d in dbs), gmax - db_range)
    return gmin, gmax


def image(db: torch.Tensor, sr: int, max_sr: int, setting: SpecSetting, lo: float, hi: float,
          minv: int) -> np.ndarray:
    """(C, H, n_frames) u16 image of one track, H rows up to max_sr / 2."""
    n_freq = db.shape[-1]
    i_start, i_end = setting.freq_scale.hz_range_to_idx((0.0, max_sr / 2.0), sr, n_freq)
    n_rows = max(min(i_end, n_freq) - i_start, 0)
    c, t = db.shape[0], db.shape[1]
    out = np.zeros((c, i_end - i_start, t), np.uint16)
    for ch in range(c):
        # NaN -> 0, round half away from zero, clip to [0, 65535]
        vals = (db[ch, :, i_start : i_start + n_rows].double().T - lo) / (hi - lo) \
            * (65535 - minv) + minv
        vals = torch.where(torch.isnan(vals), 0.0, vals)
        rounded = torch.sign(vals) * torch.floor(torch.abs(vals) + 0.5)
        out[ch, :n_rows] = torch.clamp(rounded, 0.0, 65535.0).to(torch.int32).cpu().numpy()
    return out
