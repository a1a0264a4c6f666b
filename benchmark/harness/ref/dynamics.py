"""Stats, normalize gain and guard clipping of the benchmark's plain reference.

Frozen copies (the numpy routes only) of ``thesia_tpu_torch/dynamics/stats.py``
(``calc_stats``, ``nan_safe_abs_max``),
``dsp/decibel.py`` (the scalar dB functions), ``dynamics/normalize.py``
(``calc_normalize_gain``), ``dynamics/guard.py`` (``guard_clipping``) and
``engine/track.py`` (``apply_gain``: the original samples times float32(gain),
then the guard).  ``dtype`` float64 is the precision the port states for its
dynamics; the benchmark's control passes float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .limiter import PerfectLimiter
from .loudness import integrated_lufs

def db_from_amp_scalar(x: float) -> float:
    if math.isnan(x) or math.copysign(1.0, x) < 0.0:
        return math.nan
    return 20.0 * math.log10(x) if x > 0.0 else -math.inf


def db_from_power_scalar(x: float) -> float:
    if math.isnan(x) or math.copysign(1.0, x) < 0.0:
        return math.nan
    return 10.0 * math.log10(x) if x > 0.0 else -math.inf


@dataclasses.dataclass(frozen=True)
class Stats:
    global_lufs: float
    rms_db: float
    max_peak_db: float


def nan_safe_abs_max(wavs: np.ndarray) -> float:
    if not wavs.size:
        return 0.0
    return float(np.fmax.reduce(np.abs(wavs), axis=None, initial=wavs.dtype.type(0.0)))


def calc_stats(wavs: np.ndarray, sr: int, dtype=np.float64) -> Stats:
    """LUFS (K-weighted, gated), RMS dB and peak dB of (C, n) samples."""
    x = np.atleast_2d(wavs).astype(dtype, copy=False)
    lufs = integrated_lufs(x, sr) if dtype == np.float64 else _lufs_lowp(x, sr, dtype)
    mean_sq = float(np.float32(sum(float(np.dot(ch, ch)) for ch in x) / x.size))
    return Stats(global_lufs=float(lufs),
                 rms_db=float(np.float32(db_from_power_scalar(mean_sq))),
                 max_peak_db=float(np.float32(db_from_amp_scalar(nan_safe_abs_max(x)))))


def _lufs_lowp(x: np.ndarray, sr: int, dtype) -> float:
    """The same gated loudness with the filters and sums in ``dtype``."""
    from scipy.signal import lfilter

    from .loudness import gated_lufs_from_blocks, k_weighting_coeffs

    b1, a1, b2, a2 = (c.astype(dtype) for c in k_weighting_coeffs(sr))
    y = lfilter(b2, a2, lfilter(b1, a1, x, axis=-1), axis=-1).astype(dtype)
    s100 = (sr + 5) // 10
    win = 4 * s100
    n = y.shape[-1]
    if n < win:
        return -math.inf
    csum = np.concatenate([np.zeros((y.shape[0], 1), dtype), np.cumsum(y * y, axis=-1, dtype=dtype)],
                          axis=-1)
    starts = np.arange((n - win) // s100 + 1) * s100
    z = ((csum[:, starts + win] - csum[:, starts]) / dtype(win)).sum(axis=0)
    return gated_lufs_from_blocks(z.astype(np.float64))


def normalize_gain(target: dict, stats: Stats) -> float:
    """``calc_normalize_gain``: the gain from the ORIGINAL stats, in f32 steps."""
    f32 = np.float32
    measured = {"LUFS": stats.global_lufs, "RMSdB": stats.rms_db,
                "PeakdB": stats.max_peak_db}.get(target.get("type", "Off"))
    if measured is None:
        return 1.0
    return float(f32(10.0) ** (f32(f32(target["target"]) - f32(measured)) / f32(20.0)))


@dataclasses.dataclass
class Guarded:
    """The samples after gain and guard, what the viewer draws (the pre-clip
    samples under Clip), and the limiter's gains (None outside the Limiter
    or when the gain is 1)."""

    wavs: np.ndarray
    drawn: np.ndarray
    gain_seq: np.ndarray | None


def apply_gain_and_guard(original: np.ndarray, sr: int, gain: float, mode: str,
                         dtype=np.float64, device="cpu") -> Guarded:
    """``AudioTrack.apply_gain`` then ``guard_clipping`` on (C, n) f32 samples."""
    if not np.isfinite(gain) or gain == 1.0:
        return Guarded(original, original, None)
    gained = (np.float32(gain) * original).astype(np.float32, copy=False)
    if dtype != np.float64:
        gained = gained.astype(dtype)
    if mode == "Clip":
        return Guarded(np.clip(gained, -1.0, 1.0), gained, None)
    peak = nan_safe_abs_max(gained)
    if mode == "ReduceGlobalLevel":
        if peak > 1.0:
            out = np.clip(gained.astype(dtype) * dtype(1.0 / peak), -1.0, 1.0).astype(gained.dtype)
            return Guarded(out, out, None)
        return Guarded(gained, gained, None)
    if peak > 1.0:
        seq = PerfectLimiter(sr).calc_gain_seq(gained, dtype, device)
        out = np.clip(gained.astype(dtype) * seq[None, :], -1.0, 1.0).astype(gained.dtype)
        return Guarded(out, out, seq.astype(np.float32))
    return Guarded(gained, gained, np.ones(gained.shape[1], np.float32))
