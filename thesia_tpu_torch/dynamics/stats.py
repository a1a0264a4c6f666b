"""Per-track audio statistics + guard-clipping statistics.

Host copy of ``thesia_tpu/dynamics/stats.py`` (unchanged; the native
``audio_stats`` route first); pinned by ``tests/test_torch_hostcopies.py``.

reference: src-tauri/src/core/dynamics/stats.rs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..dsp.decibel import db_from_amp_scalar, db_from_power_scalar
from .loudness import integrated_lufs


@dataclasses.dataclass(frozen=True)
class AudioStats:
    """reference: stats.rs:16-42."""

    global_lufs: float
    rms_db: float
    max_peak: float
    max_peak_db: float


def nan_safe_abs_max(wavs: np.ndarray) -> float:
    """Abs peak skipping NaN samples with a 0 floor — the exact fold the
    native path (thesia_native.cpp audio_stats: abs_max=0, `if (av >
    abs_max)` is false for NaN) and the reference's f32::max use.  Plain
    .max() propagates NaN, which silently disabled the guard-clipping
    engagement gates for NaN-containing float WAVs."""
    if not wavs.size:
        return 0.0
    return float(np.fmax.reduce(np.abs(wavs), axis=None, initial=np.float32(0.0)))


def calc_stats(wavs: np.ndarray, sr: int) -> AudioStats:
    """reference: stats.rs:56-86 (LUFS ‖ mean-square, then peak).

    Native path does the K-weighting cascade, block energies, sum of squares
    and abs peak in ONE streaming C pass (thesia_native.cpp audio_stats) —
    the numpy/scipy path allocates several GB-scale f64 temporaries, which
    measured ~80 s for a 1-hour stereo track on the build host."""
    wavs = np.atleast_2d(np.asarray(wavs, np.float32))
    n_elem = wavs.size

    from .. import native

    if native.available() and n_elem:
        from .loudness import (
            blocks_from_segment_energies,
            gated_lufs_from_blocks,
            k_weighting_coeffs,
        )

        segs, sum_sq, abs_max = native.audio_stats(
            wavs, sr, k_weighting_coeffs(sr)
        )
        global_lufs = gated_lufs_from_blocks(blocks_from_segment_energies(segs, sr))
        mean_squared = float(np.float32(sum_sq / n_elem))
        max_peak = float(abs_max)
    else:
        global_lufs = integrated_lufs(wavs, sr)
        mean_squared = float(
            np.float32(sum(float(np.dot(ch, ch)) for ch in wavs) / n_elem)
        ) if n_elem else 0.0  # wavs already float32 (coerced at entry)
        max_peak = nan_safe_abs_max(wavs)
    rms_db = np.float32(db_from_power_scalar(mean_squared))
    max_peak_db = np.float32(db_from_amp_scalar(max_peak))
    return AudioStats(
        global_lufs=global_lufs,
        rms_db=float(rms_db),
        max_peak=max_peak,
        max_peak_db=float(max_peak_db),
    )


@dataclasses.dataclass(frozen=True)
class GuardClippingStats:
    """reference: stats.rs:111-174."""

    max_reduction_gain_db: float = 0.0
    reduction_cnt: int = 0

    def __str__(self) -> str:
        if self.max_reduction_gain_db == 0.0:
            return ""
        if self.reduction_cnt == 0:
            return f"{self.max_reduction_gain_db:.2f} dB"
        return f"max {self.max_reduction_gain_db:.2f} dB, total {self.reduction_cnt} samples"

    @classmethod
    def from_wav_before_clip(cls, wav_before_clip: np.ndarray) -> "GuardClippingStats":
        max_peak = nan_safe_abs_max(wav_before_clip)
        if max_peak > 1.0:
            recip = np.float32(1.0 / np.float32(max_peak))
            return cls(
                max_reduction_gain_db=float(np.float32(db_from_amp_scalar(float(recip)))),
                reduction_cnt=int((np.abs(wav_before_clip) > 1.0).sum()),
            )
        return cls()

    @classmethod
    def from_global_gain(cls, gain: float) -> "GuardClippingStats":
        return cls(
            max_reduction_gain_db=float(np.float32(db_from_amp_scalar(gain))),
            reduction_cnt=0,
        )

    @classmethod
    def from_gain_seq(cls, gain_seq: np.ndarray) -> "GuardClippingStats":
        mn = float(gain_seq.min()) if gain_seq.size else 1.0
        return cls(
            max_reduction_gain_db=float(np.float32(db_from_amp_scalar(mn))),
            reduction_cnt=int((gain_seq != 1.0).sum()),
        )
