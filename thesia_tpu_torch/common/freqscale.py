"""Frequency-scale (linear / mel) coordinate mapping.

Host copy of ``thesia_tpu/common/freqscale.py`` (verbatim apart from this note): the port
imports nothing of the JAX package.  ``tests/test_torch_hostcopies.py``
pins the two against each other.

reference: src-common/src/lib.rs:105-160.
"""

from __future__ import annotations

import enum
import math

import numpy as np

from .melscale import hz_to_mel, mel_to_hz


def _f32_mul_add(a, b, c) -> np.float32:
    """Rust f32::mul_add (fused, single rounding) emulation: the product of
    two f32 is exact in f64 and the final round-to-f32 happens once — the
    double-rounding divergence vs a true fma is confined to exact-halfway
    f64 results, which the axis goldens never hit."""
    return np.float32(
        np.float64(np.float32(a)) * np.float64(np.float32(b))
        + np.float64(np.float32(c))
    )


class FreqScale(str, enum.Enum):
    Linear = "Linear"
    Mel = "Mel"

    def relative_freq_to_hz(self, rel_freq: float, hz_range: tuple[float, float]) -> float:
        """reference: src-common/src/lib.rs:112-121 (f32 mul_add)."""
        lo, hi = hz_range
        if self is FreqScale.Linear:
            d = np.float32(hi) - np.float32(lo)
            return float(_f32_mul_add(d, rel_freq, lo))
        mel_lo = hz_to_mel(np.float32(lo))
        mel_hi = hz_to_mel(np.float32(hi))
        d = np.float32(mel_hi) - np.float32(mel_lo)
        return float(mel_to_hz(_f32_mul_add(d, rel_freq, mel_lo)))

    def hz_to_relative_freq(self, hz: float, hz_range: tuple[float, float]) -> float:
        """reference: src-common/src/lib.rs:123-132 (f32 steps)."""
        lo, hi = hz_range
        if self is FreqScale.Linear:
            return float(
                (np.float32(hz) - np.float32(lo))
                / (np.float32(hi) - np.float32(lo))
            )
        mel_lo = np.float32(hz_to_mel(np.float32(lo)))
        mel_hi = np.float32(hz_to_mel(np.float32(hi)))
        return float(
            (np.float32(hz_to_mel(np.float32(hz))) - mel_lo) / (mel_hi - mel_lo)
        )

    def _ratio_to_max_freq(self, hz: float, sr: int) -> float:
        half_sr = np.float32(sr) / np.float32(2.0)
        if self is FreqScale.Linear:
            return float(np.float32(hz) / half_sr)
        return float(hz_to_mel(np.float32(hz)) / hz_to_mel(half_sr))

    def hz_range_to_idx(
        self, hz_range: tuple[float, float], sr: int, n_freqs_or_mels: int
    ) -> tuple[int, int]:
        """Hz range -> [min_idx, max_idx) bin range given the number of
        linear-freq or mel bins. reference: src-common/src/lib.rs:143-159."""
        if hz_range[0] >= hz_range[1]:
            return (0, 0)
        min_ratio = self._ratio_to_max_freq(hz_range[0], sr)
        max_ratio = self._ratio_to_max_freq(hz_range[1], sr)
        n = np.float32(n_freqs_or_mels)
        min_idx = int(max(math.floor(np.float32(min_ratio) * n), 0.0))
        max_idx = int(math.ceil(np.float32(max_ratio) * n))
        return (min_idx, max_idx)
