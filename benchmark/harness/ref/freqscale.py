"""Frequency-scale (linear / mel) coordinate mapping.

Frozen copy of ``thesia_tpu_torch/common/freqscale.py`` for the benchmark's plain reference;
nothing here imports the port, and the port never imports this.

reference: src-common/src/lib.rs:105-160.
"""

from __future__ import annotations

import enum
import math

import numpy as np

from .melscale import hz_to_mel


class FreqScale(str, enum.Enum):
    Linear = "Linear"
    Mel = "Mel"

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
