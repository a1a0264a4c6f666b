"""Spectrogram framing parameters.

Frozen copy of ``thesia_tpu_torch/dsp/framing.py`` for the benchmark's plain reference;
nothing here imports the port, and the port never imports this.

SpecSetting derives per-sample-rate framing:
    hop   = round(win_ms * sr / 1000 / t_overlap)
    win   = hop * t_overlap
    n_fft = next_pow2(win) * f_overlap
reference: src-tauri/src/core/spectrogram.rs:30-99.
"""

from __future__ import annotations

import dataclasses
import math

from .freqscale import FreqScale


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class SpecSetting:
    win_ms: float = 40.0
    t_overlap: int = 4
    f_overlap: int = 1
    freq_scale: FreqScale = FreqScale.Mel

    def calc_hop_length(self, sr: int) -> int:
        # rust f64::round = round-half-away-from-zero.  Floor at 1: a
        # UI-reachable combination (1 ms window, t_overlap 32, 8 kHz) rounds
        # to hop 0, where the reference's own math divides by zero
        x = self.win_ms * sr / 1000.0 / self.t_overlap
        return max(int(math.floor(x + 0.5)), 1)

    def calc_win_length(self, sr: int) -> int:
        return self.calc_hop_length(sr) * self.t_overlap

    def calc_n_fft(self, sr: int) -> int:
        return next_power_of_two(self.calc_win_length(sr)) * self.f_overlap

    def calc_framing_params(self, sr: int) -> tuple[int, int, int]:
        """(hop_length, win_length, n_fft)."""
        hop = self.calc_hop_length(sr)
        win = hop * self.t_overlap
        return hop, win, next_power_of_two(win) * self.f_overlap

    @classmethod
    def from_json(cls, d: dict) -> "SpecSetting":
        return cls(
            win_ms=float(d["winMillisec"]),
            t_overlap=int(d["tOverlap"]),
            f_overlap=int(d["fOverlap"]),
            freq_scale=FreqScale(d["freqScale"]),
        )
