"""Guard-clipping modes applied after gain.

Host copy of ``thesia_tpu/dynamics/guard.py`` (unchanged: the f64
global-gain multiply and clip, a precomputed gain sequence used verbatim);
pinned by ``tests/test_torch_hostcopies.py``.

reference: src-tauri/src/core/dynamics/guardclipping.rs and the impl on
Audio at src-tauri/src/core/audio.rs:133-179.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .limiter import LimiterManager
from .stats import GuardClippingStats, nan_safe_abs_max


class GuardClippingMode(str, enum.Enum):
    Clip = "Clip"
    ReduceGlobalLevel = "ReduceGlobalLevel"
    Limiter = "Limiter"

    def display(self) -> str:
        return {
            GuardClippingMode.Clip: "clipped",
            GuardClippingMode.ReduceGlobalLevel: "globally reduced",
            GuardClippingMode.Limiter: "reduced",
        }[self]


@dataclasses.dataclass
class GuardClippingResult:
    """Tagged union. kind: 'wav_before_clip' | 'global_gain' | 'gain_sequence'.

    wav_before_clip: (n_ch, n) f32 pre-clip waveform
    global_gain:     scalar gain (+ shape for stats fan-out)
    gain_sequence:   (1, n) f32 per-sample gain
    """

    kind: str
    wav_before_clip: np.ndarray | None = None
    global_gain: float = 1.0
    shape: tuple[int, int] = (0, 0)
    gain_seq: np.ndarray | None = None

    def per_channel_stats(self) -> list[GuardClippingStats]:
        """reference: stats.rs:176-205."""
        if self.kind == "wav_before_clip":
            return [
                GuardClippingStats.from_wav_before_clip(ch) for ch in self.wav_before_clip
            ]
        if self.kind == "global_gain":
            return [GuardClippingStats.from_global_gain(self.global_gain)] * self.shape[0]
        return [GuardClippingStats.from_gain_seq(row) for row in self.gain_seq]


_LIMITER_MANAGER = LimiterManager()


def guard_clipping(
    wavs: np.ndarray, sr: int, mode: GuardClippingMode, gain_seq=None
) -> tuple[np.ndarray, GuardClippingResult]:
    """Apply guard clipping; returns (possibly new wavs, result).

    gain_seq: optional precomputed limiter gain sequence (f64 (n,)) from the
    batched device path (dynamics.stats_device.limiter_gain_seqs_batched);
    used verbatim when the Limiter mode engages.

    reference: audio.rs:133-179.
    """
    wavs = np.atleast_2d(np.asarray(wavs, np.float32))
    if mode is GuardClippingMode.Clip:
        before = wavs.copy()
        out = np.clip(wavs, -1.0, 1.0)
        return out, GuardClippingResult(kind="wav_before_clip", wav_before_clip=before)
    if mode is GuardClippingMode.ReduceGlobalLevel:
        # NaN-skipping peak (native/reference f32::max semantics): a single
        # NaN sample must not disable the guard
        peak = nan_safe_abs_max(wavs)
        if peak > 1.0:
            gain = 1.0 / peak
            out = np.clip((wavs.astype(np.float64) * gain), -1.0, 1.0).astype(np.float32)
            return out, GuardClippingResult(
                kind="global_gain", global_gain=np.float32(gain), shape=wavs.shape
            )
        return wavs, GuardClippingResult(kind="global_gain", global_gain=1.0, shape=wavs.shape)
    # Limiter
    peak = nan_safe_abs_max(wavs)
    if peak > 1.0:
        if gain_seq is not None:
            out = np.clip(
                wavs.astype(np.float64) * gain_seq[None, :], -1.0, 1.0
            ).astype(np.float32)
            return out, GuardClippingResult(
                kind="gain_sequence",
                gain_seq=gain_seq.astype(np.float32).reshape(1, -1),
            )
        limiter = _LIMITER_MANAGER.get_or_insert(sr)
        out, gain_seq = limiter.process(wavs)
        return out, GuardClippingResult(
            kind="gain_sequence", gain_seq=gain_seq.reshape(1, -1)
        )
    return wavs, GuardClippingResult(
        kind="gain_sequence", gain_seq=np.ones((1, wavs.shape[1]), np.float32)
    )
