"""Audio buffer: samples + stats + guard-clip state.

Port of ``thesia_tpu/engine/audio.py`` (host code, numpy) with its lazy
stats, guard-clip result and stats, ``channel``, ``__len__`` (samples per
channel), ``channel_for_drawing`` (the pre-clip
waveform under Clip), ``guard_clipping_gain``, ``mutate`` and
``format_guard_clip_stats`` and ``interleaved_samples`` (the player's
frame-major copy).

reference: src-tauri/src/core/audio.rs:22-193.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..dynamics.guard import GuardClippingMode, GuardClippingResult, guard_clipping
from ..dynamics.stats import AudioStats, GuardClippingStats, calc_stats
from ..obs import span

_audio_versions = itertools.count(1)
# guard_clipping's child span for each mode
_GUARD_SPANS = {m: f"guard_clipping.{m.value}" for m in GuardClippingMode}


class Audio:
    def __init__(self, wavs: np.ndarray, sr: int):
        self.wavs = np.atleast_2d(np.ascontiguousarray(wavs, np.float32))
        self.sr = sr
        # globally-unique sample-content version; keys the device wav cache
        # (id() is unsafe: the allocator reuses addresses after gc)
        self.version = next(_audio_versions)
        # stats are lazy so TrackList can inject batched device-computed
        # values before first access (stats_device.calc_stats_batched)
        self._stats: AudioStats | None = None
        self.guard_clip_result = GuardClippingResult(
            kind="global_gain", global_gain=1.0, shape=self.wavs.shape
        )
        self.guard_clip_stats: list[GuardClippingStats] = [
            GuardClippingStats() for _ in range(self.n_ch)
        ]

    # -- views -------------------------------------------------------------
    @property
    def stats(self) -> AudioStats:
        if self._stats is None:
            with span("stats"):
                self._stats = calc_stats(self.wavs, self.sr)
        return self._stats

    @stats.setter
    def stats(self, value: AudioStats) -> None:
        self._stats = value

    @property
    def n_ch(self) -> int:
        return self.wavs.shape[0]

    def __len__(self) -> int:
        return self.wavs.shape[1]

    @property
    def sec(self) -> float:
        return self.wavs.shape[1] / self.sr

    def channel(self, ch: int) -> np.ndarray:
        return self.wavs[ch]

    def channel_for_drawing(self, ch: int) -> tuple[np.ndarray, bool]:
        """(waveform, is_clipped): the pre-clip waveform when Clip clamped
        samples (the UI draws the overflow).  reference: audio.rs:71-78."""
        if self.guard_clip_result.kind == "wav_before_clip":
            return self.guard_clip_result.wav_before_clip[ch], True
        return self.wavs[ch], False

    def guard_clipping_gain(self) -> np.ndarray | None:
        """Limiter gain sequence for the overview strip; None for other
        modes. reference: audio.rs:80-92."""
        if self.guard_clip_result.kind != "gain_sequence":
            return None
        gain_seq = self.guard_clip_result.gain_seq
        if (gain_seq < 1.0).any():
            return gain_seq
        return np.ones((1, 1), np.float32)

    def interleaved_samples(self) -> np.ndarray:
        """Frame-major interleave for playback. reference: audio.rs:181-193."""
        return np.ascontiguousarray(self.wavs.T).reshape(-1)

    # -- mutation ----------------------------------------------------------
    def mutate(self, f, guard_clipping_mode: GuardClippingMode, gain_seq=None) -> None:
        """f(wavs) -> wavs, then guard clipping, then a lazy stats recompute.
        gain_seq: precomputed limiter gains (the batched device program).
        reference: audio.rs:50-63."""
        with span("gain_apply"):
            new_wavs = f(self.wavs)
        with span("guard_clipping"), span(_GUARD_SPANS[guard_clipping_mode]):
            new_wavs, result = guard_clipping(
                new_wavs, self.sr, guard_clipping_mode, gain_seq=gain_seq
            )
        self.wavs = new_wavs
        self.version = next(_audio_versions)
        self.guard_clip_result = result
        self.guard_clip_stats = result.per_channel_stats()
        self._stats = None

    def format_guard_clip_stats(self, mode: GuardClippingMode):
        """[(ch | -1, stat_string)] with empty stats dropped.
        reference: audio.rs:94-111."""
        if mode is GuardClippingMode.Clip:
            pairs = [(ch, str(stat)) for ch, stat in enumerate(self.guard_clip_stats)]
        else:
            pairs = [(-1, str(self.guard_clip_stats[0]))] if self.guard_clip_stats else []
        return [(ch, s) for ch, s in pairs if s]
