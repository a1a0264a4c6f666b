"""The synthetic tracks that ``chip_smoke.py`` and ``profile_main_path`` drive
the main path with: a 5-minute 48 kHz stereo song and a 60-second 16 kHz
mono voice memo, (channels, samples) float32, made from a numpy generator."""

from __future__ import annotations

import numpy as np

SONG_SR, SONG_SEC = 48000, 300.0
MEMO_SR, MEMO_SEC = 16000, 60.0


def song(rng: np.random.Generator, seconds: float = SONG_SEC) -> np.ndarray:
    """Stereo 'song': a chord that changes every 2 s, a vibrato lead, a slow
    tremolo, and white noise at -60 dBFS."""
    n = int(SONG_SR * seconds)
    t = np.arange(n) / SONG_SR
    roots = np.array([220.0, 246.94, 196.0, 174.61])[(t // 2.0).astype(np.int64) % 4]
    phase_root = 2 * np.pi * np.cumsum(roots) / SONG_SR
    lead = np.sin(2 * np.pi * 880.0 * t + 3.0 * np.sin(2 * np.pi * 5.0 * t))
    trem = 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t)
    chans = []
    for pan in (0.3, 0.7):
        x = trem * (0.25 * np.sin(phase_root) + 0.15 * np.sin(1.26 * phase_root)
                    + 0.1 * np.sin(1.5 * phase_root))
        x = x + (1 - pan) * 0.1 * lead + 1e-3 * rng.standard_normal(n)
        chans.append(x)
    return np.stack(chans).astype(np.float32)


def voice_memo(rng: np.random.Generator) -> np.ndarray:
    """Mono 'voice': ten harmonics of a gliding 120 Hz pitch under a 3 Hz
    syllable envelope, and white noise at -60 dBFS."""
    n = int(MEMO_SR * MEMO_SEC)
    t = np.arange(n) / MEMO_SR
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.3 * t)
    ph = 2 * np.pi * np.cumsum(f0) / MEMO_SR
    x = sum(np.sin(k * ph) / k for k in range(1, 11)) * 0.2
    x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) ** 2 + 1e-3 * rng.standard_normal(n)
    return x[None].astype(np.float32)
