"""The benchmark's tracks, made from the seed on the device, and the WAV writer.

Frozen from ``thesia_tpu_torch/tools/signals.py`` (the song, the voice memo
and the lecture), with the rate, channels and length taken from the
configuration and the work done by torch on ``device`` in a few large
blocks: noise from a ``torch.Generator`` seeded with the run's seed, the
lecture's phrase lengths from a numpy generator on the same seed.  Every
seed gives the same sizes; only the content differs.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

BLOCK = 1 << 23  # samples a block: bounds the device temporaries


def _noise(gen: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32).double()


def song(gen, rng, sr: int, channels: int, seconds: float, device) -> torch.Tensor:
    """A chord that changes every 2 s, a vibrato lead, a slow tremolo, and
    white noise at -60 dBFS; channel k panned at 0.3 + 0.4 k / (C - 1)."""
    n = int(sr * seconds)
    pans = [0.3] if channels == 1 else [0.3 + 0.4 * k / (channels - 1) for k in range(channels)]
    out = torch.empty((channels, n), dtype=torch.float32, device=device)
    roots = torch.tensor([220.0, 246.94, 196.0, 174.61], dtype=torch.float64, device=device)
    phase0 = 0.0
    for b0 in range(0, n, BLOCK):
        t = torch.arange(b0, min(b0 + BLOCK, n), dtype=torch.float64, device=device) / sr
        r = roots[(t // 2.0).long() % 4]
        phase_root = phase0 + 2 * np.pi * torch.cumsum(r, 0) / sr
        phase0 = float(phase_root[-1])
        lead = torch.sin(2 * np.pi * 880.0 * t + 3.0 * torch.sin(2 * np.pi * 5.0 * t))
        trem = 0.6 + 0.4 * torch.sin(2 * np.pi * 0.25 * t)
        chord = trem * (0.25 * torch.sin(phase_root) + 0.15 * torch.sin(1.26 * phase_root)
                        + 0.1 * torch.sin(1.5 * phase_root))
        for k, pan in enumerate(pans):
            x = chord + (1 - pan) * 0.1 * lead + 1e-3 * _noise(gen, len(t), device)
            out[k, b0 : b0 + len(t)] = x.float()
    return out


def voice_memo(gen, rng, sr: int, channels: int, seconds: float, device) -> torch.Tensor:
    """Ten harmonics of a gliding 120 Hz pitch under a 3 Hz syllable
    envelope, and white noise at -60 dBFS."""
    n = int(sr * seconds)
    out = torch.empty((channels, n), dtype=torch.float32, device=device)
    for b0 in range(0, n, BLOCK):
        t = torch.arange(b0, min(b0 + BLOCK, n), dtype=torch.float64, device=device) / sr
        # f0 = 120 + 30 sin(2 pi 0.3 t), integrated in closed form
        ph = 2 * np.pi * 120.0 * t - (30.0 / 0.3) * torch.cos(2 * np.pi * 0.3 * t)
        x = sum(torch.sin(k * ph) / k for k in range(1, 11)) * 0.2
        x = x * (0.5 + 0.5 * torch.sin(2 * np.pi * 3.0 * t)) ** 2
        for k in range(channels):
            out[k, b0 : b0 + len(t)] = (x + 1e-3 * _noise(gen, len(t), device)).float()
    return out


def lecture(gen, rng, sr: int, channels: int, seconds: float, device) -> torch.Tensor:
    """One voice (six harmonics of a pitch gliding around 140 Hz under a 4 Hz
    syllable envelope) in phrases of 2-8 s separated by pauses of 0.3-1.5 s,
    and white noise at -60 dBFS throughout."""
    n = int(sr * seconds)
    lengths, voiced, total = [], [], 0
    while total < n:
        for on, (lo, hi) in ((True, (2.0, 8.0)), (False, (0.3, 1.5))):
            k = int(rng.uniform(lo, hi) * sr)
            lengths.append(k)
            voiced.append(on)
            total += k
    gate = torch.repeat_interleave(torch.tensor(voiced, dtype=torch.float64, device=device),
                                   torch.tensor(lengths, device=device))[:n]
    out = torch.empty((channels, n), dtype=torch.float32, device=device)
    for b0 in range(0, n, BLOCK):
        t = torch.arange(b0, min(b0 + BLOCK, n), dtype=torch.float64, device=device) / sr
        ph = 2 * np.pi * 140.0 * t - (25.0 / 0.2) * torch.cos(2 * np.pi * 0.2 * t)
        x = sum(torch.sin(k * ph) / k for k in range(1, 7)) * 0.25
        x = x * (0.5 + 0.5 * torch.sin(2 * np.pi * 4.0 * t)) ** 2 * gate[b0 : b0 + len(t)]
        for k in range(channels):
            out[k, b0 : b0 + len(t)] = (x + 1e-3 * _noise(gen, len(t), device)).float()
    return out


SIGNALS = {"song": song, "voice_memo": voice_memo, "lecture": lecture}


def make_track(spec: dict, seed: int, index: int, device) -> np.ndarray:
    """(C, n) int16 samples of a configuration's track ``spec`` (signal, sr,
    channels, seconds), the ``index``-th of its configuration."""
    if spec.get("bits", 16) != 16:
        raise ValueError("only 16-bit tracks are written")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 16 + index)
    rng = np.random.default_rng([seed, index])
    x = SIGNALS[spec["signal"]](gen, rng, int(spec["sr"]), int(spec["channels"]),
                                float(spec["seconds"]), device)
    q = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
    return q.cpu().numpy()


def wav_bytes_s16(samples: np.ndarray, sr: int) -> bytes:
    """16-bit PCM WAV file bytes of (C, n) int16 samples."""
    c = samples.shape[0]
    payload = np.ascontiguousarray(samples.T).astype("<i2").tobytes()
    head = struct.pack("<HHIIHH", 1, c, sr, sr * c * 2, c * 2, 16)
    chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(chunks)) + chunks
