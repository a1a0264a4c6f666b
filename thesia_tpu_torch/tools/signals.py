"""The synthetic tracks that ``chip_smoke.py`` and ``profile_main_path`` drive
the main path with: a 5-minute 48 kHz stereo song, a 60-second 16 kHz mono
voice memo and a 1-hour 16 kHz mono lecture (an interview or lecture
recording: 57.6 M samples, a 115 MB 16-bit WAV), (channels, samples)
float32, made from a numpy generator; ``wav_bytes``, which writes them as
16-bit, 24-bit or float WAVs; and ``write_song_and_memo``, the song and memo
files of the tools."""

from __future__ import annotations

import struct

import numpy as np

SONG_SR, SONG_SEC = 48000, 300.0
MEMO_SR, MEMO_SEC = 16000, 60.0
LECTURE_SR, LECTURE_SEC = 16000, 3600.0


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


def lecture(rng: np.random.Generator, seconds: float = LECTURE_SEC) -> np.ndarray:
    """Mono 'lecture': one voice (six harmonics of a pitch gliding around
    140 Hz under a 4 Hz syllable envelope) in phrases of 2-8 s separated by
    pauses of 0.3-1.5 s, and white noise at -60 dBFS throughout.  Built a
    minute at a time to keep the temporaries small."""
    n = int(LECTURE_SR * seconds)
    # phrase/pause gate: alternating segment lengths in samples
    lengths, voiced, total = [], [], 0
    while total < n:
        for on, (lo, hi) in ((True, (2.0, 8.0)), (False, (0.3, 1.5))):
            k = int(rng.uniform(lo, hi) * LECTURE_SR)
            lengths.append(k)
            voiced.append(on)
            total += k
    gate = np.repeat(np.array(voiced, np.float32), lengths)[:n]
    out = np.empty(n, np.float32)
    block = 60 * LECTURE_SR
    for b0 in range(0, n, block):
        t = np.arange(b0, min(b0 + block, n)) / LECTURE_SR
        # f0 = 140 + 25 sin(2 pi 0.2 t), integrated in closed form
        ph = 2 * np.pi * 140.0 * t - (25.0 / 0.2) * np.cos(2 * np.pi * 0.2 * t)
        x = sum(np.sin(k * ph) / k for k in range(1, 7)) * 0.25
        env = (0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t)) ** 2
        x = x * env * gate[b0 : b0 + len(t)] + 1e-3 * rng.standard_normal(len(t))
        out[b0 : b0 + len(t)] = x
    return out[None]


def wav_bytes(wavs: np.ndarray, sr: int, fmt: str, list_chunk: bool = False) -> bytes:
    """WAV file bytes of planar float32 samples (C, n) as 16-bit ("s16"),
    packed 24-bit ("s24") or IEEE float ("f32") PCM.  ``list_chunk`` puts a
    6-byte LIST chunk before the data, so the payload starts at byte 58, off
    4-byte alignment (as WAVs with metadata chunks do)."""
    c = wavs.shape[0]
    inter = np.ascontiguousarray(wavs.T)
    if fmt == "s16":
        tag, width = 1, 2
        payload = np.clip(np.round(inter * 32768.0), -32768, 32767).astype("<i2").tobytes()
    elif fmt == "s24":
        tag, width = 1, 3
        ints = np.clip(np.round(inter * 8388608.0), -8388608, 8388607).astype("<i4")
        payload = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    elif fmt == "f32":
        tag, width = 3, 4
        payload = inter.astype("<f4").tobytes()
    else:
        raise ValueError(f"unknown format {fmt!r}")
    head = struct.pack("<HHIIHH", tag, c, sr, sr * c * width, c * width, 8 * width)
    chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
    if list_chunk:
        chunks += b"LIST" + struct.pack("<I", 6) + b"INFO\0\0"
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        chunks += b"\0"
    return b"RIFF" + struct.pack("<I", len(chunks)) + chunks


def write_song_and_memo(out) -> list[str]:
    """Write the song and the memo (seed 0, as chip_smoke.py makes them) as
    16-bit WAVs ``out``/song_48k_stereo.wav and ``out``/memo_16k_mono.wav;
    returns their paths in that order."""
    from pathlib import Path

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = [out / "song_48k_stereo.wav", out / "memo_16k_mono.wav"]
    paths[0].write_bytes(wav_bytes(song(rng), SONG_SR, "s16"))
    paths[1].write_bytes(wav_bytes(voice_memo(rng), MEMO_SR, "s16"))
    return [str(p) for p in paths]


def main() -> int:
    """``python -m thesia_tpu_torch.tools.signals DIR``: ``write_song_and_memo``
    into DIR, the files ``coldstart`` takes."""
    import sys

    write_song_and_memo(sys.argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
