"""Audio file decoding dispatch.

Host copy of ``thesia_tpu/io/decode.py`` (verbatim apart from this note): the port
imports nothing of the JAX package.  ``tests/test_torch_hostcopies.py``
pins the two against each other.

The reference decodes via symphonia (all codecs: wav/flac/mp3/aac/alac/ogg,
reference: src-tauri/src/core/audio.rs:262-439).  Here: WAV is decoded with
the pure-numpy RIFF parser; FLAC via the native C++ extension
(thesia_tpu/native); remaining codecs are detected and reported as
unsupported with a clear error (tracked gap).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .wav import WavError, decode_wav


@dataclasses.dataclass
class AudioFormatInfo:
    """reference: src-tauri/src/core/audio.rs:195-260."""

    name: str = ""
    sr: int = 0
    bit_depth: str = ""
    bitrate: str = ""

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "sr": self.sr,
            "bitDepth": self.bit_depth,
            "bitrate": self.bitrate,
        }


class DecodeError(ValueError):
    pass


def sniff_format(head: bytes) -> str:
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:3] == b"ID3" or (len(head) > 1 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    if head[4:8] == b"ftyp":
        return "m4a"
    if head[:4] == b"OggS":
        return "ogg"
    return "unknown"


def open_audio_file(
    path: str | os.PathLike, data: bytes | None = None
) -> tuple[np.ndarray, AudioFormatInfo]:
    """Decode an audio file -> (planar f32 (n_ch, n_samples), AudioFormatInfo).

    data: file bytes already in memory (the big-WAV prefetch reads the file
    for its device upload; passing them here avoids a second GB-scale read).

    Raises DecodeError for unreadable/unsupported input (the engine converts
    this into the per-file error path, reference: core/track.rs:211-221).
    """
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if len(data) < 12:
        raise DecodeError("file too short to be audio")
    kind = sniff_format(data[:12])
    if kind == "wav":
        try:
            wavs, sr, codec = decode_wav(data)
        except WavError as e:
            raise DecodeError(str(e)) from e
        # reference format naming: "wav - pcm_s16le"; bit_depth/bitrate empty
        # for wav (audio.rs:228-234)
        return wavs, AudioFormatInfo(name=f"wav - {codec}", sr=sr)
    if kind == "flac":
        from .flac import decode_flac, FlacError

        try:
            wavs, sr, bits = decode_flac(data)
        except FlacError as e:
            raise DecodeError(str(e)) from e
        return wavs, AudioFormatInfo(name="flac", sr=sr, bit_depth=f"{bits} bit")
    return _open_via_ffmpeg(path)


_FORMAT_NAME_MAP = {
    "mov,mp4,m4a,3gp,3g2,mj2": "isomp4",
    "matroska,webm": "mkv",
    "wav": "wav",
}
_CODEC_NAME_MAP = {"mp3float": "mp3", "pcm_s16le": "pcm_s16le"}


def _open_via_ffmpeg(path) -> tuple[np.ndarray, AudioFormatInfo]:
    """Decode via the system ffmpeg libraries (mp3/aac/alac/vorbis/opus/...),
    with AudioFormatInfo naming that mirrors the reference
    (audio.rs:195-260)."""
    from ..native import ffmpeg

    if not ffmpeg.available():
        raise DecodeError("unsupported audio format (ffmpeg decoder unavailable)")
    try:
        wavs, info = ffmpeg.decode(str(path))
    except ValueError as e:
        raise DecodeError(str(e)) from e
    fmt = _FORMAT_NAME_MAP.get(info["format"], info["format"])
    codec = _CODEC_NAME_MAP.get(info["codec"], info["codec"])
    name = fmt if fmt == codec else f"{fmt} - {codec}"
    sr = info["sr"]
    bit_depth = ""
    bitrate = ""
    if codec == "alac":
        bit_depth = f"{info['bits_per_sample'] or 16} bit"
    elif not name.startswith("wav"):
        if info["bit_rate"] > 0:
            bitrate = f"{round(info['bit_rate'] / 1000)} kbps"
        elif wavs.shape[1] > 0:
            kbps = info["packet_bytes"] * 8 * sr / wavs.shape[1] / 1000
            bitrate = f"{round(kbps)} kbps"
    return wavs, AudioFormatInfo(name=name, sr=sr, bit_depth=bit_depth, bitrate=bitrate)
