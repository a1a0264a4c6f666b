"""ctypes bindings for the ffmpeg-backed decoder (built on demand).

Host copy of ``thesia_tpu/native/ffmpeg.py``; the bindings are verbatim, the
build goes through ``build_shared`` into ``thesia_tpu_torch/_build/`` (see
the package docstring).  Where the ffmpeg development headers are missing the
build fails, ``available()`` is False and decoding a non-WAV/FLAC file raises
``DecodeError``, as the original does without ffmpeg.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import build_shared

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ffmpeg_decode.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_shared(
            _SRC, "thesia_ffmpeg", ("-O2", "-shared", "-fPIC", "-std=c++17"),
            ("-lavformat", "-lavcodec", "-lavutil"),
        )
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c = ctypes
        lib.ffmpeg_decode.argtypes = [
            c.c_char_p, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
            c.c_char_p, c.c_int, c.c_char_p, c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.POINTER(c.c_uint64),
        ]
        lib.ffmpeg_decode.restype = c.c_int
        lib.thesia_ffmpeg_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path: str):
    """-> (planar f32 (n_ch, n), info dict). Raises ValueError on failure."""
    lib = _load()
    if lib is None:
        raise ValueError("ffmpeg decoder unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_uint32()
    n_ch = ctypes.c_uint32()
    n = ctypes.c_uint64()
    codec = ctypes.create_string_buffer(64)
    fmt = ctypes.create_string_buffer(64)
    bits = ctypes.c_int32()
    bitrate = ctypes.c_int64()
    pkt_bytes = ctypes.c_uint64()
    rc = lib.ffmpeg_decode(
        path.encode(), ctypes.byref(out), ctypes.byref(sr), ctypes.byref(n_ch),
        ctypes.byref(n), codec, 64, fmt, 64,
        ctypes.byref(bits), ctypes.byref(bitrate), ctypes.byref(pkt_bytes),
    )
    if rc != 0:
        raise ValueError(f"ffmpeg decode failed (code {rc})")
    count = n.value * n_ch.value
    arr = np.ctypeslib.as_array(out, shape=(count,)).reshape(n_ch.value, n.value).copy()
    lib.thesia_ffmpeg_free(out)
    return arr, {
        "sr": sr.value,
        "codec": codec.value.decode(),
        "format": fmt.value.decode(),
        "bits_per_sample": bits.value,
        "bit_rate": bitrate.value,
        "packet_bytes": pkt_bytes.value,
    }
