"""Native extension loader: builds the host library on first use (g++ -O3),
exposes ctypes bindings.

Host copy of ``thesia_tpu/native/__init__.py``; the bindings below are
verbatim.  What differs is the build: g++ compiles ``src/thesia_native.cpp``
without ``-march=native`` (a binary tuned to the build host dies with SIGILL
on a CPU that lacks its instructions) into ``thesia_tpu_torch/_build/``,
named by a hash of the source and flags, so no binary is tracked and an
edited source rebuilds.  ``tests/test_torch_hostcopies.py`` pins the outputs
byte for byte against the original.

Everything here has a pure-Python fallback; `available()` reports whether the
native path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "thesia_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def build_shared(src: str, name: str, flags=GXX_FLAGS, libs=()) -> str | None:
    """Compile ``src`` with g++ into ``BUILD_DIR/lib<name>_<hash>.so`` unless
    that file exists; its path, or None when the compile fails."""
    h = hashlib.sha256(" ".join((*flags, *libs)).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # several processes may build at once
    cmd = ["g++", *flags, "-o", tmp, src, *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_shared(_SRC, "thesia_native")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        c = ctypes
        lib.lanczos3_crop_resize_u16.argtypes = [
            c.POINTER(c.c_uint16), c.c_int, c.c_int,
            c.c_double, c.c_double, c.c_double, c.c_double,
            c.c_int, c.c_int, c.POINTER(c.c_uint16),
        ]
        lib.spectrogram_tile_rgba.argtypes = [
            c.POINTER(c.c_uint16), c.c_int, c.c_int,
            c.c_double, c.c_double, c.c_double, c.c_double,
            c.c_int, c.c_int, c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_uint8),
        ]
        lib.halve_x_u16.argtypes = [
            c.POINTER(c.c_uint16), c.c_int64, c.c_int64, c.POINTER(c.c_uint16),
        ]
        lib.u16_rgba_rows_bottom_up.argtypes = [
            c.POINTER(c.c_uint16), c.c_int64, c.c_int64,
            c.POINTER(c.c_uint8), c.POINTER(c.c_uint8),
        ]
        lib.waveform_bin_stats.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int64, c.c_int64,
            c.POINTER(c.c_float),
        ]
        lib.limiter_gain_seq.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_uint32,
            c.c_double, c.c_double, c.c_double, c.c_double,
            c.POINTER(c.c_double),
        ]
        lib.limiter_apply.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64, c.POINTER(c.c_double),
        ]
        lib.resample_block.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64,
            c.POINTER(c.c_double), c.c_int64, c.c_int64,
            c.c_double, c.c_double, c.c_int64, c.POINTER(c.c_float),
        ]
        lib.pcm_to_f32_planar.argtypes = [
            c.POINTER(c.c_uint8), c.c_int64, c.c_int64, c.c_int,
            c.POINTER(c.c_float),
        ]
        lib.pcm_to_f32_planar.restype = c.c_int
        lib.audio_stats.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_uint32,
            c.POINTER(c.c_double), c.POINTER(c.c_double),
            c.POINTER(c.c_double), c.POINTER(c.c_double),
            c.POINTER(c.c_double), c.c_int64,
            c.POINTER(c.c_double), c.POINTER(c.c_double),
        ]
        lib.flac_decode.argtypes = [
            c.POINTER(c.c_uint8), c.c_size_t, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint32),
        ]
        lib.flac_decode.restype = c.c_int
        lib.f32_to_s16_grid.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int16),
        ]
        lib.f32_to_s16_grid.restype = c.c_int
        lib.thesia_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def lanczos3_crop_resize_u16(src: np.ndarray, crop, dst_w: int, dst_h: int):
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, np.uint16)
    dst = np.empty((dst_h, dst_w), np.uint16)
    left, top, right, bottom = crop
    lib.lanczos3_crop_resize_u16(
        _ptr(src, ctypes.c_uint16), src.shape[0], src.shape[1],
        left, top, right, bottom, dst_w, dst_h, _ptr(dst, ctypes.c_uint16),
    )
    return dst


def spectrogram_tile_rgba(
    spec: np.ndarray, crop, width: int, height: int, colormap_rgba: np.ndarray
) -> np.ndarray:
    lib = _load()
    assert lib is not None
    spec = np.ascontiguousarray(spec, np.uint16)
    cm = np.ascontiguousarray(colormap_rgba, np.uint8)
    out = np.empty(height * width * 4, np.uint8)
    left, top, right, bottom = crop
    lib.spectrogram_tile_rgba(
        _ptr(spec, ctypes.c_uint16), spec.shape[0], spec.shape[1],
        left, top, right, bottom, width, height,
        _ptr(cm, ctypes.c_uint8), cm.shape[0], _ptr(out, ctypes.c_uint8),
    )
    return out


def halve_x_u16(src: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(src, np.uint16)
    h, w = src.shape
    out = np.empty((h, (w + 1) // 2), np.uint16)
    lib.halve_x_u16(_ptr(src, ctypes.c_uint16), h, w, _ptr(out, ctypes.c_uint16))
    return out


def u16_rgba_rows_bottom_up(pixels: np.ndarray, lut_rgba: np.ndarray) -> np.ndarray:
    """pixels (h, w) u16 + LUT (65536, 4) u8 -> flat RGBA bytes, rows
    bottom-up."""
    lib = _load()
    assert lib is not None
    pixels = np.ascontiguousarray(pixels, np.uint16)
    lut = np.ascontiguousarray(lut_rgba, np.uint8)
    h, w = pixels.shape
    out = np.empty(h * w * 4, np.uint8)
    lib.u16_rgba_rows_bottom_up(
        _ptr(pixels, ctypes.c_uint16), h, w,
        _ptr(lut, ctypes.c_uint8), _ptr(out, ctypes.c_uint8),
    )
    return out


def waveform_bin_stats(wav: np.ndarray, start: int, end: int, spb: int, bin_count: int):
    lib = _load()
    assert lib is not None
    wav = np.ascontiguousarray(wav, np.float32)
    out = np.empty((bin_count, 3), np.float32)
    lib.waveform_bin_stats(
        _ptr(wav, ctypes.c_float), start, end, spb, bin_count, _ptr(out, ctypes.c_float)
    )
    return out


def limiter_gain_seq(
    wavs: np.ndarray, sr: int, threshold=1.0, attack_ms=5.0, hold_ms=15.0, release_ms=40.0
) -> np.ndarray:
    lib = _load()
    assert lib is not None
    wavs = np.ascontiguousarray(np.atleast_2d(wavs), np.float32)
    n_ch, n = wavs.shape
    out = np.empty(n, np.float64)
    lib.limiter_gain_seq(
        _ptr(wavs, ctypes.c_float), n_ch, n, sr,
        threshold, attack_ms, hold_ms, release_ms, _ptr(out, ctypes.c_double),
    )
    return out


def limiter_apply(wavs: np.ndarray, gain: np.ndarray) -> np.ndarray:
    """Scale wavs by the per-sample gain.  NOT guaranteed in-place: a
    non-contiguous/non-f32 input is copied first — always use the RETURN
    value (calling for the side effect silently no-ops on a copy)."""
    lib = _load()
    assert lib is not None
    wavs = np.ascontiguousarray(np.atleast_2d(wavs), np.float32)
    gain = np.ascontiguousarray(gain, np.float64)
    lib.limiter_apply(_ptr(wavs, ctypes.c_float), wavs.shape[0], wavs.shape[1], _ptr(gain, ctypes.c_double))
    return wavs


def resample_block(
    buf: np.ndarray, bank: np.ndarray, pos0: float, ratio: float, n_out: int
) -> np.ndarray:
    """buf (n_ch, n_total) f32 + bank (n_phases+1, sinc_len) f64 ->
    (n_ch, n_out) f32 resampled output starting at input position pos0."""
    lib = _load()
    assert lib is not None
    buf = np.ascontiguousarray(buf, np.float32)
    bank = np.ascontiguousarray(bank, np.float64)
    n_ch, n_total = buf.shape
    n_phases = bank.shape[0] - 1
    sinc_len = bank.shape[1]
    out = np.empty((n_ch, n_out), np.float32)
    lib.resample_block(
        _ptr(buf, ctypes.c_float), n_ch, n_total,
        _ptr(bank, ctypes.c_double), n_phases, sinc_len,
        pos0, ratio, n_out, _ptr(out, ctypes.c_float),
    )
    return out


_PCM_FMT = {"f32": 0, "f64": 1, "u8": 2, "s16": 3, "s24": 4, "s32": 5}
_PCM_BYTES = {"f32": 4, "f64": 8, "u8": 1, "s16": 2, "s24": 3, "s32": 4}


def pcm_to_f32_planar(payload: bytes | np.ndarray, n_ch: int, fmt: str) -> np.ndarray:
    """Interleaved PCM payload -> planar (n_ch, n) f32."""
    lib = _load()
    assert lib is not None
    src = np.frombuffer(payload, np.uint8) if isinstance(payload, (bytes, bytearray, memoryview)) else np.ascontiguousarray(payload, np.uint8)
    bpp = _PCM_BYTES[fmt]
    n = len(src) // (bpp * n_ch)
    out = np.empty((n_ch, n), np.float32)
    rc = lib.pcm_to_f32_planar(
        _ptr(src, ctypes.c_uint8), n, n_ch, _PCM_FMT[fmt], _ptr(out, ctypes.c_float)
    )
    if rc != 0:
        # temp-buffer allocation failed: raising matches the numpy
        # fallback's MemoryError — returning zeros decoded a GB-scale
        # track as valid silence (review finding)
        raise MemoryError("pcm_to_f32_planar: temp buffer allocation failed")
    return out


def audio_stats(wavs: np.ndarray, sr: int, coeffs) -> tuple[np.ndarray, float, float]:
    """One streaming pass: (per-100ms weighted K-energies, sum_sq, abs_max).
    coeffs = (b1, a1, b2, a2) f64 arrays from loudness.k_weighting_coeffs."""
    lib = _load()
    assert lib is not None
    wavs = np.ascontiguousarray(np.atleast_2d(wavs), np.float32)
    n_ch, n = wavs.shape
    s100 = (sr + 5) // 10
    n_segs = n // s100 if s100 else 0
    segs = np.empty(max(n_segs, 1), np.float64)
    b1, a1, b2, a2 = (np.ascontiguousarray(c, np.float64) for c in coeffs)
    sum_sq = ctypes.c_double()
    abs_max = ctypes.c_double()
    lib.audio_stats(
        _ptr(wavs, ctypes.c_float), n_ch, n, sr,
        _ptr(b1, ctypes.c_double), _ptr(a1, ctypes.c_double),
        _ptr(b2, ctypes.c_double), _ptr(a2, ctypes.c_double),
        _ptr(segs, ctypes.c_double), n_segs,
        ctypes.byref(sum_sq), ctypes.byref(abs_max),
    )
    return segs[:n_segs], sum_sq.value, abs_max.value


def f32_to_s16_grid(wavs: np.ndarray) -> np.ndarray | None:
    """(…,) f32 -> same-shape int16 when every sample is exactly k/32768,
    else None (single C pass with early exit)."""
    lib = _load()
    assert lib is not None
    wavs = np.ascontiguousarray(wavs, np.float32)
    out = np.empty(wavs.shape, np.int16)
    ok = lib.f32_to_s16_grid(
        _ptr(wavs, ctypes.c_float), wavs.size, _ptr(out, ctypes.c_int16)
    )
    return out if ok else None


def flac_decode(data: bytes):
    """-> (planar f32 (n_ch, n), sr, bits). Raises ValueError on failure."""
    lib = _load()
    assert lib is not None
    # zero-copy view: the C side takes const uint8_t*, so the read-only
    # bytes buffer can be handed over directly (copying doubled the memory
    # of a large FLAC per decode; review finding)
    buf = np.frombuffer(data, np.uint8)
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_uint32()
    n_ch = ctypes.c_uint32()
    n = ctypes.c_uint64()
    bps = ctypes.c_uint32()
    rc = lib.flac_decode(
        _ptr(buf, ctypes.c_uint8), len(data),
        ctypes.byref(out), ctypes.byref(sr), ctypes.byref(n_ch),
        ctypes.byref(n), ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"flac decode failed (code {rc})")
    count = n.value * n_ch.value
    arr = np.ctypeslib.as_array(out, shape=(count,)).reshape(n_ch.value, n.value).copy()
    lib.thesia_free(out)
    return arr, sr.value, bps.value
