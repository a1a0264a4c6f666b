"""Window functions, normalized for the reference's STFT convention.

Host copy of ``thesia_tpu/common/windows.py`` (verbatim apart from this note): the port
imports nothing of the JAX package.  ``tests/test_torch_hostcopies.py``
pins the two against each other.

The STFT multiplies frames by window / n_fft (NOT the usual 1/sum(w)), so the
spectrogram magnitude convention matches the reference exactly.
reference: src-tauri/src/core/windows.rs:5-83, caller core/spectrogram.rs:123.
"""

from __future__ import annotations

import enum

import numpy as np


class WindowType(enum.Enum):
    Hann = "hann"
    Blackman = "blackman"
    BoxCar = "boxcar"


def _cosine_window(a, b, c, d, size: int, symmetric: bool, dtype) -> np.ndarray:
    """Generalized cosine window. reference: src-tauri/src/core/windows.rs:67-83."""
    assert size > 1
    size2 = size if symmetric else size + 1
    i = np.arange(size2, dtype=dtype)
    x = np.asarray(np.pi, dtype=dtype) * i / dtype(size2 - 1)
    w = (a - b * np.cos(2 * x)) + (c * np.cos(4 * x) - d * np.cos(6 * x))
    return w[:size]


def hann(size: int, symmetric: bool = False, dtype=np.float32) -> np.ndarray:
    """Periodic (default) Hann. hann(4) == [0, .5, 1, .5].
    reference: src-tauri/src/core/windows.rs:30-38."""
    dt = np.dtype(dtype).type
    return _cosine_window(dt(0.5), dt(0.5), dt(0.0), dt(0.0), size, symmetric, dt)


def blackman(size: int, symmetric: bool = False, dtype=np.float32) -> np.ndarray:
    """Blackman window (rubato-style). reference: src-tauri/src/core/windows.rs:41-65."""
    assert size > 1
    dt = np.dtype(dtype).type
    size2 = size + 1 if symmetric else size
    x = np.arange(size2, dtype=dt)
    np_f = dt(size2)
    w = dt(0.42) - (dt(0.5) * np.cos(dt(2 * np.pi) * x / np_f)
                    + dt(0.08) * np.cos(dt(4 * np.pi) * x / np_f))
    # rust mul_add(b*cos2, c*cos4) -> a - (b*cos2 + c*cos4); sign layout matches
    return w[1:] if symmetric else w


def calc_normalized_win(
    win_type: WindowType, size: int, norm_factor: float, dtype=np.float32
) -> np.ndarray:
    """window / norm_factor (norm_factor = n_fft in the STFT pipeline).
    reference: src-tauri/src/core/windows.rs:11-28."""
    dt = np.dtype(dtype).type
    nf = dt(norm_factor)
    if win_type is WindowType.Hann:
        return hann(size, False, dtype) / nf
    if win_type is WindowType.Blackman:
        return blackman(size, False, dtype) / nf
    return np.full(size, dt(1.0) / nf, dtype=dtype)
