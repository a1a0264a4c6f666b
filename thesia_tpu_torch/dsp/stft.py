"""Center-padded STFT helpers: frame count, cyclic reflect padding, the
window-folded real-DFT matrices and the reference-semantics STFT.

Host copy of ``stft_frame_count``, ``reflect_indices``, ``reflect_pad_1d``
and ``make_dft_matrices`` from ``thesia_tpu/dsp/stft.py:29-80`` (verbatim;
the port imports nothing of the JAX package); ``reflect_indices_torch``, the
JAX ``reflect_indices`` built on a torch device (the engine pads on the
device); and ``perform_stft``, the JAX correctness-path STFT with its two
products in torch on a device.  ``gather_frames`` and ``frame_starts`` are
not ported: nothing calls them.  ``tests/test_torch_dsp.py`` pins these
against the originals.

Semantics (reference: src-tauri/src/core/spectrogram/stft.rs:16-149): reflect-
pad win//2 samples on each side (cyclic reflection when the pad exceeds the
signal, utils.rs:61-142), frames of length win at stride hop, each frame
windowed by (hann / n_fft) and centered in n_fft, real DFT of size n_fft.
"""

from __future__ import annotations

import numpy as np
import torch


def stft_frame_count(n_samples: int, win_length: int, hop_length: int) -> int:
    """Number of STFT frames for a center-padded signal (stft.rs:50-97):
    frames start at t*hop - win//2 and must fit inside the padded extent
    [-win//2, n_samples + win//2)."""
    padded = n_samples + 2 * (win_length // 2)
    if padded < win_length:
        return 0
    return (padded - win_length) // hop_length + 1


def reflect_indices(n: int, n_left: int, n_right: int) -> np.ndarray:
    """Index map implementing cyclic reflect padding (utils.rs:111-138)."""
    if n == 1:
        return np.zeros(n_left + 1 + n_right, dtype=np.int64)
    period = 2 * (n - 1)
    i = np.arange(-n_left, n + n_right, dtype=np.int64)
    j = np.mod(i, period)
    j = np.where(j >= n, period - j, j)
    return j


def reflect_pad_1d(x: np.ndarray, n_left: int, n_right: int) -> np.ndarray:
    """Cyclic reflect padding of a 1-D array (host-side, cheap)."""
    idx = reflect_indices(x.shape[-1], n_left, n_right)
    return x[..., idx]


def reflect_indices_torch(n: int, n_left: int, n_right: int, device) -> torch.Tensor:
    """Index map implementing cyclic reflect padding (utils.rs:111-138),
    computed on ``device``."""
    if n == 1:
        return torch.zeros(n_left + 1 + n_right, dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    i = torch.arange(-n_left, n + n_right, dtype=torch.int64, device=device)
    j = torch.remainder(i, period)  # sign of the divisor, like np.mod
    return torch.where(j >= n, period - j, j)


def make_dft_matrices(
    window: np.ndarray, n_fft: int, n_pad_left: int, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices (win, n_freq).

    Re[t,k] = sum_i frame[t,i] * w[i] * cos(-2*pi*k*(n_pad_left+i)/n_fft)
    so a frame of raw samples multiplied with these gives the same result as
    window -> center-zero-pad to n_fft -> rfft.  Built in float64, cast down.
    """
    win = window.shape[0]
    n_freq = n_fft // 2 + 1
    i = np.arange(win, dtype=np.float64) + n_pad_left
    k = np.arange(n_freq, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(i, k) / n_fft
    w = window.astype(np.float64)[:, None]
    cw = (np.cos(ang) * w).astype(dtype)
    sw = (np.sin(ang) * w).astype(dtype)
    return cw, sw


def perform_stft(
    wav: np.ndarray,
    win_length: int,
    hop_length: int,
    n_fft: int,
    window: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Reference-semantics STFT -> complex64 (n_frames, n_fft//2+1).

    Correctness-path entry point (tests, small inputs): the framed signal
    times the window-folded DFT matrices, in f32 on ``device``.  The
    production path is ``SpectrogramAnalyzer.calc_spec``, which fuses
    magnitude, mel and dB."""
    from ..common.windows import WindowType, calc_normalized_win
    from ..runtime import resolve_device

    dev = resolve_device(device)
    if window is None:
        window = calc_normalized_win(WindowType.Hann, win_length, n_fft)
    n = wav.shape[-1]
    n_frames = stft_frame_count(n, win_length, hop_length)
    pad = win_length // 2
    padded = reflect_pad_1d(np.asarray(wav, np.float32), pad, pad)
    n_pad_left = (n_fft - win_length) // 2
    cw, sw = make_dft_matrices(window, n_fft, n_pad_left)
    frames = np.stack(
        [padded[t * hop_length : t * hop_length + win_length] for t in range(n_frames)]
    )
    frames_t = torch.from_numpy(frames).to(dev)
    re = torch.matmul(frames_t, torch.from_numpy(cw).to(dev)).cpu().numpy()
    im = torch.matmul(frames_t, torch.from_numpy(sw).to(dev)).cpu().numpy()
    return re + 1j * im
