"""Channel up/down-mix rules for playback output.

Host copy of ``thesia_tpu/player/mixing.py`` (numpy, unchanged);
pinned by ``tests/test_torch_hostcopies.py``.

reference: src-tauri/src/player/stream.rs:242-272.
"""

from __future__ import annotations

import numpy as np


def source_sample_for_output(
    samples: np.ndarray, input_channels: int, source_frame_idx: int,
    output_channel: int, output_channels: int,
) -> float:
    """Single-sample semantics (mirrors the reference exactly; tests)."""
    if input_channels == 0:
        return 0.0
    off = source_frame_idx * input_channels
    if off >= len(samples):
        return 0.0
    if input_channels == 1:
        return float(samples[off])
    if output_channels == 1:
        left = samples[off]
        right = samples[off + min(1, input_channels - 1)]
        return float((left + right) * 0.5)
    if input_channels == 2:
        src_ch = output_channel % 2
    else:
        src_ch = min(output_channel, input_channels - 1)
    return float(samples[off + src_ch])


def slice_frames(samples: np.ndarray, input_channels: int, start: int, n: int) -> np.ndarray:
    """(n, in_ch) from interleaved storage, zero-filled past the end."""
    out = np.zeros((n, input_channels), np.float32)
    if input_channels == 0:
        return out
    total = len(samples) // input_channels
    avail = max(min(n, total - start), 0)
    if avail > 0:
        out[:avail] = samples[
            start * input_channels : (start + avail) * input_channels
        ].reshape(avail, input_channels)
    return out


def mix_frames(src: np.ndarray, out_channels: int) -> np.ndarray:
    """(n, in_ch) -> (n, out_ch) with the reference mix rules
    (stream.rs:242-272): mono broadcasts; stereo->mono averages L/R;
    stereo->N tiles L/R; N->M clamps to the last input channel."""
    n, in_ch = src.shape
    if in_ch == out_channels:
        return src
    out = np.zeros((n, out_channels), src.dtype)
    if in_ch == 0:
        return out
    if in_ch == 1:
        out[:] = src
    elif out_channels == 1:
        out[:, 0] = (src[:, 0] + src[:, min(1, in_ch - 1)]) * 0.5
    else:
        for oc in range(out_channels):
            sc = oc % 2 if in_ch == 2 else min(oc, in_ch - 1)
            out[:, oc] = src[:, sc]
    return out


def render_block(
    samples: np.ndarray, input_channels: int, start_frame: int, n_frames: int,
    output_channels: int, volume: float,
) -> np.ndarray:
    """Vectorized block render -> (n_frames, output_channels) f32 in [-1, 1].

    Frames past the end render silence (reference fills zeros at track end).
    """
    if input_channels == 0:
        return np.zeros((n_frames, output_channels), np.float32)
    src = slice_frames(samples, input_channels, start_frame, n_frames)
    out = np.ascontiguousarray(mix_frames(src, output_channels))
    np.clip(out * volume, -1.0, 1.0, out=out)
    return out
