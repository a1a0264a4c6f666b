"""dB spectrogram -> u16 image quantization on the host.

Host copy of ``convert_spectrogram_to_img`` from
``thesia_tpu/render/visualize.py:30-62`` (the host quantizer ``bench.py``
uses; verbatim apart from this note), with ``quantize_min_value`` from
``render/colormap.py``, where the port keeps it.  The device quantizer is
K6, ``kernels/images.py: quantize_mips``; the JAX
``convert_spectrogram_to_img_device`` is not ported, since the JAX
``_quantize_and_mips`` superseded it.  ``tests/test_torch_images.py`` pins
the copy against the original.

reference: src-tauri/src/core/visualize/drawing.rs:6-36.

The u16 range is [min_value, 65535] where min_value = round(65535 /
colormap_length) (reserving 0 as the out-of-band black), values below/above
the dB range clamp, and frequency rows outside the computed spectrogram
(tracks whose sr is below the global max) are 0.
"""

from __future__ import annotations

import numpy as np

from .colormap import quantize_min_value

__all__ = ["convert_spectrogram_to_img", "quantize_min_value"]

_min_value = quantize_min_value  # internal alias


def convert_spectrogram_to_img(
    spec: np.ndarray,
    i_freq_range: tuple[int, int],
    db_range: tuple[float, float],
    colormap_length: int | None,
) -> np.ndarray:
    """spec (T, F) f32 dB -> image (H, T) u16 with H = i_freq_end - i_freq_start.

    Row i of the image is frequency bin i_freq_start + i (low freq at row 0;
    tile encoding flips to high-first at serialization time).
    """
    spec = np.asarray(spec)
    i_start, i_end = i_freq_range
    height = i_end - i_start
    width = spec.shape[0]
    if db_range[0] == db_range[1] and np.isneginf(db_range[1]):
        return np.zeros((height, width), np.uint16)
    assert np.isfinite(db_range[0])
    min_value = _min_value(colormap_length)
    u16_span = np.float32(65535 - min_value)
    db_span = np.float32(db_range[1] - db_range[0])

    f_avail = spec.shape[1]
    n_rows = max(min(i_end, f_avail) - i_start, 0)
    out = np.zeros((height, width), np.uint16)
    if n_rows > 0:
        sub = spec[:, i_start : i_start + n_rows].T.astype(np.float32)  # (n_rows, T)
        zero_to_one = (sub - np.float32(db_range[0])) / db_span
        vals = zero_to_one * u16_span + np.float32(min_value)
        # rust f32::round (half away from zero) then clamp to [0, 65535]
        vals = np.where(np.isnan(vals), 0.0, vals)
        rounded = np.sign(vals) * np.floor(np.abs(vals) + 0.5)
        out[:n_rows] = np.clip(rounded, 0.0, 65535.0).astype(np.uint16)
    return out
