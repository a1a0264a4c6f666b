"""Lanczos3 convolution resize with fractional crop window.

Frozen copy of ``thesia_tpu_torch/render/resize.py`` for the benchmark's plain reference;
nothing here imports the port, and the port never imports this.

Semantics follow the `fast_image_resize` crate's Convolution(Lanczos3)
resampler as used by the reference tile encoder (reference:
src-tauri/src/core/render_tiles.rs:354-393): the crop window (left, top,
width, height) is given in fractional source coordinates, dst pixel centers
map linearly into the crop window, the kernel support scales with the
downscale ratio, windows clamp at image borders, and weights are normalized
to sum 1.  Two passes (horizontal, then vertical) with rounding to u16
between passes, f64 accumulation.
"""

from __future__ import annotations

import numpy as np

_SUPPORT = 3.0  # lanczos3


def _lanczos3(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    with np.errstate(invalid="ignore", divide="ignore"):
        y = np.sinc(x) * np.sinc(x / 3.0)
    return np.where(ax < 3.0, y, 0.0)


def _axis_weights(src_size: int, crop_start: float, crop_size: float, dst_size: int):
    """Per-dst-pixel (indices (dst, k), weights (dst, k)) for one axis."""
    scale = crop_size / dst_size
    filter_scale = max(scale, 1.0)
    support = _SUPPORT * filter_scale
    centers = crop_start + (np.arange(dst_size, dtype=np.float64) + 0.5) * scale
    left = np.floor(centers - support).astype(np.int64)
    right = np.ceil(centers + support).astype(np.int64)
    k = int((right - left).max())
    idx = left[:, None] + np.arange(k)[None, :]
    valid = (idx >= 0) & (idx < src_size) & (idx < right[:, None])
    idx_c = np.clip(idx, 0, src_size - 1)
    w = _lanczos3((idx + 0.5 - centers[:, None]) / filter_scale)
    w = np.where(valid, w, 0.0)
    norm = w.sum(axis=1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    w = w / norm
    return idx_c, w


def _round_clamp_u16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(x + 0.5), 0.0, 65535.0).astype(np.uint16)


def lanczos3_crop_resize_u16(
    src: np.ndarray,
    crop: tuple[float, float, float, float],
    dst_w: int,
    dst_h: int,
) -> np.ndarray:
    """src (H, W) u16, crop = (left, top, right, bottom) fractional source
    coords -> (dst_h, dst_w) u16."""
    left, top, right, bottom = crop
    src_h, src_w = src.shape
    idx_x, w_x = _axis_weights(src_w, left, right - left, dst_w)
    idx_y, w_y = _axis_weights(src_h, top, bottom - top, dst_h)

    # horizontal pass: (H, dst_w)
    gathered = src[:, idx_x].astype(np.float64)  # (H, dst_w, k)
    horiz = _round_clamp_u16(np.einsum("hdk,dk->hd", gathered, w_x))
    # vertical pass: (dst_h, dst_w)
    gathered_v = horiz[idx_y, :].astype(np.float64)  # (dst_h, k, dst_w)
    out = _round_clamp_u16(np.einsum("dkw,dk->dw", gathered_v, w_y))
    return out
