"""K6 (a track's u16 spectrogram image and its X-halving mip chain) as a
hand-written CUDA kernel: its wrapper, its plain version and the work it must
do.

``quantize_mips`` launches ``csrc/images.cu`` for CUDA tensors and runs the
plain version ``quantize_mips_reference`` for CPU tensors; any other device,
or a build or launch that fails, raises: nothing falls back.  The kernel
replaces the JAX package's device program ``_quantize_and_mips``
(``thesia_tpu/engine/images.py:91``, with ``_halve_t`` :62 and
``_clamp_tail`` :82); the source's header states its design.  The plain
version is that program as torch ops (in int32, with an f64 multiply-add
rounded once to f32 where XLA contracts an f32 FMA), bit for bit the JAX
program's and the kernel's.

Images are held as ``IMAGE_DTYPE``, ``torch.uint16``: 2 bytes a pixel, as
the JAX package holds them (``jnp.uint16``).  The store only allocates,
slices, copies and views them, which torch's 16-bit unsigned type covers
on the CPU and the card (``tests/test_torch_images_kernel.py`` pins the
dtype and the host bytes); arithmetic on them happens in the kernel, or in
the plain version's int32.

The port's spectrogram has exactly ``n_frames`` columns, so the JAX
``_clamp_tail`` (which neutralizes the garbage columns of a frame-cap
bucket) has nothing to do: each level's odd width copies its last column as
the host chain does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import obs
from ..runtime import count_launch
from . import build

IMAGE_DTYPE = torch.uint16
TILE_LEVELS = 8  # csrc/images.cu: D, the levels a tile of 2^D columns halves in one launch
MAX_LEVELS = 32  # csrc/images.cu: MAX_LEVELS
# f32 operations a quantized pixel (subtract, divide, FMA, the sign test, the
# half add, floor, the clamp) and integer ones a mip pixel (two adds, a shift)
FLOP_PER_PIXEL = 7
OPS_PER_MIP_PIXEL = 3


def level_width(n_frames: int, level: int) -> int:
    """Columns of mip level ``level`` of an image ``n_frames`` wide."""
    for _ in range(level):
        n_frames = (n_frames + 1) >> 1
    return n_frames


def _halve_t(x: torch.Tensor) -> torch.Tensor:
    """(..., T) int32 -> (..., ceil(T/2)) pairwise round-half-up average with
    odd tail copy -- the device twin of render.mips.halve_x_u16."""
    t = x.shape[-1]
    half = t // 2
    out = (x[..., 0 : 2 * half : 2] + x[..., 1 : 2 * half : 2] + 1) >> 1
    if t % 2:
        out = torch.cat([out, x[..., -1:]], dim=-1)
    return out


def quantize_mips_reference(
    db: torch.Tensor,
    db_lo: torch.Tensor,
    db_span: torch.Tensor,
    n_frames: int,
    *,
    i_start: int,
    n_rows: int,
    height: int,
    min_value: int,
    mip_levels: tuple[int, ...],
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(C, >= n_frames, F) f32 dB -> (img (C, H, n_frames), [mips]), each
    IMAGE_DTYPE: the plain version of ``quantize_mips``.

    Semantics of render.visualize.convert_spectrogram_to_img (reference:
    src-tauri/src/core/visualize/drawing.rs:6-36) with the dB range as f32
    device scalars: NaN -> 0 before the clip, sign*floor(|v|+0.5) (half away
    from zero, not torch.round's half to even), clip to [0, 65535]."""
    c = db.shape[0]
    out = torch.zeros((c, height, n_frames), dtype=torch.int32, device=db.device)
    if n_rows > 0:
        sub = db[:, :n_frames, i_start : i_start + n_rows].transpose(1, 2)
        # XLA contracts q * u16_span + min_value into one f32 fused
        # multiply-add; an f64 multiply-add rounded once to f32 gives the
        # same bits (the product of two f32 is exact in f64)
        q = ((sub - db_lo) / db_span).double()
        vals = (q * (65535 - min_value) + min_value).float()
        vals = torch.where(torch.isnan(vals), 0.0, vals)
        rounded = torch.sign(vals) * torch.floor(torch.abs(vals) + 0.5)
        out[:, :n_rows] = torch.clamp(rounded, 0.0, 65535.0).to(torch.int32)
    mips = []
    cur = out
    level = 0
    for target in mip_levels:
        while level < target:
            cur = _halve_t(cur)
            level += 1
        mips.append(cur.to(IMAGE_DTYPE))
    return out.to(IMAGE_DTYPE), mips


def launch_levels(mip_levels: tuple[int, ...]) -> list[int]:
    """The levels the kernel writes for ``mip_levels``: those, and each
    multiple of TILE_LEVELS below the deepest (a later launch halves from
    it), ascending."""
    deepest = max(mip_levels, default=0)
    return sorted(set(mip_levels) | set(range(TILE_LEVELS, deepest, TILE_LEVELS)))


def images_work(n_ch: int, n_rows: int, height: int, n_frames: int,
                mip_levels: tuple[int, ...]) -> dict:
    """What one ``quantize_mips`` call must move and compute, for its bound:
    ``bytes`` (each f32 dB of the image's rows read once, the two f32
    scalars, each u16 of the image and of the requested mip levels written
    once) and ``flop`` (FLOP_PER_PIXEL a quantized pixel, OPS_PER_MIP_PIXEL a
    mip pixel).  The levels the kernel writes only to halve from again are
    not the function's output and are not counted."""
    mip_px = n_ch * height * sum(level_width(n_frames, l) for l in mip_levels)
    return {"bytes": 4 * n_ch * n_rows * n_frames + 8 + 2 * n_ch * height * n_frames + 2 * mip_px,
            "flop": FLOP_PER_PIXEL * n_ch * n_rows * n_frames + OPS_PER_MIP_PIXEL * mip_px}


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t.numel() else None)


def _check(db, db_lo, db_span, n_frames, i_start, n_rows, height, min_value, mip_levels) -> None:
    if db.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_mips: no kernel for device {db.device}")
    if db.dtype != torch.float32 or db.dim() != 3:
        raise ValueError(f"quantize_mips: db must be a (C, T, F) float32 tensor, got "
                         f"{db.dtype} {tuple(db.shape)}")
    if db.device.type == "cuda" and not db.is_contiguous():
        raise ValueError(f"quantize_mips: the kernel reads a contiguous db, got strides "
                         f"{db.stride()}")
    c, t_db, f = db.shape
    if not (1 <= c <= 65535 and 0 <= n_frames <= t_db and 0 <= n_rows <= height
            and i_start >= 0 and (n_rows == 0 or i_start + n_rows <= f) and 0 <= min_value <= 65535):
        raise ValueError(f"quantize_mips: db {tuple(db.shape)}, n_frames {n_frames}, rows "
                         f"{i_start}+{n_rows} of height {height}, min_value {min_value}")
    if list(mip_levels) != sorted(set(mip_levels)) or any(l < 1 for l in mip_levels) \
            or max(mip_levels, default=0) > MAX_LEVELS:
        raise ValueError(f"quantize_mips: mip levels {mip_levels} must ascend from 1 to {MAX_LEVELS}")
    for name, s in (("lo", db_lo), ("span", db_span)):
        if s.device != db.device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"quantize_mips: {name} must be one float32 on {db.device}")


def quantize_mips(
    db: torch.Tensor,
    db_lo: torch.Tensor,
    db_span: torch.Tensor,
    n_frames: int,
    *,
    i_start: int,
    n_rows: int,
    height: int,
    min_value: int,
    mip_levels: tuple[int, ...],
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """K6: (C, >= n_frames, F) f32 dB (contiguous on a card) and the range's
    f32 device scalars -> (img (C, height, n_frames), [mip of each level in
    mip_levels]), each IMAGE_DTYPE, as ``quantize_mips_reference``.  On a
    card one call launches ``k6_quantize`` and, for levels deeper than
    TILE_LEVELS, ``k6_halve`` on the current stream (no sync; the kernel
    reads the scalars on the card)."""
    _check(db, db_lo, db_span, n_frames, i_start, n_rows, height, min_value, mip_levels)
    kw = dict(i_start=i_start, n_rows=n_rows, height=height, min_value=min_value,
              mip_levels=tuple(mip_levels))
    if db.device.type == "cpu":
        return quantize_mips_reference(db, db_lo, db_span, n_frames, **kw)
    c, t_db, f = db.shape
    dev = db.device
    with torch.cuda.device(dev):
        img = torch.empty((c, height, n_frames), dtype=IMAGE_DTYPE, device=dev)
        if n_frames == 0 or height == 0:
            return img, [torch.empty((c, height, level_width(n_frames, l)), dtype=IMAGE_DTYPE,
                                     device=dev) for l in mip_levels]
        levels = {l: torch.empty((c, height, level_width(n_frames, l)), dtype=IMAGE_DTYPE,
                                 device=dev) for l in launch_levels(tuple(mip_levels))}
        n_levels = max(levels, default=0)
        ptrs = np.zeros(n_levels + 1, np.int64)
        for l, t in levels.items():
            ptrs[l] = t.data_ptr()
        lib = build.library()
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        obs.mark("launch.k6")
        rc = lib.thesia_quantize_mips(
            _ptr(db), c, t_db, f, n_frames, i_start, n_rows, height, _ptr(db_lo), _ptr(db_span),
            min_value, _ptr(img), ptrs.ctypes.data_as(ctypes.c_void_p), n_levels, stream)
    if rc != 0:
        raise RuntimeError(f"quantize_mips kernel launch failed: CUDA error {rc}")
    count_launch(quantize_mips)
    return img, [levels[l] for l in mip_levels]


def reset_launches() -> None:
    """Both counts to 0: ``launches`` (the main path's) and ``warm_launches``
    (under runtime.warming())."""
    quantize_mips.launches = quantize_mips.warm_launches = 0


reset_launches()
