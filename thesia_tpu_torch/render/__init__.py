"""Host-side rendering: colormap, Lanczos3 resize, mip chains and tiles.

``__all__`` is the JAX package's (``thesia_tpu/render/__init__.py``) but for
``convert_spectrogram_to_img_device``, which is not ported (the JAX
``_quantize_and_mips`` superseded it; the port's is ``kernels/images.py:
quantize_mips``)."""

from .colormap import default_colormap_rgba8
from .resize import lanczos3_crop_resize_u16
from .tiles import (
    SPECTROGRAM_TILE_GUTTER,
    SPECTROGRAM_TILE_SIZE,
    WAVEFORM_TILE_BINS,
    RenderTileCache,
    decode_spectrogram_tile,
    decode_waveform_tile,
    encode_spectrogram_tile,
    encode_waveform_tile,
)
from .visualize import convert_spectrogram_to_img

__all__ = [
    "default_colormap_rgba8",
    "convert_spectrogram_to_img",
    "lanczos3_crop_resize_u16",
    "RenderTileCache",
    "SPECTROGRAM_TILE_GUTTER",
    "SPECTROGRAM_TILE_SIZE",
    "WAVEFORM_TILE_BINS",
    "decode_spectrogram_tile",
    "decode_waveform_tile",
    "encode_spectrogram_tile",
    "encode_waveform_tile",
]
