"""Tiles of the benchmark's plain reference: the X mip chain, spectrogram
and waveform tiles.

Frozen copies (numpy routes only) of ``thesia_tpu_torch/render/colormap.py``
(the default colormap table, ``quantize_min_value``),
``render/mips.py`` (``halve_x_u16``, ``chain_len``) and ``render/tiles.py``
(tile geometry, ``encode_tile_body_from_source``, the colormap LUT,
``waveform_bin_stats``).
"""

from __future__ import annotations

import struct

import numpy as np

from .resize import lanczos3_crop_resize_u16

TILE = 512
GUTTER = 4
WAVEFORM_BINS = 1024
MIP_MIN_WIDTH = 1024

_RGB_HEX = (
    "00000000000401000501010601010802010a02020c02020e030210040312040314050417"
    "06041907051b08051d09061f0a07220b07240c08260d08290e092b10092d110a30120a32"
    "140b34150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48210c4a230c4c240c4f"
    "260c51280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f360961380962390963"
    "3b09643d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c"
    "4f0d6c510e6c520e6d540f6d550f6d57106e59106e5a116e5c126e5d126e5f136e61136e"
    "62146e64156e65156e67166e69166e6a176e6c186e6d186e6f196e71196e721a6e741a6e"
    "751b6e771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b"
    "88226a8a226a8c23698d23698f24699025689225689326679526679727669827669a2865"
    "9b29649d29649f2a63a02a63a22b62a32c61a52c60a62d60a82e5fa92e5eab2f5ead305d"
    "ae305cb0315bb1325ab3325ab43359b63458b73557b93556ba3655bc3754bd3853bf3952"
    "c03a51c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446"
    "d04545d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238"
    "df5337e05536e15635e25734e35933e45a31e55c30e65d2fe75e2ee8602de9612bea632a"
    "eb6429eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711ff1731df2741cf3761b"
    "f37819f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0b"
    "f98c0af98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108"
    "fca309fca50afca60cfca80dfcaa0ffcac11fcae12fcb014fcb216fcb418fbb61afbb81d"
    "fbba1ffbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932f9cb35f8cd37f8cf3a"
    "f7d13df7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661"
    "f2e865f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992"
    "f6fa96f8fb9af9fc9dfafda1fcffa4ffffff"
)


def colormap_rgba8() -> np.ndarray:
    """(258, 4) uint8: [black, inferno-256, white], alpha 255 -- the
    viewer's default colormap, which the benchmark's ``init`` sends."""
    rgb = np.frombuffer(bytes.fromhex(_RGB_HEX), np.uint8).reshape(-1, 3)
    out = np.empty((rgb.shape[0], 4), np.uint8)
    out[:, :3] = rgb
    out[:, 3] = 255
    return out


def min_value(colormap_length: int) -> int:
    return max(int(np.floor(65535.0 / colormap_length + 0.5)), 1)


def halve_x_u16(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    half = w // 2
    out = np.empty((h, (w + 1) // 2), np.uint16)
    pairs = np.ascontiguousarray(img[:, : half * 2]).reshape(h, half, 2)
    acc = pairs[:, :, 0].astype(np.uint32)
    acc += pairs[:, :, 1]
    acc += 1
    out[:, :half] = acc >> 1
    if w % 2:
        out[:, -1] = img[:, -1]
    return out


def chain_len(width: int) -> int:
    n = 0
    while width > MIP_MIN_WIDTH:
        width = (width + 1) // 2
        n += 1
    return n


def tile_geometry(src_h: int, src_w: int, level_x: int, level_y: int, tile_x: int, tile_y: int):
    lod_w = -(-src_w // (1 << level_x))
    lod_h = -(-src_h // (1 << level_y))
    sx, sy = tile_x * TILE, tile_y * TILE
    core_w = min(max(lod_w - sx, 0), TILE)
    core_h = min(max(lod_h - sy, 0), TILE)
    ox, oy = max(sx - GUTTER, 0), max(sy - GUTTER, 0)
    if core_w == 0 or core_h == 0:
        return 0, 0, ox, oy, lod_w, lod_h
    return (min(lod_w, sx + core_w + GUTTER) - ox, min(lod_h, sy + core_h + GUTTER) - oy,
            ox, oy, lod_w, lod_h)


def _lut(colormap: np.ndarray) -> np.ndarray:
    n = colormap.shape[0]
    v = np.arange(65536, dtype=np.int64)
    idx = np.zeros(65536, np.int64) if n <= 1 else (v * (n - 1) + 32767) // 65535
    return np.ascontiguousarray(colormap[idx])


def spectrogram_tile(chain: list[np.ndarray], colormap: np.ndarray, level_x: int, level_y: int,
                     tile_x: int, tile_y: int) -> tuple[tuple, np.ndarray]:
    """((width, height, origin_x, origin_y), RGBA (height, width, 4) rows
    bottom-up) of a tile; ``chain`` = [full-res image, mip 1, mip 2, ...]."""
    img = chain[0]
    src_h, src_w = img.shape
    width, height, ox, oy, lod_w, lod_h = tile_geometry(src_h, src_w, level_x, level_y,
                                                        tile_x, tile_y)
    geo = (width, height, ox, oy)
    if width == 0 or height == 0:
        return geo, np.zeros((0, 0, 4), np.uint8)
    m = min(level_x, len(chain) - 1)
    src = chain[m]
    src_mw = -(-src_w // (1 << m))
    if m == level_x:
        src = np.ascontiguousarray(src[:, ox : ox + width])
        if level_y == 0:
            pixels = src[oy : oy + height]
            return geo, _lut(colormap)[pixels][::-1]
        left, right = 0.0, float(width)
    else:
        left = ox * src_mw / lod_w
        right = (ox + width) * src_mw / lod_w
    top = oy * src_h / lod_h
    bottom = (oy + height) * src_h / lod_h
    pixels = lanczos3_crop_resize_u16(src, (left, top, right, bottom), width, height)
    return geo, _lut(colormap)[pixels][::-1]


def decode_spectrogram_tile(data: bytes) -> tuple[tuple, np.ndarray]:
    """The port's tile bytes -> ((width, height, origin_x, origin_y), RGBA)."""
    _rev, w, h, _lx, _ly, _tx, _ty, ox, oy = struct.unpack_from("<QIIIIIIII", data, 0)
    rgba = np.frombuffer(data, np.uint8, count=w * h * 4, offset=40).reshape(h, w, 4)
    return (w, h, ox, oy), rgba


def waveform_tile(wav: np.ndarray, level: int, tile_index: int) -> np.ndarray:
    """(bins, 3) f64 (min, max, mean) of a waveform tile: min/max skip NaN,
    means accumulate in float64."""
    spb = 1 << level
    start = tile_index * WAVEFORM_BINS * spb
    end = min(len(wav), start + WAVEFORM_BINS * spb)
    if start >= end:
        return np.zeros((0, 3))
    seg = np.asarray(wav[start:end], np.float64)
    n_bins = -(-seg.shape[0] // spb)
    pad = n_bins * spb - seg.shape[0]
    full = np.concatenate([seg, np.full(pad, np.nan)]).reshape(n_bins, spb)
    counts = np.full(n_bins, spb, np.float64)
    counts[-1] = spb - pad
    out = np.empty((n_bins, 3))
    out[:, 0] = np.nanmin(full, axis=1)
    out[:, 1] = np.nanmax(full, axis=1)
    out[:, 2] = np.nansum(full, axis=1) / counts
    return out


def decode_waveform_tile(data: bytes) -> np.ndarray:
    _rev, bin_count, _spb, _ti, _ = struct.unpack_from("<QIIII", data, 0)
    return np.frombuffer(data, "<f4", count=bin_count * 3, offset=24).reshape(-1, 3)
