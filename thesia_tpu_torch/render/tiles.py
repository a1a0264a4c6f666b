"""Render-tile encoders + LRU tile cache — the viewer wire format.

Host copy of ``thesia_tpu/render/tiles.py`` (verbatim apart from the imports
of the port's own ``native`` copy); the port imports nothing of
the JAX package.  Pinned by ``tests/test_torch_images.py``.

Binary layouts are byte-identical to the reference (reference:
src-tauri/src/core/render_tiles.rs):

waveform tile (:232-259): header 24 B = u64 revision, u32 bin_count,
u32 samples_per_bin, u32 tile_index, u32 pad; then bin_count * 12 B of
(min, max, mean) f32 LE.  A tile at `level` covers 1024 * 2^level samples.

spectrogram tile (:281-352): header 40 B = u64 revision + u32 {width, height,
level_x, level_y, tile_x, tile_y, origin_x, origin_y}; then RGBA8 rows
emitted bottom-up (high frequencies first).  Tile = 512x512 core + 4 px
gutter on interior edges, Lanczos3 crop-resized from the full-res u16 image,
then mapped through the colormap LUT with index
(v * (n_colors-1) + 32767) // 65535.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

from .resize import lanczos3_crop_resize_u16

WAVEFORM_TILE_BINS = 1024
SPECTROGRAM_TILE_SIZE = 512
SPECTROGRAM_TILE_GUTTER = 4
DEFAULT_WAVEFORM_CACHE_BUDGET_BYTES = 32 * 1024 * 1024


def waveform_bin_stats(wav: np.ndarray, start: int, end: int, spb: int):
    """Vectorized per-bin (min, max, mean) over [start, end) with bin size
    spb; the trailing partial bin is computed directly (padding it to spb
    allocated up to 4*spb bytes — 32 GB at coarse LODs — review finding).
    Means accumulate in f64 like the native path; min/max skip NaNs like
    the native comparison loop.  reference: render_tiles.rs:249-279 (which
    sums in f32 — the f64 accumulation is a deliberate accuracy upgrade,
    <=1 f32 ulp apart)."""
    seg = np.asarray(wav[start:end], np.float32)
    n = seg.shape[0]
    n_bins = -(-n // spb)
    full = n // spb
    mins = np.empty(n_bins, np.float32)
    maxs = np.empty(n_bins, np.float32)
    means = np.empty(n_bins, np.float64)
    if full:
        m = seg[: full * spb].reshape(full, spb)
        # NaN samples are SKIPPED with inf/-inf inits (native std::min/max
        # and the reference's f32::min/max both ignore NaN), so an all-NaN
        # bin yields (inf, -inf) — np.nanmin would yield NaN and make the
        # tile bytes differ between the native and fallback paths
        nan = np.isnan(m)
        mins[:full] = np.min(np.where(nan, np.float32(np.inf), m), axis=1)
        maxs[:full] = np.max(np.where(nan, np.float32(-np.inf), m), axis=1)
        means[:full] = m.sum(axis=1, dtype=np.float64) / spb
    if n_bins > full:
        tail = seg[full * spb :]
        nan = np.isnan(tail)
        mins[full] = np.min(np.where(nan, np.float32(np.inf), tail))
        maxs[full] = np.max(np.where(nan, np.float32(-np.inf), tail))
        means[full] = tail.sum(dtype=np.float64) / tail.shape[0]
    return mins, maxs, means


def encode_waveform_tile(wav: np.ndarray, revision: int, level: int, tile_index: int) -> bytes:
    """reference: render_tiles.rs:232-259."""
    spb = 1 << level if level < 63 else 2**63
    tile_samples = WAVEFORM_TILE_BINS * spb
    start = tile_index * tile_samples
    end = min(len(wav), start + tile_samples)
    bin_count = 0 if start >= end else -(-(end - start) // spb)

    header = struct.pack(
        "<QIIII", revision, bin_count, min(spb, 0xFFFFFFFF), tile_index, 0
    )
    if bin_count == 0:
        return header

    from .. import native

    if native.available():
        body = native.waveform_bin_stats(
            np.ascontiguousarray(wav, np.float32), start, end, spb, bin_count
        ).astype("<f4")
        return header + body.tobytes()

    mins, maxs, means = waveform_bin_stats(wav, start, end, spb)
    body = np.empty((bin_count, 3), "<f4")
    body[:, 0] = mins
    body[:, 1] = maxs
    body[:, 2] = means
    return header + body.tobytes()


def spectrogram_tile_geometry(
    src_h: int, src_w: int, level_x: int, level_y: int, tile_x: int, tile_y: int
) -> dict:
    """Tile geometry in LOD coordinates for a full-res (src_h, src_w) image.
    reference: render_tiles.rs:281-352 (core + interior gutters)."""
    scale_x = 1 << level_x
    scale_y = 1 << level_y
    lod_width = -(-src_w // scale_x)
    lod_height = -(-src_h // scale_y)
    start_x = tile_x * SPECTROGRAM_TILE_SIZE
    start_y = tile_y * SPECTROGRAM_TILE_SIZE
    core_w = min(max(lod_width - start_x, 0), SPECTROGRAM_TILE_SIZE)
    core_h = min(max(lod_height - start_y, 0), SPECTROGRAM_TILE_SIZE)
    origin_x = max(start_x - SPECTROGRAM_TILE_GUTTER, 0)
    origin_y = max(start_y - SPECTROGRAM_TILE_GUTTER, 0)
    if core_w == 0 or core_h == 0:
        width = height = 0
    else:
        width = min(lod_width, start_x + core_w + SPECTROGRAM_TILE_GUTTER) - origin_x
        height = min(lod_height, start_y + core_h + SPECTROGRAM_TILE_GUTTER) - origin_y
    return {
        "width": width,
        "height": height,
        "origin_x": origin_x,
        "origin_y": origin_y,
        "lod_width": lod_width,
        "lod_height": lod_height,
    }


def spectrogram_tile_source_cols(
    src_w: int, level_x: int, tile_x: int, mip_level: int, src_h: int = 1,
    level_y: int = 0, tile_y: int = 0,
) -> tuple[int, int] | None:
    """Column range [x0, x1) of the level-`mip_level` source that fully
    covers a tile's Lanczos3 taps (support 3 * scale around each center, so
    a source cropped to this range encodes byte-identically to the full
    image).  None for an empty tile.  Coordinates are in mip-level space
    (mip m width == ceil(src_w / 2^m))."""
    g = spectrogram_tile_geometry(src_h, src_w, level_x, level_y, tile_x, tile_y)
    if g["width"] == 0:
        return None
    mw = -(-src_w // (1 << mip_level))
    left = g["origin_x"] * mw / g["lod_width"]
    right = (g["origin_x"] + g["width"]) * mw / g["lod_width"]
    scale = max((right - left) / g["width"], 1.0)
    margin = int(np.ceil(3.0 * scale)) + 2
    x0 = max(int(np.floor(left)) - margin, 0)
    x1 = min(int(np.ceil(right)) + margin, mw)
    return x0, x1


def spectrogram_tile_header(
    revision: int, src_h: int, src_w: int,
    level_x: int, level_y: int, tile_x: int, tile_y: int,
) -> bytes:
    """40 B header for a tile of a full-res (src_h, src_w) image."""
    g = spectrogram_tile_geometry(src_h, src_w, level_x, level_y, tile_x, tile_y)
    return struct.pack(
        "<QIIIIIIII",
        revision,
        g["width"],
        g["height"],
        level_x,
        level_y,
        tile_x,
        tile_y,
        g["origin_x"],
        g["origin_y"],
    )


def encode_spectrogram_tile(
    spectrogram: np.ndarray,
    colormap_rgba: np.ndarray,
    revision: int,
    level_x: int,
    level_y: int,
    tile_x: int,
    tile_y: int,
) -> bytes:
    """spectrogram: (H, W) u16 full-res image (optionally a SpecImage
    carrying an X mip chain). reference: render_tiles.rs:281-352."""
    src_h, src_w = spectrogram.shape
    g = spectrogram_tile_geometry(src_h, src_w, level_x, level_y, tile_x, tile_y)
    width, height = g["width"], g["height"]
    origin_x, origin_y = g["origin_x"], g["origin_y"]
    lod_width, lod_height = g["lod_width"], g["lod_height"]

    header = spectrogram_tile_header(
        revision, src_h, src_w, level_x, level_y, tile_x, tile_y
    )
    if width == 0 or height == 0:
        return header

    # coarse LODs read from the X mip chain instead of the full-res image
    # (render/mips.py); mip level m has width == ceil(src_w / 2^m), so the
    # same fractional-crop mapping applies with src_w -> mip width.
    src = spectrogram
    m = 0
    if level_x >= 1 and hasattr(spectrogram, "mip_for_level"):
        src, m = spectrogram.mip_for_level(level_x)
    return header + encode_tile_body_from_source(
        np.asarray(src), m, 0, src_w, colormap_rgba,
        level_x, level_y, width, height, origin_x, origin_y, lod_width, lod_height,
    )


def encode_tile_body_from_source(
    src: np.ndarray,
    mip_level: int,
    src_x0: int,
    full_src_w: int,
    colormap_rgba: np.ndarray,
    level_x: int,
    level_y: int,
    width: int,
    height: int,
    origin_x: int,
    origin_y: int,
    lod_width: int,
    lod_height: int,
) -> bytes:
    """RGBA body of a tile from a (possibly partial, possibly mip-level)
    source.  `src` holds columns [src_x0, src_x0 + src.shape[1]) of the
    level-`mip_level` image (all rows); the caller guarantees the Lanczos3
    support window fits (spectrogram_tile_source_cols).  Border-clamp
    renormalization only engages at true image borders, so a sufficiently
    wide partial source is byte-identical to the full one."""
    src_h = src.shape[0]
    src_mw = -(-full_src_w // (1 << mip_level))

    if mip_level == level_x:
        # X axis is identity at the matching chain entry: crop columns first
        # so the residual (Y-only) resize reads a tile-sized window
        src = np.ascontiguousarray(src[:, origin_x - src_x0 : origin_x - src_x0 + width])
        if level_y == 0:
            # full identity: pure crop + colormap LUT
            lod_pixels = src[origin_y : origin_y + height]
            return _colormap_rows_bottom_up(lod_pixels, colormap_rgba)
        left, right = 0.0, float(width)
    else:
        left = origin_x * src_mw / lod_width - src_x0
        right = (origin_x + width) * src_mw / lod_width - src_x0
    top = origin_y * src_h / lod_height
    bottom = (origin_y + height) * src_h / lod_height

    from .. import native

    if native.available():
        rgba_bytes = native.spectrogram_tile_rgba(
            np.asarray(src), (left, top, right, bottom), width, height,
            np.ascontiguousarray(colormap_rgba),
        )
        return rgba_bytes.tobytes()

    lod_pixels = lanczos3_crop_resize_u16(
        np.asarray(src), (left, top, right, bottom), width, height
    )
    return _colormap_rows_bottom_up(lod_pixels, colormap_rgba)


_U16_LUT_CACHE: dict[tuple, np.ndarray] = {}


def _u16_rgba_lut(colormap_rgba: np.ndarray) -> np.ndarray:
    """(65536, 4) u8 lookup folding the index math of render_tiles.rs:345
    ((v*(n-1)+32767)/65535) into one gather; cached per colormap content."""
    key = (colormap_rgba.shape[0], hash(colormap_rgba.tobytes()))
    lut = _U16_LUT_CACHE.get(key)
    if lut is None:
        n_colors = colormap_rgba.shape[0]
        v = np.arange(65536, dtype=np.int64)
        idx = (
            np.zeros(65536, np.int64)
            if n_colors <= 1
            else (v * (n_colors - 1) + 32767) // 65535
        )
        lut = np.ascontiguousarray(colormap_rgba[idx])
        if len(_U16_LUT_CACHE) > 4:
            _U16_LUT_CACHE.clear()
        _U16_LUT_CACHE[key] = lut
    return lut


def _colormap_rows_bottom_up(lod_pixels: np.ndarray, colormap_rgba: np.ndarray) -> bytes:
    """u16 LOD pixels -> RGBA bytes, rows bottom-up (high freq first)."""
    from .. import native

    lut = _u16_rgba_lut(colormap_rgba)
    if native.available():
        return native.u16_rgba_rows_bottom_up(lod_pixels, lut).tobytes()
    rgba = lut[lod_pixels]  # (h, w, 4)
    return rgba[::-1].tobytes()


def decode_waveform_tile(data: bytes):
    """Client-side decode (tests + viewer): returns dict with header + bins."""
    revision, bin_count, spb, tile_index, _ = struct.unpack_from("<QIIII", data, 0)
    bins = np.frombuffer(data, "<f4", count=bin_count * 3, offset=24).reshape(-1, 3)
    return {
        "revision": revision,
        "binCount": bin_count,
        "samplesPerBin": spb,
        "tileIndex": tile_index,
        "bins": bins,
    }


def decode_spectrogram_tile(data: bytes):
    (revision, w, h, lx, ly, tx, ty, ox, oy) = struct.unpack_from("<QIIIIIIII", data, 0)
    rgba = np.frombuffer(data, np.uint8, count=w * h * 4, offset=40).reshape(h, w, 4)
    return {
        "revision": revision,
        "width": w,
        "height": h,
        "levelX": lx,
        "levelY": ly,
        "tileX": tx,
        "tileY": ty,
        "originX": ox,
        "originY": oy,
        "rgba": rgba,
    }


class RenderTileCache:
    """Byte-budgeted LRU of encoded waveform tiles + revision counters.

    Waveform tiles are cached server-side; spectrogram tiles are encoded per
    request (the client GPU cache holds them).  reference:
    render_tiles.rs:51-230.
    """

    def __init__(self, budget_bytes: int = DEFAULT_WAVEFORM_CACHE_BUDGET_BYTES):
        self._entries: dict[tuple, tuple[bytes, int]] = {}
        self._bytes = 0
        self._budget = budget_bytes
        self._tick = 0
        self.waveform_revision = 1
        self.spectrogram_revision = 1
        self.colormap_rgba = np.array(
            [[0, 0, 0, 255], [255, 255, 255, 255]], np.uint8
        )
        self._lock = threading.Lock()

    def set_colormap(self, colormap_rgba: np.ndarray) -> None:
        colormap_rgba = np.asarray(colormap_rgba, np.uint8)
        if colormap_rgba.ndim == 1:
            colormap_rgba = colormap_rgba.reshape(-1, 4)
        if colormap_rgba.shape[0] >= 1 and colormap_rgba.shape[1] == 4:
            self.colormap_rgba = colormap_rgba
        self.invalidate_spectrogram()

    def invalidate_waveform(self) -> None:
        with self._lock:
            self.waveform_revision = max((self.waveform_revision + 1) & 0xFFFFFFFFFFFFFFFF, 1)
            self._entries.clear()
            self._bytes = 0

    def invalidate_spectrogram(self) -> None:
        self.spectrogram_revision = max((self.spectrogram_revision + 1) & 0xFFFFFFFFFFFFFFFF, 1)

    def invalidate_all(self) -> None:
        self.invalidate_waveform()
        self.invalidate_spectrogram()

    def metadata(
        self,
        sample_count: int,
        sample_rate: int,
        track_sec: float,
        is_clipped: bool,
        spectrogram_shape: tuple[int, int] | None,
    ) -> dict:
        """reference: render_tiles.rs:101-122. Shape is (H, W)."""
        h, w = spectrogram_shape if spectrogram_shape else (0, 0)
        return {
            "waveformRevision": self.waveform_revision,
            "spectrogramRevision": self.spectrogram_revision,
            "sampleRate": sample_rate,
            "sampleCount": sample_count,
            "trackSec": track_sec,
            "isClipped": is_clipped,
            "spectrogramWidth": w,
            "spectrogramHeight": h,
            "waveformTileBins": WAVEFORM_TILE_BINS,
            "spectrogramTileSize": SPECTROGRAM_TILE_SIZE,
        }

    def cached_waveform_tile(self, track_id: int, ch: int, level: int, tile_index: int):
        with self._lock:
            revision = self.waveform_revision
            key = (track_id, ch, revision, level, tile_index)
            entry = self._entries.get(key)
            if entry is None:
                return revision, None
            self._tick += 1
            self._entries[key] = (entry[0], self._tick)
            return revision, entry[0]

    def store_waveform_tile(
        self, track_id: int, ch: int, revision: int, level: int, tile_index: int, data: bytes
    ) -> None:
        with self._lock:
            if revision != self.waveform_revision:
                return
            key = (track_id, ch, revision, level, tile_index)
            old = self._entries.get(key)
            if old is not None:
                self._bytes -= len(old[0])
            self._tick += 1
            self._entries[key] = (data, self._tick)
            self._bytes += len(data)
            while self._bytes > self._budget and self._entries:
                lru_key = min(self._entries, key=lambda k: self._entries[k][1])
                self._bytes -= len(self._entries.pop(lru_key)[0])

    def spectrogram_tile(
        self, spectrogram: np.ndarray, level_x: int, level_y: int, tile_x: int, tile_y: int
    ) -> bytes:
        return encode_spectrogram_tile(
            spectrogram,
            self.colormap_rgba,
            self.spectrogram_revision,
            level_x,
            level_y,
            tile_x,
            tile_y,
        )

    @property
    def entry_count(self) -> int:
        return len(self._entries)

    @property
    def cached_bytes(self) -> int:
        return self._bytes
