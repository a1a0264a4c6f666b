"""X-axis mip chain for spectrogram u16 images.

Host copy of ``thesia_tpu/render/mips.py`` (verbatim apart from the import of
the port's own ``native`` copy); the port imports nothing of
the JAX package.  Pinned by ``tests/test_torch_images.py``.

The reference encodes every spectrogram tile by Lanczos3-resizing a crop of
the FULL-RES u16 image (reference: src-tauri/src/core/render_tiles.rs:281-393
— `resize_spectrogram_tile` maps LOD coords back to full-res source).  At
coarse LODs on long tracks that crop is enormous (levelX=9 reads 512*2^9
source columns per tile; measured 479 ms on a 1-hour track), so the rebuild
precomputes a chain of 2x box-halved images along the time axis and encodes
tiles from the nearest chain entry instead.

Only the time (width) axis gets a chain: spectrogram heights are a few
hundred to a few thousand rows (n_mel or n_fft/2+1) and the viewer's levelY
stays small, so the Y-axis residual resize from full height is cheap.

Halving uses ceil semantics — ceil(ceil(w/2)/2) == ceil(w/4), so chain entry
k has exactly the encoder's LOD width ceil(W/2^k) and a tile at levelX==k
becomes a pure crop + colormap lookup (the Lanczos3 kernel at scale 1 with
integral offsets is the identity).  Averaging rounds half-up ((a+b+1)>>1);
an odd trailing column is copied through.
"""

from __future__ import annotations

import threading

import numpy as np

# stop the chain once the image fits a couple of tiles; deeper LODs resize
# from the last entry (tiny) with the ordinary fractional-crop Lanczos3
MIP_MIN_WIDTH = 1024


def halve_x_u16(img: np.ndarray) -> np.ndarray:
    """(H, W) u16 -> (H, ceil(W/2)) u16 by pairwise round-half-up average."""
    from .. import native

    if native.available():
        return native.halve_x_u16(np.asarray(img))
    h, w = img.shape
    half = w // 2
    out = np.empty((h, (w + 1) // 2), np.uint16)
    # contiguous (h, half, 2) view keeps the reads streaming (a strided
    # even/odd slice of a wide image is ~30x slower)
    pairs = np.ascontiguousarray(img[:, : half * 2]).reshape(h, half, 2)
    acc = pairs[:, :, 0].astype(np.uint32)
    acc += pairs[:, :, 1]
    acc += 1
    out[:, :half] = acc >> 1
    if w % 2:
        out[:, -1] = img[:, -1]
    return out


def chain_len(width: int, min_width: int = MIP_MIN_WIDTH) -> int:
    """Number of chain entries build_mip_chain produces for a given width."""
    n = 0
    while width > min_width:
        width = (width + 1) // 2
        n += 1
    return n


def build_mip_chain(img: np.ndarray, min_width: int = MIP_MIN_WIDTH) -> list[np.ndarray]:
    """[level1, level2, ...] box-halved copies; empty for narrow images."""
    chain: list[np.ndarray] = []
    cur = np.asarray(img)
    while cur.shape[1] > min_width:
        cur = halve_x_u16(cur)
        chain.append(cur)
    return chain


class SpecImage(np.ndarray):
    """Full-res u16 spectrogram image + lazily built X mip chain.

    An ndarray subclass so every existing consumer (metadata shape, golden
    hashes, device-parity asserts) sees the plain image; the tile encoder
    asks for `mip_for_level` to read a small source window at coarse LODs.
    """

    def __new__(cls, arr, mips: list[np.ndarray] | None = None):
        obj = np.ascontiguousarray(arr, dtype=np.uint16).view(cls)
        obj._mips = mips
        obj._mip_lock = threading.Lock()
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        # views/slices don't inherit the chain (their geometry differs)
        self._mips = None
        self._mip_lock = threading.Lock()

    def mips(self) -> list[np.ndarray]:
        if self._mips is None:
            with self._mip_lock:
                if self._mips is None:
                    self._mips = build_mip_chain(self)
        return self._mips

    def mip_for_level(self, level_x: int) -> tuple[np.ndarray, int]:
        """Deepest chain entry usable for an X LOD: (source, mip_level)."""
        if level_x <= 0:
            return np.asarray(self), 0
        chain = self.mips()
        m = min(level_x, len(chain))
        if m == 0:
            return np.asarray(self), 0
        return chain[m - 1], m

    def mip_bytes(self) -> int:
        """Bytes held by the built chain (0 until first coarse request)."""
        chain = self._mips
        return sum(a.nbytes for a in chain) if chain else 0
