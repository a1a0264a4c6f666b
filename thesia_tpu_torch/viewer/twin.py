"""Host copy of ``thesia_tpu/viewer/twin.py``: the executed Python twins of
the port's viewer/js/axes.js, viewport.js and caches.js (the port imports
nothing of the JAX package; ``tests/test_torch_hostcopies.py`` pins the code
statement for statement, ``tests/test_torch_viewer_consistency.py`` parses
``thesia_tpu_torch/viewer/js/`` against it).

The original's notes follow.

Executed Python twins of the viewer's numeric logic (VERDICT r2 #8).

No JS runtime exists in the build image, so every formula and table the
viewer JS uses for numeric decisions is mirrored here and exercised by
tests; a consistency test additionally parses the JS sources and asserts
the table literals and constants match, so the twin and the JS cannot
drift apart.

Sources mirrored:
  * tick scale tables + lookup — viewer/js/axes.js, values from
    reference src/prototypes/constants/tracks.ts:47-175 and lookup from
    src/hooks/useAxisMarkers.ts getTickScale (boundaries DESC, first
    boundary <= value).
  * LOD selection — viewer/js/viewport.js specLevels/waveLevel
    (reference: src/modules/AudioTrackViewport.tsx:385-476,
    src/lib/waveform-renderer.ts:44-50).
  * waveform crossfade weights — viewer/js/viewport.js (reference:
    AudioTrackViewport.tsx:30-35,642-684; 200 ms equal-power).
  * byte-budgeted LRU cache — viewer/js/caches.js LruByteCache
    (reference: src/lib/audio-render-tiles.ts:25-152).
"""

from __future__ import annotations

import math

TIME_TICK_SIZE = [
    (309128, 0.0001, 10), (234256, 0.0002, 5), (159384, 0.0005, 2),
    (84512.5, 0.001, 1), (44960.7, 0.001, 2), (16902.5, 0.001, 5),
    (7635.0, 0.002, 5), (4061.0, 0.01, 2), (1527.0, 0.01, 5),
    (681.875, 0.02, 5), (362.757, 0.1, 2), (136.375, 0.1, 5),
    (57.0, 0.2, 5), (30.324, 1, 2), (11.4, 1, 5), (5.7, 2, 5),
    (3.0324, 10, 2), (2.28, 10, 3), (0.73325, 10, 6), (0.32507, 60, 2),
    (0.12221, 60, 5), (0.0611, 120, 5), (0.03251, 600, 2),
    (0.02444, 600, 3), (0.00544, 600, 6), (0.00241, 3600, 2),
    (0.00091, 3600, 5),
]

AMP_TICK_NUM = [
    (3500, 203, 203), (2000, 101, 101), (1210, 65, 65), (1185, 63, 63),
    (1165, 61, 61), (1070, 59, 59), (1035, 57, 57), (995, 55, 55),
    (985, 53, 53), (940, 51, 51), (920, 49, 49), (835, 47, 47),
    (790, 45, 45), (765, 43, 43), (740, 41, 41), (660, 39, 39),
    (635, 37, 37), (610, 35, 35), (590, 33, 33), (560, 31, 31),
    (530, 29, 29), (505, 27, 27), (495, 25, 25), (480, 25, 25),
    (405, 23, 23), (340, 21, 21), (320, 19, 19), (305, 17, 17),
    (300, 15, 15), (230, 13, 13), (80, 5, 5),
]

FREQ_TICK_NUM = [
    (1500, 100, 60), (1000, 60, 40), (850, 50, 30), (700, 40, 25),
    (600, 30, 20), (500, 28, 18), (450, 25, 16), (400, 22, 14),
    (360, 18, 12), (320, 15, 10), (280, 14, 9), (240, 12, 8),
    (200, 11, 7), (150, 10, 6), (120, 9, 5), (100, 6, 4),
    (90, 6, 3), (80, 4, 2),
]

DB_TICK_NUM = [
    (1000, 60, 60), (520, 25, 25), (250, 13, 13), (120, 6, 6), (80, 4, 4),
]

MAX_PX_PER_SEC = 384000  # reference: constants/tracks.ts:189
CROSSFADE_MS = 200
SPEC_TILE_CACHE_BYTES = 128 * 1024 * 1024
WAVE_TILE_CACHE_BYTES = 32 * 1024 * 1024


def tick_scale(table, value):
    """First DESC boundary <= value -> (a, b); None below the smallest."""
    for boundary, a, b in table:
        if value >= boundary:
            return (a, b)
    return None


def spec_levels(spectrogram_width, track_sec, spectrogram_height,
                px_per_sec, view_h, rows_visible_frac=1.0):
    """viewport.js specLevels: (level_x, level_y)."""
    base_px_per_sec = spectrogram_width / track_sec
    level_x = max(0, math.floor(math.log2(base_px_per_sec / px_per_sec)))
    visible_rows = max(spectrogram_height * rows_visible_frac, 1)
    # floor like the reference's log2Level (AudioTrackViewport.tsx:91)
    level_y = max(0, math.floor(math.log2(max(visible_rows / max(view_h, 1), 1))))
    return level_x, level_y


def wave_level(sample_rate, px_per_sec, dpr):
    """viewport.js waveLevel (reference waveform-renderer.ts:44-50)."""
    samples_per_px = sample_rate / (px_per_sec * dpr)
    if px_per_sec * 2 * dpr >= sample_rate / 2:
        return 0
    if samples_per_px <= 2:
        return 0
    return max(0, math.ceil(math.log2(samples_per_px)))


def spec_key(id_ch_str, spectrogram_revision, lx, ly, tx, ty):
    """viewport.js _specKey — revision-scoped tile cache key (a wrong key
    serves stale tiles across settings changes)."""
    return f"{id_ch_str}:{spectrogram_revision}:{lx}:{ly}:{tx}:{ty}"


def wave_key(id_ch_str, waveform_revision, level, ti):
    """viewport.js _waveKey."""
    return f"{id_ch_str}:{waveform_revision}:{level}:{ti}"


def crossfade_weights(elapsed_ms):
    """Equal-power (old_alpha, new_alpha) at `elapsed_ms` into the fade;
    the fade ends at CROSSFADE_MS."""
    t = min(max(elapsed_ms / CROSSFADE_MS, 0.0), 1.0)
    return math.cos(t * math.pi / 2), math.sin(t * math.pi / 2)


class LruByteCache:
    """Python twin of caches.js LruByteCache (insert-order LRU with
    recency refresh on get; evicts oldest past the byte budget)."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.bytes = 0
        self.map: dict = {}

    def get(self, key):
        e = self.map.get(key)
        if e is None:
            return None
        self.map.pop(key)
        self.map[key] = e
        return e[0]

    def has(self, key) -> bool:
        return key in self.map

    def set(self, key, value, nbytes: int) -> None:
        prev = self.map.pop(key, None)
        if prev is not None:
            self.bytes -= prev[1]
        self.map[key] = (value, nbytes)
        self.bytes += nbytes
        self._evict()

    def delete(self, key) -> None:
        e = self.map.pop(key, None)
        if e is not None:
            self.bytes -= e[1]

    def retain(self, keep) -> None:
        for key in list(self.map):
            if not keep(key):
                self.delete(key)

    def clear(self) -> None:
        for key in list(self.map):
            self.delete(key)

    def _evict(self) -> None:
        for key in list(self.map):
            if self.bytes <= self.budget:
                break
            self.delete(key)

    def keys(self):
        return list(self.map)
