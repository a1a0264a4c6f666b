"""TrackManager: orchestrates spectrogram compute and u16 image quantization.

Port of the synchronous paths of ``thesia_tpu/engine/manager.py``
(``_global_range_device``, ``add_tracks``, ``reload_tracks``,
``remove_tracks``, the synchronous ``apply_track_list_changes``,
``set_setting``, ``set_db_range``, ``update_all_specs_imgs``,
``_update_specs_inner``, ``_spec_source``, ``_ensure_spec``,
``_dispatch_quantize``).  The deferred apply, the range reconcile and the
shape warmer are not ported.

Every spectrogram reads its samples through ``_spec_source``: while guard
clipping was a no-op, the original samples (uploaded once, keyed by the
original's version) with the normalize gain applied per row inside the
kernel, so a normalize change never re-uploads; otherwise the post-guard
samples.

Global dB range (reference: src-tauri/src/core/mod.rs:31-231): max_dB =
min(global max over all specs, 0); min_dB = max(global min, max_dB -
dB_range).  When the range, max_sr or the settings change, every image is
requantized; otherwise only freshly added tracks.  The range arithmetic
follows the JAX package exactly: on the force paths it stays on the device
in f32 (span = gmax - gmin in f32); on the incremental host path gmin uses the
f32 subtraction gmax - dB_range and the quantize span is the f64 difference
cast to f32.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..dsp.framing import SpecSetting
from ..dsp.spectrogram import SpecResult, SpectrogramAnalyzer
from ..obs import span
from ..render.colormap import quantize_min_value
from ..runtime import resolve_device
from .images import SpecImageStore, TrackImages, _quantize_and_mips, land_u16, mip_plan
from .track import TrackList

IdCh = tuple[int, int]


def _global_range_device(bounds, db_range: float):
    """bounds: [(row_min, row_max)] per-track device tensors -> (gmin, gmax,
    span) f32 device scalars (mod.rs:168-230)."""
    mins = torch.cat([b[0] for b in bounds]).amin()
    maxs = torch.cat([b[1] for b in bounds]).amax()
    gmax = torch.minimum(maxs, torch.zeros_like(maxs))
    gmin = torch.maximum(mins, gmax - torch.tensor(db_range, dtype=torch.float32, device=gmax.device))
    return gmin, gmax, gmax - gmin


class TrackManager:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # global dB range: host floats once known, or device scalars from
        # _global_range_device (read lazily)
        self._range_host: tuple[float, float] | None = (math.inf, -math.inf)
        self._range_dev = None  # (gmin, gmax, span) f32 device scalars
        self.max_sr = 0
        self.setting = SpecSetting()
        self.db_range = 100.0
        self.colormap_length = 258
        self.spec_analyzer = SpectrogramAnalyzer(self.device)
        # per-track SpecResult (device-resident), LRU-evicted under a byte
        # budget with recompute-on-miss from the cached device wavs
        self.specs: dict[int, SpecResult] = {}
        self._spec_budget = int(os.environ.get("THESIA_SPEC_CACHE_BYTES", 6 * 1024**3))
        # per-track (row_min, row_max) device tensors; they outlive spec eviction
        self._spec_bounds: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.images = SpecImageStore()
        self._no_spec_img_ids: set[int] = set()

    # -- global dB range ---------------------------------------------------
    def _sync_range(self) -> tuple[float, float]:
        if self._range_host is None:
            gmin, gmax, _ = self._range_dev
            self._range_host = (float(gmin), float(gmax))
        return self._range_host

    @property
    def min_db(self) -> float:
        return self._sync_range()[0]

    @property
    def max_db(self) -> float:
        return self._sync_range()[1]

    def _quant_scalars(self):
        """(lo, span) f32 device scalars for the quantize pass."""
        if self._range_dev is not None:
            gmin, _gmax, span_ = self._range_dev
            return gmin, span_
        lo, hi = self._range_host
        f32 = lambda v: torch.tensor(np.float32(v), device=self.device)  # noqa: E731
        return f32(lo), f32(hi - lo)

    @property
    def spec_imgs(self):
        """Host view of every image (test surface)."""
        return self.images.completed_images()

    # -- lifecycle ---------------------------------------------------------
    def add_tracks(self, tracklist: TrackList, added_ids: list[int]) -> None:
        params = tracklist.construct_sr_win_nfft_set(added_ids, self.setting)
        self._update_specs(tracklist, tracklist.id_ch_tuples_from(added_ids), params)
        self._no_spec_img_ids.update(added_ids)

    def reload_tracks(self, tracklist: TrackList, reloaded_ids: list[int]) -> None:
        self.add_tracks(tracklist, reloaded_ids)

    def remove_tracks(self, tracklist: TrackList, removed_id_ch: list[IdCh]) -> None:
        for tid in dict.fromkeys(t for t, _ch in removed_id_ch):
            self.images.remove(tid)
            self.specs.pop(tid, None)
            self._spec_bounds.pop(tid, None)
            self.spec_analyzer.drop_wav(tid)
        self.spec_analyzer.retain(
            tracklist.construct_all_sr_win_nfft_set(self.setting), self.setting.freq_scale
        )

    def apply_track_list_changes(self, tracklist: TrackList) -> tuple[set[int], int]:
        updated = self._update_spec_imgs(tracklist, force_update_all=False)
        return updated, self.max_sr

    def set_setting(self, tracklist: TrackList, setting: SpecSetting) -> None:
        params = tracklist.construct_sr_win_nfft_set(tracklist.all_ids(), setting)
        old = self.setting
        self.setting = setting
        try:
            self.spec_analyzer.retain(params, setting.freq_scale)
            self._update_specs(tracklist, tracklist.id_ch_tuples(), params)
            self._update_spec_imgs(tracklist, force_update_all=True)
        except Exception:
            # a failed switch must not leave self.setting claiming a setting
            # the specs and images do not hold: restore, recompute, re-raise
            self.setting = old
            old_params = tracklist.construct_sr_win_nfft_set(tracklist.all_ids(), old)
            self.spec_analyzer.retain(old_params, old.freq_scale)
            self._update_specs(tracklist, tracklist.id_ch_tuples(), old_params)
            self._update_spec_imgs(tracklist, force_update_all=True)
            raise

    def update_all_specs_imgs(self, tracklist: TrackList) -> None:
        """Recompute every spectrogram and requantize every image (after a
        normalize or guard-clipping change)."""
        self._update_specs(tracklist, tracklist.id_ch_tuples(), None)
        self._update_spec_imgs(tracklist, force_update_all=True)

    def set_db_range(self, tracklist: TrackList, db_range: float) -> None:
        self.db_range = db_range
        self._update_spec_imgs(tracklist, force_update_all=True)

    def set_colormap_length(self, tracklist: TrackList, colormap_length: int) -> None:
        self.colormap_length = colormap_length
        self._update_spec_imgs(tracklist, force_update_all=True)

    # -- internals ---------------------------------------------------------
    def _update_specs(self, tracklist: TrackList, id_ch_tuples, params) -> None:
        """params None: the parameter sets of every track."""
        with span("spec.recompute"):
            if params is None:
                params = tracklist.construct_all_sr_win_nfft_set(self.setting)
            self.spec_analyzer.prepare(params, self.setting.freq_scale)
            track_ids = sorted({t for t, _ in id_ch_tuples})
            for tid in track_ids:
                self._spec_bounds.pop(tid, None)  # stale under the new spec
            items = []
            for tid in track_ids:
                wavs, token, gain = self._spec_source(tracklist[tid])
                items.append((tid, wavs, tracklist[tid].sr, token, gain))
            self.specs.update(self.spec_analyzer.calc_specs_batched(items, self.setting))

    def _update_spec_imgs(self, tracklist: TrackList, force_update_all: bool) -> set[int]:
        """reference: mod.rs:168-230."""
        with span("spec.quantize"):
            for tid, res in self.specs.items():
                if res.n_frames > 0:
                    self._spec_bounds[tid] = (res.row_min, res.row_max)
            max_sr = tracklist.max_sr()
            sr_changed = self.max_sr != max_sr
            self.max_sr = max_sr
            bounds = [
                self._spec_bounds[tid] for tid in tracklist.all_ids() if tid in self._spec_bounds
            ]
            if force_update_all or sr_changed:
                ids_need_update = set(tracklist.all_ids())
                self._no_spec_img_ids.clear()
                if bounds:
                    self._range_dev = _global_range_device(bounds, self.db_range)
                    self._range_host = None
                else:
                    self._range_dev = None
                    self._range_host = (math.inf, -math.inf)
            else:
                gmin, gmax = math.inf, -math.inf
                for row_min, row_max in bounds:
                    gmin = min(gmin, float(row_min.min()))
                    gmax = max(gmax, float(row_max.max()))
                gmax = min(gmax, 0.0)
                # f32 subtraction, like the reference's f32 math and the device path
                gmin = max(gmin, float(np.float32(gmax) - np.float32(self.db_range)))
                prev = self._sync_range()
                self._range_host = (gmin, gmax)
                self._range_dev = None
                if prev != (gmin, gmax):
                    ids_need_update = set(tracklist.all_ids())
                else:
                    ids_need_update = set(self._no_spec_img_ids)
                self._no_spec_img_ids.clear()

            lo, span_ = self._quant_scalars()
            for track_id in sorted(ids_need_update):
                res = self._ensure_spec(tracklist, track_id)
                if res is not None:
                    self._dispatch_quantize(tracklist, track_id, res, lo, span_)
            self._evict_specs()
            return ids_need_update

    def _ensure_spec(self, tracklist: TrackList, track_id: int) -> SpecResult | None:
        """Spec for a track, recomputed from the cached device wav if the
        budget evicted it; refreshes LRU recency."""
        res = self.specs.pop(track_id, None)
        if res is None:
            track = tracklist.get(track_id)
            if track is None:
                return None
            wavs, token, gain = self._spec_source(track)
            res = self.spec_analyzer.calc_spec_multi(
                wavs, track.sr, self.setting, cache_key=track_id, token=token, gain=gain,
            )
        self.specs[track_id] = res  # MRU
        return res

    @staticmethod
    def _spec_source(track):
        """(wavs, token, gain): the original samples and a scalar gain applied
        on the device while the guard was a no-op, so gain changes reuse the
        cached upload; the post-guard samples when the guard changed them.
        Every spectrogram sources through here, so the wav cache stays keyed
        on one token per track."""
        g = track.device_scalar_gain()
        if g is not None:
            return track.original.wavs, track.original.version, g
        return track.audio.wavs, track.audio.version, 1.0

    def _evict_specs(self) -> None:
        total = sum(r.db.numel() * 4 for r in self.specs.values())
        for tid in list(self.specs):
            if total <= self._spec_budget or len(self.specs) <= 1:
                break
            total -= self.specs.pop(tid).db.numel() * 4

    def _dispatch_quantize(self, tracklist: TrackList, track_id: int, res, lo, span_) -> None:
        """Quantize + device mip chain for one track, then land both on the
        host in one transfer."""
        track = tracklist.get(track_id)
        if track is None or res.n_frames == 0:
            return
        levels = tuple(mip_plan(res.n_frames))
        img, mips = self.quantize(track.sr, res.db, res.n_frames, lo, span_, levels)
        with span("spec.land"):
            host = land_u16([img, *mips])
        self.images.set_images(
            track_id,
            TrackImages(track_id, res.n_frames, img.shape[1], host[0], dict(zip(levels, host[1:]))),
        )

    def quantize(self, sr: int, db, n_frames: int, lo, span_, mip_levels=()):
        """A track's (C, T, F) dB -> (image (C, H, n_frames), [mips]) int32 on
        the device under the current settings, range and max_sr."""
        n_freq = db.shape[-1]
        # images are max_sr tall: rows above a lower-rate track's n_freq are 0
        i_start, i_end = self.setting.freq_scale.hz_range_to_idx(
            (0.0, self.max_sr / 2.0), sr, n_freq
        )
        return _quantize_and_mips(
            db, lo, span_, n_frames,
            i_start=i_start, n_rows=max(min(i_end, n_freq) - i_start, 0),
            height=i_end - i_start,
            min_value=quantize_min_value(self.colormap_length or None),
            mip_levels=mip_levels,
        )
