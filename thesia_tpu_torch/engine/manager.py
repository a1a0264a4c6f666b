"""TrackManager: orchestrates spectrogram compute and u16 image quantization.

Port of ``thesia_tpu/engine/manager.py``: ``_global_range_device``, the
lifecycle commands, the synchronous ``apply_track_list_changes`` and the
deferred one (``apply_track_list_changes_deferred``, whose probe closure the
session runs off the write lock, then ``reconcile_range`` or
``confirm_range_unmoved``) with the range epoch, ``_applied_range`` and
``_range_mixed`` bookkeeping, ``set_setting``, ``set_db_range``,
``update_all_specs_imgs``, ``_ensure_spec``, the image
reloader and ``_dispatch_quantize``, which returns at dispatch and hands the
device images to the store's streamer, and the shape warmer's hooks:
``shape_warmer`` (``dsp/precompile.py``), ``warm_for_pending_add``,
``_warm_neighbor_shapes`` after every add and settings change, and the
``interactive()`` blocks at the JAX package's places.

Every spectrogram reads its samples as the manager's device-sample store
(``samples``, ``engine/samples.py``) names them: while guard clipping was a
no-op, the original samples (uploaded once, keyed by the original's version)
with the normalize gain applied per row inside the kernel, so a normalize
change never re-uploads; otherwise the post-guard samples, which the device
route of the gain and guard (K10) leaves in the wav cache beside the original.

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
import threading

import numpy as np
import torch

from ..dsp import precompile
from ..dsp.framing import SpecSetting
from ..dsp.spectrogram import SpecResult, SpectrogramAnalyzer
from ..kernels import images as kimages
from ..obs import span
from ..parallel.sharding import active_spec_sharding
from ..render.colormap import quantize_min_value
from ..runtime import resolve_device
from .images import SpecImageStore, TrackImages, mip_plan
from .samples import DeviceSamples
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
        # the tracks' samples on the device, over the analyzer's wav cache
        self.samples = DeviceSamples(self.spec_analyzer)
        # per-track SpecResult (device-resident), LRU-evicted under a byte
        # budget with recompute-on-miss from the cached device wavs
        self.specs: dict[int, SpecResult] = {}
        self._spec_budget = int(os.environ.get("THESIA_SPEC_CACHE_BYTES", 6 * 1024**3))
        # per-track (row_min, row_max) device tensors; they outlive spec eviction
        self._spec_bounds: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # device images + background host streaming
        self.images = SpecImageStore()
        self.images.set_reloader(self._reload_track_images)
        self._reload_lock = threading.Lock()
        self._last_tracklist: TrackList | None = None
        self._spec_n_ch: dict[int, int] = {}
        self._no_spec_img_ids: set[int] = set()
        # bumped by every range-affecting image pass: a deferred apply's
        # reconcile only acts if no later pass superseded its range
        self._range_epoch = 0
        # the range the pre-existing images were last fully quantized under
        # (("host", (gmin, gmax)) or ("dev", (gmin, gmax) device scalars)): a
        # deferred apply's probe compares the new range against THIS, not
        # against the previous range value (two rapid applies would
        # otherwise compare R1 with R2 while the old images sit at R0)
        self._applied_range = ("host", (math.inf, -math.inf))
        # True while some image may sit at a range other than
        # _applied_range: a deferred apply quantizes its fresh rows under the
        # new, not yet applied, range; a later probe then must not trust
        # value equality with _applied_range alone
        self._range_mixed = False
        # background warm of the current and neighbouring settings
        self.shape_warmer = precompile.ShapeWarmer(self.device)

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

    @staticmethod
    def _fetch_range(kind_payload) -> tuple[float, float]:
        """(gmin, gmax) host floats from an _applied_range snapshot --
        blocking when the snapshot holds device scalars."""
        kind, payload = kind_payload
        if kind == "host":
            return payload
        gmin, gmax = payload
        return float(gmin), float(gmax)

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
        """Host view of every image (test surface); drains the streamer."""
        return self.images.completed_images()

    # -- lifecycle ---------------------------------------------------------
    def add_tracks(self, tracklist: TrackList, added_ids: list[int]) -> None:
        # the warmer got a header-probed head start during decode
        # (warm_for_pending_add); pause it for the add's own device compute
        with self.shape_warmer.interactive():
            params = tracklist.construct_sr_win_nfft_set(added_ids, self.setting)
            self._update_specs(tracklist, tracklist.id_ch_tuples_from(added_ids), params)
            self._no_spec_img_ids.update(added_ids)
        self._warm_neighbor_shapes(tracklist)

    def reload_tracks(self, tracklist: TrackList, reloaded_ids: list[int]) -> None:
        self.add_tracks(tracklist, reloaded_ids)

    def remove_tracks(self, tracklist: TrackList, removed_id_ch: list[IdCh]) -> None:
        for tid in dict.fromkeys(t for t, _ch in removed_id_ch):
            self.images.remove(tid)
            self.specs.pop(tid, None)
            self._spec_bounds.pop(tid, None)
            self._spec_n_ch.pop(tid, None)
            self.samples.drop(tid)
        self.spec_analyzer.retain(
            tracklist.construct_all_sr_win_nfft_set(self.setting), self.setting.freq_scale
        )

    def apply_track_list_changes(self, tracklist: TrackList) -> tuple[set[int], int]:
        with self.shape_warmer.interactive():
            updated = self._update_spec_imgs(tracklist, force_update_all=False)
        return updated, self.max_sr

    def apply_track_list_changes_deferred(self, tracklist: TrackList):
        """Apply that returns at dispatch even on the incremental path.

        The synchronous incremental apply compares the recomputed global
        range with the applied one on the host, which waits for the spec
        compute of whatever was just added.  Here the new global range is
        composed on the device, the fresh tracks are quantized under it at
        once, and the did-the-range-move probe is returned as a closure the
        session runs on its switch pool: only when it reports True does a
        follow-up write requantize the pre-existing tracks.

        Returns (updated_ids, max_sr, probe_info|None); probe_info is
        (probe_fn, range_epoch, fresh_ids), None when the pass took a
        force-style route that left nothing to reconcile."""
        with self.shape_warmer.interactive():
            updated, probe_info = self._update_spec_imgs(
                tracklist, force_update_all=False, defer_range_probe=True
            )
        return updated, self.max_sr, probe_info

    def reconcile_range(self, tracklist: TrackList, epoch: int, fresh_ids: set[int]) -> bool:
        """Requantize the pre-existing tracks under the range a deferred
        apply computed (its probe reported the range moved).  No-op (False)
        when a later range pass superseded the epoch: that pass already
        requantized everything under the then-current range."""
        if epoch != self._range_epoch:
            return False
        # rows that have no image yet (added after this apply's dispatch)
        # wait for their own apply
        ids = [
            t for t in tracklist.all_ids()
            if t not in fresh_ids and t not in self._no_spec_img_ids
        ]
        if not ids:
            # nothing pre-existing, but the fresh rows WERE quantized under
            # the current range at dispatch -- record that
            self._mark_range_applied()
            return False
        with self.shape_warmer.interactive(), span("spec.quantize"):
            with span("spec.quantize.range"):
                lo, span_ = self._quant_scalars()
            self._quantize_all(tracklist, ids, lo, span_)
            self._mark_range_applied()
        return True

    def _quantize_all(self, tracklist: TrackList, ids, lo, span_) -> None:
        """K6 on every track of ``ids`` that has a spectrogram, then the
        spectrogram budget's eviction."""
        with span("spec.quantize.k6"):
            for track_id in sorted(ids):
                res = self._ensure_spec(tracklist, track_id)
                if res is not None:
                    self._dispatch_quantize(tracklist, track_id, res, lo, span_)
        with span("spec.quantize.evict"):
            self._evict_specs()

    def confirm_range_unmoved(self, epoch: int) -> None:
        """The deferred apply's probe reported the range did not move: the
        fresh rows were quantized at the applied value, so all images are
        uniform again.  Runs on the write worker."""
        if epoch == self._range_epoch:
            self._mark_range_applied()

    def _mark_range_applied(self) -> None:
        """All live images now sit at the current range."""
        if self._range_dev is not None:
            self._applied_range = ("dev", (self._range_dev[0], self._range_dev[1]))
        else:
            self._applied_range = ("host", self._range_host)
        self._range_mixed = False

    def set_setting(self, tracklist: TrackList, setting: SpecSetting) -> None:
        params = tracklist.construct_sr_win_nfft_set(tracklist.all_ids(), setting)
        old = self.setting
        with self.shape_warmer.interactive():
            self.setting = setting
            try:
                self.spec_analyzer.retain(params, setting.freq_scale)
                self._update_specs(tracklist, tracklist.id_ch_tuples(), params)
                self._update_spec_imgs(tracklist, force_update_all=True)
            except Exception:
                # a failed switch must not leave self.setting claiming a
                # setting the specs and images do not hold: restore,
                # recompute, re-raise
                self.setting = old
                old_params = tracklist.construct_sr_win_nfft_set(tracklist.all_ids(), old)
                self.spec_analyzer.retain(old_params, old.freq_scale)
                self._update_specs(tracklist, tracklist.id_ch_tuples(), old_params)
                self._update_spec_imgs(tracklist, force_update_all=True)
                raise
        self._warm_neighbor_shapes(tracklist)

    def warm_for_pending_add(self, existing_items, probed_items) -> None:
        """Start warming before the add's decode finishes.

        existing_items: [(track_id, (n_ch, n), sr)], a snapshot of the
        tracklist that the session took under its read lock; probed_items:
        [(path, (n_ch, n_samples), sr)] read from the files' headers
        (io/probe.py).  Submits the current setting's job first (the
        spectrogram of the probed files, as the add will compute it), then
        the nearest-knob neighbours over all tracks (a settings change
        recomputes everything)."""
        if not precompile.enabled() or not probed_items:
            return
        probed = [(f"probe:{k}", shape, sr) for k, shape, sr in probed_items]
        items = list(existing_items) + probed
        an = self.spec_analyzer
        sh = active_spec_sharding()
        jobs = list(precompile.spec_jobs_for(an, probed, self.setting, sh))
        for s in precompile.neighbor_settings(self.setting):
            jobs.extend(precompile.spec_jobs_for(an, items, s, sh))
        self.shape_warmer.submit(precompile.handed(jobs))

    def _warm_neighbor_shapes(self, tracklist: TrackList) -> None:
        """Queue the warm of the settings one UI knob away (t_overlap
        detents, win presets, the other freq scale), so that a knob turned
        soon after finds its tables built."""
        if not precompile.enabled():
            return
        items = [
            (tid, tuple(tracklist[tid].audio.wavs.shape), tracklist[tid].sr)
            for tid in tracklist.all_ids()
        ]
        if not items:
            return
        sh = active_spec_sharding()
        jobs = []
        for s in precompile.neighbor_settings(self.setting):
            jobs.extend(precompile.spec_jobs_for(self.spec_analyzer, items, s, sh))
        self.shape_warmer.submit(precompile.handed(jobs))

    def update_all_specs_imgs(self, tracklist: TrackList) -> None:
        """Recompute every spectrogram and requantize every image (after a
        normalize or guard-clipping change)."""
        with self.shape_warmer.interactive():
            self._update_specs(tracklist, tracklist.id_ch_tuples(), None)
            self._update_spec_imgs(tracklist, force_update_all=True)

    def set_db_range(self, tracklist: TrackList, db_range: float) -> None:
        with self.shape_warmer.interactive():
            self.db_range = db_range
            self._update_spec_imgs(tracklist, force_update_all=True)

    def set_colormap_length(self, tracklist: TrackList, colormap_length: int) -> None:
        self.colormap_length = colormap_length
        self._update_spec_imgs(tracklist, force_update_all=True)

    def get_spectrogram(self, id_ch: IdCh) -> np.ndarray | None:
        """Host image, waiting for streaming to land (test surface; tile
        serving goes through self.images)."""
        self.images.drain()
        return self.images.host_image(*id_ch)

    # -- internals ---------------------------------------------------------
    def _update_specs(self, tracklist: TrackList, id_ch_tuples, params) -> None:
        """params None: the parameter sets of every track."""
        with span("spec.recompute"):
            self._last_tracklist = tracklist
            if params is None:
                params = tracklist.construct_all_sr_win_nfft_set(self.setting)
            self.spec_analyzer.prepare(params, self.setting.freq_scale)
            track_ids = sorted({t for t, _ in id_ch_tuples})
            for tid in track_ids:
                self._spec_bounds.pop(tid, None)  # stale under the new spec
            items, owner = [], {}
            for tid in track_ids:
                wavs, key, token, gain = self.samples.spec_item(tid, tracklist[tid])
                items.append((key, wavs, tracklist[tid].sr, token, gain))
                owner[key] = tid
            got = self.spec_analyzer.calc_specs_batched(items, self.setting)
            self.specs.update({owner[key]: res for key, res in got.items()})
            for tid in track_ids:
                self._spec_n_ch[tid] = tracklist[tid].n_ch

    def _update_spec_imgs(
        self, tracklist: TrackList, force_update_all: bool, defer_range_probe: bool = False
    ):
        """reference: mod.rs:168-230.

        Force-update paths (settings, dB range, colormap: everything
        requantizes anyway) compute the global range on the device and
        return at dispatch; the synchronous incremental path fetches the two
        scalars to the host for the comparison.  With defer_range_probe the
        incremental path also stays on the device and hands the comparison
        back as a closure; the return value is then (ids, probe_info|None)
        instead of the bare id set."""
        with span("spec.quantize"):
            self._range_epoch += 1
            self._last_tracklist = tracklist
            for tid, res in self.specs.items():
                if res.n_frames > 0:
                    self._spec_bounds[tid] = (res.row_min, res.row_max)
            max_sr = tracklist.max_sr()
            sr_changed = self.max_sr != max_sr
            self.max_sr = max_sr
            bounds = [
                self._spec_bounds[tid] for tid in tracklist.all_ids() if tid in self._spec_bounds
            ]
            probe_info = None
            with span("spec.quantize.range"):
                if force_update_all or sr_changed:
                    ids_need_update = set(tracklist.all_ids())
                    self._no_spec_img_ids.clear()
                    if bounds:
                        self._range_dev = _global_range_device(bounds, self.db_range)
                        self._range_host = None
                    else:
                        self._range_dev = None
                        self._range_host = (math.inf, -math.inf)
                    self._mark_range_applied()  # every image requantizes below
                elif defer_range_probe:
                    # dispatch only: the new range on the device now, the host
                    # comparison later on the session's switch pool.  Fresh
                    # tracks quantize under the NEW range at once; the
                    # pre-existing ones only if the probe reports a move against
                    # _applied_range.
                    prev_applied = self._applied_range
                    prev_mixed = self._range_mixed
                    if bounds:
                        new_dev = _global_range_device(bounds, self.db_range)
                        self._range_dev, self._range_host = new_dev, None
                    else:
                        new_dev = None
                        self._range_dev, self._range_host = None, (math.inf, -math.inf)
                    ids_need_update = set(self._no_spec_img_ids)
                    self._no_spec_img_ids.clear()
                    if ids_need_update:
                        # until this apply's reconcile or confirm lands, images
                        # may be split across two ranges
                        self._range_mixed = True

                    def probe() -> bool:
                        """Blocks until every spec's bounds are computed; True
                        when some image is stale: the global range moved off what
                        the pre-existing images were quantized under, or an
                        earlier superseded apply left images at a range that
                        never became applied (prev_mixed)."""
                        if prev_mixed:
                            return True
                        pmin, pmax = TrackManager._fetch_range(prev_applied)
                        if new_dev is None:
                            nmin, nmax = math.inf, -math.inf
                        else:
                            nmin, nmax = float(new_dev[0]), float(new_dev[1])
                        return (nmin, nmax) != (pmin, pmax)

                    probe_info = (probe, self._range_epoch, set(ids_need_update))
                else:
                    gmin, gmax = math.inf, -math.inf
                    for row_min, row_max in bounds:
                        gmin = min(gmin, float(row_min.min()))
                        gmax = max(gmax, float(row_max.max()))
                    gmax = min(gmax, 0.0)
                    # f32 subtraction, like the reference's f32 math and the device path
                    gmin = max(gmin, float(np.float32(gmax) - np.float32(self.db_range)))
                    # compare against the range the images were QUANTIZED under:
                    # after a superseded deferred apply it can differ from the
                    # stored one, and mixed images prove nothing by value
                    prev_min, prev_max = self._fetch_range(self._applied_range)
                    was_mixed = self._range_mixed
                    self._range_host = (gmin, gmax)
                    self._range_dev = None
                    # moved -> everything requantizes below; unmoved -> images
                    # already sit at this value: either way they now do
                    self._mark_range_applied()
                    if was_mixed or prev_max != gmax or prev_min != gmin:
                        ids_need_update = set(tracklist.all_ids())
                    else:
                        ids_need_update = set(self._no_spec_img_ids)
                    self._no_spec_img_ids.clear()

                lo, span_ = self._quant_scalars()
            self._quantize_all(tracklist, ids_need_update, lo, span_)
            if defer_range_probe:
                return ids_need_update, probe_info
            return ids_need_update

    def _ensure_spec(self, tracklist: TrackList, track_id: int) -> SpecResult | None:
        """Spec for a track, recomputed from the cached device wav if the
        budget evicted it; refreshes LRU recency."""
        res = self.specs.pop(track_id, None)
        if res is None:
            track = tracklist.get(track_id)
            if track is None:
                return None
            wavs, key, token, gain = self.samples.spec_item(track_id, track)
            res = self.spec_analyzer.calc_spec_multi(
                wavs, track.sr, self.setting, cache_key=key, token=token, gain=gain,
            )
            self._spec_n_ch[track_id] = track.n_ch
        self.specs[track_id] = res  # MRU
        return res

    def _evict_specs(self) -> None:
        total = sum(r.db.numel() * 4 for r in self.specs.values())
        for tid in list(self.specs):
            if total <= self._spec_budget or len(self.specs) <= 1:
                break
            total -= self.specs.pop(tid).db.numel() * 4

    def _reload_track_images(self, track_id: int) -> bool:
        """Image-store miss callback: requantize an evicted track's image
        (recomputing its spec first if that was evicted too).  Runs in the
        tile request's thread."""
        tracklist = self._last_tracklist
        if tracklist is None or tracklist.get(track_id) is None:
            return False
        with self._reload_lock:
            if not self.images.needs_reload(track_id):
                return True  # another thread already reloaded it
            res = self._ensure_spec(tracklist, track_id)
            if res is None:
                return False
            lo, span_ = self._quant_scalars()
            self._dispatch_quantize(tracklist, track_id, res, lo, span_)
            self._evict_specs()
            return True

    def _dispatch_quantize(self, tracklist: TrackList, track_id: int, res, lo, span_) -> None:
        """Quantize + device mip chain for one track, handed to the image
        store, which streams them to the host in the background and serves
        tiles from device regions until they land.  Returns at dispatch."""
        track = tracklist.get(track_id)
        if track is None or res.n_frames == 0:
            return
        levels = tuple(mip_plan(res.n_frames))
        img, mips = self.quantize(track.sr, res.db, res.n_frames, lo, span_, levels)
        n_ch = self._spec_n_ch.get(track_id, img.shape[0])
        self.images.set_images(
            track_id,
            TrackImages(track_id, n_ch, res.n_frames, img.shape[1], img, dict(zip(levels, mips))),
        )

    def quantize(self, sr: int, db, n_frames: int, lo, span_, mip_levels=()):
        """A track's (C, T, F) dB -> (image (C, H, n_frames), [mips]) u16 on
        the device under the current settings, range and max_sr: K6's kernel
        on a card (``kernels.images.quantize_mips``)."""
        n_freq = db.shape[-1]
        # images are max_sr tall: rows above a lower-rate track's n_freq are 0
        i_start, i_end = self.setting.freq_scale.hz_range_to_idx(
            (0.0, self.max_sr / 2.0), sr, n_freq
        )
        return kimages.quantize_mips(
            db, lo, span_, n_frames,
            i_start=i_start, n_rows=max(min(i_end, n_freq) - i_start, 0),
            height=i_end - i_start,
            min_value=quantize_min_value(self.colormap_length or None),
            mip_levels=mip_levels,
        )
