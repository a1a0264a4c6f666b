"""AudioTrack + TrackList: decode, per-track normalize/guard state, sparse
id-keyed track storage with max_sec/max_sr bookkeeping.

Port of ``thesia_tpu/engine/track.py``: the ``original``/``audio`` split,
``device_scalar_gain``, normalize and ``apply_gain``, ``reload``, the common
normalize and guard-clipping modes with rollback, batched stats and the
batched Limiter plan.  The batched programs run on the list's device
(``dynamics/stats_device.py``); where ``device_dynamics_preferred`` picks
the host, the native streaming code runs in a thread pool.  Unlike the JAX
package, a failing device program raises: nothing hands its work to the
host.  Decoding goes through the port's copy of ``open_audio_file``; an add
can hand the decoder the bytes of the session's big-WAV prefetch read
(``preread``), as the JAX package shares that read.  Unlike the JAX
package, every whole-track stats pass goes through K9 where the policy picks
the device: a lone fresh track as a group of one, and each track a normalize
or guard switch re-gained, right after the switch.  Where the list keeps its
tracks' samples on the device (``samples``, the session's
``engine/samples.py`` store), the stats read the device samples the
spectrogram reads, and a switch applies the gain and the guard there (K10,
``TrackList._device_route``), bit for bit as numpy does, and lands one f32
copy; a lone track whose Limiter engages keeps the native streaming limiter.

reference: src-tauri/src/core/track.rs.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
from pathlib import Path

import numpy as np

from ..dsp.framing import SpecSetting, SrWinNfft
from ..dynamics import stats_device
from ..dynamics.guard import GuardClippingMode, GuardClippingResult
from ..dynamics.normalize import NormalizeTarget, calc_normalize_gain
from ..dynamics.stats import GuardClippingStats
from ..io.decode import AudioFormatInfo, open_audio_file
from ..kernels import dynamics as kdyn
from .. import obs
from ..obs import span
from ..runtime import resolve_device
from .audio import _GUARD_SPANS, Audio
from .utils import unique_filenames


class AudioTrack:
    """reference: track.rs:48-171."""

    def __init__(self, path_str: str, data: bytes | None = None):
        path = Path(path_str).resolve(strict=True)
        wavs, format_info = open_audio_file(path, data)
        self.format_info: AudioFormatInfo = format_info
        self.path = path
        self.original = Audio(wavs, format_info.sr)
        self.audio = self.original

    def reload(self) -> bool:
        """True if the content changed. reference: track.rs:75-89."""
        wavs, format_info = open_audio_file(self.path)
        if (
            wavs.shape == self.original.wavs.shape
            and np.array_equal(wavs, self.original.wavs)
            and format_info == self.format_info
        ):
            return False
        self.format_info = format_info
        self.original = Audio(wavs, format_info.sr)
        self.audio = self.original
        return True

    # views
    def channel(self, ch: int) -> np.ndarray:
        return self.audio.channel(ch)

    def channel_for_drawing(self, ch: int) -> tuple[np.ndarray, bool]:
        return self.audio.channel_for_drawing(ch)

    def interleaved_samples(self) -> np.ndarray:
        return self.audio.interleaved_samples()

    @property
    def sr(self) -> int:
        return self.audio.sr

    @property
    def n_ch(self) -> int:
        return self.audio.n_ch

    @property
    def sec(self) -> float:
        return self.audio.sec

    @property
    def stats(self):
        return self.audio.stats

    def path_string(self) -> str:
        return str(self.path)

    def is_path_same(self, path: str) -> bool:
        try:
            return Path(path).resolve(strict=True) == self.path
        except OSError:
            return False

    def guard_clipping_gain(self):
        return self.audio.guard_clipping_gain()

    def format_guard_clip_stats(self, mode: GuardClippingMode):
        return self.audio.format_guard_clip_stats(mode)

    def device_scalar_gain(self) -> float | None:
        """Scalar g such that audio.wavs == float32(g) * original.wavs
        bitwise, i.e. the applied gain when guard clipping was a no-op (no
        sample exceeded +/-1, so Clip clamped nothing, ReduceGlobalLevel kept
        gain 1, the Limiter sequence is all ones).  The spectrogram then
        reads the original samples, uploaded once, with g applied in the
        kernel, so normalize changes never re-upload.  None when the guard
        changed samples (clamps, f64 global reduce, limiter gains)."""
        if self.audio is self.original:
            return 1.0
        g = getattr(self.audio, "applied_scalar_gain", None)
        if g is None:
            return None
        if any(s.max_reduction_gain_db != 0.0 for s in self.audio.guard_clip_stats):
            return None
        return float(g)

    # normalize (the gain always comes from the ORIGINAL stats,
    # reference: track.rs:152-170)
    def normalize(self, target: NormalizeTarget, guard_clipping_mode: GuardClippingMode):
        gain = calc_normalize_gain(target, self.original.stats)
        self.apply_gain(gain, guard_clipping_mode)

    def apply_gain(
        self, gain: float, guard_clipping_mode: GuardClippingMode, gain_seq=None,
        gained: np.ndarray | None = None, peaks: stats_device.GainPeaks | None = None,
    ):
        """gained: the float32(gain) * original array, when the caller already
        built it for a peak test (the batched limiter plan).  gain_seq: K8's
        gains, on the host (host route) or the device (device route).

        peaks: K10's first pass over the original's device samples
        (``TrackList._gain_peaks``).  Given, the gain and the guard run on the
        device (``_apply_on_device``), bit for bit as the host route does in
        numpy, except that a Limiter that engages without K8's gains keeps the
        native streaming limiter on the host.  Returns the post-guard device
        samples the device route made, else None."""
        if not np.isfinite(gain) or gain == 1.0:
            self.audio = self.original
            return None
        if peaks is not None:
            y = self._apply_on_device(gain, guard_clipping_mode, gain_seq, peaks)
            if y is not None:
                stats_device.count_guard_route("device")
                return y
        stats_device.count_guard_route("host")
        original_wavs = self.original.wavs
        mutated = Audio.__new__(Audio)
        mutated.wavs = original_wavs
        mutated.sr = self.original.sr
        mutated.stats = self.original.stats
        mutated.guard_clip_result = self.original.guard_clip_result
        mutated.guard_clip_stats = list(self.original.guard_clip_stats)
        mutated.mutate(
            (lambda wavs: gained)
            if gained is not None
            else (lambda wavs: (np.float32(gain) * original_wavs)
                  .astype(np.float32, copy=False)),  # f32*f32 is already f32
            guard_clipping_mode,
            gain_seq=gain_seq,
        )
        mutated.applied_scalar_gain = float(gain)  # for device_scalar_gain
        self.audio = mutated
        return None

    def _apply_on_device(self, gain: float, mode: GuardClippingMode, gain_seq,
                         p: stats_device.GainPeaks):
        """``Audio.mutate``'s gain and ``guard.guard_clipping`` by K10 on the
        device from its first pass ``p``, one f32 copy landed: the Audio is
        built from the landed samples, the pre-clip waveform (Clip), the f32
        gains (Limiter) and the kernel's counts, with ``GuardClippingStats``'s
        own formulas.  Returns the post-guard device samples; None, touching
        nothing, where the Limiter engages and no K8 gains were given: the
        host route runs it."""
        peak = p.peak
        limiter = mode is GuardClippingMode.Limiter
        if limiter and peak > 1.0 and gain_seq is None:
            return None
        op, scale = kdyn.GUARD_GAIN, 1.0
        if mode is GuardClippingMode.Clip:
            op = kdyn.GUARD_CLIP
        elif peak > 1.0:
            op = kdyn.GUARD_SEQ if limiter else kdyn.GUARD_SCALE
            scale = 1.0 / peak  # guard.py's f64 scalar (ReduceGlobalLevel)
        n = len(self.original)
        with span("guard_clipping"), span(_GUARD_SPANS[mode]):
            y, stats, seq32 = kdyn.guard_apply(p.x, gain, op, scale,
                                               gain_seq if op == kdyn.GUARD_SEQ else None)
            with span("guard.land"):
                wavs = stats_device.to_host(y)
                before = None if p.gained is None else stats_device.to_host(p.gained)
                gains = None if seq32 is None else stats_device.to_host(seq32).reshape(1, n)
                stats = [] if stats is None else stats.tolist()
            audio = Audio(wavs, self.sr)
            if mode is GuardClippingMode.Clip:
                result = GuardClippingResult(kind="wav_before_clip", wav_before_clip=before)
                guard_stats = [_clip_stats(pk, cnt) for pk, cnt in zip(p.peaks, stats)]
            elif not limiter:
                result = GuardClippingResult(
                    kind="global_gain", global_gain=np.float32(scale) if peak > 1.0 else 1.0,
                    shape=wavs.shape)
                guard_stats = result.per_channel_stats()
            elif gains is None:
                result = GuardClippingResult(kind="gain_sequence",
                                             gain_seq=np.ones((1, n), np.float32))
                guard_stats = [GuardClippingStats.from_gain_seq(np.ones(1, np.float32))]
            else:
                result = GuardClippingResult(kind="gain_sequence", gain_seq=gains)
                guard_stats = [dataclasses.replace(
                    GuardClippingStats.from_gain_seq(np.float32([kdyn.gain_seq_min(stats[1])])),
                    reduction_cnt=int(stats[0]))]
            audio.guard_clip_result = result
            audio.guard_clip_stats = guard_stats
            audio.applied_scalar_gain = float(gain)  # for device_scalar_gain
            self.audio = audio
        return y


def _clip_stats(peak: float, count: int) -> GuardClippingStats:
    """``GuardClippingStats.from_wav_before_clip`` of a channel whose
    NaN-skipping peak and count of |sample| > 1 the device gave."""
    stats = GuardClippingStats.from_wav_before_clip(np.float32([peak]))
    return dataclasses.replace(stats, reduction_cnt=int(count)) if peak > 1.0 else stats


class TrackList:
    """reference: track.rs:189-437.  ``device``: where the batched dynamics
    programs run (the card unless the caller names the CPU).  ``samples``:
    optional keeper of the tracks' samples on ``device`` (the session's
    ``tm.samples``, ``engine/samples.py``), asked for ``current(track_id,
    track)`` -> (samples, gain), a (C, n) f32 tensor whose float32(gain)
    multiple is ``track.audio``'s samples, for ``original(track_id, track)``,
    the original's, and told ``keep_guarded(track_id, track, samples)`` of the
    post-guard samples made there.  With one, the batched stats take their
    rows from it instead of uploading them again, and a normalize or guard
    switch applies the gain and the guard on the device (K10,
    ``_device_route``).  Without one (tests, ``tools/dryrun_mesh.py``) both
    stay on the host route.  Each list operation reads
    ``device_dynamics_preferred`` once and hands it down as ``use_device``."""

    def __init__(self, device="cuda", samples=None):
        self.device = resolve_device(device)
        self.samples = samples
        self.max_sec = 0.0
        self.common_normalize = NormalizeTarget()
        self.common_guard_clipping = GuardClippingMode.ReduceGlobalLevel
        self._tracks: dict[int, AudioTrack] = {}
        self._filenames: dict[int, str] = {}
        self._id_max_sec = 0

    def add_tracks(self, id_list: list[int], path_list: list[str], preread=None) -> list[int]:
        """Parallel decode; failed paths are silently skipped (the caller
        diffs ids to find errors). reference: track.rs:211-239.

        preread: optional {track_id: Future[bytes]} from the session's
        big-WAV prefetch -- the decoder takes that single file read (and
        reads the file itself when it failed)."""

        def load(args):
            track_id, path = args
            data = None
            fut = (preread or {}).get(track_id)
            if fut is not None:
                try:
                    data = fut.result()
                except Exception:
                    data = None  # decode does its own read (and error path)
            try:
                with span("decode"):
                    return (track_id, AudioTrack(path, data))
            except Exception:
                return None

        if len(id_list) > 1 and (os.cpu_count() or 1) > 1:
            # the pool's wall time, the parent of each thread's ``decode``
            with span("decode.pool"), concurrent.futures.ThreadPoolExecutor() as pool:
                results = list(pool.map(obs.carry(load), zip(id_list, path_list)))
        else:
            results = [load(x) for x in zip(id_list, path_list)]

        loaded = [res for res in results if res is not None]
        use_device = stats_device.device_dynamics_preferred()
        self._precompute_stats(loaded, use_device)
        self._normalize_tracks(loaded, use_device)
        added_ids = []
        for track_id, track in loaded:
            if track.sec > self.max_sec:
                self.max_sec = track.sec
                self._id_max_sec = track_id
            self._tracks[track_id] = track
            added_ids.append(track_id)
        self._update_filenames()
        return added_ids

    def reload_tracks(self, id_list: list[int]) -> tuple[list[int], list[int]]:
        """(reloaded_ids, no_err_ids). reference: track.rs:241-276."""
        reloaded, no_err = [], []
        use_device = stats_device.device_dynamics_preferred()
        for track_id in id_list:
            track = self._tracks.get(track_id)
            if track is None:
                raise KeyError(f"[reload_tracks] Wrong Track ID {track_id}")
            try:
                changed = track.reload()
            except Exception:
                continue
            if changed:
                self._precompute_stats([(track_id, track)], use_device)
                self._normalize_tracks([(track_id, track)], use_device)
                if track.sec > self.max_sec:
                    self.max_sec = track.sec
                    self._id_max_sec = track_id
                reloaded.append(track_id)
            no_err.append(track_id)
        return reloaded, no_err

    def remove_tracks(self, id_list: list[int]) -> list[tuple[int, int]]:
        removed_id_ch = []
        need_update_max_sec = False
        for track_id in id_list:
            track = self._tracks.pop(track_id, None)
            if track is None:
                continue
            removed_id_ch.extend((track_id, ch) for ch in range(track.n_ch))
            if track_id == self._id_max_sec:
                need_update_max_sec = True
        if need_update_max_sec:
            best = (0, 0.0)
            for track_id, track in self._tracks.items():
                if track.sec > best[1]:
                    best = (track_id, track.sec)
            self._id_max_sec, self.max_sec = best
        self._update_filenames()
        return removed_id_ch

    def set_common_normalize(self, target: NormalizeTarget) -> None:
        old = self.common_normalize
        self.common_normalize = target
        self._apply_or_rollback(lambda: setattr(self, "common_normalize", old))

    def set_common_guard_clipping(self, mode: GuardClippingMode) -> None:
        old = self.common_guard_clipping
        self.common_guard_clipping = mode
        self._apply_or_rollback(lambda: setattr(self, "common_guard_clipping", old))

    def _apply_or_rollback(self, restore) -> None:
        """A failure mid-apply (some tracks re-gained, others not) must not
        leave the mode claiming the new state: restore it, re-apply the old
        one so every track is consistent, and re-raise."""
        use_device = stats_device.device_dynamics_preferred()
        try:
            self._normalize_tracks(list(self._tracks.items()), use_device)
        except Exception:
            restore()
            try:
                self._normalize_tracks(list(self._tracks.items()), use_device)
            except Exception:
                logging.getLogger(__name__).exception(
                    "rollback re-apply after failed normalize/guard switch"
                )
            raise

    def _precompute_stats(self, loaded, use_device: bool) -> None:
        """Stats of fresh tracks ([(track_id, track)]) before normalize reads
        them: on the device, one K9 program per (sr, n_ch) group, a lone
        track a group of one (``_batched_stats``); where the policy picks the
        host, two or more in the native path's thread pool (the reference's
        rayon-parallel stats, track.rs:211-221), a lone one lazily."""
        loaded = [(tid, t) for tid, t in loaded if t.original._stats is None]
        if use_device:
            self._batched_stats(loaded)
            return
        if len(loaded) < 2:
            return
        with concurrent.futures.ThreadPoolExecutor() as pool:
            # touching .stats computes and caches them
            list(pool.map(obs.carry(lambda t: t.original.stats), [t for _tid, t in loaded]))

    def _batched_stats(self, loaded) -> None:
        """The stats of each track's current audio ([(track_id, track)]) in
        one ``stats_device.calc_stats_batched`` call: one K9 program per
        (sr, n_ch) group, its rows from ``samples`` where the list has a
        store; tracks shorter than a gating block on the host."""
        if not loaded:
            return
        items = [(i, t.audio.wavs, t.sr) for i, (_tid, t) in enumerate(loaded)]
        with span("stats.batched"):
            sources = None if self.samples is None else {
                i: self.samples.current(tid, t) for i, (tid, t) in enumerate(loaded)}
            stats = stats_device.calc_stats_batched(items, self.device, sources)
        for i, (_tid, t) in enumerate(loaded):
            t.audio.stats = stats[i]

    def _normalize_tracks(self, loaded, use_device: bool) -> None:
        """Common normalize + guard clipping over a set of tracks ([(track_id,
        track)]).  Limiter mode over two or more tracks batches every engaging
        track's gain sequence into one K8 program per sample rate; other modes
        take the per-track path.  Then, where the policy picks the device, the
        tracks the switch gained or guarded (``Audio.mutate`` dropped their
        stats) get them through K9 at once, outside the ``normalize`` span.
        reference: track.rs:152-170 + the mod.rs loop."""
        mode = self.common_guard_clipping
        target = self.common_normalize
        with span("normalize"):
            if mode is not GuardClippingMode.Limiter or len(loaded) < 2:
                for tid, track in loaded:
                    self._apply_gain(tid, track, calc_normalize_gain(target, track.original.stats),
                                     mode, self._device_route(track, use_device))
            else:
                self._normalize_tracks_limiter_batched(loaded, target, mode, use_device)
        if use_device:
            self._batched_stats([(tid, t) for tid, t in loaded if t.audio._stats is None])

    def _device_route(self, track: AudioTrack, use_device: bool) -> bool:
        """Where a track's gain and guard run on the device: the list keeps
        its tracks' samples there (``samples``), the policy picks the device
        programs, and the track holds a gating block."""
        return (use_device and self.samples is not None
                and stats_device.holds_gating_block(len(track.original), track.sr))

    def _gain_peaks(self, tid: int, track: AudioTrack, gain: float,
                    mode: GuardClippingMode) -> stats_device.GainPeaks:
        """K10's first pass on the original's device samples: the peaks of
        float32(gain) times them, and that product kept on the device where
        Clip lands it as the pre-clip waveform."""
        x = self.samples.original(tid, track)
        with span("gain_apply"):
            return stats_device.GainPeaks(x, gain, keep=mode is GuardClippingMode.Clip)

    def _apply_gain(self, tid: int, track: AudioTrack, gain: float, mode: GuardClippingMode,
                    device_route: bool, gain_seq=None, peaks=None) -> None:
        """``track.apply_gain`` on its route: on the device route from K10's
        first pass (``peaks``, made here unless given), the post-guard device
        samples it made handed to the store."""
        if device_route and peaks is None and np.isfinite(gain) and gain != 1.0:
            peaks = self._gain_peaks(tid, track, gain, mode)
        y = track.apply_gain(gain, mode, gain_seq=gain_seq, peaks=peaks)
        if y is not None:
            self.samples.keep_guarded(tid, track, y)

    def _normalize_tracks_limiter_batched(self, loaded, target, mode, use_device: bool) -> None:
        """Every engaging track's K8 gains in one program per sample rate: on
        the device route from K10's peaks and the original's device samples
        (``_limit_on_device``), else from numpy's product on the host."""
        plan: list[tuple[AudioTrack, float, np.ndarray]] = []
        device_items = []
        for tid, track in loaded:
            gain = calc_normalize_gain(target, track.original.stats)
            if not np.isfinite(gain) or gain == 1.0:
                track.apply_gain(gain, mode)
                continue
            if self._device_route(track, use_device):
                device_items.append((tid, track, gain))
                continue
            gained = (np.float32(gain) * track.original.wavs).astype(np.float32, copy=False)
            peak = float(np.abs(gained).max()) if gained.size else 0.0
            if peak > 1.0:
                plan.append((track, gain, gained))
            else:
                # not clipping (the common case): reuse the peak-test product
                # and apply now, so one track's f32 copy is alive at a time
                track.apply_gain(gain, mode, gained=gained)
                del gained
        self._limit_on_device(device_items, mode)
        if not plan:
            return
        if use_device:
            with span("guard.limiter"):  # K8 and the gains' copy to the host
                gains = stats_device.limiter_gain_seqs_batched(
                    [(i, g, t.sr) for i, (t, _gain, g) in enumerate(plan)], self.device
                )
            for i in range(len(plan)):
                track, gain, gained = plan[i]
                plan[i] = None  # release the f32 copy as soon as consumed
                track.apply_gain(gain, mode, gain_seq=gains[i], gained=gained)
            return
        # the native streaming limiter, thread-parallel (ctypes drops the GIL)
        with span("guard.limiter"), concurrent.futures.ThreadPoolExecutor() as pool:
            apply = obs.carry(lambda item: item[0].apply_gain(item[1], mode, gained=item[2]))
            list(pool.map(apply, plan))

    def _limit_on_device(self, items, mode) -> None:
        """The device route of the batched Limiter ([(track_id, track,
        gain)]): K10's peaks; the tracks it engages on take one K8 program per
        sample rate, its rows float32(gain) times the originals' device
        samples, its gains left on the device for K10's second pass.  A track
        with a NaN sample goes as the host route's peak test sends it (numpy's
        max is NaN there): to the native limiter where it engages."""
        engaged = []
        for tid, track, gain in items:
            peaks = self._gain_peaks(tid, track, gain, mode)
            if peaks.peak > 1.0 and not peaks.has_nan:
                engaged.append((tid, track, gain, peaks))
            else:
                self._apply_gain(tid, track, gain, mode, True, peaks=peaks)
        if not engaged:
            return
        with span("guard.limiter"):  # K8; its gains stay on the device
            gains = stats_device.limiter_gain_seqs_batched(
                [(i, t.original.wavs, t.sr) for i, (_tid, t, _g, _p) in enumerate(engaged)],
                self.device, sources={i: (p.x, g) for i, (_tid, _t, g, p) in enumerate(engaged)},
                land=False)
        for i, (tid, track, gain, peaks) in enumerate(engaged):
            self._apply_gain(tid, track, gain, mode, True, gain_seq=gains.pop(i), peaks=peaks)

    # -- queries -----------------------------------------------------------
    def all_ids(self) -> list[int]:
        return sorted(self._tracks)

    def id_ch_tuples(self) -> list[tuple[int, int]]:
        return self.id_ch_tuples_from(self.all_ids())

    def id_ch_tuples_from(self, id_list) -> list[tuple[int, int]]:
        out = []
        for track_id in id_list:
            track = self._tracks.get(track_id)
            if track is not None:
                out.extend((track_id, ch) for ch in range(track.n_ch))
        return out

    def max_sr(self) -> int:
        return max((t.sr for t in self._tracks.values()), default=0)

    def construct_sr_win_nfft_set(self, ids, setting: SpecSetting) -> set[SrWinNfft]:
        return {setting.calc_sr_win_nfft(self[track_id].sr) for track_id in ids}

    def construct_all_sr_win_nfft_set(self, setting: SpecSetting) -> set[SrWinNfft]:
        return self.construct_sr_win_nfft_set(self.all_ids(), setting)

    @property
    def is_empty(self) -> bool:
        return not self._tracks

    def has(self, track_id: int) -> bool:
        return track_id in self._tracks

    def get(self, track_id: int) -> AudioTrack | None:
        return self._tracks.get(track_id)

    def __getitem__(self, track_id: int) -> AudioTrack:
        return self._tracks[track_id]

    def find_id_by_path(self, path: str) -> int | None:
        for track_id in sorted(self._tracks):
            if self._tracks[track_id].is_path_same(path):
                return track_id
        return None

    def filename(self, track_id: int) -> str:
        return self._filenames.get(track_id, "")

    def _update_filenames(self) -> None:
        self._filenames = unique_filenames(
            {track_id: str(t.path) for track_id, t in self._tracks.items()}
        )
