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
(``preread``), as the JAX package shares that read, and the batched stats
read the samples the spectrogram holds on the device (``source``).  Unlike
the JAX package, every whole-track stats pass goes through K9 where the
policy picks the device: a lone fresh track as a group of one, and each
track a normalize or guard switch re-gained, right after the switch, from
the same device samples its spectrogram then reads.

reference: src-tauri/src/core/track.rs.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
from pathlib import Path

import numpy as np

from ..dsp.framing import SpecSetting, SrWinNfft
from ..dynamics import stats_device
from ..dynamics.guard import GuardClippingMode
from ..dynamics.normalize import NormalizeTarget, calc_normalize_gain
from ..io.decode import AudioFormatInfo, open_audio_file
from .. import obs
from ..obs import span
from ..runtime import resolve_device
from .audio import Audio
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
        gained: np.ndarray | None = None,
    ):
        """gained: the float32(gain) * original array, when the caller already
        built it for a peak test (the batched limiter plan)."""
        if not np.isfinite(gain) or gain == 1.0:
            self.audio = self.original
            return
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


class TrackList:
    """reference: track.rs:189-437.  ``device``: where the batched dynamics
    programs run (the card unless the caller names the CPU).  ``source``:
    optional fn(track_id, track) -> (samples, gain), the track's samples as
    its spectrogram reads them, a (C, n) f32 tensor on ``device`` whose
    float32(gain) multiple is ``track.audio``'s samples; the batched stats
    take their rows from it instead of uploading them again."""

    def __init__(self, device="cuda", source=None):
        self.device = resolve_device(device)
        self.source = source
        self.max_sec = 0.0
        self.common_normalize = NormalizeTarget()
        self.common_guard_clipping = GuardClippingMode.ReduceGlobalLevel
        self._tracks: dict[int, AudioTrack] = {}
        self._filenames: dict[int, str] = {}
        self._id_max_sec = 0

    def add_tracks(
        self, id_list: list[int], path_list: list[str], preread=None, source=None
    ) -> list[int]:
        """Parallel decode; failed paths are silently skipped (the caller
        diffs ids to find errors). reference: track.rs:211-239.

        preread: optional {track_id: Future[bytes]} from the session's
        big-WAV prefetch -- the decoder takes that single file read (and
        reads the file itself when it failed).  source: as the list's, for
        this add (the session's adopts a track's pending prefetch first)."""

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
        self._precompute_stats(loaded, source)
        self._normalize_tracks(loaded, source)
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
        for track_id in id_list:
            track = self._tracks.get(track_id)
            if track is None:
                raise KeyError(f"[reload_tracks] Wrong Track ID {track_id}")
            try:
                changed = track.reload()
            except Exception:
                continue
            if changed:
                self._precompute_stats([(track_id, track)])
                self._normalize_tracks([(track_id, track)])
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
        try:
            self._normalize_tracks(list(self._tracks.items()))
        except Exception:
            restore()
            try:
                self._normalize_tracks(list(self._tracks.items()))
            except Exception:
                logging.getLogger(__name__).exception(
                    "rollback re-apply after failed normalize/guard switch"
                )
            raise

    def _precompute_stats(self, loaded, source=None) -> None:
        """Stats of fresh tracks ([(track_id, track)]) before normalize reads
        them: on the device, one K9 program per (sr, n_ch) group, a lone
        track a group of one (``_batched_stats``); where the policy picks the
        host, two or more in the native path's thread pool (the reference's
        rayon-parallel stats, track.rs:211-221), a lone one lazily."""
        loaded = [(tid, t) for tid, t in loaded if t.original._stats is None]
        if stats_device.device_dynamics_preferred():
            self._batched_stats(loaded, source)
            return
        if len(loaded) < 2:
            return
        with concurrent.futures.ThreadPoolExecutor() as pool:
            # touching .stats computes and caches them
            list(pool.map(obs.carry(lambda t: t.original.stats), [t for _tid, t in loaded]))

    def _batched_stats(self, loaded, source=None) -> None:
        """The stats of each track's current audio ([(track_id, track)]) in
        one ``stats_device.calc_stats_batched`` call: one K9 program per
        (sr, n_ch) group, its rows from ``source`` (default: the list's)
        where there is one; tracks shorter than a gating block on the host."""
        if not loaded:
            return
        source = source or self.source
        items = [(i, t.audio.wavs, t.sr) for i, (_tid, t) in enumerate(loaded)]
        with span("stats.batched"):
            sources = None if source is None else {
                i: source(tid, t) for i, (tid, t) in enumerate(loaded)}
            stats = stats_device.calc_stats_batched(items, self.device, sources)
        for i, (_tid, t) in enumerate(loaded):
            t.audio.stats = stats[i]

    def _normalize_tracks(self, loaded, source=None) -> None:
        """Common normalize + guard clipping over a set of tracks ([(track_id,
        track)]).  Limiter mode over two or more tracks batches every engaging
        track's gain sequence into one K8 program per sample rate; other modes
        take the per-track path.  Then, where the policy picks the device, the
        tracks the switch gained or guarded (``Audio.mutate`` dropped their
        stats) get them through K9 at once, outside the ``normalize`` span.
        reference: track.rs:152-170 + the mod.rs loop."""
        tracks = [t for _tid, t in loaded]
        mode = self.common_guard_clipping
        target = self.common_normalize
        with span("normalize"):
            if mode is not GuardClippingMode.Limiter or len(tracks) < 2:
                for track in tracks:
                    track.normalize(target, mode)
            else:
                self._normalize_tracks_limiter_batched(tracks, target, mode)
        if stats_device.device_dynamics_preferred():
            self._batched_stats([(tid, t) for tid, t in loaded if t.audio._stats is None],
                                source)

    def _normalize_tracks_limiter_batched(self, tracks, target, mode) -> None:
        plan: list[tuple[AudioTrack, float, np.ndarray]] = []
        for track in tracks:
            gain = calc_normalize_gain(target, track.original.stats)
            if not np.isfinite(gain) or gain == 1.0:
                track.apply_gain(gain, mode)
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
        if not plan:
            return
        if stats_device.device_dynamics_preferred():
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
