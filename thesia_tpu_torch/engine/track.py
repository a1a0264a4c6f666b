"""AudioTrack + TrackList: decode and sparse id-keyed track storage with
max_sec/max_sr bookkeeping.

Port of ``thesia_tpu/engine/track.py`` without dynamics (normalize stays at
its default ``Off``, so every track plays and analyses its original samples).
Decoding goes through the port's copy of ``open_audio_file`` (``io/decode.py``).

reference: src-tauri/src/core/track.rs.
"""

from __future__ import annotations

import concurrent.futures
import os
from pathlib import Path

import numpy as np

from ..dsp.framing import SpecSetting, SrWinNfft
from ..io.decode import AudioFormatInfo, open_audio_file
from ..obs import span
from .audio import Audio
from .utils import unique_filenames


class AudioTrack:
    """reference: track.rs:48-171."""

    def __init__(self, path_str: str):
        path = Path(path_str).resolve(strict=True)
        wavs, format_info = open_audio_file(path)
        self.format_info: AudioFormatInfo = format_info
        self.path = path
        self.audio = Audio(wavs, format_info.sr)

    def channel_for_drawing(self, ch: int) -> tuple[np.ndarray, bool]:
        return self.audio.channel_for_drawing(ch)

    @property
    def sr(self) -> int:
        return self.audio.sr

    @property
    def n_ch(self) -> int:
        return self.audio.n_ch

    @property
    def sec(self) -> float:
        return self.audio.sec


class TrackList:
    """reference: track.rs:189-437."""

    def __init__(self):
        self.max_sec = 0.0
        self._tracks: dict[int, AudioTrack] = {}
        self._filenames: dict[int, str] = {}
        self._id_max_sec = 0

    def add_tracks(self, id_list: list[int], path_list: list[str]) -> list[int]:
        """Parallel decode; failed paths are silently skipped (the caller
        diffs ids to find errors). reference: track.rs:211-239."""

        def load(args):
            track_id, path = args
            try:
                with span("decode"):
                    return (track_id, AudioTrack(path))
            except Exception:
                return None

        if len(id_list) > 1 and (os.cpu_count() or 1) > 1:
            with concurrent.futures.ThreadPoolExecutor() as pool:
                results = list(pool.map(load, zip(id_list, path_list)))
        else:
            results = [load(x) for x in zip(id_list, path_list)]

        added_ids = []
        for res in results:
            if res is None:
                continue
            track_id, track = res
            if track.sec > self.max_sec:
                self.max_sec = track.sec
                self._id_max_sec = track_id
            self._tracks[track_id] = track
            added_ids.append(track_id)
        self._update_filenames()
        return added_ids

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

    def get(self, track_id: int) -> AudioTrack | None:
        return self._tracks.get(track_id)

    def __getitem__(self, track_id: int) -> AudioTrack:
        return self._tracks[track_id]

    def filename(self, track_id: int) -> str:
        return self._filenames.get(track_id, "")

    def _update_filenames(self) -> None:
        self._filenames = unique_filenames(
            {track_id: str(t.path) for track_id, t in self._tracks.items()}
        )
