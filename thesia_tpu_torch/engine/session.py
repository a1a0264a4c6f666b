"""EngineSession: the command surface of the port's first slice.

Port of the synchronous commands of ``thesia_tpu/engine/session.py`` with the
same names, arguments and JSON payloads: ``init``, ``add_tracks``,
``remove_tracks``, ``apply_track_list_changes``, ``get_spec_setting``,
``set_spec_setting``, ``set_db_range``, ``get_max_db``, ``get_min_db``,
``get_audio_render_metadata``, ``get_spectrogram_tile`` and
``get_waveform_tile``.  Writes are serialized by one lock and run on the
caller's thread.  There is no player and no dynamics yet: ``init`` reports the
JAX defaults for the guard-clipping and normalize settings.

The session runs on the card (``device="cuda"``) unless the caller asks for
the CPU with ``device="cpu"``; a card that is not there raises, nothing falls
back to the CPU.

Payload conventions match the reference wire format: camelCase JSON,
JsonNumber-tagged non-finite floats (interface.rs:103-130), "id_ch" strings
(interface.rs:132-146), binary tiles.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from pathlib import Path

import numpy as np

from ..dsp.framing import SpecSetting
from ..obs import span
from ..render.tiles import RenderTileCache, encode_waveform_tile, spectrogram_tile_header
from ..runtime import resolve_device
from .manager import TrackManager
from .track import TrackList

# thesia_tpu/player/player.py:23-24 (the player is not ported yet)
PLAY_JUMP_SEC = 1.0
PLAY_BIG_JUMP_SEC = 5.0
# the JAX session's defaults for the dynamics settings (not ported yet)
DEFAULT_GUARD_CLIPPING = "ReduceGlobalLevel"
DEFAULT_NORMALIZE = {"type": "Off"}

# LOD levels are log2 factors: beyond 48 the shifts overflow int64/u32 math
_MAX_LOD_LEVEL = 48


# -- host copies of thesia_tpu/engine/session.py:41-110 (the port imports
#    nothing of the JAX package); pinned by tests/test_torch_session.py


def json_number(value: float) -> dict:
    """Tagged float serialization. reference: interface.rs:103-130."""
    if value == math.inf:
        return {"type": "Infinity"}
    if value == -math.inf:
        return {"type": "NegInfinity"}
    if isinstance(value, float) and math.isnan(value):
        return {"type": "NaN"}
    return {"type": "Finite", "value": float(value)}


def _as_finite(value, name: str) -> float:
    """Coerce a JSON value to a finite float; ValueError otherwise."""
    try:
        out = float(value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"invalid {name}: {value!r}") from e
    if not math.isfinite(out):
        raise ValueError(f"invalid {name}: {value!r}")
    return out


def _require_positive_finite(value, name: str) -> float:
    out = _as_finite(value, name)
    if not out > 0.0:
        raise ValueError(f"invalid {name}: {value!r}")
    return out


def _as_index(value, name: str, max_value: int = 2**31 - 1) -> int:
    """Coerce a JSON value to a bounded non-negative int; ValueError for
    anything else, incl. None/strings/negatives."""
    try:
        out = int(value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"invalid {name}: {value!r}") from e
    if out < 0 or out > max_value:
        raise ValueError(f"invalid {name}: {value!r}")
    return out


def format_id_ch(track_id: int, ch: int) -> str:
    return f"{track_id}_{ch}"


def parse_id_ch_str(id_ch_str: str) -> tuple[int, int]:
    """reference interface.rs:132-146: exactly two UNSIGNED ints."""
    bad = ValueError('The array element should be "{unsigned_int}_{unsigned_int}".')
    if not isinstance(id_ch_str, str):
        raise bad
    parts = id_ch_str.split("_")
    if len(parts) != 2:
        raise bad
    try:
        tid, ch = int(parts[0]), int(parts[1])
    except ValueError:
        raise bad from None
    if tid < 0 or ch < 0:
        raise bad
    return tid, ch


class EngineSession:
    def __init__(self, *, device="cuda", settings_dir: str | os.PathLike | None = None):
        self.device = resolve_device(device)
        self.tracklist = TrackList()
        self.tm = TrackManager(self.device)
        self.tile_cache = RenderTileCache()
        self.spec_setting = SpecSetting()
        self._settings_dir = Path(
            settings_dir or os.environ.get("THESIA_TPU_CONFIG", "~/.thesia_tpu")
        ).expanduser()
        self._write_lock = threading.Lock()

    def _write(self, fn):
        with self._write_lock:
            return fn()

    # -- settings persistence (reference: lib.rs:100-178) -------------------
    def _store_path(self, name: str) -> Path:
        self._settings_dir.mkdir(parents=True, exist_ok=True)
        return self._settings_dir / name

    def _load_store(self, name: str) -> dict:
        try:
            with open(self._store_path(name)) as f:
                stored = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        return stored if isinstance(stored, dict) else {}

    def _save_store(self, name: str, data: dict) -> None:
        path = self._store_path(name)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    # ======================================================================
    # lifecycle / settings
    def init(self, colormap_rgba) -> dict:
        """reference: lib.rs:46-98."""
        colormap_rgba = np.asarray(colormap_rgba, np.uint8).reshape(-1)
        stored = self._load_store("settings.json")

        def _parse(key, fn):
            if key not in stored:
                return None
            try:
                return fn(stored[key])
            except Exception:
                logging.getLogger(__name__).warning("ignoring invalid persisted setting %r", key)
                return None

        spec = _parse("specSetting", lambda v: SpecSetting.from_json(v).validated())
        db_range = _parse("dBRange", float)
        blend = _parse("blend", lambda v: _as_finite(v, "blend"))

        def work():
            if not self.tracklist.is_empty:
                self.tracklist = TrackList()
                self.tm = TrackManager(self.device)
            self.tm.set_colormap_length(self.tracklist, len(colormap_rgba) // 4)
            if spec is not None:
                self.tm.set_setting(self.tracklist, spec)
            if db_range is not None and db_range > 0.0 and math.isfinite(db_range):
                self.tm.set_db_range(self.tracklist, db_range)
            user_settings = {
                "specSetting": self.tm.setting.to_json(),
                "blend": blend if blend is not None else 0.5,
                "dBRange": self.tm.db_range,
                "commonGuardClipping": DEFAULT_GUARD_CLIPPING,
                "commonNormalize": dict(DEFAULT_NORMALIZE),
            }
            self._save_store("settings.json", user_settings)
            return user_settings

        user_settings = self._write(work)
        self.spec_setting = SpecSetting.from_json(user_settings["specSetting"])
        self.tile_cache.invalidate_all()
        self.tile_cache.set_colormap(colormap_rgba.reshape(-1, 4))
        return {
            "constants": {"PLAY_JUMP_SEC": PLAY_JUMP_SEC, "PLAY_BIG_JUMP_SEC": PLAY_BIG_JUMP_SEC},
            "userSettings": user_settings,
        }

    # ======================================================================
    # track CRUD
    def add_tracks(self, track_ids: list[int], paths: list[str]) -> list[int]:
        if not track_ids or len(track_ids) != len(paths):
            raise ValueError("trackIds and paths must be equal-length non-empty lists")

        def work():
            added = self.tracklist.add_tracks(list(track_ids), list(paths))
            self.tm.add_tracks(self.tracklist, added)
            self.tile_cache.invalidate_all()
            return added

        return self._write(work)

    def remove_tracks(self, track_ids: list[int]) -> None:
        if not track_ids:
            raise ValueError("trackIds must be non-empty")

        def work():
            removed = self.tracklist.remove_tracks(list(track_ids))
            self.tile_cache.invalidate_all()
            self.tm.remove_tracks(self.tracklist, removed)

        self._write(work)

    def apply_track_list_changes(self) -> list[str]:
        """Recompute the global dB range and (re)quantize images after a
        tracklist change (reference: lib.rs:229-248 / mod.rs:102-230)."""

        def work():
            updated_ids, _sr = self.tm.apply_track_list_changes(self.tracklist)
            return self.tracklist.id_ch_tuples_from(sorted(updated_ids))

        id_ch_tuples = self._write(work)
        if id_ch_tuples:
            self.tile_cache.invalidate_spectrogram()
        return [format_id_ch(i, c) for i, c in id_ch_tuples]

    # ======================================================================
    # spectrogram parameters
    def set_db_range(self, db_range: float) -> None:
        db_range = _require_positive_finite(db_range, "dBRange")
        self._write(lambda: self.tm.set_db_range(self.tracklist, db_range))
        self.tile_cache.invalidate_spectrogram()

    def get_spec_setting(self) -> dict:
        return self.spec_setting.to_json()

    def set_spec_setting(self, spec_setting: dict | SpecSetting) -> None:
        if isinstance(spec_setting, dict):
            spec_setting = SpecSetting.from_json(spec_setting)
        spec_setting.validated()
        self.spec_setting = spec_setting
        try:
            self._write(lambda: self.tm.set_setting(self.tracklist, spec_setting))
        except Exception:
            self.spec_setting = self.tm.setting
            raise
        self.tile_cache.invalidate_spectrogram()

    # ======================================================================
    # render
    def get_audio_render_metadata(self, id_ch_str: str) -> dict | None:
        track_id, ch = parse_id_ch_str(id_ch_str)
        track = self.tracklist.get(track_id)
        if track is None:
            return None
        if ch >= track.n_ch:
            raise KeyError(f"Track {track_id} has no channel {ch}")
        wav, is_clipped = track.channel_for_drawing(ch)
        shape = self.tm.images.geometry(track_id)
        md = self.tile_cache.metadata(len(wav), track.sr, track.sec, is_clipped, shape)
        md["isComputing"] = False  # images land before the write returns
        return md

    def get_waveform_tile(self, id_ch_str: str, level: int, tile_index: int) -> bytes:
        level = _as_index(level, "level", max_value=_MAX_LOD_LEVEL)
        tile_index = _as_index(tile_index, "tileIndex")
        track_id, ch = parse_id_ch_str(id_ch_str)
        track = self.tracklist.get(track_id)
        if track is None:
            raise KeyError(f"Track {track_id} does not exist")
        if ch >= track.n_ch:
            raise KeyError(f"Track {track_id} has no channel {ch}")
        wav, _ = track.channel_for_drawing(ch)
        revision, cached = self.tile_cache.cached_waveform_tile(track_id, ch, level, tile_index)
        if cached is not None:
            return cached
        with span("tile.waveform_encode"):
            data = encode_waveform_tile(wav, revision, level, tile_index)
        self.tile_cache.store_waveform_tile(track_id, ch, revision, level, tile_index, data)
        return data

    def get_spectrogram_tile(
        self, id_ch_str: str, level_x: int, level_y: int, tile_x: int, tile_y: int
    ) -> bytes:
        level_x = _as_index(level_x, "levelX", max_value=_MAX_LOD_LEVEL)
        level_y = _as_index(level_y, "levelY", max_value=_MAX_LOD_LEVEL)
        tile_x = _as_index(tile_x, "tileX", max_value=(1 << 32) // 512 - 16)
        tile_y = _as_index(tile_y, "tileY", max_value=(1 << 32) // 512 - 16)
        track_id, ch = parse_id_ch_str(id_ch_str)
        geo = self.tm.images.geometry(track_id)
        if geo is None:
            raise KeyError(f"Spectrogram {id_ch_str} does not exist")
        height, n_frames = geo
        with span("tile.spectrogram_encode"):
            body = self.tm.images.tile_body(
                track_id, ch, self.tile_cache.colormap_rgba, level_x, level_y, tile_x, tile_y
            )
            if body is None:
                raise KeyError(f"Spectrogram {id_ch_str} does not exist")
            header = spectrogram_tile_header(
                self.tile_cache.spectrogram_revision, height, n_frames,
                level_x, level_y, tile_x, tile_y,
            )
            return header + body

    # ======================================================================
    # global getters
    def get_max_db(self) -> dict:
        return json_number(self.tm.max_db)

    def get_min_db(self) -> dict:
        return json_number(self.tm.min_db)
