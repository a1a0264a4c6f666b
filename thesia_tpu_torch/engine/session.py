"""EngineSession: the command surface of the port.

Port of the synchronous commands of ``thesia_tpu/engine/session.py`` with the
same names, arguments and JSON payloads: ``init``, ``set_user_settings``,
``add_tracks``, ``reload_tracks``, ``remove_tracks``,
``apply_track_list_changes``, ``find_id_by_path``, ``get/set_spec_setting``,
``get/set_db_range``, ``get/set_common_guard_clipping``,
``get/set_common_normalize``, ``get_audio_render_metadata``,
``get_spectrogram_tile``, ``get_waveform_tile``, ``get_limiter_gain`` and the
getters (``get_max_db`` ... ``get_global_lufs``, ``get_rms_db``,
``get_max_peak_db``, ``get_guard_clip_stats`` ... ``get_file_name``).
Writes are serialized by one lock and run on the caller's thread: the
settings switches are synchronous, with the JAX package's ``defer=False``
semantics, and each invalidates the whole tile cache.  There is no player.

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
from ..dynamics.guard import GuardClippingMode
from ..dynamics.normalize import NormalizeTarget
from ..obs import span
from ..render.tiles import RenderTileCache, encode_waveform_tile, spectrogram_tile_header
from ..runtime import resolve_device
from .manager import TrackManager
from .track import TrackList

# thesia_tpu/player/player.py:23-24 (the player is not ported yet)
PLAY_JUMP_SEC = 1.0
PLAY_BIG_JUMP_SEC = 5.0

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
        self.tracklist = TrackList(self.device)
        self.tm = TrackManager(self.device)
        self.tile_cache = RenderTileCache()
        self.spec_setting = SpecSetting()
        self._settings_dir = Path(
            settings_dir or os.environ.get("THESIA_TPU_CONFIG", "~/.thesia_tpu")
        ).expanduser()
        self._write_lock = threading.Lock()
        # serializes the settings JSON read-modify-writes
        self._store_lock = threading.Lock()

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

        # every persisted value is parsed before any teardown (the reference
        # deserializes first, lib.rs:52-53): an invalid one degrades to its
        # default instead of failing init halfway
        spec = _parse("specSetting", lambda v: SpecSetting.from_json(v).validated())
        db_range = _parse("dBRange", float)
        guard = _parse("commonGuardClipping", GuardClippingMode)
        normalize = _parse("commonNormalize", NormalizeTarget.from_json)
        blend = _parse("blend", lambda v: _as_finite(v, "blend"))

        def work():
            if not self.tracklist.is_empty:
                self.tracklist = TrackList(self.device)
                self.tm = TrackManager(self.device)
            self.tm.set_colormap_length(self.tracklist, len(colormap_rgba) // 4)
            if spec is not None:
                self.tm.set_setting(self.tracklist, spec)
            if db_range is not None and db_range > 0.0 and math.isfinite(db_range):
                self.tm.set_db_range(self.tracklist, db_range)
            if guard is not None:
                self.tracklist.set_common_guard_clipping(guard)
            if normalize is not None:
                self.tracklist.set_common_normalize(normalize)
            # read-modify-write under the store lock: a blend that
            # set_user_settings stored since the load above passes through
            with self._store_lock:
                fresh_blend = self._load_store("settings.json").get("blend")
                fresh_blend_ok = (
                    isinstance(fresh_blend, (int, float))
                    and not isinstance(fresh_blend, bool)
                    and math.isfinite(fresh_blend)
                )
                user_settings = {
                    "specSetting": self.tm.setting.to_json(),
                    "blend": (
                        float(fresh_blend) if fresh_blend_ok
                        else blend if blend is not None else 0.5
                    ),
                    "dBRange": self.tm.db_range,
                    "commonGuardClipping": self.tracklist.common_guard_clipping.value,
                    "commonNormalize": self.tracklist.common_normalize.to_json(),
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

    def set_user_settings(self, user_settings: dict) -> None:
        """Persist a partial settings update, each value validated as its
        command would take it (reference: lib.rs:100-149)."""
        validators = {
            "specSetting": lambda v: SpecSetting.from_json(v).validated(),
            "blend": lambda v: _as_finite(v, "blend"),
            "dBRange": lambda v: _require_positive_finite(v, "dBRange"),
            "commonGuardClipping": GuardClippingMode,
            "commonNormalize": NormalizeTarget.from_json,
        }
        for k, v in user_settings.items():
            if k in validators and v is not None:
                try:
                    validators[k](v)
                except ValueError:
                    raise
                except Exception as e:
                    raise ValueError(f"invalid {k}: {e}") from e
        with self._store_lock:
            stored = self._load_store("settings.json")
            for k, v in user_settings.items():
                if k in validators and v is not None:
                    stored[k] = v
            self._save_store("settings.json", stored)

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

    def reload_tracks(self, track_ids: list[int]) -> list[int]:
        if not track_ids:
            raise ValueError("trackIds must be non-empty")

        def work():
            reloaded, no_err = self.tracklist.reload_tracks(list(track_ids))
            self.tm.reload_tracks(self.tracklist, reloaded)
            if reloaded:
                self.tile_cache.invalidate_all()
            return no_err

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

    def find_id_by_path(self, path: str) -> int:
        found = self.tracklist.find_id_by_path(path)
        return -1 if found is None else found

    # ======================================================================
    # spectrogram parameters
    def get_db_range(self) -> float:
        return self.tm.db_range

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
    # dynamics: synchronous switches (the JAX package's defer=False)
    def get_common_guard_clipping(self) -> str:
        return self.tracklist.common_guard_clipping.value

    def set_common_guard_clipping(self, mode: str | GuardClippingMode) -> None:
        """Switch the guard-clipping mode: every track is re-derived from its
        original samples, then every spectrogram and image is recomputed.  A
        failure leaves the mode as it was and raises."""
        mode = GuardClippingMode(mode)
        self._switch_dynamics(lambda: self.tracklist.set_common_guard_clipping(mode))

    def get_common_normalize(self) -> dict:
        return self.tracklist.common_normalize.to_json()

    def set_common_normalize(self, target: dict | NormalizeTarget) -> None:
        """Switch the common normalize target; as set_common_guard_clipping."""
        if isinstance(target, dict):
            target = NormalizeTarget.from_json(target)
        self._switch_dynamics(lambda: self.tracklist.set_common_normalize(target))

    def _switch_dynamics(self, apply) -> None:
        def work():
            apply()
            self.tm.update_all_specs_imgs(self.tracklist)

        self._write(work)
        self.tile_cache.invalidate_all()

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

    def get_limiter_gain(self, track_id: int) -> list[float] | None:
        track = self.tracklist.get(track_id)
        if track is None:
            return None
        gain = track.guard_clipping_gain()
        return None if gain is None else np.asarray(gain).reshape(-1).tolist()

    # ======================================================================
    # per-track / global getters
    def get_max_db(self) -> dict:
        return json_number(self.tm.max_db)

    def get_min_db(self) -> dict:
        return json_number(self.tm.min_db)

    def get_max_track_hz(self) -> float:
        return self.tm.max_sr / 2.0

    def get_longest_track_length_sec(self) -> float:
        return self.tracklist.max_sec

    def get_channel_counts(self, track_id: int) -> int:
        track = self.tracklist.get(track_id)
        return 0 if track is None else track.n_ch

    def get_length_sec(self, track_id: int) -> float:
        track = self.tracklist.get(track_id)
        return 0.0 if track is None else track.sec

    def get_sample_rate(self, track_id: int) -> int:
        track = self.tracklist.get(track_id)
        return 0 if track is None else track.sr

    def get_format_info(self, track_id: int) -> dict:
        track = self.tracklist.get(track_id)
        if track is None:
            return {"name": "", "sr": 0, "bitDepth": "", "bitrate": ""}
        return track.format_info.to_json()

    def get_global_lufs(self, track_id: int) -> dict:
        track = self.tracklist.get(track_id)
        return json_number(-math.inf if track is None else track.stats.global_lufs)

    def get_rms_db(self, track_id: int) -> dict:
        track = self.tracklist.get(track_id)
        return json_number(-math.inf if track is None else track.stats.rms_db)

    def get_max_peak_db(self, track_id: int) -> dict:
        track = self.tracklist.get(track_id)
        return json_number(-math.inf if track is None else track.stats.max_peak_db)

    def get_guard_clip_stats(self, track_id: int) -> list:
        """reference: lib.rs:492-507."""
        mode = self.tracklist.common_guard_clipping
        track = self.tracklist.get(track_id)
        if track is None:
            return []
        return [
            [ch, f"{mode.display()} by {stat}"]
            for ch, stat in track.format_guard_clip_stats(mode)
        ]

    def get_path(self, track_id: int) -> str:
        track = self.tracklist.get(track_id)
        return "" if track is None else track.path_string()

    def get_file_name(self, track_id: int) -> str:
        return self.tracklist.filename(track_id)
