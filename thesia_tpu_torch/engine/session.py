"""EngineSession: the command surface of the port.

Port of ``thesia_tpu/engine/session.py`` with the same names, arguments and
JSON payloads: ``init``, ``is_dev``, ``set_user_settings``,
``get/set_open_files_dialog_path``, ``add_tracks``, ``reload_tracks``,
``remove_tracks``, ``apply_track_list_changes``, ``find_id_by_path``,
``get/set_spec_setting``, ``get/set_db_range``,
``get/set_common_guard_clipping``, ``get/set_common_normalize``,
``get_audio_render_metadata``, ``get_spectrogram_tile``,
``get_waveform_tile``, ``get_limiter_gain``, the getters (``get_max_db`` ...
``get_file_name``), the player commands (``set_volume_db``,
``set_track_player``, ``seek_player``, ``pause_player``, ``resume_player``;
the ``player`` is the port's copy of ``thesia_tpu/player/``, fed one
``track.audio`` snapshot per load, told the maximum sample rate after every
apply, and made to reload its track when a normalize or guard switch lands),
``add_listener``, ``spec_switch_pending`` and ``settings_settled``.

The shape warmer (``dsp/precompile.py``) gets the JAX package's head start:
``add_tracks`` reads each file's shape from its header (``io/probe.py``) and
submits the current and neighbouring settings' warm jobs before the decode
(``_warm_from_headers``); a deferred ``set_spec_setting`` builds the new
setting's tables on the switch worker, off the write lock, before it takes
the lock (``_precompile_setting``); ``init`` supersedes the old warmer's
queue.  Where the port differs: ``_precompile_setting`` does nothing when
``THESIA_PRECOMPILE`` is ``0`` (the JAX package runs it regardless), so
that the variable turns every warm off.

``add_tracks`` prefetches every WAV of ``_PREFETCH_MIN_FILE_BYTES`` or more
as the JAX package does: two ``wav-prefetch`` workers read the file (the
decoder takes the same bytes) and upload its interleaved s16, s24 or f32
payload while decode and stats run; the write worker adopts the upload into
the analyzer's wav cache once the decoded samples vouch for it, or counts the
prefetch in ``prefetch_failed`` and lets the ordinary upload run: the
manager's device-sample store (``tm.samples``, ``engine/samples.py``) takes
the pending uploads and decides them.  The batched stats of an add, and those
after a normalize or guard switch, read each track's samples from that store,
as the spectrogram does, so the stats upload nothing the spectrogram would
not.

Writes run on one write-worker thread under the exclusive side of a
readers-writer lock (the reference's write-lock worker, interface.rs:12-56).
As in the JAX package, ``apply_track_list_changes``, ``set_spec_setting``,
``set_common_normalize`` and ``set_common_guard_clipping`` return at dispatch
unless ``THESIA_DEFER_SETTINGS`` is ``0`` or the caller passes
``defer=False``: one serial switch worker applies them, the latest generation
of each kind wins, and metadata reports ``isComputing`` until every switch
has landed and every image has streamed to the host.  The port's switch has
no compile phase (the kernels have no per-shape compile), and its deferred
apply skips the range probe when a later range pass has already superseded
the apply's epoch (the JAX package probes anyway, which can hold the switch
worker for a whole spectrogram compute).

The session runs on the card (``device="cuda"``) unless the caller asks for
the CPU with ``device="cpu"``; a card that is not there raises, nothing falls
back to the CPU.

Payload conventions match the reference wire format: camelCase JSON,
JsonNumber-tagged non-finite floats (interface.rs:103-130), "id_ch" strings
(interface.rs:132-146), binary tiles.
"""

from __future__ import annotations

import concurrent.futures
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
from .. import obs
from ..obs import RwLock, span
from ..parallel.sharding import active_spec_sharding
from ..player.player import PLAY_BIG_JUMP_SEC, PLAY_JUMP_SEC, Player
from ..render.tiles import RenderTileCache, encode_waveform_tile, spectrogram_tile_header
from .. import runtime
from ..runtime import resolve_device
from .manager import TrackManager
from .track import TrackList

OPEN_FILES_DIALOG_PATH_KEY = "openFilesDialogPath"

# LOD levels are log2 factors: beyond 48 the shifts overflow int64/u32 math
_MAX_LOD_LEVEL = 48

log = logging.getLogger(__name__)


def _defer_default() -> bool:
    """The JAX package's default: deferred unless THESIA_DEFER_SETTINGS=0."""
    return os.environ.get("THESIA_DEFER_SETTINGS", "1") != "0"


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
        self.tm = TrackManager(self.device)
        self.tracklist = TrackList(self.device, samples=self.tm.samples)
        self.tile_cache = RenderTileCache()
        self.spec_setting = SpecSetting()
        self._settings_dir = Path(
            settings_dir or os.environ.get("THESIA_TPU_CONFIG", "~/.thesia_tpu")
        ).expanduser()
        self._write_worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="write-lock-worker"
        )
        # readers-writer lock mirroring the reference's RwLock'd globals
        # (lib.rs:36-42): the write worker takes .write() around every
        # mutation
        self.rw = RwLock()
        # serializes the settings JSON read-modify-writes
        self._store_lock = threading.Lock()
        self._listeners: list = []
        # big-WAV read + upload workers (eager: a lazy pool raced concurrent
        # add_tracks calls); concurrent.futures joins them at exit
        self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="wav-prefetch"
        )
        # deferred switches: ONE serial worker (cross-kind FIFO keeps the
        # final state that of the synchronous order), latest generation wins
        # per kind; "range" is the deferred apply's reconcile
        self._spec_switch_lock = threading.Lock()
        self._spec_switch_cond = threading.Condition(self._spec_switch_lock)
        self._switch_gen = {"spec": 0, "guard": 0, "normalize": 0, "range": 0}
        self._switch_applied = {"spec": 0, "guard": 0, "normalize": 0, "range": 0}
        self._spec_switch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="settings-switch"
        )
        # reported (target) values of the deferred knobs: read-back sees the
        # target right after dispatch, the tracklist the applied state
        self._guard_target = self.tracklist.common_guard_clipping
        self._normalize_target = self.tracklist.common_normalize
        self.player = Player(self._player_get_track, self._emit_player_state)

    # -- events ------------------------------------------------------------
    def add_listener(self, fn) -> None:
        """fn(event_name: str, payload) called for backend events."""
        self._listeners.append(fn)

    def _emit(self, name: str, payload) -> None:
        for fn in list(self._listeners):
            try:
                fn(name, payload)
            except Exception:
                log.warning("event listener failed on %s", name, exc_info=True)

    def _emit_player_state(self, event: dict) -> None:
        self._emit("player-state-changed", event)

    def _player_get_track(self, track_id: int):
        track = self.tracklist.get(track_id)
        if track is None:
            return None
        # one snapshot of track.audio: a write command rebinds it (gain,
        # guard, reload publish a new Audio), so separate reads could mix one
        # Audio's samples with another's rate or length
        audio = track.audio
        return audio.interleaved_samples(), audio.n_ch, audio.sr, audio.sec

    # -- write serialization ----------------------------------------------
    def _write(self, fn):
        """Run fn on the write worker under the exclusive lock and wait; the
        process's device warmup pauses meanwhile (runtime.foreground)."""

        def locked():
            with runtime.foreground(), self.rw.write():
                return fn()

        try:
            fut = self._write_worker.submit(obs.carry(locked))
        except RuntimeError:
            # the interpreter is exiting and has already stopped the write
            # worker while the switch pool still runs a queued switch: finish
            # it on this thread, under the same exclusive lock
            return locked()
        return fut.result()

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
    def is_dev(self) -> bool:
        return bool(os.environ.get("THESIA_TPU_DEV"))

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
                self.tm.images.shutdown()
                # supersede the old warmer's queue: it warms tables of a
                # manager that is going away
                self.tm.shape_warmer.submit([])
                self.tm = TrackManager(self.device)
                self.tracklist = TrackList(self.device, samples=self.tm.samples)
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

        # init supersedes every in-flight deferred switch: a stale pre-init
        # target must not re-apply over the freshly restored state
        with self._spec_switch_cond:
            init_gens = {}
            for kind in self._switch_gen:
                self._switch_gen[kind] += 1
                self._switch_applied[kind] = self._switch_gen[kind]
                init_gens[kind] = self._switch_gen[kind]
            self._spec_switch_cond.notify_all()
        user_settings = self._write(work)
        with self._spec_switch_lock:
            # reset a reported target only if no newer switch was dispatched
            # while init ran: that switch owns the target and applies it
            if self._switch_gen["guard"] == init_gens["guard"]:
                self._guard_target = self.tracklist.common_guard_clipping
            if self._switch_gen["normalize"] == init_gens["normalize"]:
                self._normalize_target = self.tracklist.common_normalize
            if self._switch_gen["spec"] == init_gens["spec"]:
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

    def get_open_files_dialog_path(self) -> str:
        return self._load_store("paths.json").get(OPEN_FILES_DIALOG_PATH_KEY, "")

    def set_open_files_dialog_path(self, path: str) -> None:
        with self._store_lock:
            store = self._load_store("paths.json")
            store[OPEN_FILES_DIALOG_PATH_KEY] = path
            self._save_store("paths.json", store)

    # ======================================================================
    # track CRUD
    def add_tracks(self, track_ids: list[int], paths: list[str]) -> list[int]:
        if not track_ids or len(track_ids) != len(paths):
            raise ValueError("trackIds and paths must be equal-length non-empty lists")
        # big WAVs: read and upload the interleaved payload now, while the
        # write worker decodes and computes stats
        prefetches = self._start_wav_prefetch(track_ids, paths)
        # the shape warmer's head start: probe the files' headers for (n_ch,
        # n, sr) and warm the current and nearest-knob settings while the
        # add decodes
        self._warm_from_headers(paths)

        def work():
            samples = self.tm.samples
            samples.expect({tid: uf for tid, (_rf, uf) in prefetches.items()})
            added = self.tracklist.add_tracks(
                list(track_ids), list(paths),
                preread={tid: rf for tid, (rf, _uf) in prefetches.items()},
            )
            samples.adopt_pending({tid: self.tracklist[tid] for tid in added})
            self.tm.add_tracks(self.tracklist, added)
            self.tile_cache.invalidate_all()
            return added

        return self._write(work)

    _PREFETCH_MIN_FILE_BYTES = 64 << 20

    def _warm_from_headers(self, paths) -> None:
        from ..io.probe import probe_shape

        probed = []
        for path in paths:
            got = probe_shape(path)
            if got is not None:
                n_ch, n, sr = got
                probed.append((str(path), (n_ch, n), sr))
        if not probed:
            return
        # snapshot the tracklist under the read lock: this runs on the
        # caller's thread before the add's write, concurrently with any
        # other client's write command
        with self.rw.read():
            existing = [
                (tid, tuple(self.tracklist[tid].audio.wavs.shape), self.tracklist[tid].sr)
                for tid in self.tracklist.all_ids()
            ]
        self.tm.warm_for_pending_add(existing, probed)

    @staticmethod
    def _read_file(path):
        with span("prefetch.read"), open(path, "rb") as f:
            return f.read()

    def _start_wav_prefetch(self, track_ids, paths):
        futs = {}
        for tid, path in zip(track_ids, paths):
            try:
                if not str(path).lower().endswith(".wav"):
                    continue
                if os.path.getsize(path) < self._PREFETCH_MIN_FILE_BYTES:
                    continue
            except OSError:
                continue
            # two chained tasks: the read future also goes to the decoder (one
            # read of the file); FIFO order schedules every read before the
            # upload that waits on it, so the two workers cannot deadlock
            try:
                read_fut = self._prefetch_pool.submit(obs.carry(self._read_file), path)
                up_fut = self._prefetch_pool.submit(obs.carry(self._prefetch_one), read_fut)
            except RuntimeError:
                # the interpreter is exiting: the decoder reads the file itself
                break
            futs[tid] = (read_fut, up_fut)
        return futs

    def _prefetch_one(self, read_fut):
        from ..io.wav import WAVE_FORMAT_IEEE_FLOAT, WAVE_FORMAT_PCM, WavError, probe_wav

        data = read_fut.result()
        try:
            fmt_tag, bits, n_ch, _sr, payload = probe_wav(data)
        except WavError:
            return None
        fmt = {
            (WAVE_FORMAT_PCM, 16): "s16",
            (WAVE_FORMAT_PCM, 24): "s24",
            (WAVE_FORMAT_IEEE_FLOAT, 32): "f32",
        }.get((fmt_tag, bits))
        if fmt is None:
            return None
        with span("prefetch.upload"):
            return self.tm.spec_analyzer.upload_interleaved_pcm(payload, n_ch, fmt)

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

    def apply_track_list_changes(self, *, defer: bool | None = None) -> list[str]:
        """Recompute the global dB range and (re)quantize images after a
        tracklist change (reference: lib.rs:229-248 / mod.rs:102-230).

        Deferred (the default): returns at dispatch.  The manager composes
        the new range on the device and quantizes the fresh tracks under it;
        the did-the-range-move probe, which waits for their spectrograms,
        runs on the switch pool, and only a range that moved requantizes the
        pre-existing tracks in a follow-up write.  defer=False keeps the
        synchronous reference semantics."""
        if defer is None:
            defer = _defer_default()
        if not defer:
            def work_sync():
                updated_ids, sr = self.tm.apply_track_list_changes(self.tracklist)
                return self.tracklist.id_ch_tuples_from(sorted(updated_ids)), sr

            id_ch_tuples, sr = self._write(work_sync)
            if id_ch_tuples:
                self.tile_cache.invalidate_spectrogram()
            self.player.set_sr(sr)
            return [format_id_ch(i, c) for i, c in id_ch_tuples]

        # the gen is assigned INSIDE the write: two concurrent applies must
        # see gen order == write order == range-epoch order
        gen_cell: list[int] = []

        def work():
            with self._spec_switch_lock:
                self._switch_gen["range"] += 1
                gen_cell.append(self._switch_gen["range"])
            updated_ids, sr, probe_info = self.tm.apply_track_list_changes_deferred(
                self.tracklist
            )
            return self.tracklist.id_ch_tuples_from(sorted(updated_ids)), sr, probe_info

        try:
            id_ch_tuples, sr, probe_info = self._write(work)
        except Exception:
            if gen_cell:
                self._mark_applied("range", gen_cell[0])
            raise
        gen = gen_cell[0]
        if id_ch_tuples:
            self.tile_cache.invalidate_spectrogram()
        self.player.set_sr(sr)
        if probe_info is None:
            self._mark_applied("range", gen)
        else:
            self._spec_switch_pool.submit(obs.carry(self._reconcile_range), gen, probe_info)
        return [format_id_ch(i, c) for i, c in id_ch_tuples]

    def _reconcile_range(self, gen: int, probe_info) -> None:
        """Background half of the deferred apply: run the range probe off the
        write lock, then requantize the pre-existing tracks iff the range
        moved.  Latest wins: a newer apply or init supersedes by generation,
        any later range pass (settings, dB range, colormap, sync apply) by
        range epoch -- and then the probe is not run at all."""
        probe, epoch, fresh_ids = probe_info
        try:
            if self._superseded("range", gen) or epoch != self.tm._range_epoch:
                return
            try:
                moved = probe()
            except Exception:
                # can't know -> assume moved; the requantize is idempotent
                # under the current range and epoch-guarded against churn
                log.warning("deferred apply range probe failed", exc_info=True)
                moved = True
            if not self._superseded("range", gen):
                def work():
                    if self._superseded("range", gen):
                        return False
                    if moved:
                        return self.tm.reconcile_range(self.tracklist, epoch, fresh_ids)
                    # unmoved: the fresh rows sit at the applied value
                    self.tm.confirm_range_unmoved(epoch)
                    return False

                if self._write(work):
                    self.tile_cache.invalidate_spectrogram()
        except Exception:
            log.warning("deferred apply reconcile failed", exc_info=True)
            self._emit("settings-switch-failed", {"applyTrackListChanges": True})
        finally:
            self._mark_applied("range", gen)

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

    def set_spec_setting(
        self, spec_setting: dict | SpecSetting, *, defer: bool | None = None
    ) -> None:
        """Switch the spectrogram settings.

        Deferred (the default): validates, records the target (read back at
        once by get_spec_setting) and returns; the switch worker applies it
        under the write lock, and until it lands metadata reports
        isComputing and tiles keep serving the old revision.  Rapid switches
        supersede each other (latest wins).  defer=False blocks until the
        switch has been applied and raises if it failed."""
        if isinstance(spec_setting, dict):
            spec_setting = SpecSetting.from_json(spec_setting)
        spec_setting.validated()
        if defer is None:
            defer = _defer_default()
        with self._spec_switch_lock:
            # target + generation assigned together: two racing clients must
            # not end with one's setting applied and the other's reported
            self.spec_setting = spec_setting
            self._switch_gen["spec"] += 1
            gen = self._switch_gen["spec"]
        if defer:
            self._spec_switch_pool.submit(obs.carry(self._apply_spec_setting), gen, spec_setting,
                                          True)
        else:
            self._apply_spec_setting(gen, spec_setting, False)

    def _superseded(self, kind: str, gen: int) -> bool:
        with self._spec_switch_lock:
            return gen != self._switch_gen[kind]

    def spec_switch_pending(self) -> bool:
        """True while any deferred switch (spec, guard, normalize, or a
        deferred apply's range reconcile) is still queued."""
        with self._spec_switch_lock:
            return any(self._switch_applied[k] < self._switch_gen[k] for k in self._switch_gen)

    def settings_settled(self, timeout: float | None = None) -> bool:
        """Block until every queued switch has been applied or superseded;
        False if the timeout ran out first."""
        with self._spec_switch_cond:
            return self._spec_switch_cond.wait_for(
                lambda: all(self._switch_applied[k] >= self._switch_gen[k] for k in self._switch_gen),
                timeout=timeout,
            )

    def _mark_applied(self, kind: str, gen: int) -> None:
        with self._spec_switch_cond:
            if gen > self._switch_applied[kind]:
                self._switch_applied[kind] = gen
            self._spec_switch_cond.notify_all()

    def _apply_spec_setting(self, gen: int, setting: SpecSetting, deferred: bool) -> None:
        try:
            if self._superseded("spec", gen):
                return
            if deferred:
                # build the new setting's tables with no session lock held:
                # tile serving and other commands proceed, a newer switch
                # stops it between jobs
                try:
                    self._precompile_setting(setting, gen)
                except Exception:
                    log.warning("settings precompile failed; the switch builds "
                                "its tables inline", exc_info=True)
            if self._superseded("spec", gen):
                return

            def work():
                if self._superseded("spec", gen):
                    return False
                self.tm.set_setting(self.tracklist, setting)
                return True

            try:
                applied = self._write(work)
            except Exception:
                # log, surface an event, and roll the reported target back
                # to the engine's actual setting
                log.warning("deferred settings switch failed", exc_info=True)
                with self._spec_switch_lock:
                    if gen == self._switch_gen["spec"]:
                        self.spec_setting = self.tm.setting
                self._emit("settings-switch-failed", {"specSetting": setting.to_json()})
                if not deferred:
                    raise
                return
            if applied:
                self.tile_cache.invalidate_spectrogram()
        finally:
            self._mark_applied("spec", gen)

    def _precompile_setting(self, setting: SpecSetting, gen: int) -> None:
        from ..dsp import precompile

        if not precompile.enabled():
            return
        with self.rw.read():
            items = [
                (tid, tuple(self.tracklist[tid].audio.wavs.shape), self.tracklist[tid].sr)
                for tid in self.tracklist.all_ids()
            ]
        if not items:
            return
        tm = self.tm
        jobs = precompile.spec_jobs_for(tm.spec_analyzer, items, setting, active_spec_sharding())
        # pause the background warmer: this warm IS the interactive work
        with tm.shape_warmer.interactive():
            for make in jobs:
                if self._superseded("spec", gen):
                    return
                tm.shape_warmer.run_now(make)

    # ======================================================================
    # dynamics
    def get_common_guard_clipping(self) -> str:
        # the TARGET: read-back right after a deferred dispatch sees the
        # requested mode, not the not-yet-switched tracklist state
        return self._guard_target.value

    def set_common_guard_clipping(
        self, mode: str | GuardClippingMode, *, defer: bool | None = None
    ) -> None:
        """Switch the guard-clipping mode: every track is re-derived from its
        original samples, then every spectrogram and image is recomputed.
        Same deferred contract as set_spec_setting; a failure leaves the
        mode as it was (and raises when not deferred)."""
        mode = GuardClippingMode(mode)
        self._dispatch_common_switch("guard", mode, defer)

    def get_common_normalize(self) -> dict:
        return self._normalize_target.to_json()

    def set_common_normalize(
        self, target: dict | NormalizeTarget, *, defer: bool | None = None
    ) -> None:
        """Switch the common normalize target; as set_common_guard_clipping."""
        if isinstance(target, dict):
            target = NormalizeTarget.from_json(target)
        self._dispatch_common_switch("normalize", target, defer)

    def _dispatch_common_switch(self, kind: str, value, defer: bool | None) -> None:
        if defer is None:
            defer = _defer_default()
        with self._spec_switch_lock:
            if kind == "guard":
                self._guard_target = value
            else:
                self._normalize_target = value
            self._switch_gen[kind] += 1
            gen = self._switch_gen[kind]
        if defer:
            self._spec_switch_pool.submit(obs.carry(self._apply_common_switch), kind, gen, value,
                                          True)
        else:
            self._apply_common_switch(kind, gen, value, False)

    def _apply_common_switch(self, kind: str, gen: int, value, deferred: bool) -> None:
        try:
            if self._superseded(kind, gen):
                return

            def work():
                if self._superseded(kind, gen):
                    return False
                if kind == "guard":
                    self.tracklist.set_common_guard_clipping(value)
                else:
                    self.tracklist.set_common_normalize(value)
                self.tm.update_all_specs_imgs(self.tracklist)
                return True

            try:
                applied = self._write(work)
            except Exception:
                # log, surface an event, and roll the reported target back
                # to the tracklist's actual state
                log.warning("deferred %s switch failed", kind, exc_info=True)
                with self._spec_switch_lock:
                    if gen == self._switch_gen[kind]:
                        if kind == "guard":
                            self._guard_target = self.tracklist.common_guard_clipping
                        else:
                            self._normalize_target = self.tracklist.common_normalize
                payload_key = "commonGuardClipping" if kind == "guard" else "commonNormalize"
                payload_val = value.value if kind == "guard" else value.to_json()
                self._emit("settings-switch-failed", {payload_key: payload_val})
                if not deferred:
                    raise
                return
            if applied:
                self.tile_cache.invalidate_all()
                self.player.set_track(None, None)
        finally:
            self._mark_applied(kind, gen)

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
        # the shape is known as soon as the quantize is dispatched
        shape = self.tm.images.geometry(track_id)
        md = self.tile_cache.metadata(len(wav), track.sr, track.sec, is_clipped, shape)
        # still streaming to the host, or a deferred switch in flight: the
        # viewer keeps polling and picks up the new revision when it lands
        md["isComputing"] = self.tm.images.is_computing(track_id) or self.spec_switch_pending()
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

    # ======================================================================
    # player
    def set_volume_db(self, volume_db: float) -> None:
        self.player.set_volume_db(_as_finite(volume_db, "volumeDB"))

    def set_track_player(self, track_id: int, sec: float | None = None) -> None:
        if sec is not None:
            sec = _as_finite(sec, "sec")
        if self.tracklist.get(track_id) is not None:
            self.player.max_sec = self.tracklist.max_sec
            self.player.set_track(track_id, sec)

    def seek_player(self, sec: float) -> None:
        sec = _as_finite(sec, "sec")
        self.player.max_sec = self.tracklist.max_sec
        self.player.seek(sec)

    def pause_player(self) -> None:
        self.player.pause()

    def resume_player(self) -> None:
        self.player.resume()
