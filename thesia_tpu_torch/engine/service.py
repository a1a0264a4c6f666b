"""HTTP/WebSocket service exposing the EngineSession command surface.

Port of ``thesia_tpu/engine/service.py``: the same routes, status codes and
bodies, served by the port's standard-library transport (``engine/http.py``)
in place of aiohttp, which the machine with the card does not have.  The
command tables (``COMMANDS``, ``WRITE_COMMANDS``, ``BINARY_COMMANDS``,
``OPTIONAL_ARGS``, ``MISC_COMMANDS``), ``MiscApi`` and ``_jsonable`` are the
original's (``:24-96,422-433``); ``Commands.call`` is its ``handle_command``
(``:139-199``) without the transport, so tests and scripts can drive the
table in process.

Transport analogue of the reference's Tauri IPC (reference:
src-tauri/src/lib.rs:759-816 command registry): JSON commands via
POST /api/<command>, binary tiles as application/octet-stream, backend
events (player-state-changed, menu events) over WebSocket /events.

Where the port differs from the JAX service:
- ``main()`` takes ``--device`` (default ``cuda``; ``cpu`` is the only way
  onto the CPU, and without a card the session raises), limits glibc to one
  malloc arena before the session's threads exist (``limit_malloc_arenas``),
  and starts the process's device warmup in the background once the session
  is built (``start_device_warmup``; the JAX ``main()`` does neither): in
  fresh processes on the card both move the child's first add and apply
  (PERF.md);
- ``/debug/metrics`` reports ``shape_warmer`` with ``failed`` beside the
  JAX keys ``compiled`` and ``idle`` (the JAX warmer only logs a failed job),
  ``kernel_launches``, the launch counts of the port's kernels on the
  engine's path since the process started, and apart from them
  ``warm_kernel_launches``, those of the device warmup and the shape warmer;
- ``/debug/profile`` writes a ``torch.profiler`` Chrome trace
  (``obs.profile_trace``), not an XProf trace;
- a chunked request body gets 411 (``engine/http.py``);
- ``/player/*`` and ``/debug/profile`` answer 400 to a body that is not a
  JSON object, and ``/upload`` to a body that is not multipart, where the
  JAX service raises (500).
"""

from __future__ import annotations

import asyncio
import json
import logging

import numpy as np

from .. import obs
from . import http, images
from .axis_api import AXIS_COMMANDS, AxisApi
from .session import EngineSession

log = logging.getLogger("thesia_tpu_torch.service")

BINARY_COMMANDS = {"get_waveform_tile", "get_spectrogram_tile"}

# commands that mutate engine state — they serialize through the session's
# write worker under the exclusive lock; everything else runs under the
# shared read lock (reference: RwLock'd globals, lib.rs:36-42)
WRITE_COMMANDS = {
    "init", "set_user_settings", "set_open_files_dialog_path",
    "add_tracks", "reload_tracks", "remove_tracks", "apply_track_list_changes",
    "set_dB_range", "set_spec_setting", "set_common_guard_clipping",
    "set_common_normalize",
}

# command name -> (method name, [arg names in order])
COMMANDS = {
    "is_dev": ("is_dev", []),
    "init": ("init", ["colormapRgba"]),
    "set_user_settings": ("set_user_settings", ["userSettings"]),
    "get_open_files_dialog_path": ("get_open_files_dialog_path", []),
    "set_open_files_dialog_path": ("set_open_files_dialog_path", ["path"]),
    "add_tracks": ("add_tracks", ["trackIds", "paths"]),
    "reload_tracks": ("reload_tracks", ["trackIds"]),
    "remove_tracks": ("remove_tracks", ["trackIds"]),
    "apply_track_list_changes": ("apply_track_list_changes", []),
    "find_id_by_path": ("find_id_by_path", ["path"]),
    "get_dB_range": ("get_db_range", []),
    "set_dB_range": ("set_db_range", ["dBRange"]),
    "get_spec_setting": ("get_spec_setting", []),
    "set_spec_setting": ("set_spec_setting", ["specSetting"]),
    "get_common_guard_clipping": ("get_common_guard_clipping", []),
    "set_common_guard_clipping": ("set_common_guard_clipping", ["mode"]),
    "get_common_normalize": ("get_common_normalize", []),
    "set_common_normalize": ("set_common_normalize", ["target"]),
    "get_audio_render_metadata": ("get_audio_render_metadata", ["idChStr"]),
    "get_waveform_tile": ("get_waveform_tile", ["idChStr", "level", "tileIndex"]),
    "get_spectrogram_tile": (
        "get_spectrogram_tile",
        ["idChStr", "levelX", "levelY", "tileX", "tileY"],
    ),
    "get_limiter_gain": ("get_limiter_gain", ["trackId"]),
    "get_max_dB": ("get_max_db", []),
    "get_min_dB": ("get_min_db", []),
    "get_max_track_hz": ("get_max_track_hz", []),
    "get_longest_track_length_sec": ("get_longest_track_length_sec", []),
    "get_channel_counts": ("get_channel_counts", ["trackId"]),
    "get_length_sec": ("get_length_sec", ["trackId"]),
    "get_sample_rate": ("get_sample_rate", ["trackId"]),
    "get_format_info": ("get_format_info", ["trackId"]),
    "get_global_lufs": ("get_global_lufs", ["trackId"]),
    "get_rms_dB": ("get_rms_db", ["trackId"]),
    "get_max_peak_dB": ("get_max_peak_db", ["trackId"]),
    "get_guard_clip_stats": ("get_guard_clip_stats", ["trackId"]),
    "get_path": ("get_path", ["trackId"]),
    "get_file_name": ("get_file_name", ["trackId"]),
    "set_volume_dB": ("set_volume_db", ["volumeDB"]),
    "set_track_player": ("set_track_player", ["trackId", "sec"]),
    "seek_player": ("seek_player", ["sec"]),
    "pause_player": ("pause_player", []),
    "resume_player": ("resume_player", []),
}

OPTIONAL_ARGS = {"sec"}


class MiscApi:
    """Viewer-support commands that exist client-side in the reference."""

    def get_default_colormap(self) -> list:
        from ..render.colormap import default_colormap_rgba8

        return default_colormap_rgba8().reshape(-1).tolist()


MISC_COMMANDS = {"get_default_colormap": ("get_default_colormap", [])}


class Commands:
    """The command table on one session: session commands, then the axis
    commands, then the misc ones, in the JAX service's lookup order."""

    def __init__(self, session: EngineSession):
        self.session = session
        self.axis = AxisApi()
        self.misc = MiscApi()

    def call(self, name: str, body) -> tuple[int, object]:
        """(status, payload) that ``POST /api/<name>`` answers to the parsed
        ``body``: the tile bytes of a binary command, else the JSON object
        ({"result": ...} or {"error": ...})."""
        target = self.session
        spec = COMMANDS.get(name)
        if spec is None:
            spec = AXIS_COMMANDS.get(name)
            target = self.axis
        if spec is None:
            spec = MISC_COMMANDS.get(name)
            target = self.misc
        if spec is None:
            return 404, {"error": f"unknown command {name}"}
        method_name, arg_names = spec
        if not isinstance(body, dict):
            return 400, {"error": "request body must be a JSON object"}
        args = []
        for a in arg_names:
            if a in body:
                args.append(body[a])
            elif a in OPTIONAL_ARGS:
                args.append(None)
            else:
                return 400, {"error": f"missing argument {a} for {name}"}
        method = getattr(target, method_name)
        try:
            # the root of every span the command causes, on any thread
            with obs.root_span("command." + name):
                if target is self.session and name not in WRITE_COMMANDS:
                    # concurrent reads hold the shared lock so they never
                    # observe a half-applied mutation from the write worker
                    with self.session.rw.read():
                        result = method(*args)
                else:
                    result = method(*args)
        except (KeyError, ValueError, AssertionError) as e:
            return 400, {"error": str(e)}
        except (TypeError, AttributeError) as e:
            # wrong-typed args (string where float expected, int idChStr, …)
            # surface from deep in the command body — client errors, not
            # 500s; the same types also flag real engine defects, so the
            # traceback goes to the log
            logging.getLogger(__name__).warning(
                "%s mapped to 400: %r", name, e, exc_info=True
            )
            return 400, {"error": f"invalid argument: {e}"}
        if name in BINARY_COMMANDS:
            return 200, result
        return 200, {"result": _jsonable(result)}


def _kernel_launches(warm: bool = False) -> dict:
    """Launches of the port's kernels in this process (0 on the CPU, where
    the wrappers run their plain versions): the engine's, or with warm those
    of the device warmup and the shape warmer."""
    from ..kernels import dynamics, images, pcm, spec_db

    counts = spec_db.spec_db.warm_launches if warm else spec_db.spec_db.launches
    out = {f"spec_fft_{k}": v for k, v in counts.items()}
    for fn in (pcm.deinterleave_flat, pcm.deinterleave_s24, dynamics.lufs_stats,
               dynamics.limiter_gain, images.quantize_mips):
        out[fn.__name__] = fn.warm_launches if warm else fn.launches
    return out


def _stats_rows(warm: bool = False) -> dict:
    """Where the batched dynamics' rows came from in this process: uploads
    or device wavs, and of these the rows made as float32(gain) times a
    device wav (``scaled``); with warm those of the warmers."""
    from ..dynamics import stats_device as sd

    rows = sd.warm_rows_from if warm else sd.rows_from
    return {**rows, "scaled": sd.warm_scaled_rows if warm else sd.scaled_rows}


def _stats_group_tracks(warm: bool = False) -> dict:
    """{tracks in a K9 group: its launches} in this process; with warm the
    warmers'."""
    from ..dynamics import stats_device as sd

    counts = sd.warm_group_tracks if warm else sd.group_tracks
    return {str(k): v for k, v in sorted(counts.items())}


class EngineService:
    def __init__(
        self,
        session: EngineSession | None = None,
        viewer_dir: str | None = None,
        media_dirs: list[str] | None = None,
        open_paths: list[str] | None = None,
    ):
        self.session = session or EngineSession()
        self.commands = Commands(self.session)
        self.viewer_dir = viewer_dir
        self.media_dirs = media_dirs or []
        # argv file-association paths: handed to the first viewer after its
        # init, like the reference's open-audio-tracks event for argv files
        # (reference: lib.rs:562-619 argv / deep-link open paths)
        self.open_paths = list(open_paths or [])
        self._ws_clients: set[http.WebSocket] = set()
        self._send_tasks: set[asyncio.Task] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: http.HttpServer | None = None
        self._tick_task: asyncio.Task | None = None
        self._routes = {
            "/events": ("GET", self.handle_events_ws),
            "/player/state": ("GET", self.handle_player_tick),
            "/player/attach_pcm": ("POST", self.handle_player_attach_pcm),
            "/player/detach_pcm": ("POST", self.handle_player_detach_pcm),
            "/player/pcm": ("POST", self.handle_player_pcm),
            "/debug/metrics": ("GET", self.handle_metrics),
            "/debug/profile": ("POST", self.handle_profile),
            "/pending_open_paths": ("GET", self.handle_pending_open_paths),
            "/upload": ("POST", self.handle_upload),
            "/media": ("GET", self.handle_list_media),
        }
        self.session.add_listener(self._on_event)

    # -- events ------------------------------------------------------------
    def _on_event(self, name: str, payload) -> None:
        if self._loop is None or not self._ws_clients:
            return
        msg = json.dumps({"event": name, "payload": payload})

        def _send_all() -> None:
            for ws in list(self._ws_clients):
                if ws.closed:
                    self._ws_clients.discard(ws)
                    continue
                task = asyncio.ensure_future(ws.send_str(msg))
                # keep the task referenced until it ends, and retrieve a dead
                # client's exception so it is not reported as never retrieved
                self._send_tasks.add(task)
                task.add_done_callback(self._send_done)

        self._loop.call_soon_threadsafe(_send_all)

    def _send_done(self, task: asyncio.Task) -> None:
        self._send_tasks.discard(task)
        if not task.cancelled():
            task.exception()

    # -- routing -----------------------------------------------------------
    async def handle(self, req: http.Request) -> http.Response | None:
        """The JAX service's router (``make_app``): the routes, then the
        viewer's files; 405 for a known path with another method."""
        path, method = req.path, req.method
        if method == "HEAD":
            method = "GET"
        command = path[5:] if path.startswith("/api/") else ""
        route = self._routes.get(path)
        if command and "/" not in command:
            if method == "POST":
                return await self.handle_command(req, command)
        elif path == "/" and self.viewer_dir and method == "GET":
            return await http.static_response(self.viewer_dir, "index.html")
        elif route is not None and route[0] == method:
            return await route[1](req)
        if self.viewer_dir and method == "GET":
            return await http.static_response(self.viewer_dir, path)
        if (command and "/" not in command) or route is not None or (path == "/" and self.viewer_dir):
            return http.text_response(405, "405: Method Not Allowed")
        return http.text_response(404, "404: Not Found")

    async def _json_body(self, req: http.Request) -> dict:
        """The body of a player or profile request: {} when empty or
        unreadable, 400 when it is not an object."""
        try:
            body = await req.json() if req.can_read_body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            body = {}
        if not isinstance(body, dict):
            raise http.HttpError(400, "request body must be a JSON object")
        return body

    @staticmethod
    async def _executor(fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    # -- handlers ----------------------------------------------------------
    async def handle_command(self, req: http.Request, name: str) -> http.Response:
        if not (name in COMMANDS or name in AXIS_COMMANDS or name in MISC_COMMANDS):
            return http.json_response({"error": f"unknown command {name}"}, 404)
        try:
            body = await req.json() if req.can_read_body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            body = {}
        status, payload = await self._executor(self.commands.call, name, body)
        if isinstance(payload, bytes):
            return http.bytes_response(payload)
        return http.json_response(payload, status)

    async def handle_events_ws(self, req: http.Request) -> None:
        ws = await http.accept_websocket(req)
        self._ws_clients.add(ws)
        try:
            await ws.serve_until_closed()
        finally:
            self._ws_clients.discard(ws)

    async def handle_player_tick(self, _req: http.Request) -> http.Response:
        self.session.player.tick()
        return http.json_response({"result": self.session.player.state()})

    # -- remote audio (browser playback) ------------------------------------
    # The reference plays sound through an in-process cpal stream on the
    # user's machine (src-tauri/src/player/stream.rs:501-639); here the
    # user's machine is the browser, so the viewer attaches its AudioContext
    # as the player's output device and pulls the PCM chunks it schedules
    # via Web Audio.  Single listener, latest attach wins.
    async def handle_player_attach_pcm(self, req: http.Request) -> http.Response:
        body = await self._json_body(req)
        try:
            cfg = await self._executor(lambda: self.session.player.attach_remote_audio(
                int(body.get("sampleRate", 48000)), int(body.get("channels", 2))))
        except (ValueError, TypeError) as e:
            return http.json_response({"error": str(e)}, 400)
        return http.json_response({"result": cfg})

    async def handle_player_detach_pcm(self, _req: http.Request) -> http.Response:
        await self._executor(self.session.player.detach_remote_audio)
        return http.json_response({"result": None})

    async def handle_player_pcm(self, req: http.Request) -> http.Response:
        body = await self._json_body(req)
        try:
            chunk = await self._executor(
                lambda: self.session.player.pull_pcm(int(body.get("frames", 4096))))
        except (ValueError, TypeError) as e:
            return http.json_response({"error": str(e)}, 400)
        return http.bytes_response(chunk)

    async def handle_pending_open_paths(self, _req: http.Request) -> http.Response:
        """One-shot: argv/file-association paths the viewer should open."""
        paths, self.open_paths = self.open_paths, []
        return http.json_response({"result": paths})

    async def handle_metrics(self, _req: http.Request) -> http.Response:
        """Per-stage timing summary (decode, spec recompute/quantize, tile
        encode, a span per command), the shape warmer and the jobs it ran by
        kind, the tiles' region fetches, the port's kernel launches, where
        the batched dynamics' rows came from, and the tracks each K9 launch
        took."""
        out = obs.summary()
        warmer = self.session.tm.shape_warmer
        out["shape_warmer"] = {
            "compiled": warmer.compiled_count,
            "idle": warmer._pending is None,
            "failed": warmer.failed_count,
        }
        out["warm_jobs"] = {kind: len(ms) for kind, ms in warmer.job_ms.items()}
        out["region_fetches"] = images.region_fetches
        out["kernel_launches"] = _kernel_launches()
        out["warm_kernel_launches"] = _kernel_launches(warm=True)
        out["stats_rows"] = _stats_rows()
        out["warm_stats_rows"] = _stats_rows(warm=True)
        out["stats_group_tracks"] = _stats_group_tracks()
        out["warm_stats_group_tracks"] = _stats_group_tracks(warm=True)
        return http.json_response({"result": out})

    async def handle_profile(self, req: http.Request) -> http.Response:
        """One-shot profiler capture: POST {"durationMs": 1000} ->
        {"result": "<trace dir>"} holding trace.json (Chrome trace format)."""
        body = await self._json_body(req)
        try:
            duration = float(body.get("durationMs", 1000.0))
        except (TypeError, ValueError) as e:
            return http.json_response({"error": str(e)}, 400)
        try:
            path = await self._executor(obs.profile_trace, duration)
        except Exception as e:
            log.exception("profiler capture failed")
            return http.json_response({"error": str(e)}, 500)
        return http.json_response({"result": path})

    def _prune_stale_uploads(self, updir, max_age_s: float = 24 * 3600.0) -> None:
        """Per-upload directories would otherwise accumulate without bound.
        Prune old ones, but NEVER a directory whose file backs a live track
        (reload_tracks re-reads from the path)."""
        import shutil
        import time as _time

        live = set()
        try:
            for tid in self.session.tracklist.all_ids():
                track = self.session.tracklist.get(tid)
                if track is not None:
                    live.add(track.path.parent)
        except Exception:
            return  # never let cleanup break an upload
        now = _time.time()
        try:
            for sub in updir.iterdir():
                # resolve before the live check: track paths are resolved, so
                # a symlinked tmpdir would defeat the protection
                try:
                    resolved = sub.resolve()
                except OSError:
                    continue
                if not sub.is_dir() or resolved in live:
                    continue
                if now - sub.stat().st_mtime > max_age_s:
                    shutil.rmtree(sub, ignore_errors=True)
        except OSError:
            pass

    async def handle_upload(self, req: http.Request) -> http.Response:
        """Accept an uploaded audio file, store it, return its server path."""
        import tempfile
        from pathlib import Path

        field = await http.MultipartReader(req).next()
        if field is None or field.name != "file":
            return http.json_response({"error": "expected multipart field 'file'"}, 400)
        filename = Path(field.filename or "upload.bin").name
        updir = Path(tempfile.gettempdir()) / "thesia_tpu_torch_uploads"
        updir.mkdir(exist_ok=True)
        # off the event loop: rmtree of a stale multi-GB upload would stall
        # every concurrent request
        await self._executor(self._prune_stale_uploads, updir)
        # unique per-upload subdirectory: same-named uploads must not
        # overwrite each other; the original basename is kept for the UI
        dest = Path(tempfile.mkdtemp(dir=updir)) / filename
        with open(dest, "wb") as f:
            while True:
                chunk = await field.read_chunk()
                if not chunk:
                    break
                f.write(chunk)
        return http.json_response({"result": str(dest)})

    async def handle_list_media(self, _req: http.Request) -> http.Response:
        """List audio files in the configured media directories."""
        from pathlib import Path

        exts = {".wav", ".flac", ".mp3", ".m4a", ".aac", ".ogg", ".oga", ".opus"}
        out = []
        for d in self.media_dirs:
            p = Path(d)
            if not p.is_dir():
                continue
            for f in sorted(p.rglob("*")):
                if f.is_file() and (f.suffix.lower() in exts or f.suffix == ""):
                    out.append(str(f))
        return http.json_response({"result": out})

    # -- lifecycle ---------------------------------------------------------
    async def _player_loop(self):
        while True:
            await asyncio.sleep(0.02)  # reference tick: 20 ms (player.rs:23)
            try:
                self.session.player.tick()
            except Exception:
                # one bad tick (e.g. an audio backend hiccup) must not kill
                # playback progress and end-of-track events forever
                log.exception("player tick failed")

    async def start(self, host: str = "127.0.0.1", port: int = 8707) -> int:
        """Listen on the running loop and start the player tick; returns the
        bound port."""
        self._loop = asyncio.get_running_loop()
        self._server = http.HttpServer(self.handle)
        bound = await self._server.start(host, port)
        self._tick_task = asyncio.ensure_future(self._player_loop())
        return bound

    async def stop(self) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()
        if self._server is not None:
            await self._server.close()

    def run(self, host: str = "127.0.0.1", port: int = 8707) -> None:
        """Serve until SIGINT or SIGTERM."""
        import signal

        async def main():
            bound = await self.start(host, port)
            print(f"thesia_tpu_torch engine listening on http://{host}:{bound}", flush=True)
            log.info("listening on http://%s:%s", host, bound)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await stop.wait()
            await self.stop()

        asyncio.run(main())


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def start_device_warmup(session: EngineSession) -> None:
    """Start the process's device warmup in the background once the session
    is built (the JAX package's ``device_warmup`` names service startup as
    its background caller), unless the warmer is off."""
    from .. import runtime
    from ..dsp import precompile

    if precompile.enabled():
        runtime.device_warmup(background=True, device=session.device)


def limit_malloc_arenas() -> None:
    """``mallopt(M_ARENA_MAX, 1)``: threads made from here on (the executor's,
    the write worker's) share the main thread's malloc arena.  glibc only;
    elsewhere nothing happens."""
    import ctypes

    try:
        ctypes.CDLL(None).mallopt(-8, 1)  # M_ARENA_MAX
    except (OSError, AttributeError):
        log.info("mallopt is not available; malloc arenas left as they are")


def main():
    import argparse
    import faulthandler
    import os
    import signal

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps all stacks
    logging.basicConfig(
        level=os.environ.get("THESIA_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    default_viewer = os.path.join(os.path.dirname(os.path.dirname(__file__)), "viewer")
    p = argparse.ArgumentParser(description="thesia_tpu_torch engine service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8707)
    p.add_argument("--viewer-dir", default=default_viewer)
    p.add_argument("--media-dir", action="append", default=[], help="directory listed in the viewer's server-media dropdown")
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: cuda (default; a missing card is an error) or cpu")
    p.add_argument(
        "paths", nargs="*",
        help="audio files to open in the first connecting viewer "
        "(== the reference's argv file-association open)",
    )
    args = p.parse_args()
    limit_malloc_arenas()
    session = EngineSession(device=args.device)
    start_device_warmup(session)
    EngineService(
        session, viewer_dir=args.viewer_dir, media_dirs=args.media_dir, open_paths=args.paths,
    ).run(args.host, args.port)


if __name__ == "__main__":
    main()
