"""Playback state machine.

Host copy of ``thesia_tpu/player/player.py``; pinned statement for
statement by ``tests/test_torch_hostcopies.py``, apart from
``set_volume_db``: the JAX package's ``amp_from_db`` (10^(0.05 x), its
exponent in float64, the power in float32 under jax's default precision) is
written out in torch, which gives the same gain bit for bit.

reference: src-tauri/src/player.rs + player/state.rs.  The audio-device layer
is abstracted behind OutputSink; in headless/server deployments the
WallClockSink advances the play position in real time without hardware (the
UI extrapolates position from emitted anchors either way, reference:
src/hooks/usePlayer.ts:44-52).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

PLAY_JUMP_SEC = 1.0
PLAY_BIG_JUMP_SEC = 5.0

# a remote (browser) audio client that stops pulling while the track plays
# is gone (tab closed, network drop): fall back to the local output path so
# the position keeps advancing like the reference's always-on device stream
REMOTE_STALE_SEC = 10.0
MAX_PULL_FRAMES = 65536  # bounds one /player/pcm response to 512 KiB stereo

_PCM_HEADER = struct.Struct("<IIIIdII")  # nFrames ch sr flags posSec version pad


def encode_pcm_chunk(
    data: np.ndarray,
    sample_rate: int,
    position_sec: float,
    cursor_version: int,
    is_playing: bool,
    ended: bool,
) -> bytes:
    """Binary wire chunk for the viewer's Web Audio scheduler: 32 B header
    (u32 nFrames, u32 channels, u32 sampleRate, u32 flags[bit0 playing,
    bit1 ended], f64 positionSec, u32 cursorVersion, u32 pad) + interleaved
    f32le frames.  Decoded by viewer/js/api.js decodePcmChunk."""
    n, ch = data.shape
    flags = (1 if is_playing else 0) | (2 if ended else 0)
    header = _PCM_HEADER.pack(
        n, ch, int(sample_rate), flags, float(position_sec),
        int(cursor_version) & 0xFFFFFFFF, 0,
    )
    return header + np.ascontiguousarray(data, np.float32).tobytes()


@dataclasses.dataclass
class PlaybackData:
    """reference: player/state.rs:42-67."""

    track_id: Optional[int] = None
    samples: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32)
    )
    input_channels: int = 0
    sample_rate: int = 0
    position_frame: float = 0.0
    cursor_version: int = 0
    volume: float = 1.0
    is_playing: bool = False

    @property
    def total_frames(self) -> int:
        if self.input_channels == 0:
            return 0
        return len(self.samples) // self.input_channels

    def position_sec(self) -> float:
        """reference: player/state.rs:150-157."""
        if len(self.samples) == 0 or self.input_channels == 0 or self.sample_rate == 0:
            return 0.0
        clamped = min(max(self.position_frame, 0.0), float(self.total_frames))
        return clamped / self.sample_rate


class WallClockSink:
    """Advances the playhead in real time without an audio device."""

    def advance(self, playback: PlaybackData, anchor: float) -> tuple[float, bool]:
        """Returns (new position_frame, reached_end)."""
        now = time.monotonic()
        elapsed = now - anchor
        pos = playback.position_frame + elapsed * playback.sample_rate
        total = float(playback.total_frames)
        if pos >= total:
            return total, True
        return pos, False


class Player:
    """Single-track player; commands mirror PlayerCommand (player.rs:29-45)."""

    def __init__(
        self,
        get_track: Callable,
        emit: Callable[[dict], None] | None = None,
        output: str | None = None,
    ):
        """get_track(track_id) -> None | (interleaved f32, n_ch, sr, sec);
        emit(state_event_dict) publishes 'player-state-changed'.

        output: "auto" (default; real output stream — a paced null sink in
        headless containers) or "off" (wall-clock position only).  Env
        override THESIA_AUDIO_OUTPUT."""
        self._get_track = get_track
        self._emit = emit or (lambda e: None)
        self.playback = PlaybackData()
        self.max_sec = 0.0
        self.requested_sr = 0
        self.error = ""
        self.lock = threading.Lock()
        self._engine = None
        # True when attach_remote_audio built the engine on demand for a
        # browser client in output="off" mode: detach must then tear the
        # engine back down instead of silently converting the deployment's
        # explicit "off" into a live local output stream
        self._engine_from_attach = False
        mode = output or os.environ.get("THESIA_AUDIO_OUTPUT", "auto")
        if mode != "off":
            try:
                from .stream import OutputEngine

                self._engine = OutputEngine(self.playback, self.lock)
                self._engine.ensure_stream(0)
            except Exception:
                self._engine = None
        self._sink = WallClockSink()
        self._anchor = time.monotonic()
        self._last_event: dict | None = None
        self._end_seen = False

    # -- internal ----------------------------------------------------------
    @property
    def output_engine(self):
        return self._engine

    def _sync_position(self) -> None:
        if self._engine is not None and self._engine.is_active():
            # the stream callback owns position_frame (stream.rs:442-499);
            # with NO live stream (device lost, rebuild failing) fall
            # through to the wall clock so position/is_playing stay honest
            self._anchor = time.monotonic()
            return
        if self.playback.is_playing:
            pos, ended = self._sink.advance(self.playback, self._anchor)
            self.playback.position_frame = pos
            if ended:
                self.playback.is_playing = False
        self._anchor = time.monotonic()

    def _snapshot(self) -> dict:
        return {
            "isPlaying": self.playback.is_playing,
            "positionSec": self.playback.position_sec(),
            "eventTimeMs": int(time.time() * 1000),
            "trackId": self.playback.track_id,
            "err": self.error,
        }

    def _emit_state(self) -> None:
        event = self._snapshot()
        self._last_event = event
        self._emit(event)

    # -- remote (browser) audio ---------------------------------------------
    # The deployable last hop the reference gets from its in-process cpal
    # stream (stream.rs:501-639): a viewer attaches its AudioContext as the
    # output device and pulls PCM chunks it schedules via Web Audio.  The
    # local device path stays the default for desktop deployments.
    def attach_remote_audio(self, sample_rate: int, channels: int) -> dict:
        from .stream import OutputEngine, RemoteOutputDevice

        device = RemoteOutputDevice(sample_rate, channels)
        if self._engine is None:
            # output mode "off": create the engine on demand for the client
            self._engine = OutputEngine(self.playback, self.lock, device=device)
            self._engine.ensure_stream(self.requested_sr)
            self._engine_from_attach = True
        else:
            self._engine.set_device(device)
        cfg = self._engine.config
        if cfg is None:
            err = self._engine.error
            if self._engine_from_attach:
                # roll the on-demand engine back: a failed attach must leave
                # output="off" exactly as it was
                self._engine.shutdown()
                self._engine = None
                self._engine_from_attach = False
            raise ValueError(f"remote audio stream build failed: {err}")
        return {
            "sampleRate": cfg.sample_rate,
            "channels": cfg.channels,
            "sampleFormat": cfg.sample_format,
        }

    def detach_remote_audio(self) -> None:
        from .stream import RemoteOutputDevice, default_output_device

        engine = self._engine
        if engine is None or not isinstance(engine.device, RemoteOutputDevice):
            return
        if self._engine_from_attach:
            # restore the deployment's explicit output="off": wall-clock
            # sink only, no local stream the operator never asked for
            self._engine = None
            self._engine_from_attach = False
            self._anchor = time.monotonic()  # wall-clock sink takes over
            engine.shutdown()
        else:
            engine.set_device(default_output_device())

    def remote_attached(self) -> bool:
        from .stream import RemoteOutputDevice

        return self._engine is not None and isinstance(
            self._engine.device, RemoteOutputDevice
        )

    def pull_pcm(self, n_frames: int) -> bytes:
        """One client-paced chunk: runs the device-callback fill (mix ->
        volume -> clamp -> position advance) and returns the encoded wire
        chunk.  ValueError when no remote stream is attached (a detach or
        staleness fallback raced the client's pull loop)."""
        from .stream import RemoteStreamHandle

        n = int(n_frames)
        if not (1 <= n <= MAX_PULL_FRAMES):
            raise ValueError(f"frames must be in [1, {MAX_PULL_FRAMES}]")
        engine = self._engine
        handle = engine.handle if engine is not None else None
        if not isinstance(handle, RemoteStreamHandle):
            raise ValueError("no remote audio stream attached")
        data = handle.pull(n)
        with self.lock:
            position_sec = self.playback.position_sec()
            version = self.playback.cursor_version
            playing = self.playback.is_playing
        # header rate comes from the HANDLE that produced the PCM, not
        # engine.config: a detach/staleness fallback racing this pull swaps
        # engine.config to the local device's rate mid-flight
        return encode_pcm_chunk(
            data, handle.config.sample_rate, position_sec, version, playing,
            engine.source.reached_end,
        )

    def _check_remote_staleness(self) -> None:
        from .stream import RemoteStreamHandle

        engine = self._engine
        if engine is None or not self.remote_attached():
            return
        handle = engine.handle
        if not isinstance(handle, RemoteStreamHandle):
            return
        with self.lock:
            playing = self.playback.is_playing
        if (
            playing
            and time.monotonic() - handle.last_pull_monotonic > REMOTE_STALE_SEC
        ):
            self.detach_remote_audio()

    # -- commands (reference: player.rs:68-120) ----------------------------
    def set_volume_db(self, volume_db: float) -> None:
        with self.lock:
            self.playback.volume = float(
                torch.pow(10.0, torch.tensor(0.05 * np.float64(volume_db), dtype=torch.float32)))

    def set_sr(self, sr: int) -> None:
        self.requested_sr = sr
        if self._engine is not None:
            # rebuild the output stream at the nearest supported rate
            # (reference player.rs SetSr -> rebuild, device.rs:15-103)
            self._engine.ensure_stream(sr)

    def set_track(self, track_id: Optional[int], start_sec: Optional[float]) -> None:
        """reference: state.rs:190-236 + player.rs:96-104."""
        self._sync_position()
        target_id = track_id if track_id is not None else self.playback.track_id
        loaded = self._get_track(target_id) if target_id is not None else None
        with self.lock:
            p = self.playback
            # snapshot position/playing INSIDE the final lock: _get_track can
            # be slow, and reading them before it would overwrite a
            # concurrent pause/seek that landed during the load
            start = start_sec if start_sec is not None else p.position_sec()
            is_playing = p.is_playing
            if loaded is not None:
                samples, n_ch, sr, max_sec = loaded
                start = min(max(start, 0.0), max(max_sec, 0.0))
                p.track_id = target_id
                p.samples = np.asarray(samples, np.float32)
                p.input_channels = n_ch
                p.sample_rate = sr
                p.position_frame = start * sr
                p.cursor_version += 1
                p.is_playing = is_playing
            else:
                p.track_id = None
                p.samples = np.zeros(0, np.float32)
                p.input_channels = 0
                p.sample_rate = 0
                p.position_frame = 0.0
                p.cursor_version += 1
                p.is_playing = False
        self._clear_reached_end()
        self._end_seen = False
        self._anchor = time.monotonic()
        self._emit_state()

    def _clear_reached_end(self) -> None:
        """Synchronously clear the callback's end flag on seek/set_track —
        it is otherwise cleared only when the next fill() notices the
        version bump, and a 20 ms tick landing in that window would emit a
        spurious 'ended' event AND swallow the next genuine one."""
        if self._engine is not None:
            self._engine.source.reached_end = False

    def seek(self, sec: float) -> None:
        """reference: state.rs:238-254."""
        self._sync_position()
        with self.lock:
            p = self.playback
            sec = min(max(sec, 0.0), max(self.max_sec, 0.0))
            if p.sample_rate == 0 or p.input_channels == 0 or len(p.samples) == 0:
                p.position_frame = 0.0
            else:
                sec = min(sec, p.total_frames / p.sample_rate)
                p.position_frame = sec * p.sample_rate
                p.cursor_version += 1
        self._clear_reached_end()
        self._end_seen = False
        self._anchor = time.monotonic()
        self._emit_state()

    def pause(self) -> None:
        self._sync_position()
        with self.lock:
            self.playback.is_playing = False
        self._emit_state()

    def resume(self) -> None:
        self._sync_position()
        with self.lock:
            if self.playback.track_id is not None and len(self.playback.samples) > 0:
                self.playback.is_playing = True
                self._anchor = time.monotonic()
        # re-arm the end detection: resuming AT the track end must emit a
        # fresh 'ended' (the reference fires mark_track_end every time
        # reached_end && is_playing, stream.rs:433-439) — without this the
        # UI stays 'playing' forever (review finding)
        self._clear_reached_end()
        self._end_seen = False
        self._emit_state()

    def tick(self) -> None:
        """Periodic poll (reference main loop, 20 ms): advances position,
        polls the output device (500 ms cadence inside), surfaces stream
        errors, emits on track end.  reference: player.rs:130-173."""
        self._check_remote_staleness()
        if self._engine is not None:
            self._engine.poll()
            if self._engine.error != self.error:
                self.error = self._engine.error
                self._emit_state()
            if self._engine.is_active():
                # keep the wall-clock anchor fresh while the callback owns
                # the position: if the stream dies between ticks, the
                # fallback must count only the time SINCE the stream died,
                # not re-add the whole played interval (review finding)
                self._anchor = time.monotonic()
                ended = self._engine.source.reached_end
                if ended and not self._end_seen:
                    self._end_seen = True
                    self._emit_state()  # track ended (callback already paused)
                return
            # stream down: wall-clock path below keeps the position moving
        was_playing = self.playback.is_playing
        self._sync_position()
        if was_playing and not self.playback.is_playing:
            self._emit_state()  # track ended

    def state(self) -> dict:
        self._sync_position()
        return self._snapshot()
