"""Audio output-stream layer: devices, config selection, callback fill.

Host copy of ``thesia_tpu/player/stream.py`` (numpy, unchanged; the
optional ``sounddevice`` backend included); pinned by
``tests/test_torch_hostcopies.py``.

Behavioral equivalent of the reference's cpal-based output path —
reference: src-tauri/src/player/stream.rs:501-660 (build_output_stream +
callback fill: channel up/down-mix, volume, clamp, sample-format convert),
player/device.rs:15-103 (default device + config-by-sample-rate selection),
player.rs:130-164 (stream error capture, rebuild, 500 ms device polling).

This container has no sound hardware (/dev/snd absent, no libasound), so the
default backend is `NullOutputDevice` — the moral equivalent of ALSA's
"null" PCM: a paced consumer thread that requests buffers in real time and
discards them.  The full callback machinery (locked shared playback state,
cursor-version resampler resets, position advance by *input* frames
consumed, end-of-track detection, error capture) runs identically on it, so
swapping in a hardware device is exactly one new OutputDevice subclass.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from .mixing import mix_frames, slice_frames
from .resampler import StreamResampler

log = logging.getLogger("thesia_tpu.player")

RESAMPLER_CHUNK = 1024  # input frames per resampler feed (stream.rs chunk)
DEVICE_POLL_SEC = 0.5  # reference player.rs:24


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    channels: int
    sample_rate: int
    buffer_frames: int
    sample_format: str  # "f32" | "i16" | "u16" | "i24" | "u24"


@dataclasses.dataclass(frozen=True)
class SupportedConfigRange:
    """cpal SupportedStreamConfigRange analogue."""

    channels: int
    min_sample_rate: int
    max_sample_rate: int
    sample_format: str

    def clamp(self, sr: int) -> int:
        return min(max(sr, self.min_sample_rate), self.max_sample_rate)


class StreamError(RuntimeError):
    pass


class OutputDevice:
    """A sink that can open one paced output stream."""

    name: str = "abstract"

    def supported_configs(self) -> list[SupportedConfigRange]:
        raise NotImplementedError

    def default_config(self) -> StreamConfig:
        raise NotImplementedError

    def is_alive(self) -> bool:
        """Device-poll hook (reference polls the default device every
        500 ms and rebuilds when it changes/disappears)."""
        return True

    def open_stream(self, config: StreamConfig, callback) -> "StreamHandle":
        """callback(n_frames, channels, sample_rate) -> (n, ch) f32 in
        [-1, 1]; called from the stream thread."""
        raise NotImplementedError


class StreamHandle:
    def close(self) -> None:
        raise NotImplementedError

    @property
    def error(self) -> Optional[str]:
        return None


class _PacedStreamHandle(StreamHandle):
    """Stream thread: requests `buffer_frames` every period, real-time paced
    against a monotonic deadline (no drift), converts to the device sample
    format (discarded by the null sink), captures callback errors."""

    def __init__(self, config: StreamConfig, callback, consume):
        self._config = config
        self._callback = callback
        self._consume = consume
        self._stop = threading.Event()
        self._error: Optional[str] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"audio-out-{config.sample_rate}"
        )
        self._thread.start()

    @property
    def error(self) -> Optional[str]:
        return self._error

    def _run(self) -> None:
        cfg = self._config
        period = cfg.buffer_frames / cfg.sample_rate
        deadline = time.monotonic()
        while not self._stop.is_set():
            try:
                block = self._callback(cfg.buffer_frames, cfg.channels, cfg.sample_rate)
                data = convert_sample_format(block, cfg.sample_format)
                self._consume(data)
            except Exception as exc:  # captured, surfaced, stream keeps state
                self._error = f"{type(exc).__name__}: {exc}"
                return
            deadline += period
            delay = deadline - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
            else:
                deadline = time.monotonic()  # fell behind; resync

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def convert_sample_format(block: np.ndarray, fmt: str) -> np.ndarray:
    """f32 [-1,1] frames -> device wire format.
    reference: stream.rs:501-639 builds a stream per cpal SampleFormat."""
    if fmt == "f32":
        return block.astype(np.float32, copy=False)
    if fmt == "i16":
        return np.clip(np.floor(block * 32768.0 + 0.5), -32768, 32767).astype(np.int16)
    if fmt == "u16":
        return (
            np.clip(np.floor(block * 32768.0 + 0.5), -32768, 32767) + 32768
        ).astype(np.uint16)
    if fmt in ("i24", "u24"):
        i32 = np.clip(np.floor(block * 8388608.0 + 0.5), -8388608, 8388607).astype(
            np.int32
        )
        return i32 if fmt == "i24" else (i32 + 8388608).astype(np.uint32)
    raise StreamError(f"unsupported sample format {fmt}")


class NullOutputDevice(OutputDevice):
    """Headless real-time sink (ALSA "null" PCM analogue)."""

    name = "null"

    def __init__(self, default_sr: int = 48000, channels: int = 2):
        self._default_sr = default_sr
        self._channels = channels

    def supported_configs(self) -> list[SupportedConfigRange]:
        return [
            SupportedConfigRange(self._channels, 8000, 192000, "f32"),
            SupportedConfigRange(self._channels, 8000, 192000, "i16"),
        ]

    def default_config(self) -> StreamConfig:
        return StreamConfig(self._channels, self._default_sr, 512, "f32")

    def open_stream(self, config: StreamConfig, callback) -> StreamHandle:
        return _PacedStreamHandle(config, callback, consume=lambda data: None)


class RemoteStreamHandle(StreamHandle):
    """Client-paced pull stream for browser playback.

    The reference's player delivers sound through a cpal callback on the
    user's machine (reference: src-tauri/src/player/stream.rs:501-639); in
    the service deployment the user's machine is a browser, so the "device
    clock" is the viewer's AudioContext and each Web-Audio-scheduled chunk
    arrives as a pull() over HTTP.  pull() runs the exact same fill()
    callback a hardware stream would (mix -> volume -> clamp -> position
    advance -> cursor-version resampler resets), so the bytes a browser
    schedules are bit-identical to what a local device would play.
    """

    def __init__(self, config: StreamConfig, callback):
        self._config = config
        self._callback = callback
        self._error: Optional[str] = None
        self._closed = False
        self._pull_lock = threading.Lock()  # serialize pipelined pulls
        self.last_pull_monotonic = time.monotonic()

    @property
    def error(self) -> Optional[str]:
        return self._error

    @property
    def config(self) -> StreamConfig:
        """The stream's own config: pull_pcm stamps chunk headers from the
        handle, not the engine, so a concurrent detach/rebuild (which swaps
        engine.config to the local device's rate) can't mislabel in-flight
        PCM with the wrong sample rate."""
        return self._config

    def pull(self, n_frames: int) -> np.ndarray:
        """(n_frames, channels) in the device sample format (f32)."""
        with self._pull_lock:
            if self._closed:
                # a detach / staleness fallback closed this stream; the new
                # device's callback owns the position now — a late pull must
                # not advance it a second time
                raise ValueError("remote audio stream detached")
            self.last_pull_monotonic = time.monotonic()
            try:
                block = self._callback(
                    n_frames, self._config.channels, self._config.sample_rate
                )
                return convert_sample_format(block, self._config.sample_format)
            except Exception as exc:  # surfaced via OutputEngine.poll
                self._error = f"{type(exc).__name__}: {exc}"
                raise

    def close(self) -> None:
        # no thread to stop (the client paces) — but mark closed so a pull
        # racing the close can't keep advancing the shared position
        with self._pull_lock:
            self._closed = True


class RemoteOutputDevice(OutputDevice):
    """An attached browser audio context, seen as an output device.

    The AudioContext's sample rate is fixed for its lifetime, so the device
    advertises exactly one supported rate — select_output_config then
    engages the StreamResampler for any track at a different rate, the same
    tier logic a rate-locked hardware device goes through
    (reference: device.rs:15-103, stream.rs:335-499)."""

    name = "remote"

    def __init__(self, sample_rate: int, channels: int):
        sr = int(sample_rate)
        ch = int(channels)
        if not (8000 <= sr <= 384000):
            raise ValueError(f"unsupported remote sample rate {sample_rate}")
        if ch not in (1, 2):
            raise ValueError(f"unsupported remote channel count {channels}")
        self._sr = sr
        self._ch = ch

    def supported_configs(self) -> list[SupportedConfigRange]:
        return [SupportedConfigRange(self._ch, self._sr, self._sr, "f32")]

    def default_config(self) -> StreamConfig:
        return StreamConfig(self._ch, self._sr, 1024, "f32")

    def open_stream(self, config: StreamConfig, callback) -> StreamHandle:
        return RemoteStreamHandle(config, callback)


def _try_sounddevice() -> Optional[OutputDevice]:
    try:
        import sounddevice  # noqa: F401
    except Exception:
        return None

    class SounddeviceOutputDevice(OutputDevice):
        name = "sounddevice"

        def supported_configs(self) -> list[SupportedConfigRange]:
            import sounddevice as sd

            info = sd.query_devices(kind="output")
            ch = int(info.get("max_output_channels", 2)) or 2
            return [SupportedConfigRange(min(ch, 2), 8000, 192000, "f32")]

        def default_config(self) -> StreamConfig:
            import sounddevice as sd

            info = sd.query_devices(kind="output")
            return StreamConfig(
                min(int(info.get("max_output_channels", 2)) or 2, 2),
                int(info.get("default_samplerate", 48000)),
                512,
                "f32",
            )

        def is_alive(self) -> bool:
            import sounddevice as sd

            try:
                sd.query_devices(kind="output")
                return True
            except Exception:
                return False

        def open_stream(self, config: StreamConfig, callback) -> StreamHandle:
            import sounddevice as sd

            class _H(StreamHandle):
                _error: Optional[str] = None

                @property
                def error(self) -> Optional[str]:
                    # a PortAudio abort without a recorded exception still
                    # surfaces (OutputEngine.poll then rebuilds)
                    if self._error is None and not stream.active:
                        return "stream stopped"
                    return self._error

                def close(self) -> None:
                    stream.stop()
                    stream.close()

            handle = _H()

            def sd_callback(outdata, frames, _time, status):
                try:
                    if status:
                        raise StreamError(str(status))
                    outdata[:] = callback(frames, config.channels, config.sample_rate)
                except Exception as exc:  # captured for the rebuild poll
                    handle._error = f"{type(exc).__name__}: {exc}"
                    raise sd.CallbackAbort from exc

            stream = sd.OutputStream(
                samplerate=config.sample_rate,
                channels=config.channels,
                blocksize=config.buffer_frames,
                dtype="float32",
                callback=sd_callback,
            )
            stream.start()
            return handle

    try:
        dev = SounddeviceOutputDevice()
        dev.default_config()
        return dev
    except Exception:
        return None


def default_output_device() -> OutputDevice:
    """Hardware backend when one exists, else the paced null sink.
    reference: device.rs default_output_device."""
    return _try_sounddevice() or NullOutputDevice()


def select_output_config(device: OutputDevice, requested_sr: int) -> StreamConfig:
    """Pick the stream config for a requested sample rate.

    reference: device.rs:15-103 — candidates filtered to the default
    config's channel count + sample format; choose the supported rate
    nearest the request, preferring rates >= the request on distance ties;
    fall back to the default config when nothing matches."""
    default = device.default_config()
    if requested_sr <= 0:
        return default
    ranges = list(device.supported_configs())
    # the reference relaxes the filter in tiers before giving up
    # (device.rs:69-81): default channels+format, then format-only, then
    # any range — a device whose ranges don't include the default layout
    # must still serve the nearest supported rate (review finding)
    candidates = [
        r for r in ranges
        if r.channels == default.channels and r.sample_format == default.sample_format
    ]
    if not candidates:
        candidates = [r for r in ranges if r.sample_format == default.sample_format]
    if not candidates:
        candidates = ranges
    if not candidates:
        return default
    best: tuple[int, int] | None = None  # (distance, -is_at_least) for min()
    chosen = None
    for r in candidates:
        rate = r.clamp(requested_sr)
        key = (abs(rate - requested_sr), 0 if rate >= requested_sr else 1)
        if best is None or key < best:
            best = key
            chosen = (r, rate)
    r, best_rate = chosen
    return StreamConfig(
        r.channels, best_rate, default.buffer_frames, r.sample_format
    )


class PlaybackStreamSource:
    """Bridges locked shared playback state to the output callback.

    fill() is the audio callback body (reference stream.rs:442-499):
      * snapshot state under the lock;
      * cursor_version change -> resampler reset (stream.rs:110);
      * equal rates: direct frame slice; mismatched: StreamResampler fed
        fixed input chunks, output queued (stream.rs:335-430);
      * mix to output channels, apply volume, clamp;
      * advance position by INPUT frames consumed; flag track end.
    """

    def __init__(self, playback, lock: threading.Lock):
        self._playback = playback
        self._lock = lock
        self._resampler: StreamResampler | None = None
        self._resampler_key: tuple[int, int, int] | None = None
        self._seen_version = -1
        self._seen_out_sr = 0
        self._out_queue = np.zeros((0, 0), np.float32)
        self._feed_pos: int | None = None  # input cursor for resampler feeds
        self.reached_end = False

    def _ensure_resampler(self, sr_in: int, sr_out: int, n_ch: int) -> StreamResampler:
        key = (sr_in, sr_out, n_ch)
        if self._resampler_key != key:
            self._resampler = StreamResampler(sr_in, sr_out, n_ch)
            self._resampler_key = key
            self._out_queue = np.zeros((0, n_ch), np.float32)
        return self._resampler

    def fill(self, n_frames: int, out_channels: int, out_sr: int) -> np.ndarray:
        with self._lock:
            p = self._playback
            playing = p.is_playing
            samples = p.samples
            in_ch = p.input_channels
            sr = p.sample_rate
            pos = p.position_frame
            vol = p.volume
            version = p.cursor_version
        if version != self._seen_version or out_sr != self._seen_out_sr:
            # reset the feed state on seeks AND on output-rate changes: a
            # set_sr round trip through an equal-rate stream leaves the old
            # resampler key/queue/feed cursor intact, so without this a
            # return to the resampled rate would resume audio from the
            # minutes-old stale cursor while the display shows current time
            self._seen_version = version
            self._seen_out_sr = out_sr
            if self._resampler is not None:
                self._resampler.reset()
                self._out_queue = np.zeros((0, self._out_queue.shape[1]), np.float32)
            self._feed_pos = None  # re-anchor the feed cursor to the seek pos
            self.reached_end = False

        if not playing or in_ch == 0 or sr == 0 or len(samples) == 0:
            return np.zeros((n_frames, out_channels), np.float32)

        total = len(samples) // in_ch
        tail_drained = True  # equal-rate path has no queued tail
        if sr == out_sr:
            src = slice_frames(samples, in_ch, int(pos), n_frames)
            consumed = float(n_frames)
        else:
            rs = self._ensure_resampler(sr, out_sr, in_ch)
            if self._feed_pos is None:
                self._feed_pos = int(pos)
            while self._out_queue.shape[0] < n_frames:
                if self._feed_pos >= total + RESAMPLER_CHUNK * 4:
                    break  # drained past the end incl. filter tail — the
                    # check must gate the FEED, or every later callback
                    # tops the queue back up with silence and the
                    # end-of-track drain never completes (review finding)
                chunk = slice_frames(samples, in_ch, self._feed_pos, RESAMPLER_CHUNK)
                produced = rs.process(chunk.T).T  # resampler is planar (ch, n)
                self._feed_pos += RESAMPLER_CHUNK
                if produced.shape[0]:
                    self._out_queue = (
                        produced.astype(np.float32)
                        if self._out_queue.shape[0] == 0
                        else np.concatenate([self._out_queue, produced.astype(np.float32)])
                    )
            take = min(n_frames, self._out_queue.shape[0])
            src = np.zeros((n_frames, in_ch), np.float32)
            src[:take] = self._out_queue[:take]
            self._out_queue = self._out_queue[take:]
            # display position advances at the exact rate ratio; the feed
            # cursor runs ahead by the queue depth (bounded by one chunk)
            consumed = n_frames * sr / out_sr
            # the end is reached only when the resampler could not fill the
            # buffer anymore — the display position hits `total` while the
            # out-queue still holds the real track tail (sinc latency +
            # queued frames), and ending there truncated it audibly
            # (reference drains rubato before mark_track_end; review finding)
            tail_drained = take < n_frames

        out = mix_frames(src, out_channels)
        out = np.clip(out * vol, -1.0, 1.0).astype(np.float32, copy=False)

        with self._lock:
            p = self._playback
            if p.cursor_version == version and p.is_playing:
                new_pos = min(pos + consumed, float(total))
                p.position_frame = new_pos
                if new_pos >= total and tail_drained:
                    p.is_playing = False
                    self.reached_end = True
        return out


class OutputEngine:
    """Owns the device + stream; rebuilds on error / rate change / device
    loss (reference player.rs:130-188 main loop duties)."""

    def __init__(self, playback, lock: threading.Lock, device: OutputDevice | None = None):
        self._playback = playback
        self._lock = lock
        self._device = device or default_output_device()
        self.source = PlaybackStreamSource(playback, lock)
        self._handle: StreamHandle | None = None
        self._config: StreamConfig | None = None
        self._requested_sr = 0
        self._last_poll = 0.0
        self.error = ""
        # command threads (set_sr / set_device) and the tick thread (poll)
        # can race _rebuild; without this lock both could open a stream and
        # the loser's handle would leak with its callback thread live
        self._rebuild_lock = threading.Lock()

    @property
    def config(self) -> StreamConfig | None:
        return self._config

    @property
    def handle(self) -> StreamHandle | None:
        return self._handle

    @property
    def device(self) -> OutputDevice:
        return self._device

    def set_device(self, device: OutputDevice) -> None:
        with self._rebuild_lock:
            self._device = device
            self._rebuild()

    def ensure_stream(self, requested_sr: int) -> None:
        with self._rebuild_lock:
            if self._handle is not None and self._requested_sr == requested_sr:
                return
            self._requested_sr = requested_sr
            self._rebuild()

    def is_active(self) -> bool:
        """A live stream exists (its callback owns position_frame)."""
        return self._handle is not None

    def _rebuild(self) -> None:
        # caller holds _rebuild_lock
        if self._handle is not None:
            try:
                self._handle.close()
            except Exception:
                pass
            self._handle = None
        try:
            cfg = select_output_config(self._device, self._requested_sr)
            self._config = cfg
            self._handle = self._device.open_stream(cfg, self.source.fill)
            self.error = ""
            log.info(
                "output stream: %s %d ch @ %d Hz (%s)",
                self._device.name, cfg.channels, cfg.sample_rate, cfg.sample_format,
            )
        except Exception as exc:
            self._config = None
            self.error = f"{type(exc).__name__}: {exc}"
            log.warning("output stream build failed: %s", self.error)

    def poll(self) -> None:
        """500 ms cadence from the player tick: captured callback errors or
        a dead device trigger a rebuild; the error string is surfaced
        through player-state-changed (player.rs:130-164)."""
        now = time.monotonic()
        if now - self._last_poll < DEVICE_POLL_SEC:
            return
        self._last_poll = now
        with self._rebuild_lock:
            if self._handle is not None and self._handle.error:
                self.error = self._handle.error
                self._rebuild()
            elif self._handle is None or not self._device.is_alive():
                self._rebuild()

    def close(self) -> None:
        with self._rebuild_lock:
            if self._handle is not None:
                try:
                    self._handle.close()
                except Exception:
                    pass
                self._handle = None

    def shutdown(self) -> None:
        """Tear the engine down for good (detach of an on-demand remote
        engine in output='off' mode): close the stream AND clear the config
        so is_active()/config can't report a live output that no longer
        exists."""
        with self._rebuild_lock:
            if self._handle is not None:
                try:
                    self._handle.close()
                except Exception:
                    pass
                self._handle = None
            self._config = None
