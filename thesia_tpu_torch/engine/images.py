"""Spectrogram images: u16 quantization and the X mip chain on the device,
streamed to the host in the background; tiles served from the host image
once it has landed and, until then, from regions fetched off the device.

Port of ``thesia_tpu/engine/images.py``.  The JAX device program
``_quantize_and_mips`` (K6: the quantize, ``_halve_t``, ``_clamp_tail``) is
the hand-written kernel ``kernels/images.py: quantize_mips``
(``csrc/images.cu``), which the manager dispatches.  Device images and mips
are ``torch.uint16`` (``kernels.images.IMAGE_DTYPE``), 2 bytes a pixel as in
the JAX package, so their bits go to the host as they are.

``TrackImages``' interval bookkeeping (``_merge_landed``, ``covers``,
``next_gap``, ``reset_host``, ``host_bytes``, ``host_image``) is the
original's code, pinned statement for statement by
``tests/test_torch_hostcopies.py``.  ``SpecImageStore`` keeps the original's
contract (geometry at dispatch, deepest mip first, then full-res chunks, a
tile request pulling its region and track to the front, three retries and
then eviction, the host budget ``THESIA_IMG_CACHE_BYTES`` with requantize on
miss).  What differs is the copy itself, designed for the card:

  * One copy stream per store.  ``set_images`` records an event on the stream
    that dispatched the quantize; the copy stream waits on that event and on
    nothing else, so a region fetch never queues behind a recompute that was
    dispatched later on the compute stream (a bare ``.cpu()`` would).
  * A strided slice ``dev_img[ch, :, x0:x1]`` is copied into a contiguous
    staging buffer on the copy stream, then by one DMA into pinned memory:
    the streamer owns a ring of two pinned buffers of
    ``STREAM_CHUNK_BYTES`` (the DMA of one chunk overlaps the host copy of the
    one before), region fetches take small pinned blocks from torch's caching
    host allocator.  Whole images are never pinned: host images stay plain
    numpy arrays, within reach of the eviction budget.  An interval is
    published only after the events of all its copies have completed.
  * ``record_stream(copy_stream)`` on every device image and mip, so the
    caching allocator cannot hand their memory to a new quantize while a copy
    still reads it; the streamer drops them after its last copy event.
  * On the CPU the same code runs with plain slices and no streams.
  * The streamer thread ends after a second without work (the next
    ``set_images`` starts another), and an exit hook stops every streamer
    before the interpreter finalizes, so no thread is inside a copy then.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
import time
import weakref

import numpy as np
import torch

from .. import obs
from ..kernels.images import IMAGE_DTYPE
from ..obs import span
from ..render.mips import SpecImage, chain_len, halve_x_u16
from ..render.tiles import (
    encode_tile_body_from_source,
    spectrogram_tile_geometry,
    spectrogram_tile_source_cols,
)

log = logging.getLogger(__name__)

IdCh = tuple[int, int]

# sentinel: a tile attempt landed on a streamer transition (entry completed
# or was replaced mid-read) -- the caller re-resolves the entry and retries
_TRANSITION = object()

# first device mip level, as in the JAX store; shallower levels are region
# fetches halved locally
DEVICE_MIP_FROM = 3
# one streamed chunk (all rows of a column range, one channel); also the size
# of each pinned staging buffer
STREAM_CHUNK_BYTES = int(os.environ.get("THESIA_STREAM_CHUNK_BYTES", 4 * 1024 * 1024))
# pinned staging buffers per streamer
PINNED_RING = 2
# seconds without work after which a streamer thread ends
IDLE_EXIT_S = 1.0
# region fetches of interim tiles (device -> host while an image streams)
region_fetches = 0


def mip_plan(n_frames: int) -> list[int]:
    """Device mip levels to build: DEVICE_MIP_FROM..chain_len (the host
    chain's levels)."""
    return list(range(DEVICE_MIP_FROM, chain_len(n_frames) + 1))


def land_u16(arrays: list[torch.Tensor]) -> list[np.ndarray]:
    """Device u16 images or mips -> host u16 arrays, in ONE device->host
    transfer."""
    host = torch.cat([a.reshape(-1) for a in arrays]).cpu().numpy()
    out, off = [], 0
    for a in arrays:
        out.append(host[off : off + a.numel()].reshape(tuple(a.shape)))
        off += a.numel()
    return out


class TrackImages:
    """One track's images: device tensors + streaming-in host buffers.

    Host layout per channel: preallocated (H, n_frames) u16 filled by the
    streamer mostly left-to-right, but interactive tile requests can pull a
    region forward: ``landed`` is the merged list of [start, end) full-res
    column intervals already on the host (all channels).  ``ready`` is the
    event the copy stream waits on (None on the CPU); ``copy_ms`` sums the
    copy stream's device time for this image's landing."""

    __slots__ = (
        "track_id", "n_ch", "n_frames", "height", "dev_img", "dev_mips",
        "host", "landed", "stream_hint", "host_mips",
        "complete", "dropped", "evicted", "stream_retries", "last_use",
        "ready", "copy_ms", "trace_parent",
    )

    def __init__(self, track_id, n_ch, n_frames, height, dev_img, dev_mips):
        self.track_id = track_id
        self.n_ch = n_ch
        self.n_frames = n_frames
        self.height = height
        self.dev_img = dev_img  # (C, H, n_frames) uint16 tensor
        self.dev_mips = dev_mips  # {level: (C, H, ceil(n_frames/2^level)) uint16}
        self.host: list[np.ndarray | None] = [None] * n_ch
        self.landed: list[list[int]] = []  # merged [start, end) intervals
        self.stream_hint: tuple[int, int] | None = None  # viewport priority
        self.host_mips: dict[int, np.ndarray] = {}
        self.complete = False
        self.dropped = False
        self.evicted = False  # host bytes dropped by the budget; geometry kept
        self.stream_retries = 0  # failed chunks of this entry, retried by the loop
        self.last_use = 0
        self.ready = None
        self.copy_ms = 0.0
        self.trace_parent = None  # obs.current() where the image was queued

    def host_image(self, ch: int) -> SpecImage | None:
        if not self.complete or ch >= self.n_ch:
            return None
        img = self.host[ch]
        return img if isinstance(img, SpecImage) else None

    # interval bookkeeping -- caller holds the store lock
    def _merge_landed(self, x0: int, x1: int) -> None:
        ivs = self.landed
        new = [x0, x1]
        out = []
        for iv in ivs:
            if iv[1] < new[0] or iv[0] > new[1]:
                out.append(iv)
            else:
                new = [min(iv[0], new[0]), max(iv[1], new[1])]
        out.append(new)
        out.sort()
        self.landed = out

    def covers(self, x0: int, x1: int) -> bool:
        return any(iv[0] <= x0 and x1 <= iv[1] for iv in self.landed)

    def next_gap(self, max_len: int) -> tuple[int, int] | None:
        """First un-landed [start, end) span, capped at max_len."""
        pos = 0
        for iv in self.landed:
            if iv[0] > pos:
                return (pos, min(iv[0], pos + max_len))
            pos = max(pos, iv[1])
        if pos < self.n_frames:
            return (pos, min(self.n_frames, pos + max_len))
        return None

    def reset_host(self) -> None:
        self.host = [None] * self.n_ch
        self.landed = []
        self.stream_hint = None
        self.host_mips = {}

    def host_bytes(self) -> int:
        total = 0
        for img in self.host:
            if img is not None:
                total += img.nbytes
                if isinstance(img, SpecImage):
                    total += img.mip_bytes()
        return total


class _Landing:
    """Device->host copies of column ranges of one track's device image into
    its host buffers.  On a card each piece goes through the copy stream:
    copied into contiguous device staging, one DMA into a slot of the pinned
    ring, then (once its event completes) copied into the host image; with two
    slots the DMA of one piece overlaps the host copy of the previous one.
    On the CPU a piece is a plain slice and copy."""

    def __init__(self, store: SpecImageStore, t: TrackImages):
        self.store = store
        self.t = t
        self.pending: list = [None] * PINNED_RING  # per slot: (start, done, dst, shape)
        self.k = 0

    def put(self, ch: int, x0: int, x1: int, dst: np.ndarray) -> None:
        src = self.t.dev_img[ch, :, x0:x1]
        if not src.is_cuda:
            dst[...] = src.numpy()
            return
        slot = self.k % PINNED_RING
        self.k += 1
        self._retire(slot)
        stream = self.store._copy_stream(src.device)
        ring = self.store._pinned_slot(slot, src.numel())
        with torch.cuda.stream(stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            stream.wait_event(self.t.ready)
            start.record(stream)
            ring[: src.numel()].copy_(src.contiguous().view(-1), non_blocking=True)
            done.record(stream)
        self.pending[slot] = (start, done, dst, tuple(src.shape), ring)

    def _retire(self, slot: int) -> None:
        p = self.pending[slot]
        if p is None:
            return
        self.pending[slot] = None
        start, done, dst, shape, ring = p
        done.synchronize()
        self.t.copy_ms += start.elapsed_time(done)
        n = shape[0] * shape[1]
        dst[...] = ring[:n].numpy().reshape(shape)

    def flush(self) -> None:
        """Wait for every piece in flight and copy it into the host image."""
        for i in range(1, PINNED_RING + 1):
            self._retire((self.k + i) % PINNED_RING)


_LIVE_STORES: weakref.WeakSet = weakref.WeakSet()
_exit_hook_lock = threading.Lock()
_exit_hook_registered = False


def _stop_streamers_at_exit() -> None:
    """Stop every store's streamer and wait for it, so that no thread is in a
    device copy while the interpreter finalizes."""
    for store in list(_LIVE_STORES):
        store.shutdown()
        worker = store._worker
        if worker is not None:
            worker.join(timeout=10.0)


def _track_for_exit(store: SpecImageStore) -> None:
    global _exit_hook_registered
    with _exit_hook_lock:
        if not _exit_hook_registered:
            atexit.register(_stop_streamers_at_exit)
            _exit_hook_registered = True
        _LIVE_STORES.add(store)


class SpecImageStore:
    """Owns every track's spectrogram images + the background streamer."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tracks: dict[int, TrackImages] = {}
        self._queue: list[int] = []  # track ids pending streaming, FIFO
        self._wake = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._interactive_waiters = 0
        self._worker: threading.Thread | None = None
        self._shutdown = False
        # host-RAM budget for landed images (+ their mip chains); LRU beyond
        # it is evicted down to geometry and requantized on demand via the
        # reloader
        self._host_budget = int(os.environ.get("THESIA_IMG_CACHE_BYTES", 4 * 1024**3))
        self._use_tick = 0
        self._reloader = None  # fn(track_id) -> bool, set by TrackManager
        self._stream = None  # the copy stream, made at first use on a card
        self._ring: list[torch.Tensor | None] = [None] * PINNED_RING
        # chunks whose copy raised (each retried by the loop); a healthy
        # run keeps it at 0
        self.stream_failures = 0

    def set_reloader(self, fn) -> None:
        self._reloader = fn

    def needs_reload(self, track_id: int) -> bool:
        t = self._tracks.get(track_id)
        return t is not None and t.evicted

    # -- the card's copy path ------------------------------------------------
    def _copy_stream(self, device) -> torch.cuda.Stream:
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            return self._stream

    def _pinned_slot(self, slot: int, n: int) -> torch.Tensor:
        """Pinned u16 staging buffer ``slot`` of the streamer's ring, at
        least ``n`` elements (STREAM_CHUNK_BYTES unless a chunk needs more)."""
        buf = self._ring[slot]
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, STREAM_CHUNK_BYTES // 2), dtype=IMAGE_DTYPE, pin_memory=True)
            self._ring[slot] = buf
        return buf

    def _to_host(self, t: TrackImages, src: torch.Tensor) -> np.ndarray:
        """One slice of a device image or mip -> host u16 array; on a card
        through the copy stream, after t's quantize and nothing later."""
        if not src.is_cuda:
            return src.numpy().copy()
        stream = self._copy_stream(src.device)
        with torch.cuda.stream(stream):
            stream.wait_event(t.ready)
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src.contiguous(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host.numpy()

    # -- lifecycle ----------------------------------------------------------
    def set_images(self, track_id: int, images: TrackImages) -> None:
        """Replace a track's images (fresh quantize) and queue streaming.
        Called on the thread that dispatched the quantize: on a card, the
        copy stream will wait for that thread's current stream here."""
        images.trace_parent = obs.current()
        dev = images.dev_img
        if dev is not None and dev.device.type == "cuda":
            stream = self._copy_stream(dev.device)
            images.ready = torch.cuda.Event()
            images.ready.record(torch.cuda.current_stream(dev.device))
            for a in (dev, *images.dev_mips.values()):
                a.record_stream(stream)
        with self._lock:
            old = self._tracks.get(track_id)
            if old is not None:
                old.dropped = True
            self._tracks[track_id] = images
            if track_id not in self._queue:
                self._queue.append(track_id)
            self._ensure_worker()
            self._wake.notify_all()

    def shutdown(self) -> None:
        """Stop the streamer (session re-init replaces the store).  Every
        entry is dropped so an in-flight stream aborts at its next chunk."""
        with self._lock:
            self._shutdown = True
            for t in self._tracks.values():
                t.dropped = True
            self._queue.clear()
            self._wake.notify_all()
            self._idle.notify_all()

    def remove(self, track_id: int) -> None:
        with self._lock:
            old = self._tracks.pop(track_id, None)
            if old is not None:
                old.dropped = True
            if track_id in self._queue:
                self._queue.remove(track_id)

    def track_ids(self) -> list[int]:
        return list(self._tracks)

    def geometry(self, track_id: int) -> tuple[int, int] | None:
        """(height, n_frames) as soon as quantize is DISPATCHED."""
        t = self._tracks.get(track_id)
        return None if t is None else (t.height, t.n_frames)

    def is_computing(self, track_id: int) -> bool:
        t = self._tracks.get(track_id)
        return t is not None and not t.complete and not t.evicted

    def _touch(self, t: TrackImages) -> None:
        self._use_tick += 1
        t.last_use = self._use_tick

    def host_image(self, track_id: int, ch: int) -> SpecImage | None:
        t = self._tracks.get(track_id)
        if t is None:
            return None
        self._touch(t)
        return t.host_image(ch)

    def completed_images(self) -> dict[IdCh, SpecImage]:
        """Blocking view used by tests: drains the streamer first."""
        self.drain()
        out = {}
        with self._lock:
            for tid, t in self._tracks.items():
                for ch in range(t.n_ch):
                    img = t.host_image(ch)
                    if img is not None:
                        out[(tid, ch)] = img
        return out

    # -- tile serving ---------------------------------------------------------
    def tile_body(
        self, track_id: int, ch: int, colormap_rgba, level_x, level_y, tile_x, tile_y
    ) -> bytes | None:
        """RGBA tile body (no header) or None if the track has no image.
        Serves from host when landed; otherwise fetches the tile's source
        window from the device image/mips."""
        t = self._tracks.get(track_id)
        if t is None or ch >= t.n_ch:
            return None
        g = spectrogram_tile_geometry(t.height, t.n_frames, level_x, level_y, tile_x, tile_y)
        if g["width"] == 0 or g["height"] == 0:
            return b""
        # the streamer completes entries concurrently (complete=True, then
        # device copies freed) and _evict_host can evict mid-read; a single
        # attempt can land exactly on such a transition, so retry -- the
        # follow-up serves from the landed host image, or requantizes an
        # evicted entry through the manager (geometry is eviction-stable)
        for _attempt in range(3):
            if t.evicted:
                if self._reloader is None or not self._reloader(track_id):
                    return None
                t = self._tracks.get(track_id)
                if t is None or ch >= t.n_ch or t.evicted:
                    return None
            self._touch(t)
            out = self._tile_body_attempt(t, ch, colormap_rgba, level_x, level_y, tile_x, tile_y, g)
            if out is not _TRANSITION:
                return out
            t = self._tracks.get(track_id)
            if t is None or ch >= t.n_ch:
                return None
        return None

    def _tile_body_attempt(self, t, ch, colormap_rgba, level_x, level_y, tile_x, tile_y, g):
        host_img = t.host_image(ch)
        if host_img is not None:
            src, m = host_img.mip_for_level(level_x) if level_x >= 1 else (np.asarray(host_img), 0)
            return encode_tile_body_from_source(
                np.asarray(src), m, 0, t.n_frames, colormap_rgba,
                level_x, level_y, g["width"], g["height"],
                g["origin_x"], g["origin_y"], g["lod_width"], g["lod_height"],
            )
        # streaming: serve from the SAME chain level the settled host path
        # would use, so interim and final tile bytes are identical.  Levels
        # >= DEVICE_MIP_FROM exist as device mips (bit-exact twins of the
        # host chain); shallower levels fetch an aligned full-res region and
        # halve it locally.
        m = min(level_x, chain_len(t.n_frames)) if level_x >= 1 else 0
        cols = spectrogram_tile_source_cols(t.n_frames, level_x, tile_x, m, t.height, level_y, tile_y)
        if cols is None:
            return b""
        x0, x1 = cols
        host_mip = t.host_mips.get(m) if m >= 1 else None
        if m == 0 or m in t.dev_mips or host_mip is not None:
            if host_mip is not None:
                # the deepest mip lands first, so whole-track paints serve
                # from the host while full-res still streams
                region = host_mip[ch][:, x0:x1]
            else:
                region = None
                if m == 0:
                    region = self._landed_region(t, ch, x0, x1)
                if region is None:
                    region = self._fetch_region(t, ch, m, x0, x1)
                    if region is None:
                        return _TRANSITION if (t.complete or t.dropped or t.evicted) else None
                    if m == 0:
                        # pull this region (all channels) to the front of
                        # the stream so the next request lands host-side
                        self._prioritize(t, x0, x1)
        else:
            # align to 2^m so local halving reproduces the global chain's
            # column pairing exactly (a region clipped at the image end
            # reproduces the odd-width tail copy too)
            x0f = x0 << m
            x1f = min(x1 << m, t.n_frames)
            region = self._landed_region(t, ch, x0f, x1f, contiguous=True)
            if region is None:
                region = self._fetch_region(t, ch, 0, x0f, x1f)
                if region is None:
                    return _TRANSITION if (t.complete or t.dropped or t.evicted) else None
                self._prioritize(t, x0f, x1f)
            for _ in range(m):
                region = halve_x_u16(region)
        return encode_tile_body_from_source(
            region, m, x0, t.n_frames, colormap_rgba,
            level_x, level_y, g["width"], g["height"],
            g["origin_x"], g["origin_y"], g["lod_width"], g["lod_height"],
        )

    def _landed_region(self, t: TrackImages, ch: int, x0: int, x1: int, contiguous: bool = False):
        """(H, x1-x0) view of the host buffer when [x0, x1) has landed, else
        None.  Safe: intervals are published under the lock only after their
        bytes are fully written."""
        with self._lock:
            buf = t.host[ch] if ch < len(t.host) else None
            if buf is None or not t.covers(x0, x1):
                return None
            region = np.asarray(buf)[:, x0:x1]
            return np.ascontiguousarray(region) if contiguous else region

    def _prioritize(self, t: TrackImages, x0: int, x1: int) -> None:
        """Viewport priority: move the requested full-res region -- and its
        track -- to the front of the stream work."""
        with self._lock:
            if t.dropped or t.complete or t.evicted:
                return
            t.stream_hint = (x0, x1)
            q = self._queue
            if t.track_id in q and q[0] != t.track_id:
                q.remove(t.track_id)
                q.insert(0, t.track_id)
            self._wake.notify_all()

    def _fetch_region(self, t: TrackImages, ch: int, m: int, x0: int, x1: int):
        src_dev = t.dev_img if m == 0 else t.dev_mips.get(m)
        if src_dev is None:
            return None
        global region_fetches
        with self._lock:
            self._interactive_waiters += 1
            region_fetches += 1
        try:
            with span("tile.region_d2h"):
                return self._to_host(t, src_dev[ch, :, x0:x1])
        finally:
            with self._lock:
                self._interactive_waiters -= 1
                self._wake.notify_all()

    # -- streaming ------------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._stream_loop, name="spec-image-streamer", daemon=True
            )
            self._worker.start()
            _track_for_exit(self)

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every queued image has fully landed."""
        with self._lock:
            if self._queue:
                self._ensure_worker()
                self._wake.notify_all()
            return self._idle.wait_for(lambda: not self._queue, timeout=timeout)

    def _stream_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._lock:
                while not self._queue:
                    self._idle.notify_all()
                    if self._shutdown or (
                        not self._wake.wait(timeout=IDLE_EXIT_S) and not self._queue
                    ):
                        # idle (or stopped): end; set_images starts another
                        if self._worker is me:
                            self._worker = None
                        return
                track_id = self._queue[0]
                t = self._tracks.get(track_id)
            # evicted: the budget freed this entry while it was still queued
            # behind a prioritized track; it requantizes on demand
            if t is None or t.dropped or t.complete or t.evicted:
                with self._lock:
                    if self._queue and self._queue[0] == track_id:
                        # set_images may have installed a fresh entry (and
                        # skipped re-queueing) between our capture and the
                        # dropped check -- only pop when no live replacement
                        # is waiting
                        cur = self._tracks.get(track_id)
                        if cur is None or cur is t or cur.complete or cur.evicted:
                            self._queue.pop(0)
                continue
            ok = True
            try:
                self._stream_one(t)
            except Exception:
                ok = False
                log.warning("image stream chunk for track %s failed", track_id, exc_info=True)
            with self._lock:
                retry_sleep = 0.0
                if not ok:
                    self.stream_failures += 1
                if self._queue and self._queue[0] == track_id:
                    cur = self._tracks.get(track_id)
                    if cur is t and not ok and not t.dropped and not t.complete:
                        # a failed copy on a LIVE entry: retry a few times
                        # instead of stranding it incomplete forever
                        t.stream_retries += 1
                        if t.stream_retries > 3:
                            log.warning(
                                "image stream for track %s failed %d times; "
                                "marking evicted (requantize on demand)",
                                track_id, t.stream_retries,
                            )
                            # evicted routes the next tile request through
                            # the reloader and flips isComputing off
                            t.evicted = True
                            t.reset_host()
                            self._queue.pop(0)
                        else:
                            retry_sleep = 0.2 * t.stream_retries
                    elif cur is None or cur is t or cur.complete:
                        self._queue.pop(0)
                    # else: set_images replaced the entry while we streamed
                    # the old one -- keep the id at the head so the next
                    # iteration streams the REPLACEMENT
                self._idle.notify_all()
            if retry_sleep:
                time.sleep(retry_sleep)

    def _yield_to_interactive(self) -> None:
        with self._lock:
            while self._interactive_waiters > 0:
                self._wake.wait(timeout=0.25)

    def _stream_one(self, t: TrackImages) -> None:
        """Deepest mip first (first whole-track paint), then full-res in
        chunks -- normally left-to-right, but a viewport-priority hint pulls
        that region forward; landed intervals make the out-of-order progress
        resumable.  On completion build host mip chains and drop the device
        tensors."""
        with obs.resume(t.trace_parent), span("spec.stream"):
            deepest = max(t.dev_mips) if t.dev_mips else None
            if deepest is not None and not t.dropped and deepest not in t.host_mips:
                t.host_mips[deepest] = self._to_host(t, t.dev_mips[deepest])  # small
            chunk_cols = max(STREAM_CHUNK_BYTES // max(t.height * 2, 1), 1024)
            # (re)use existing buffers -- a preempted stream resumes here
            fresh = [
                np.empty((t.height, t.n_frames), np.uint16) if t.host[ch] is None else None
                for ch in range(t.n_ch)
            ]
            with self._lock:
                for ch in range(t.n_ch):
                    if t.host[ch] is None:
                        t.host[ch] = fresh[ch]
                bufs = list(t.host)
            with span("spec.stream.copy"):  # the ring's copies
                landing = _Landing(self, t)
                try:
                    landed = self._stream_chunks(t, landing, bufs, chunk_cols)
                finally:
                    # no copy may be in flight into a ring slot once this returns
                    landing.flush()
            if not landed or t.dropped:
                return
            # host images + eager mip chains (tile serving must never stall
            # on a chain build after the device tensors are gone)
            with span("spec.stream.mips"):
                for ch in range(t.n_ch):
                    img = SpecImage(np.asarray(bufs[ch]))
                    img.mips()
                    t.host[ch] = img
            t.complete = True
            t.dev_img = None
            t.dev_mips = {}
            t.host_mips = {}
            # count the landing itself as a use: a just-streamed image would
            # otherwise be the first eviction candidate
            with self._lock:
                self._touch(t)
            self._evict_host()

    def _stream_chunks(self, t: TrackImages, landing: _Landing, bufs, chunk_cols: int) -> bool:
        """Land full-res chunks; True once every column has landed, False if
        the entry was dropped or another track took the queue head."""
        while True:
            if t.dropped:
                return False
            with self._lock:
                # another track was prioritized to the queue head: yield;
                # this entry stays queued and resumes later
                if self._queue and self._queue[0] != t.track_id:
                    return False
                nxt = None
                if t.stream_hint is not None:
                    h0, h1 = t.stream_hint
                    pos = h0
                    for iv in t.landed:
                        if iv[0] <= pos < iv[1]:
                            pos = iv[1]
                    if pos < min(h1, t.n_frames):
                        end = min(h1, t.n_frames, pos + chunk_cols)
                        # cap at the next landed interval: never re-fetch
                        # landed columns
                        for iv in t.landed:
                            if pos < iv[0] < end:
                                end = iv[0]
                        nxt = (pos, end)
                    else:
                        t.stream_hint = None
                if nxt is None:
                    nxt = t.next_gap(chunk_cols)
                if nxt is None:
                    return True
            x0, x1 = nxt
            for ch in range(t.n_ch):
                if t.dropped:
                    return False
                self._yield_to_interactive()
                landing.put(ch, x0, x1, bufs[ch][:, x0:x1])
            # publish only after every copy of the chunk has completed
            landing.flush()
            with self._lock:
                t._merge_landed(x0, x1)

    def _evict_host(self) -> None:
        """Keep landed images within the host budget; oldest-use first.
        Evicted entries keep their geometry and requantize on demand."""
        with self._lock:
            completed = [t for t in self._tracks.values() if t.complete and not t.dropped]
            total = sum(t.host_bytes() for t in completed)
            if total <= self._host_budget:
                return
            completed.sort(key=lambda t: t.last_use)
            for t in completed[:-1]:  # never evict the most recent
                if total <= self._host_budget:
                    break
                total -= t.host_bytes()
                t.complete = False
                t.evicted = True
                t.reset_host()
