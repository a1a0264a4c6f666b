"""Host-to-device uploads of samples: pinned staging memory and a copy stream.

The device-to-host ring of ``engine/images.py`` run the other way.  Per card
one copier owns a copy stream and a ring of ``PINNED_RING`` pinned staging
buffers of ``CHUNK_BYTES`` each; an upload walks the source in chunks, copies
each on the host into a slot whose previous DMA has completed, and queues
that slot's DMA on the copy stream, so the host copy of one chunk overlaps the
DMA of the one before.  The host copy, not the link, sets the pace, so it is
torch's copy, spread over the CPU's threads.  Whole tracks are never pinned
(an hour of 48 kHz stereo f32 is 1.38 GB).  The destination is allocated on
the copy stream; an event recorded after the last chunk is all a consumer
waits on (``Upload.tensor_for`` makes the current stream wait for it and
records that stream on the tensor, so the caching allocator keeps its memory
until the consumer's work is done).  Uploads from several threads (the
prefetch workers, the write worker) serialize on the copier's lock: they
share one link.

On the CPU an upload is ``torch.from_numpy`` (a copy when the source is
read-only).  Every upload counts in ``counters`` (uploads and bytes, on either
device) and, on a card, leaves its start/done events in ``history`` for the
copy stream's device time; an upload made under ``runtime.warming()`` counts
in ``warm_counters`` instead and leaves no events.
"""

from __future__ import annotations

import collections
import threading
import warnings

import numpy as np
import torch

from ..runtime import is_warming

# one staging chunk; also the size of each pinned buffer
CHUNK_BYTES = 16 << 20
# pinned staging buffers per copier
PINNED_RING = 2

# uploads and bytes since the last reset, on any device (plain integers), and
# those of the device warmup and the shape warmer apart
counters = {"uploads": 0, "bytes": 0}
warm_counters = {"uploads": 0, "bytes": 0}
# (bytes, start event, done event) of the latest uploads on a card
history: collections.deque = collections.deque(maxlen=256)
_counter_lock = threading.Lock()


def reset_counters() -> None:
    with _counter_lock:
        for c in (counters, warm_counters):
            c["uploads"] = c["bytes"] = 0
        history.clear()


def copy_stream_ms() -> float:
    """Copy-stream device milliseconds of the uploads in ``history`` (waits
    for each to finish)."""
    total = 0.0
    for _nbytes, start, done in list(history):
        done.synchronize()
        total += start.elapsed_time(done)
    return total


class Upload:
    """A tensor being uploaded: ``tensor`` holds the samples once ``done``
    (None on the CPU) has completed; ``stream`` is the copy stream (None on
    the CPU), on which follow-up work runs in order after the copy."""

    __slots__ = ("tensor", "done", "stream")

    def __init__(self, tensor: torch.Tensor, done=None, stream=None):
        self.tensor = tensor
        self.done = done
        self.stream = stream

    def tensor_for(self) -> torch.Tensor:
        """The tensor, readable on the current stream."""
        if self.done is None:
            return self.tensor
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.done)
        self.tensor.record_stream(stream)
        return self.tensor


class _Copier:
    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device)
        self.ring = [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                     for _ in range(PINNED_RING)]
        self.slot_done = [None] * PINNED_RING  # event of each slot's last DMA
        self.k = 0

    def copy(self, src: torch.Tensor, dst: torch.Tensor):
        """src (n,) uint8 host bytes -> dst (n,) uint8 device bytes, chunk by
        chunk through the ring on the copy stream; -> (start, done) events."""
        n = src.shape[0]
        with self.lock:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            for off in range(0, n, CHUNK_BYTES):
                slot = self.k % PINNED_RING
                self.k += 1
                if self.slot_done[slot] is not None:
                    self.slot_done[slot].synchronize()  # its previous DMA has read it
                m = min(CHUNK_BYTES, n - off)
                self.ring[slot][:m].copy_(src[off : off + m])
                with torch.cuda.stream(self.stream):
                    dst[off : off + m].copy_(self.ring[slot][:m], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self.stream)
                self.slot_done[slot] = ev
            done = torch.cuda.Event(enable_timing=True)
            done.record(self.stream)
        return start, done


_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}
_copiers: dict[torch.device, _Copier] = {}
_copiers_lock = threading.Lock()


def _copier(device: torch.device) -> _Copier:
    with _copiers_lock:
        c = _copiers.get(device)
        if c is None:
            c = _copiers[device] = _Copier(device)
        return c


def upload(src: np.ndarray, device: torch.device) -> Upload:
    """A contiguous host array (any shape; float32 or uint8; may be a
    read-only view of file bytes) -> Upload of a tensor of the same shape and
    dtype on ``device``."""
    src = np.ascontiguousarray(src)
    warm = is_warming()
    with _counter_lock:
        c = warm_counters if warm else counters
        c["uploads"] += 1
        c["bytes"] += src.nbytes
    if device.type == "cpu":
        return Upload(torch.from_numpy(src if src.flags.writeable else src.copy()))
    if device.type != "cuda":
        raise ValueError(f"upload: unsupported device {device}")
    copier = _copier(device)
    with torch.cuda.stream(copier.stream):
        dst = torch.empty(src.shape, dtype=_DTYPES[src.dtype], device=device)
    with warnings.catch_warnings():
        # a read-only source (file bytes) is only ever read
        warnings.filterwarnings("ignore", message=".*not writable.*")
        host = torch.from_numpy(src.reshape(-1).view(np.uint8))
    start, done = copier.copy(host, dst.view(-1).view(torch.uint8))
    if not warm:
        history.append((src.nbytes, start, done))
    return Upload(dst, done, copier.stream)
