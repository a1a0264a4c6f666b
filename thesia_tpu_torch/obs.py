"""Observability: timing spans, stage metrics, and a readers-writer lock.

Host copy of ``span``, ``record``, ``summary``, ``reset`` and ``RwLock`` from
``thesia_tpu/obs.py`` (verbatim; ``RwLock`` is ``thesia_tpu/obs.py:97-150``).
``profile_trace`` is the counterpart of the original's (``:152``), which
captures a JAX trace: here ``torch.profiler`` records the host and, where
there is a card, its kernels and copies, and writes a Chrome trace.  Spans are
logged under the logger "thesia_tpu" when THESIA_LOG_SPANS is set.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque

log = logging.getLogger("thesia_tpu")

_RING = 512
_LOG_SPANS = os.environ.get("THESIA_LOG_SPANS", "") not in ("", "0", "false", "False")


class _Stage:
    __slots__ = ("durations", "count", "total")

    def __init__(self):
        self.durations = deque(maxlen=_RING)
        self.count = 0
        self.total = 0.0


_stages: dict[str, _Stage] = {}
_stages_lock = threading.Lock()


def record(stage: str, seconds: float) -> None:
    with _stages_lock:
        s = _stages.get(stage)
        if s is None:
            s = _stages[stage] = _Stage()
        s.durations.append(seconds)
        s.count += 1
        s.total += seconds
    if _LOG_SPANS:
        log.info("span %s %.3f ms", stage, seconds * 1e3)


@contextlib.contextmanager
def span(stage: str):
    """Time a stage; records into the metrics registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(stage, time.perf_counter() - t0)


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def summary() -> dict:
    """{stage: {count, total_ms, p50_ms, p95_ms, last_ms}} over the last
    512 samples per stage (counts/totals are lifetime)."""
    out = {}
    with _stages_lock:
        for name, s in _stages.items():
            vals = sorted(s.durations)
            out[name] = {
                "count": s.count,
                "total_ms": round(s.total * 1e3, 3),
                "p50_ms": round(_pct(vals, 0.50) * 1e3, 3),
                "p95_ms": round(_pct(vals, 0.95) * 1e3, 3),
                "last_ms": round((s.durations[-1] if s.durations else 0.0) * 1e3, 3),
            }
    return out


def reset() -> None:
    with _stages_lock:
        _stages.clear()


class RwLock:
    """Writer-priority readers-writer lock (threading.Condition based).

    NOT reentrant (like parking_lot's RwLock in the reference): a thread
    that re-enters read() while a writer is queued — or calls write()
    while holding read() — deadlocks.  Callers must not nest lock
    acquisitions on the same thread; session handlers take the lock once
    at the service boundary only."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            except BaseException:
                # an exception while blocked (KeyboardInterrupt, shutdown)
                # must not leak the counter — readers would spin on
                # _writers_waiting forever — AND must wake readers already
                # parked on the writer-priority gate: with no holder left,
                # nothing else would ever notify them (review finding)
                self._writers_waiting -= 1
                self._cond.notify_all()
                raise
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


def profile_trace(duration_ms: float, out_dir: str | None = None) -> str:
    """One-shot ``torch.profiler`` capture of ``duration_ms`` of the whole
    process (host ops, and the card's kernels and copies from every thread
    when CUDA is available), written as ``trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto) into the returned directory."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    if out_dir is None:
        out = tempfile.mkdtemp(prefix="thesia_tpu_torch_trace_")
    else:
        out = out_dir
        os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(max(duration_ms, 1.0) / 1000.0)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    log.info("profiler trace captured to %s", out)
    return out
