"""Observability: timing spans, stage metrics, and a readers-writer lock.

Host copy of ``span``, ``record``, ``summary``, ``reset`` and ``RwLock`` from
``thesia_tpu/obs.py`` (verbatim; ``RwLock`` is ``thesia_tpu/obs.py:97-150``).
``profile_trace`` is the counterpart of the original's (``:152``), which
captures a JAX trace: here ``torch.profiler`` records the host and, where
there is a card, its kernels and copies, and writes a Chrome trace.  Spans are
logged under the logger "thesia_tpu" when THESIA_LOG_SPANS is set.

The span log is the port's own (the original keeps totals only): while
``tracing(True)`` is on, every span also appends ``(name, id, parent_id,
root_id, thread_name, start_ns, end_ns)`` to a bounded in-memory log, on
``time.time_ns()``'s clock (torch.profiler's ``baseTimeNanoseconds`` + ``ts``
is that clock too), which ``span_log()`` hands out.  A ``root_span`` (a
command, a warm job) starts a tree: every span it causes, on any thread,
carries its id as ``root_id``.  Work handed to another thread keeps its
place in the tree through ``current()`` and ``resume()`` (or ``carry(fn)``).
``mark`` logs a point (a kernel launch).  While tracing is off, ``span`` does
what the original's does after one flag check, and the rest do nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
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
    """Time a stage; records into the metrics registry (and, while tracing
    is on, into the span log as a child of the span open here)."""
    if _tracing:
        yield from _traced(stage, _current.get(), False)
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(stage, time.perf_counter() - t0)


# -- the span log ---------------------------------------------------------------

_LOG_MAX = 1 << 19  # records; the oldest go first
_tracing = False
_log: deque = deque(maxlen=_LOG_MAX)
_ids = itertools.count(1)
# (id, root_id) of the span open in this context
_current: contextvars.ContextVar = contextvars.ContextVar("thesia_span", default=None)


def tracing(on: bool) -> None:
    """Turn the span log on or off (off at import)."""
    global _tracing
    _tracing = bool(on)


def span_log() -> list:
    """The logged records, oldest first; the log is empty afterwards."""
    out = []
    try:
        while True:
            out.append(_log.popleft())
    except IndexError:
        return out


def _traced(stage: str, parent, root: bool):
    sid = next(_ids)
    root_id = sid if root or parent is None else parent[1]
    token = _current.set((sid, root_id))
    start = time.time_ns()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds = time.perf_counter() - t0
        end = time.time_ns()
        _current.reset(token)
        record(stage, seconds)
        _log.append((stage, sid, None if parent is None else parent[0], root_id,
                     threading.current_thread().name, start, end))


@contextlib.contextmanager
def root_span(stage: str, parent=None):
    """A span that starts a tree of its own: the spans it causes carry its id
    as their root.  Its parent is ``parent`` (a ``current()`` taken where the
    work was handed over), else the span open here."""
    if not _tracing:
        with span(stage):
            yield
        return
    yield from _traced(stage, _current.get() if parent is None else parent, True)


def current():
    """The span open here, for ``resume`` on another thread; None while
    tracing is off."""
    return _current.get() if _tracing else None


@contextlib.contextmanager
def resume(handle):
    """Run the block inside ``handle``'s span (a ``current()``; None: as is)."""
    if handle is None:
        yield
        return
    token = _current.set(handle)
    try:
        yield
    finally:
        _current.reset(token)


def carry(fn):
    """``fn`` run inside the span open here, whatever thread calls it; ``fn``
    itself while tracing is off."""
    handle = current()
    if handle is None:
        return fn

    def carried(*args, **kwargs):
        with resume(handle):
            return fn(*args, **kwargs)

    return carried


def mark(name: str) -> None:
    """Log a point (start = end) as a child of the span open here."""
    if not _tracing:
        return
    parent = _current.get()
    sid = next(_ids)
    now = time.time_ns()
    _log.append((name, sid, None if parent is None else parent[0],
                 sid if parent is None else parent[1], threading.current_thread().name,
                 now, now))


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
    chrome://tracing or Perfetto) into the returned directory.  The span log
    is on meanwhile, and the spans that ran in the capture join the host
    events on their thread's row (category ``span``; ``id``, ``parent`` and
    ``root`` in ``args``)."""
    import json
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
    was_tracing = _tracing
    tracing(True)
    t0 = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            time.sleep(max(duration_ms, 1.0) / 1000.0)
    finally:
        t1 = time.time_ns()
        # a log someone else turned on stays theirs: read it, leave it
        records = list(_log) if was_tracing else span_log()
        tracing(was_tracing)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(
        _span_events([r for r in records if r[6] >= t0 and r[5] <= t1],
                     int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)
    log.info("profiler trace captured to %s", out)
    return out


def _span_events(records: list, base_ns: int) -> list:
    """Chrome trace events of span-log records: complete events on the row of
    their thread (its native id while it lives, else a row of its own named
    after it, numbered above any thread id)."""
    pid = os.getpid()
    tids = {t.name: t.native_id for t in threading.enumerate()}
    out = []
    for name, sid, parent, root, thread, start, end in records:
        tid = tids.get(thread)
        if tid is None:
            tid = tids[thread] = (1 << 32) + len(tids)
            out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                        "args": {"name": thread}})
        out.append({"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": tid,
                    "ts": (start - base_ns) / 1e3, "dur": (end - start) / 1e3,
                    "args": {"id": sid, "parent": parent, "root": root}})
    return out
