"""The program's span log, read after a traced window: the spans of the
window, a span's descendants and self time, the device's idle time put down
to the spans open while it lasted, and the check that spans and device
events share one clock.

``thesia_tpu_torch.obs`` keeps the log only while tracing is on.  ``arm()``
turns it on: the readers built on the log call it when the harness loads
them, which it does in a traced run only, before set-up; the untraced run
never turns it on.  ``window(run)`` takes the log from the program once a run
(the first reader that asks) and keeps it on the run.  A program without a
span log gives None, and so does every reader built on it.

A record is ``(name, id, parent_id, root_id, thread, start_ns, end_ns)`` on
``time.time_ns()``'s clock, the clock of the device trace's intervals
(``trace.DeviceTrace.read``) and of the turns' phases.  A record whose start
is its end is a point: ``launch.<family>``, a hand kernel's launch.  A tree
whose root is named ``warm.<kind>`` is the shape warmer's; idle time is
never put down to it.
"""

from __future__ import annotations

import collections
import statistics
import sys

from . import trace as tr

NAME, ID, PARENT, ROOT, THREAD, START, END = range(7)
# the clock check's bounds.  The trace maps the card's timestamps to the
# host's clock with excursions that last seconds: kernels up to 1.1 ms
# before their own cudaLaunchKernel events in the same trace on an idle card,
# and hand kernels up to 4.1 ms before their launch points in a traced cell
# (NVIDIA H100 80GB HBM3), while the trace's host-side events keep to
# time.time_ns().  So the median lag of a family, which the excursions do
# not move, must show the launch before the kernel within LAUNCH_SLACK_NS,
# and no single lag may pass CLOCK_SLACK_NS, 2.4x the largest excursion
# seen: a trace on another clock fails either.  The stretches attributed
# are 10-1000 ms.
LAUNCH_SLACK_NS = 100_000
CLOCK_SLACK_NS = 10_000_000


def arm() -> None:
    """Turn the program's span log on, where the program has one."""
    from thesia_tpu_torch import obs

    if hasattr(obs, "tracing"):
        obs.tracing(True)


def turn_bounds(turn) -> tuple[int, int]:
    """A turn's first and last instant by its phases (``time.time_ns()``)."""
    return turn.phases[0][1], turn.phases[-1][2]


class Window:
    """The span log of one run's window.  ``spans`` are the records that
    overlap [t0, t1]; lookups by id, parent and root see the whole log."""

    def __init__(self, records: list, t0: int, t1: int):
        self.t0, self.t1 = t0, t1
        self.by_id = {r[ID]: r for r in records}
        self.children = collections.defaultdict(list)
        self.by_root = collections.defaultdict(list)
        for r in records:
            if r[PARENT] is not None:
                self.children[r[PARENT]].append(r)
            self.by_root[r[ROOT]].append(r)
        self.spans = [r for r in records if r[END] >= t0 and r[START] <= t1]
        self._depth: dict[int, int] = {}

    def named(self, name: str, turn=None) -> list:
        """Records of ``name`` that start in the window, or in ``turn``."""
        a, b = (self.t0, self.t1) if turn is None else turn_bounds(turn)
        return [r for r in self.spans if r[NAME] == name and a <= r[START] < b]

    def root_of(self, rec):
        return self.by_id.get(rec[ROOT])

    def is_warm(self, rec) -> bool:
        root = self.root_of(rec)
        return root is not None and root[NAME].startswith("warm.")

    def descendants(self, rec) -> list:
        """Every record ``rec`` caused, on any thread: its subtree, less the
        trees of their own (warm jobs) rooted in it."""
        if rec[ROOT] == rec[ID]:
            return [r for r in self.by_root[rec[ID]] if r is not rec]
        out, todo = [], [rec]
        while todo:
            for child in self.children[todo.pop()[ID]]:
                if child[ROOT] == rec[ROOT]:
                    out.append(child)
                    todo.append(child)
        return out

    def self_ns(self, rec) -> int:
        """The span's interval less the union of its descendants'."""
        return rec[END] - rec[START] - union_ns(
            [(max(r[START], rec[START]), min(r[END], rec[END])) for r in self.descendants(rec)])

    def depth(self, rec) -> int:
        """Ancestors through the parent links, across threads and roots."""
        d = self._depth.get(rec[ID])
        if d is None:
            parent = self.by_id.get(rec[PARENT]) if rec[PARENT] is not None else None
            d = 0 if parent is None else self.depth(parent) + 1
            self._depth[rec[ID]] = d
        return d


def union_ns(intervals) -> int:
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + (0 if cur_b is None else cur_b - cur_a)


def window(run, log=sys.stderr) -> Window | None:
    """The run's window of the span log: [the device trace's window] in a
    traced run on the card, else from the first turn's start to the last
    turn's end.  None without turns or without a span log."""
    if "_span_window" not in vars(run):
        run._span_window = None
        from thesia_tpu_torch import obs

        if hasattr(obs, "span_log") and run.turns:
            if run.trace is not None:
                t0, t1 = run.trace["t0_ns"], run.trace["t1_ns"]
            else:
                t0, t1 = turn_bounds(run.turns[0])[0], turn_bounds(run.turns[-1])[1]
            win = run._span_window = Window(obs.span_log(), t0, t1)
            warm = collections.Counter(r[NAME].removeprefix("warm.") for r in win.spans
                                       if r[ROOT] == r[ID] and r[NAME].startswith("warm.")
                                       and t0 <= r[START] < t1)
            print(f"span log: {len(win.spans)} records in the window; warm jobs run in the "
                  f"window by kind: {dict(warm) or 'none'}", file=log)
    return run._span_window


def clock_check(win: Window, trace: dict) -> tuple[bool, dict]:
    """Each hand kernel's device events from the window's start against its
    launch points (``launch.<family>``) from the same instant, both sorted:
    the i-th event cannot start before the i-th launch on one clock, so each
    lag is event minus launch.  (ok, {family: [lag_ns]}): ok when events and
    launches are as many (the window ends after a synchronize, and set-up
    leaves the card idle), each family's median lag is at least
    -LAUNCH_SLACK_NS and no lag is below -CLOCK_SLACK_NS."""
    lags, ok = {}, True
    for family, pattern in tr.HAND_KERNELS.items():
        events = sorted(a for a, _b, n in trace["intervals"] if pattern in n and a >= win.t0)
        launches = sorted(r[START] for r in win.spans
                          if r[NAME] == f"launch.{family}" and r[START] >= win.t0)
        got = lags[family] = [e - s for e, s in zip(events, launches)]
        ok = ok and len(launches) == len(events) and all(v >= -CLOCK_SLACK_NS for v in got) \
            and (not got or statistics.median(got) >= -LAUNCH_SLACK_NS)
    return ok, lags


def idle_gaps(trace: dict) -> list[tuple[int, int]]:
    """The window's stretches with no device operation, in order."""
    gaps, prev = [], trace["t0_ns"]
    for a, b, _n in trace["intervals"] + [(trace["t1_ns"], trace["t1_ns"], "")]:
        if a > prev:
            gaps.append((prev, min(a, trace["t1_ns"])))
        prev = max(prev, b)
    return [(a, b) for a, b in gaps if b > a]


def attribute(win: Window, gaps: list) -> list[tuple[int, int, tuple | None]]:
    """Cut each gap where the deepest open span changes, over every thread,
    the warmer's trees and the points left out (the latest started of equal
    depth): [(start_ns, end_ns, record or None)]."""
    events = []
    for r in win.spans:
        if r[END] > r[START] and not win.is_warm(r):
            events.append((r[START], 1, r[ID]))
            events.append((r[END], 0, r[ID]))
    events.sort()
    open_, pieces, i = {}, [], 0

    def deepest():
        if not open_:
            return None
        return max(open_.values(), key=lambda r: (win.depth(r), r[START], r[ID]))

    def step(ev):
        if ev[1]:
            open_[ev[2]] = win.by_id[ev[2]]
        else:
            open_.pop(ev[2], None)

    for ga, gb in gaps:
        while i < len(events) and events[i][0] <= ga:
            step(events[i])
            i += 1
        cur, rec = ga, deepest()
        while i < len(events) and events[i][0] < gb:
            t = events[i][0]
            step(events[i])
            i += 1
            now = deepest()
            if now is not rec:
                if t > cur:
                    pieces.append((cur, t, rec))
                    cur = t
                rec = now
        pieces.append((cur, gb, rec))
    return pieces


def phase_at(run, t: int) -> str:
    """The harness step (a turn's phase) that holds ``t``."""
    for turn in run.turns:
        for name, a, b in turn.phases:
            if a <= t < b:
                return name
    return "between turns"


def idle(run, log=sys.stderr) -> list | None:
    """The window's idle pieces put down to spans (``attribute``), once a run;
    None without a device trace, without a span log, or where the clock
    check fails.  The first call prints the clock check, the spans holding
    the most idle time and the longest pieces (``<step>|<span>``) to
    ``log``, whatever the check says."""
    if "_span_idle" in vars(run):
        return run._span_idle
    run._span_idle = None
    win = window(run, log)
    if win is None or run.trace is None:
        return None
    ok, lags = clock_check(win, run.trace)
    parts = []
    for family, ns in lags.items():
        if ns:
            ms = [v / 1e6 for v in ns]
            early = sum(v < -LAUNCH_SLACK_NS for v in ns)
            parts.append(f"{family} n={len(ms)} min {min(ms):.4f} median "
                         f"{statistics.median(ms):.4f} max {max(ms):.4f} "
                         f"({early} over {LAUNCH_SLACK_NS / 1e6} ms early)")
    print("span clock check, ms from each hand kernel's launch to its device start: "
          + ("; ".join(parts) or "no hand kernel")
          + (" -- ok" if ok else " -- FAILED: a median below "
             f"-{LAUNCH_SLACK_NS / 1e6} ms, a lag below -{CLOCK_SLACK_NS / 1e6} ms, or "
             "kernels and launches not as many"), file=log)
    pieces = attribute(win, idle_gaps(run.trace))
    by_span: dict[str, float] = collections.defaultdict(float)
    for a, b, rec in pieces:
        by_span["unspanned" if rec is None else rec[NAME]] += (b - a) / 1e9
    top = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    print("device-idle seconds by the deepest open span: "
          + ", ".join(f"{n} {s:.3f}" for n, s in top), file=log)
    longest = sorted(pieces, key=lambda p: p[0] - p[1])[:10]
    print("longest idle pieces: " + ", ".join(
        f"{phase_at(run, (a + b) // 2)}|{'unspanned' if rec is None else rec[NAME]} "
        f"{(b - a) / 1e9:.4f}" for a, b, rec in longest), file=log)
    if ok:
        run._span_idle = pieces
    return run._span_idle


# -- what the readers share ------------------------------------------------------


def window_ms_a_turn(run, name: str) -> float | None:
    """Ms of the spans of ``name`` that start in the window, over its turns."""
    win = window(run)
    if win is None:
        return None
    return sum(r[END] - r[START] for r in win.named(name)) / 1e6 / len(run.turns)


def kind_ms(run, kind: str, keep) -> float | None:
    """Mean over the window's turns of ``kind`` of the ms of the spans that
    start in the turn and ``keep(win, record)`` accepts."""
    win, turns = window(run), run.of(kind)
    if win is None or not turns:
        return None
    total = 0
    for turn in turns:
        a, b = turn_bounds(turn)
        total += sum(r[END] - r[START] for r in win.spans
                     if a <= r[START] < b and keep(win, r))
    return total / 1e6 / len(turns)


def first_in_turns(run, name: str) -> list:
    """The first root span of ``name`` in each turn of the window that has one."""
    win = window(run)
    if win is None:
        return []
    out = []
    for turn in run.turns:
        got = [r for r in win.named(name, turn) if r[ROOT] == r[ID]]
        if got:
            out.append(min(got, key=lambda r: r[START]))
    return out


TILE_COMMANDS = ("command.get_spectrogram_tile", "command.get_waveform_tile")


def tile_kind(win: Window, rec) -> str:
    """A tile command's kind: ``region`` (a spectrogram tile fetched from the
    device), ``image`` (from the landed host image), ``waveform``, or
    ``cached`` (no encode under it)."""
    names = {r[NAME] for r in win.descendants(rec)}
    if "tile.region_d2h" in names:
        return "region"
    if "tile.spectrogram_encode" in names:
        return "image"
    return "waveform" if "tile.waveform_encode" in names else "cached"


def tile_ms(run, kind: str) -> list[float]:
    """Ms of the window's tile commands of ``kind``."""
    win = window(run)
    if win is None:
        return []
    return [(r[END] - r[START]) / 1e6 for r in win.spans
            if r[NAME] in TILE_COMMANDS and r[ROOT] == r[ID] and win.t0 <= r[START] < win.t1
            and tile_kind(win, r) == kind]


def idle_unspanned_pct(run) -> float | None:
    """100 x the window's device-idle time in which no span of the program
    (the warmer's left out) was open on any thread, over all of it."""
    pieces = idle(run)
    if not pieces:
        return None
    total = sum(b - a for a, b, _r in pieces)
    return 100.0 * sum(b - a for a, b, r in pieces if r is None) / total
