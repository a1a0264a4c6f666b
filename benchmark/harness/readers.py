"""What a metric's reader is handed: ``Run``, the record of one run's window,
and the helpers the readers in ``benchmark/metrics/`` share.

A reader is ``benchmark/metrics/<metric name>.py`` with ``UNIT`` and
``read(run) -> float | None``; None when the run holds nothing to read, and
the harness then leaves the metric out of the result line.  Turn kinds and
the kernels a turn launches come from the mix's deck (``drive.Turn.kind``,
``drive.Turn.rules``); nothing here names a mix or a kind.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

from . import trace as tr
from . import work
from .ref.framing import SpecSetting

# the port's launch counters of each kernel family a deck entry may list
LAUNCH_COUNTER = {"spec_fft": ("spec_fft_mel", "spec_fft_linear"), "k6": ("quantize_mips",)}
# the device kernels of each family, by name in the trace, and the one
# kernel of it that each launch runs once
TRACE_KERNEL = {"spec_fft": tr.HAND_KERNELS["spec_fft"], "k6": "k6_"}
LAUNCH_KERNEL = {"spec_fft": tr.HAND_KERNELS["spec_fft"], "k6": tr.HAND_KERNELS["k6"]}


@dataclasses.dataclass
class Run:
    setup_s: float
    window_s: float
    turns: list  # drive.Turn
    tile_ms: list
    spans: dict  # span name -> {"count", "total_ms"} over the window
    tracks: list  # (n_ch, n_samples, sr) a track of the configuration
    states: list  # the knob state each turn left
    warm: dict = dataclasses.field(default_factory=dict)  # warmers' launches in the window
    trace: dict | None = None  # trace.DeviceTrace.read(), traced runs only

    def of(self, *kinds) -> list:
        return [t for t in self.turns if t.kind in kinds]

    def span_ms(self, *names) -> float:
        return sum(self.spans.get(n, {}).get("total_ms", 0.0) for n in names)

    def span_count(self, *names) -> int:
        return sum(self.spans.get(n, {}).get("count", 0) for n in names)


def per_turn_ms(run: Run, *spans) -> float | None:
    """Total of the spans over the window, a turn."""
    n = len(run.turns)
    return run.span_ms(*spans) / n if n and run.span_count(*spans) else None


def kind_span_ms(run: Run, kind: str, *spans) -> float | None:
    """Mean over the window's turns of ``kind`` of the spans each recorded."""
    turns = run.of(kind)
    if not turns or not any(n in t.spans for t in turns for n in spans):
        return None
    return 1e3 * sum(t.spans.get(n, (0, 0.0))[1] for t in turns for n in spans) / len(turns)


def mean_turn_s(run: Run, kind: str) -> float | None:
    """The window's time in turns of ``kind`` over their number: a turn's
    time runs from its command to its last step (the turns of a closed loop
    fill the window)."""
    turns = run.of(kind)
    return sum(t.end - t.t0 for t in turns) / len(turns) if turns else None


def percentile(values: list, q: float) -> float:
    """The q-th percentile by ``statistics.quantiles`` (exclusive method)."""
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=100)[int(q) - 1]


def _turn_work(run: Run, turn_index: int, kernel: str) -> list[float]:
    """Least ms of each launch of ``kernel`` that the window's turn
    ``turn_index`` runs: once a track where the turn's deck entry lists the
    kernel, at the knob state the turn left."""
    turn, state = run.turns[turn_index], run.states[turn_index]
    if kernel not in turn.rules:
        return []
    setting = SpecSetting.from_json(state["spec"])
    max_sr = max(sr for _c, _n, sr in run.tracks)
    out = []
    for n_ch, n, sr in run.tracks:
        if kernel == "spec_fft":
            w = work.spectrogram_work(n_ch, n, sr, setting)
        else:
            n_rows, height, frames = work.image_shape(sr, max_sr, n, setting)
            w = work.image_work(n_ch, n_rows, height, frames)
        out.append(work.least_ms(w["bytes"], w["flop"])[0])
    return out


def warm_launches(run: Run, kernel: str) -> int:
    return sum(run.warm.get(k, 0) for k in LAUNCH_COUNTER[kernel])


def roofline_pct(run: Run, kernel: str) -> float | None:
    """100 x the least time of the engine's ``kernel`` launches in the window
    over their device time by kernel name.  The launches the engine counted
    must be the ones the deck's rules predict, or the count is wrong and the
    reader raises.  The warmers' launches in the window (counted by the
    port apart) are left out of the device time: each runs 17 frames of one
    row, so they are that many of the shortest ``LAUNCH_KERNEL`` events;
    where the events do not add up to both counts the reader returns None."""
    if run.trace is None or not run.turns:
        return None
    least, engine = 0.0, 0
    for i, turn in enumerate(run.turns):
        launches = _turn_work(run, i, kernel)
        counted = sum(turn.launches.get(k, 0) for k in LAUNCH_COUNTER[kernel])
        if counted != len(launches):
            raise AssertionError(f"{kernel}: a {turn.kind} turn launched {counted} times, "
                                 f"the work model counts {len(launches)}")
        least += sum(launches)
        engine += counted
    events = sorted(b - a for a, b, n in run.trace["intervals"] if LAUNCH_KERNEL[kernel] in n)
    n_warm = warm_launches(run, kernel)
    if len(events) != engine + n_warm:
        return None
    device_s = tr.kernel_seconds(run.trace, TRACE_KERNEL[kernel]) - sum(events[:n_warm]) / 1e9
    return 100.0 * least / 1e3 / device_s if device_s > 0 else None


def idle_pct(run: Run) -> float | None:
    if run.trace is None or not run.turns:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
