"""The one traffic generator: a closed loop of one viewer user on
``thesia_tpu_torch.engine.service.Commands.call``, the command table the
viewer's HTTP requests reach, minus the transport.

A mix (``benchmark/traffic/<mix>.json``) is data only; this module knows no
mix by name.  It holds:

* ``setup``: steps run once, before the deck's warm pass;
* ``deck``: the turns of the loop, each ``{"kind", "launches", "steps"}``.
  The loop runs the deck in its order, cyclically, from a start the seed
  picks.  Set-up first sets each knob the deck turns to its value in the
  periodic pass just before that start, then runs one whole pass, so it
  visits exactly the states the window will (every shape the window uses
  is warm) and every seed does the same set of turns.  ``kind`` names the
  turn for the metric readers; ``launches`` lists the hand-kernel families
  (``spec_fft``, ``k6``) the turn's command launches once a track, the
  rule the roofline readers count work by;
* ``viewport`` (``width_px``, ``height_px``), ``poll_ms``, and the sample
  of turns held against the reference: the window's first turn, the first
  run of each deck index in ``observe_steps``, and each other turn with
  probability ``observe_share``, at most ``observe_max`` of those.

A step is ``{"do": ...}``, one of:

* ``call``: ``command`` with ``body``, where a string value ``$track_ids``,
  ``$paths`` or ``$value`` stands for the session's track ids, its WAV
  paths, or the step's new knob value.  With ``state`` (``spec``,
  ``db_range``, ``normalize`` or ``guard``: the knob state the reference
  works from) the step sets that knob to ``value`` (``"update": "merge"``
  merges a dict into the knob's).  A ``value`` ``{"peak_over_dbfs": d}``
  is the LUFS target that puts the first track's peak ``d`` dB over full
  scale, read from the engine once the set-up steps have run.  With
  ``"dispatch": true`` the call's host time is the turn's ``dispatch_ms``;
* ``await_revision``: poll until channel 0's ``spectrogramRevision`` has
  moved from its value before the turn (the command's result has landed);
* ``paint``: fetch every spectrogram and waveform tile of a
  ``viewport.width_px`` wide view of the whole session (the longest track
  fit to the width) at the level of detail where a tile column is at most
  one screen pixel, ``viewport.height_px`` rows a channel, as the viewer
  fetches them, also mid-stream; the turn's ``paint_ms`` ends here;
* ``settle``: poll until every channel's ``isComputing`` is false;
* ``summary``: the row readers the viewer refreshes (each track's LUFS,
  RMS dB, peak dB and guard text, then max and min dB);
* ``observe``: in a sampled turn, keep the last paint's tiles and summary
  (and the limiter gains the session holds) for the reference.

Polls run every ``poll_ms``.  ``step`` names a step in the breakdown
(default: the command or the action).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

from .ref.pipeline import Observation

BINARY = {"get_spectrogram_tile", "get_waveform_tile"}
SETTLE_TIMEOUT_S = 120.0
KNOBS = ("spec", "db_range", "normalize", "guard")


class CommandFailed(RuntimeError):
    pass


@dataclasses.dataclass
class Turn:
    """One turn of the deck, by the host clock."""

    kind: str
    t0: float
    rules: tuple = ()  # the deck entry's ``launches``
    dispatch_ms: float = math.nan
    paint_ms: float = math.nan
    end: float = math.nan
    launches: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)  # name -> (count, seconds)
    phases: list = dataclasses.field(default_factory=list)  # (name, start_ns, end_ns)

    def mark(self, step: str) -> None:
        """Close the running step (if any) and start ``step``; "" ends."""
        now = time.time_ns()
        if self.phases and self.phases[-1][2] is None:
            name, start, _ = self.phases[-1]
            self.phases[-1] = (name, start, now)
        if step:
            self.phases.append((f"{self.kind}.{step}", now, None))


class Client:
    """The viewer's side of the command table: every call counted, every
    tile timed.  With ``after_call`` set (set-up), it runs after each call."""

    def __init__(self, commands):
        self.commands = commands
        self.attempted = 0
        self.failed = 0
        self.tile_ms: list[float] = []
        self.recording = False
        self.after_call = None

    def call(self, name: str, **body):
        self.attempted += 1
        status, payload = self.commands.call(name, body)
        if self.after_call is not None:
            self.after_call()
        if status != 200:
            self.failed += 1
            raise CommandFailed(f"{name} {body}: {status} {payload}")
        return payload if name in BINARY else payload["result"]

    def tile(self, name: str, **body) -> bytes:
        t = time.perf_counter()
        out = self.call(name, **body)
        if self.recording:
            self.tile_ms.append((time.perf_counter() - t) * 1e3)
        return out


def number(tagged: dict) -> float:
    return {"Infinity": math.inf, "NegInfinity": -math.inf, "NaN": math.nan}.get(
        tagged["type"], tagged.get("value"))


def initial_state(settings: dict) -> dict:
    return {"spec": dict(settings["specSetting"]), "db_range": float(settings["dBRange"]),
            "normalize": dict(settings["commonNormalize"]),
            "guard": settings["commonGuardClipping"]}


def resolve_value(value, lufs: float, peak: float):
    """A knob value as sent: ``{"peak_over_dbfs": d}`` becomes the LUFS
    target that puts a track of loudness ``lufs`` and peak ``peak`` dB that
    many dB over full scale."""
    if isinstance(value, dict) and "peak_over_dbfs" in value:
        return {"type": "LUFS", "target": round(lufs - peak + value["peak_over_dbfs"], 3)}
    return value


def needs_resolving(deck: list) -> bool:
    return any(isinstance(st.get("value"), dict) and "peak_over_dbfs" in st["value"]
               for entry in deck for st in entry["steps"])


def update_state(state: dict, step: dict, value):
    """Set the step's knob in ``state``; returns the knob's new value."""
    knob = step["state"]
    if knob not in KNOBS:
        raise ValueError(f"unknown knob state {knob!r}")
    if step.get("update", "set") == "merge":
        state[knob] = {**state[knob], **value}
    else:
        state[knob] = float(value) if knob == "db_range" else value
    return state[knob]


def deck_states(state0: dict, deck: list, lufs: float | None = None,
                peak: float | None = None) -> list[dict]:
    """The knob state each deck entry leaves in a periodic pass (the deck
    run twice from ``state0``; the second pass), values resolved from
    ``lufs`` and ``peak`` where given."""
    state, out = copy_state(state0), []
    for entry in deck * 2:
        for st in entry["steps"]:
            if st["do"] == "call" and "state" in st:
                value = st["value"] if lufs is None else resolve_value(st["value"], lufs, peak)
                update_state(state, st, value)
        out.append(copy_state(state))
    return out[len(deck):]


class Session:
    """The state the loop has set (the reference works from it) and the
    viewer-side readers of one session."""

    def __init__(self, client: Client, paths: list[str], n_ch: list[int], mix: dict,
                 settings: dict):
        self.c = client
        self.paths = paths
        self.ids = list(range(len(paths)))
        self.channels = [f"{t}_{ch}" for t in self.ids for ch in range(n_ch[t])]
        self.mix = mix
        self.poll_s = mix["poll_ms"] / 1e3
        self.state = initial_state(settings)

    def apply_settings(self) -> None:
        """Bring the engine's knobs to the configuration's settings (before
        any track is open), sending only those that differ."""
        c, s = self.c, self.state
        if c.call("get_spec_setting") != s["spec"]:
            c.call("set_spec_setting", specSetting=s["spec"])
        if c.call("get_dB_range") != s["db_range"]:
            c.call("set_dB_range", dBRange=s["db_range"])
        if c.call("get_common_normalize") != s["normalize"]:
            c.call("set_common_normalize", target=s["normalize"])
        if c.call("get_common_guard_clipping") != s["guard"]:
            c.call("set_common_guard_clipping", mode=s["guard"])

    # -- readers -------------------------------------------------------------
    def metadata(self) -> dict:
        return {k: self.c.call("get_audio_render_metadata", idChStr=k) for k in self.channels}

    def wait(self, done, what: str) -> None:
        t_end = time.perf_counter() + SETTLE_TIMEOUT_S
        while True:
            if done(self.metadata()):
                return
            if time.perf_counter() > t_end:
                raise CommandFailed(f"not {what} within {SETTLE_TIMEOUT_S} s")
            time.sleep(self.poll_s)

    def settle(self) -> None:
        self.wait(lambda md: not any(m["isComputing"] for m in md.values()), "settled")

    def revision(self) -> int:
        return self.c.call("get_audio_render_metadata", idChStr=self.channels[0])[
            "spectrogramRevision"]

    def paint(self, keep: bool) -> tuple[dict, dict]:
        """Fetch the viewport's tiles; with ``keep`` their bytes by request."""
        vp = self.mix["viewport"]
        md = self.metadata()
        longest = max(m["trackSec"] for m in md.values())
        spec, wave = {}, {}
        for key, m in md.items():
            t, ch = (int(v) for v in key.split("_"))
            for req in spectrogram_tiles(m, longest, vp["width_px"], vp["height_px"]):
                data = self.c.tile("get_spectrogram_tile", idChStr=key, levelX=req[0],
                                   levelY=req[1], tileX=req[2], tileY=req[3])
                if keep:
                    spec[(t, ch, *req)] = data
            for req in waveform_tiles(m, longest, vp["width_px"]):
                data = self.c.tile("get_waveform_tile", idChStr=key, level=req[0],
                                   tileIndex=req[1])
                if keep:
                    wave[(t, ch, *req)] = data
        return spec, wave

    def summary(self) -> dict:
        out = {}
        for t in self.ids:
            out[t] = {"lufs": number(self.c.call("get_global_lufs", trackId=t)),
                      "rms": number(self.c.call("get_rms_dB", trackId=t)),
                      "peak": number(self.c.call("get_max_peak_dB", trackId=t))}
            self.c.call("get_guard_clip_stats", trackId=t)
        self.c.call("get_max_dB")
        self.c.call("get_min_dB")
        return out


def spectrogram_tiles(md: dict, longest_s: float, width_px: int, height_px: int):
    """(levelX, levelY, tileX, tileY) of the view of [0, longest_s) at
    ``width_px``: the deepest X level whose columns are at most one pixel
    each, the deepest Y level at least ``height_px`` rows tall."""
    w, h = md["spectrogramWidth"], md["spectrogramHeight"]
    if w == 0 or h == 0:
        return []
    cols_per_px = (w / md["trackSec"]) * longest_s / width_px
    lx = max(int(math.floor(math.log2(cols_per_px))), 0) if cols_per_px > 1 else 0
    ly = max(int(math.floor(math.log2(h / height_px))), 0) if h > height_px else 0
    lod_w = -(-w // (1 << lx))
    lod_h = -(-h // (1 << ly))
    return [(lx, ly, tx, ty) for ty in range(-(-lod_h // 512)) for tx in range(-(-lod_w // 512))]


def waveform_tiles(md: dict, longest_s: float, width_px: int):
    """(level, tileIndex) of the view: bins of at most one pixel each."""
    n = md["sampleCount"]
    spp = md["sampleRate"] * longest_s / width_px
    level = max(int(math.floor(math.log2(spp))), 0) if spp > 1 else 0
    per_tile = md["waveformTileBins"] << level
    return [(level, i) for i in range(-(-n // per_tile))]


class Loop:
    """A mix's loop on one session: ``setup()`` runs the set-up steps and one
    pass of the deck (its shapes warm), ``run(seconds)`` the window.
    ``turns``, ``states`` (the knob state each turn left) and ``observed``
    (the outputs of the sampled turns) are the window's.  ``counters`` and
    ``spans`` read the port's launch counters and span totals; each turn
    keeps its own change of both."""

    def __init__(self, sess: Session, seed: int, counters=None, spans=None, warm_idle=None):
        self.s = sess
        self.mix = sess.mix
        self.rng = random.Random(seed)
        self.counters = counters or (lambda: {})
        self.spans = spans or (lambda: {})
        self.warm_idle = warm_idle
        self.deck = [dict(e) for e in self.mix["deck"]]
        self.start = self.rng.randrange(len(self.deck))
        self.turns: list[Turn] = []
        self.states: list[dict] = []
        self.observed: list[Observation] = []
        self._last = (({}, {}), {})  # the last paint's tiles, the last summary

    def setup(self) -> None:
        """Set-up steps and a whole pass of the deck.  After every command of
        set-up the shape warmer runs out what it was handed (``warm_idle``),
        so no job of it is superseded unrun and the window's turns find
        every shape they hand it already warm."""
        self.s.c.after_call = self.warm_idle
        try:
            self.s.apply_settings()
            setup = Turn("setup", time.perf_counter())
            for step in self.mix.get("setup", []):
                self._step(setup, step, keep=False)
            if needs_resolving(self.deck):
                lufs = number(self.s.c.call("get_global_lufs", trackId=0))
                peak = number(self.s.c.call("get_max_peak_dB", trackId=0))
                self.deck = [{**e, "steps": [{**st, "value": resolve_value(st["value"], lufs,
                                                                           peak)}
                                             if "value" in st else st for st in e["steps"]]}
                             for e in self.deck]
            self._prime()
            for i in range(len(self.deck)):
                self._turn(i, keep=False)
        finally:
            self.s.c.after_call = None
        self.turns, self.states, self.observed = [], [], []

    def _prime(self) -> None:
        """Set each knob the deck turns to its value in the deck's periodic
        pass just before the window's first turn, by the deck's own command
        for that knob, one at a time, each until the engine has landed and
        settled it: the warm pass then visits exactly the states the window
        will, so the window hands the shape warmer no job it has not run."""
        first = {}
        for entry in self.deck:
            for st in entry["steps"]:
                if st["do"] == "call" and "state" in st:
                    first.setdefault(st["state"], st)
        if not first:
            return
        target = deck_states(self.s.state, self.deck)[(self.start - 1) % len(self.deck)]
        prime = Turn("prime", time.perf_counter())
        for knob, step in first.items():
            if target[knob] == self.s.state[knob]:
                continue
            before = self.s.revision()
            self._step(prime, {**step, "value": target[knob], "update": "set"}, keep=False)
            self._step(prime, {"do": "await_revision"}, keep=False, before=before)
            self.s.settle()

    def run(self, seconds: float) -> float:
        """Turns until ``seconds`` have passed; returns the window's length,
        which ends with the last turn it started."""
        self.turns, self.states, self.observed = [], [], []
        self.s.c.recording = True
        t0 = time.perf_counter()
        i, drawn = 0, 0
        steps = set(self.mix.get("observe_steps", []))
        n = len(self.deck)
        while time.perf_counter() - t0 < seconds:
            keep = i == 0 or ((self.start + i) % n in steps and i < n)
            if not keep and drawn < self.mix["observe_max"] and \
                    self.rng.random() < self.mix["observe_share"]:
                keep, drawn = True, drawn + 1
            self._turn(i, keep)
            i += 1
        window = time.perf_counter() - t0
        self.s.c.recording = False
        return window

    def _turn(self, i: int, keep: bool) -> None:
        entry = self.deck[(self.start + i) % len(self.deck)]
        steps = entry["steps"]
        before = self.s.revision() if any(st["do"] == "await_revision" for st in steps) else None
        launches0, spans0 = self.counters(), self.spans()
        turn = Turn(entry["kind"], time.perf_counter(), tuple(entry.get("launches", ())))
        for step in steps:
            self._step(turn, step, keep, before)
        turn.mark("")
        turn.end = time.perf_counter()
        launches, spans = self.counters(), self.spans()
        turn.launches = {k: v - launches0.get(k, 0) for k, v in launches.items()}
        turn.spans = {k: (c - spans0.get(k, (0, 0.0))[0], s - spans0.get(k, (0, 0.0))[1])
                      for k, (c, s) in spans.items() if c > spans0.get(k, (0, 0.0))[0]}
        self.turns.append(turn)
        self.states.append(copy_state(self.s.state))

    def _step(self, turn: Turn, step: dict, keep: bool, before=None) -> None:
        s, do = self.s, step["do"]
        turn.mark(step.get("step", step.get("command", do)))
        if do == "call":
            value = None
            if "state" in step:
                value = update_state(s.state, step, step["value"])
            subs = {"$track_ids": s.ids, "$paths": s.paths, "$value": value}
            body = {k: subs.get(v, v) if isinstance(v, str) else v
                    for k, v in step.get("body", {}).items()}
            t = time.perf_counter()
            s.c.call(step["command"], **body)
            if step.get("dispatch"):
                turn.dispatch_ms = (time.perf_counter() - t) * 1e3
        elif do == "await_revision":
            s.wait(lambda md: md[s.channels[0]]["spectrogramRevision"] != before, "repainted")
        elif do == "paint":
            self._last = (s.paint(keep), self._last[1])
            turn.paint_ms = (time.perf_counter() - turn.t0) * 1e3
        elif do == "settle":
            s.settle()
        elif do == "summary":
            self._last = (self._last[0], s.summary())
        elif do == "observe":
            if keep:
                self.observed.append(self._observe_now(*self._last))
        else:
            raise ValueError(f"unknown step {do!r}")

    def _observe_now(self, tiles, summary) -> Observation:
        """The turn's tiles and readers, and the limiter gains the session
        holds (a reference: a later command publishes new arrays)."""
        tracklist = self.s.c.commands.session.tracklist
        spec, wave = tiles
        return Observation(state=copy_state(self.s.state), spec_tiles=spec, wave_tiles=wave,
                           summary=summary,
                           limiter={t: tracklist[t].guard_clipping_gain() for t in self.s.ids})


def copy_state(state: dict) -> dict:
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in state.items()}
