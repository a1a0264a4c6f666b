"""The readings that the limits of ``correct`` are set from.

``control_numbers``: the control -- the reference computed in the precision
just below the port's (``Reference(control=True)``) put in the program's
place -- held against the reference on the requests a run of the cell makes
(the viewport's tiles and the summary at the cell's knob states), at the
cell's own size; it needs no program.  ``program_numbers``: runs of the
program itself, a short window each, one process for all seeds.

    python3 -m benchmark.harness.control --workload song_memo.open \
        --program-seeds 1,2,3 --control-seeds 4,5,6 --seconds 8

prints one JSON line a seed and side.
"""

from __future__ import annotations

import argparse
import json
import random
import struct
import sys
import time

from . import signals
from .drive import deck_states, initial_state, spectrogram_tiles, waveform_tiles
from .ref import render
from .ref.pipeline import Observation, Reference, compare


def _metadata(ref: Reference) -> dict:
    out = {}
    for t, ((x, sr), img) in enumerate(zip(ref.tracks, ref.images)):
        for ch in range(x.shape[0]):
            out[(t, ch)] = {"spectrogramWidth": img.shape[2], "spectrogramHeight": img.shape[1],
                            "trackSec": x.shape[1] / sr, "sampleCount": x.shape[1],
                            "sampleRate": sr, "waveformTileBins": render.WAVEFORM_BINS}
    return out


def _as_program(ref: Reference, ctl: Reference, state: dict, viewport: dict) -> Observation:
    """The control's answers, in the port's wire format, to the requests a
    paint and a summary of ``state`` make."""
    ref.outputs(state)
    ctl.outputs(state)
    md = _metadata(ref)
    longest = max(m["trackSec"] for m in md.values())
    spec, wave = {}, {}
    for (t, ch), m in md.items():
        for lx, ly, tx, ty in spectrogram_tiles(m, longest, viewport["width_px"],
                                                viewport["height_px"]):
            (w, h, ox, oy), rgba = ctl.spec_tile(t, ch, lx, ly, tx, ty)
            spec[(t, ch, lx, ly, tx, ty)] = (struct.pack("<QIIIIIIII", 1, w, h, lx, ly, tx, ty,
                                                         ox, oy) + rgba.tobytes())
        for level, i in waveform_tiles(m, longest, viewport["width_px"]):
            bins = ctl.wave_tile(t, ch, level, i).astype("<f4")
            wave[(t, ch, level, i)] = (struct.pack("<QIIII", 1, bins.shape[0], 1 << level, i, 0)
                                       + bins.tobytes())
    summary = {t: ctl.summary(t) for t in range(len(ctl.tracks))}
    limiter = {t: ctl.limiter(t) for t in range(len(ctl.tracks))}
    return Observation(state=dict(state), spec_tiles=spec, wave_tiles=wave, summary=summary,
                       limiter=limiter)


def cell_states(cell, ref: Reference, seed: int, n: int) -> list[dict]:
    """The distinct knob states a run of the cell observes: those the deck's
    periodic pass leaves after the mix's ``observe_steps``, and ``n`` others
    drawn from the seed (hot normalize targets resolved from the
    reference's stats, as the loop resolves them from the engine's)."""
    st = ref._orig_stats[0]
    periodic = deck_states(initial_state(cell.config["settings"]), cell.mix["deck"],
                           st.global_lufs, st.max_peak_db)
    steps = cell.mix.get("observe_steps", [])
    chosen = [periodic[i] for i in steps]
    rest = [s for i, s in enumerate(periodic) if i not in steps and s not in chosen]
    rest = [s for i, s in enumerate(rest) if s not in rest[:i]]
    return chosen + random.Random(seed).sample(rest, min(n, len(rest)))


def control_numbers(cell, seed: int, device, n_states: int = 2) -> dict:
    tracks = [(signals.make_track(spec, seed, i, device), int(spec["sr"]))
              for i, spec in enumerate(cell.config["tracks"])]
    ref = Reference(tracks, device)
    ctl = Reference(tracks, device, control=True)
    states = cell_states(cell, ref, seed, n_states)
    obs = [_as_program(ref, ctl, st, cell.mix["viewport"]) for st in states]
    out = compare(ref, obs)
    out.pop("tiles_compared")
    return out


def main(argv=None) -> int:
    from pathlib import Path

    from .cells import ROOT, resolve

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = resolve(args.workload, False, Path(ROOT))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        nums = control_numbers(cell, seed, args.device)
        print(json.dumps({"side": "control", "workload": args.workload, "seed": seed,
                          "numbers": nums, "s": time.perf_counter() - t}), flush=True)
    if args.program_seeds:
        from benchmark.run import production_env, run_cell

        production_env()
        for seed in [int(s) for s in args.program_seeds.split(",") if s]:
            t = time.perf_counter()
            r = run_cell(cell, seed, args.seconds, False, device=args.device, t0=t)
            print(json.dumps({"side": "program", "workload": args.workload, "seed": seed,
                              "numbers": {k: c["value"] for k, c in r["checks"].items()},
                              "metrics": r["metrics"], "s": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
