"""One long-track add on a fresh session, on one CUDA card: the add's wall
and host spans, then the apply and the landing of its image.

    python -m thesia_tpu_torch.tools.profile_long_add [--warm on|off] [WAV]    # from the repository root

WAV defaults to the 1-hour 16 kHz mono lecture of ``signals`` (115 MB, made
once into a temporary file).  The session runs in the default deferred mode;
prints the card's name and power limit, then one JSON line: add wall s,
apply dispatch ms, settle s (``settings_settled`` + ``drain`` +
synchronize), and the host span totals of the add and of the settle
(``decode``, ``stats``, ``spec.h2d_upload``, ``spec.stream`` ...).  Uses
only the session's public commands, so the same file can time an older tree
of the package (run it with that tree first on ``sys.path``).  ``--warm off``
turns the shape warmer and the device warmup off for this process
(``THESIA_PRECOMPILE=0``); ``on``, the default, leaves them on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import obs, runtime
from ..engine.session import EngineSession
from ..io.wav import encode_wav_s16
from ..render.colormap import default_colormap_rgba8
from . import signals


def spans() -> dict:
    return {k: v["total_ms"] for k, v in obs.summary().items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--warm", choices=("on", "off"), default="on")
    p.add_argument("wav", nargs="?")
    args = p.parse_args()
    os.environ["THESIA_PRECOMPILE"] = "1" if args.warm == "on" else "0"
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="thesia_long_add_"))
    if args.wav:
        path = Path(args.wav)
    else:
        path = work / "lecture_16k_1h.wav"
        path.write_bytes(encode_wav_s16(signals.lecture(np.random.default_rng(1)), signals.LECTURE_SR))
    sess = EngineSession(settings_dir=work / "config")
    sess.init(default_colormap_rgba8().reshape(-1).tolist())
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.add_tracks([0], [str(path)])
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    add_spans = spans()
    obs.reset()
    t0 = time.perf_counter()
    sess.apply_track_list_changes()
    apply_ms = (time.perf_counter() - t0) * 1e3
    if not (sess.settings_settled(timeout=600) and sess.tm.images.drain(timeout=600)):
        raise RuntimeError("the session did not settle")
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    print(json.dumps({"warm": args.warm, "wav_mb": round(path.stat().st_size / 1e6, 1),
                      "add_wall_s": round(add_s, 4),
                      "apply_dispatch_ms": round(apply_ms, 3), "settle_s": round(settle_s, 4),
                      "add_spans_ms": add_spans, "settle_spans_ms": spans()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
