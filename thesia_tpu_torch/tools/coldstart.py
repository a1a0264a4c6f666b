"""A fresh process's first commands on one CUDA card, with the shape warmer
on or off.

    python -m thesia_tpu_torch.tools.coldstart --warm on|off SONG MEMO
    python -m thesia_tpu_torch.tools.coldstart --warm on|off --lecture WAV

Run from the repository root, one process per measurement (a kernel's
module loads once per process).  With SONG and MEMO: a session in the
synchronous mode adds both files (the first add, with its ``stats.batched``
span), applies and drains (the first apply, with its ``spec.quantize``
span), then switches to Linear and then to the 20 ms window preset (the
neighbours the warmer prepares after each command), each drained.  With
``--lecture``: the first add of that one file, then the apply.  Between two
commands the process waits for the warmer to go idle, as a user's pause
would let it (that wait is not timed).  ``--warm off`` sets
``THESIA_PRECOMPILE=0`` for this process before the package is imported.

Prints the card's name and power limit, then one JSON line: seconds per
command, the host spans named above, the warmer's ``compiled`` and
``failed`` and its milliseconds per job kind, the main path's and the
warm's kernel launches counted apart, and a SHA-256 of every landed u16
image after each command (equal with the warmer on and off).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}
WIN20 = {"winMillisec": 20.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--warm", choices=("on", "off"), required=True)
    p.add_argument("--lecture", help="add this one file instead of SONG and MEMO")
    p.add_argument("files", nargs="*")
    args = p.parse_args()
    if bool(args.lecture) == bool(args.files) or (args.files and len(args.files) != 2):
        p.error("give SONG and MEMO, or --lecture WAV")
    os.environ["THESIA_PRECOMPILE"] = "1" if args.warm == "on" else "0"
    os.environ["THESIA_DEFER_SETTINGS"] = "0"

    import numpy as np
    import torch

    from .. import obs, runtime
    from ..engine.session import EngineSession
    from ..kernels import images, pcm, spec_db
    from ..render.colormap import default_colormap_rgba8

    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    sess = EngineSession(settings_dir=Path(tempfile.mkdtemp(prefix="thesia_coldstart_")))
    sess.init(default_colormap_rgba8().reshape(-1).tolist())
    warmer = sess.tm.shape_warmer
    out: dict = {"warm": args.warm, "malloc_arena_max": os.environ.get("MALLOC_ARENA_MAX")}
    hashes: dict = {}

    def timed(name, fn, spans=()):
        obs.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if not sess.tm.images.drain(timeout=600):
            raise RuntimeError(f"{name}: the images did not land")
        torch.cuda.synchronize()
        out[f"{name}_s"] = round(time.perf_counter() - t0, 4)
        summary = obs.summary()
        for s in spans:
            out[f"{name}_{s}_ms"] = round(summary.get(s, {}).get("total_ms", 0.0), 1)

    def landed(name):
        imgs = sess.tm.spec_imgs
        h = hashlib.sha256()
        for k in sorted(imgs):
            h.update(np.ascontiguousarray(imgs[k]).tobytes())
        hashes[name] = h.hexdigest()

    def pause():
        if not warmer.drain(timeout=600):
            raise RuntimeError("the shape warmer did not go idle")

    if args.lecture:
        timed("lecture_add", lambda: sess.add_tracks([0], [args.lecture]), ("stats", "decode"))
        timed("lecture_apply", lambda: sess.apply_track_list_changes(), ("spec.quantize",))
        landed("lecture_apply")
    else:
        timed("add", lambda: sess.add_tracks([0, 1], list(args.files)),
              ("stats.batched", "decode", "spec.recompute"))
        timed("apply", lambda: sess.apply_track_list_changes(), ("spec.quantize", "spec.stream"))
        landed("apply")
        pause()
        timed("linear", lambda: sess.set_spec_setting(LINEAR), ("spec.recompute", "spec.quantize"))
        landed("linear")
        pause()
        timed("win20", lambda: sess.set_spec_setting(WIN20), ("spec.recompute", "spec.quantize"))
        landed("win20")
    pause()
    sess.tm.images.shutdown()
    out.update(
        warmup_done=runtime.warmup_done(),
        compiled=warmer.compiled_count, failed=warmer.failed_count,
        job_ms={k: round(sum(v), 3) for k, v in warmer.job_ms.items()},
        jobs={k: len(v) for k, v in warmer.job_ms.items()},
        launches={**spec_db.spec_db.launches,
                  **{k: getattr(pcm, k).launches for k in ("deinterleave_flat", "deinterleave_s24")},
                  "quantize_mips": images.quantize_mips.launches},
        warm_launches={**spec_db.spec_db.warm_launches,
                       **{k: getattr(pcm, k).warm_launches
                          for k in ("deinterleave_flat", "deinterleave_s24")},
                       "quantize_mips": images.quantize_mips.warm_launches},
        images_sha256=hashes,
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
