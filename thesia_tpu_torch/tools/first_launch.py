"""First launches of the synchronous apply's device steps, on the calling
thread or on a new worker thread, in a fresh process on one CUDA card.

    python -m thesia_tpu_torch.tools.first_launch main [--warm off|thread|same]
    python -m thesia_tpu_torch.tools.first_launch worker [--warm off|thread|same]

The session runs every write on its write-worker thread, so the first apply
of a process pays the card's lazy kernel loading (the first launch of each
kernel loads its module) on that thread.  This times the apply's device
steps at the song's shape (2 channels x 30001 frames x 347 mel rows, f32 dB):
the row bounds, the global range, K6 (the quantize with its device mips) and
the landing's staging copy of a strided slice, each synchronized, twice, on
the thread that the argument names.  Run each variant in its own process: a module loads once per
process.  With ``MALLOC_ARENA_MAX=1`` in the environment a new thread shares
the main thread's malloc arena.  ``--warm`` runs the process's device warmup
(``runtime.device_warmup``) first: ``thread`` on the warmup's own thread, as
the shape warmer starts it; ``same`` on the thread that then runs the steps
(the write worker's, for ``worker``); ``off`` (the default) not at all.
Prints the card's name and power limit, then one JSON line of milliseconds
per step and of the warmup.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time

import torch

from .. import runtime
from ..dsp.precompile import warm_device
from ..engine.images import mip_plan
from ..engine.manager import _global_range_device
from ..kernels.images import quantize_mips
from ..render.colormap import quantize_min_value

CHANNELS, FRAMES, ROWS = 2, 30001, 347


def steps(db: torch.Tensor) -> dict[str, float]:
    """Milliseconds of each device step of a synchronous apply, in order."""
    out, state = {}, {}

    def bounds():
        state["bounds"] = (db.amin(dim=1).amin(dim=1), db.amax(dim=1).amax(dim=1))

    def global_range():
        state["range"] = _global_range_device([state["bounds"]], 100.0)

    def quantize():
        gmin, _gmax, span = state["range"]
        state["img"], _mips = quantize_mips(
            db, gmin, span, FRAMES, i_start=0, n_rows=ROWS, height=ROWS,
            min_value=quantize_min_value(258), mip_levels=tuple(mip_plan(FRAMES)))

    def staging():
        state["img"][0, :, : FRAMES // 2].contiguous()

    for name, fn in (("bounds", bounds), ("global_range", global_range),
                     ("quantize_mips", quantize), ("staging", staging)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("where", choices=("main", "worker"))
    p.add_argument("--warm", choices=("off", "thread", "same"), default="off")
    args = p.parse_args()
    where = args.where
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    # the input is made on the calling thread, with kernels the steps do not use
    gen = torch.Generator(device=dev).manual_seed(0)
    db = torch.rand((CHANNELS, FRAMES, ROWS), generator=gen, device=dev) * -120.0
    torch.cuda.synchronize()

    warm_ms = {}

    def warm(kind):
        t0 = time.perf_counter()
        if kind == "thread":
            runtime.device_warmup(device=dev)
        else:
            with runtime.warming():
                warm_device(dev)
        warm_ms[kind] = round((time.perf_counter() - t0) * 1e3, 3)

    if args.warm == "thread":
        warm("thread")

    def both():
        if args.warm == "same":
            warm("same")
        return steps(db), steps(db)

    if where == "main":
        first, second = both()
    else:
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            first, second = pool.submit(both).result()
    print(json.dumps({"thread": where, "malloc_arena_max": os.environ.get("MALLOC_ARENA_MAX"),
                      "warm": args.warm, "warmup_ms": warm_ms,
                      "first_ms": first, "first_total_ms": round(sum(first.values()), 3),
                      "second_ms": second, "second_total_ms": round(sum(second.values()), 3)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
