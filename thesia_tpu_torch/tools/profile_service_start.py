"""The service's cold start on one CUDA card, in fresh processes: the wall
from launching the service to its ``listening`` line, its first add and
apply over HTTP, and where a start's time goes.

    python -m thesia_tpu_torch.tools.profile_service_start [N] [--warm on|off]
        [--start-warmup on|off] [--arena-max on|off] [--delay S] [--parts]

Runs N (default 3) services one after another, each a child process that
runs the service's ``main()`` on ``--port 0``, and drives each as the viewer
would: init, add a 5-minute 48 kHz stereo song and a 60-second 16 kHz memo
(16-bit WAVs made once from ``signals``), apply, and poll the metadata until
nothing is computing; then reads ``/debug/metrics`` and stops the child with
SIGTERM; ``--delay`` seconds pass between the ``listening`` line and the
first command (a viewer's page load and a user's pick; default 0).
``--warm off`` turns the shape warmer and the device warmup off in
the child (``THESIA_PRECOMPILE=0``); ``--start-warmup`` and ``--arena-max``
keep or skip two steps of ``main()`` in the child: the device warmup started
once the session is built, and the malloc arena limit.  With ``--parts``, a
probe process per run also times the parts of the same start apart (torch's
import, the port's, the card's context, the session, the server's listen).
The kernel libraries' build cache (``_build/``) is warm after the first
child.  Prints the card's name and power limit, then one JSON line with
every run's numbers and their medians.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import runtime
from ..render.colormap import default_colormap_rgba8
from . import signals

ROOT = Path(__file__).resolve().parents[2]

# the service's main() with its optional start steps skipped on request
CHILD = r"""
import sys
from thesia_tpu_torch.engine import service
start_warmup, arena_max, media = sys.argv[1:4]
if start_warmup == "off":
    service.start_device_warmup = lambda session: None
if arena_max == "off":
    service.limit_malloc_arenas = lambda: None
sys.argv = ["thesia_tpu_torch", "--port", "0", "--media-dir", media]
service.main()
"""

PARTS = r"""
import asyncio, json, sys, tempfile, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
from thesia_tpu_torch.engine.service import EngineService
from thesia_tpu_torch.engine.session import EngineSession
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
svc = EngineService(EngineSession(settings_dir=tempfile.mkdtemp()))
t4 = time.perf_counter()
async def listen():
    await svc.start("127.0.0.1", 0)
    await svc.stop()
asyncio.run(listen())
t5 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "import_port_s": t2 - t1, "cuda_context_s": t3 - t2,
                  "session_s": t4 - t3, "listen_s": t5 - t4}), flush=True)
"""


def post(conn, name, body=None):
    conn.request("POST", "/api/" + name, json.dumps(body or {}), {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    if r.status != 200:
        raise RuntimeError(f"{name}: HTTP {r.status} {data[:200]!r}")
    return json.loads(data)["result"]


def drive(port: int, paths: list[str], delay: float) -> dict:
    """The viewer's first minute against a listening child."""
    time.sleep(delay)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    post(conn, "init", {"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()})
    t0 = time.perf_counter()
    post(conn, "add_tracks", {"trackIds": [0, 1], "paths": paths})
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    post(conn, "apply_track_list_changes")
    apply_ms = (time.perf_counter() - t0) * 1e3
    while any(post(conn, "get_audio_render_metadata", {"idChStr": k})["isComputing"]
              for k in ("0_0", "0_1", "1_0")):
        if time.perf_counter() - t0 > 600:
            raise RuntimeError("still computing after 600 s")
        time.sleep(0.005)
    settle_s = time.perf_counter() - t0
    conn.request("GET", "/debug/metrics")
    metrics = json.loads(conn.getresponse().read())["result"]
    conn.close()
    return {"add_s": round(add_s, 4), "apply_dispatch_ms": round(apply_ms, 3),
            "settle_s": round(settle_s, 4), "shape_warmer": metrics["shape_warmer"],
            "warm_kernel_launches": metrics["warm_kernel_launches"]}


def child_run(env: dict, work: Path, paths: list[str], start_warmup: str, arena_max: str,
              delay: float) -> dict:
    """Start the service, time it to ``listening``, drive it, stop it."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", CHILD, start_warmup, arena_max, str(work)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        for line in proc.stdout:
            if "listening on http://" in line:
                start_s = time.perf_counter() - t0
                port = int(line.strip().rsplit(":", 1)[1])
                return {"start_to_listening_s": round(start_s, 3), **drive(port, paths, delay)}
        raise RuntimeError(f"the service exited with {proc.wait()} before it listened")
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=3)
    p.add_argument("--warm", choices=("on", "off"), default="on")
    p.add_argument("--start-warmup", choices=("on", "off"), default="on")
    p.add_argument("--arena-max", choices=("on", "off"), default="on")
    p.add_argument("--delay", type=float, default=0.0)
    p.add_argument("--parts", action="store_true")
    args = p.parse_args()
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="thesia_service_start_"))
    paths = signals.write_song_and_memo(work)
    path = os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, THESIA_TPU_CONFIG=str(work / "config"),
               THESIA_LOG_LEVEL="WARNING", THESIA_PRECOMPILE="1" if args.warm == "on" else "0")
    env.pop("THESIA_DEFER_SETTINGS", None)
    runs, parts = [], []
    for _ in range(args.n):
        runs.append(child_run(env, work, paths, args.start_warmup, args.arena_max, args.delay))
        if args.parts:
            out = subprocess.run([sys.executable, "-c", PARTS], cwd=ROOT, env=env,
                                 capture_output=True, text=True, timeout=600, check=True)
            parts.append({k: round(v, 3) for k, v in json.loads(out.stdout).items()})
    keys = ("start_to_listening_s", "add_s", "apply_dispatch_ms", "settle_s")
    result = {"warm": args.warm, "start_warmup": args.start_warmup, "arena_max": args.arena_max,
              "delay_s": args.delay,
              "runs": runs, "medians": {k: statistics.median(r[k] for r in runs) for k in keys}}
    if parts:
        result["parts_s"] = parts
        result["median_parts_s"] = {k: statistics.median(p_[k] for p_ in parts) for k in parts[0]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
