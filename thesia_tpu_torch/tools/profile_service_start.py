"""The service's cold start on one CUDA card, in fresh processes: the wall
from launching ``python -m thesia_tpu_torch --port 0`` to its ``listening``
line, and where a start's time goes.

    python -m thesia_tpu_torch.tools.profile_service_start [N]    # from the repository root

Runs N (default 3) of each, one after another: the service as a child
process (stopped with SIGTERM once it listens), then a probe process that
times the parts of the same start apart (torch's import, the port's, the
card's context, the session, the server's listen).  The kernel libraries'
build cache (``_build/``) is warm after the first child.  Prints the card's
name and power limit, then one JSON line with every run's numbers and their
medians.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import runtime

ROOT = Path(__file__).resolve().parents[2]

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


def child_start(env: dict, work: Path) -> float:
    """Seconds from launching the service to its ``listening`` line."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "thesia_tpu_torch", "--port", "0", "--media-dir", str(work)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for line in proc.stdout:
            if "listening on http://" in line:
                return time.perf_counter() - t0
        raise RuntimeError(f"the service exited with {proc.wait()} before it listened")
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="thesia_service_start_"))
    path = os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, THESIA_TPU_CONFIG=str(work / "config"),
               THESIA_LOG_LEVEL="WARNING")
    starts, parts = [], []
    for _ in range(n):
        starts.append(round(child_start(env, work), 3))
        out = subprocess.run([sys.executable, "-c", PARTS], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600, check=True)
        parts.append({k: round(v, 3) for k, v in json.loads(out.stdout).items()})
    print(json.dumps({"start_to_listening_s": starts, "median_start_s": statistics.median(starts),
                      "parts_s": parts,
                      "median_parts_s": {k: statistics.median(p[k] for p in parts) for k in parts[0]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
