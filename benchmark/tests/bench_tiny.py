"""A copy of the benchmark's data files (BENCHMARK.json, configs, mixes,
limits, metric readers) with every track cut to a few seconds, for runs of
the harness on the CPU at a size a test can hold."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY_SECONDS = {"song": 3.0, "voice_memo": 1.5, "lecture": 4.0}


def tiny_root(dst: Path) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, dst / "benchmark" / sub)
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        for t in cfg["tracks"]:
            t["seconds"] = TINY_SECONDS[t["signal"]]
        path.write_text(json.dumps(cfg))
    return dst


def run_tiny(root: Path, workload: str, seed: int = 2**31 + 5, trace: bool = False,
             seconds: float = 1.5, device: str = "cpu") -> dict:
    import time

    from benchmark.harness.cells import resolve
    from benchmark.run import run_cell

    cell = resolve(workload, trace, root)
    return run_cell(cell, seed, seconds, trace, device=device, t0=time.perf_counter())
