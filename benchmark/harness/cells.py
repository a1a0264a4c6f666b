"""Resolve a cell of ``BENCHMARK.json`` by name into the files that belong to
it, each found by its name: ``benchmark/configs/<config>.json`` (through the
configuration's ``file``), ``benchmark/traffic/<traffic>.json``,
``benchmark/limits/<cell>.json`` (the limits ``correct`` is judged by) and
``benchmark/metrics/<metric>.py`` (a reader a metric).  A new configuration,
mix, metric or cell is new files and new entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: dict  # name -> (unit, reader module), in BENCHMARK.json's order


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, trace: bool, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{w['name']}.json").read_text())
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in wanted:
        if _applies(m, workload):
            reader = load_reader(root, m["name"])
            if reader.UNIT != m["unit"]:
                raise ValueError(f"{m['name']}: the reader's unit {reader.UNIT!r} is not "
                                 f"BENCHMARK.json's {m['unit']!r}")
            metrics[m["name"]] = (m["unit"], reader)
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix, limits=limits,
                metrics=metrics)
