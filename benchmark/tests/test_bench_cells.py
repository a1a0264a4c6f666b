"""The harness finds every file of a cell by name, and BENCHMARK.json keeps
the shape the benchmark's contract asks for."""

import json
import re

import pytest

from bench_tiny import ROOT, run_tiny, tiny_root
from benchmark.harness.cells import load_reader, resolve

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_resolves_by_name(workload, trace):
    cell = resolve(workload, trace, ROOT)
    assert cell.config["tracks"] and cell.mix["deck"]
    assert all(entry["kind"] and entry["steps"] for entry in cell.mix["deck"])
    assert {"spec_px_off", "wave_gap", "stats_gap_db"} <= set(cell.limits)
    names = set(cell.metrics)
    if trace:
        assert names and "setup_s" not in names
    else:
        assert "setup_s" in names and len(names) >= 2


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
        assert load_reader(ROOT, m["name"]).UNIT == m["unit"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for w in CELLS:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", CELLS)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_config_mix_metric_and_cell_need_no_edit(tmp_path, monkeypatch):
    """New files and new BENCHMARK.json entries, nothing else edited."""
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/song_memo_48k.json").read_text())
    cfg["name"] = "memo_only_16k"
    cfg["tracks"] = [t for t in cfg["tracks"] if t["name"] == "memo"]
    (root / "benchmark/configs/memo_only_16k.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/open.json").read_text())
    mix["viewport"] = {"width_px": 960, "height_px": 128}
    (root / "benchmark/traffic/open_small.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/memo.open_small.json").write_text(
        (root / "benchmark/limits/song_memo.open.json").read_text())
    (root / "benchmark/metrics/tile_requests_per_turn.py").write_text(
        'UNIT = "1"\n\n\ndef read(run):\n    return len(run.tile_ms) / len(run.turns)\n')
    bench["configs"].append({"name": "memo_only_16k", "source": "a test",
                             "file": "benchmark/configs/memo_only_16k.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "memo.open_small", "config": "memo_only_16k",
                               "traffic": "open_small", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("memo.open_small")
    bench["per_layer"].append({"name": "tile_requests_per_turn", "unit": "1", "better": "lower",
                               "source": "host_clock", "layer": "render", "moves": "open_s",
                               "workloads": ["memo.open_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = resolve("memo.open_small", True, root)
    assert "tile_requests_per_turn" in traced.metrics
    result = run_tiny(root, "memo.open_small")
    assert result["correct"] and "open_s" in result["metrics"]


def test_a_new_loop_of_new_turn_kinds_needs_no_edit(tmp_path):
    """A loop the generator has never run -- two turn kinds of its own, the
    frequency scale flipped each turn -- with its metrics, from new files and
    new BENCHMARK.json entries only; it runs, agrees with the reference, and
    its readers count the work of each kind by the mix's own launch rules."""
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    open_mix = json.loads((root / "benchmark/traffic/open.json").read_text())

    def flip(kind, scale):
        return {"kind": kind, "launches": ["spec_fft", "k6"], "steps": [
            {"do": "call", "command": "set_spec_setting", "state": "spec", "update": "merge",
             "value": {"freqScale": scale}, "body": {"specSetting": "$value"}, "dispatch": True},
            {"do": "await_revision"}, {"do": "paint"}, {"do": "settle"}, {"do": "observe"}]}

    mix = {"why": "a test", "viewport": {"width_px": 640, "height_px": 128}, "poll_ms": 2,
           "observe_share": 0.5, "observe_max": 2, "observe_steps": [0],
           "setup": open_mix["deck"][0]["steps"][:2] + [{"do": "settle"}],
           "deck": [flip("to_linear", "Linear"), flip("to_mel", "Mel")]}
    (root / "benchmark/traffic/scale_flip.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/song_memo.scale_flip.json").write_text(
        (root / "benchmark/limits/song_memo.switch.json").read_text())
    (root / "benchmark/metrics/flip_s.py").write_text(
        "from benchmark.harness.readers import mean_turn_s\n\nUNIT = \"s\"\n\n\n"
        "def read(run):\n    return mean_turn_s(run, \"to_linear\")\n")
    (root / "benchmark/metrics/flip_turns.py").write_text(
        "UNIT = \"1\"\n\n\ndef read(run):\n    return len(run.of(\"to_mel\"))\n")
    bench["workloads"].append({"name": "song_memo.scale_flip", "config": "song_memo_48k",
                               "traffic": "scale_flip", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "flip_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["song_memo.scale_flip"]})
    bench["per_layer"].append({"name": "flip_turns", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "engine.session",
                               "moves": "flip_s", "workloads": ["song_memo.scale_flip"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_tiny(root, "song_memo.scale_flip", seconds=2.0)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "flip_s"}
    traced = resolve("song_memo.scale_flip", True, root)
    assert set(traced.metrics) == {"flip_turns"}
