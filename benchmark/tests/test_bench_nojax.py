"""The run refuses jax, jaxlib, flax and the JAX package, compared by whole
top-level name, and a run without a card or without the port prints no
result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from bench_tiny import ROOT
from benchmark import run


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["thesia_tpu_torch", "thesia_tpu_torch.engine", "jaxtyping",
                                  "numpy", "benchmark"]) == []
    assert run.forbidden_modules(["thesia_tpu.engine.session", "jax.numpy", "jaxlib",
                                  "flax.linen", "os"]) == ["flax", "jax", "jaxlib", "thesia_tpu"]


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "thesia_tpu"])
def test_the_run_fails_when_a_forbidden_module_is_loaded(monkeypatch, name):
    run.check_no_jax("now")
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType(name + ".sub"))
    with pytest.raises(run.ForbiddenModule, match=name):
        run.check_no_jax("after the window")


def test_the_harness_and_the_port_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run as r; "
            "import benchmark.harness.drive, benchmark.harness.control, benchmark.harness.trace; "
            "import thesia_tpu_torch.engine.service; print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "song_memo.open",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_command_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["benchmark"]
