"""Each cell runs end to end at a tiny size on the port's CPU route (which
the test selects; the command line has no such route), agrees with the plain
reference, and prints a last line of the contract's form.  The control, and
runs with the timed path broken underneath, come out not correct."""

import io
import json

import pytest

from bench_tiny import ROOT, run_tiny, tiny_root
from benchmark.harness.cells import resolve
from benchmark.harness.control import control_numbers
from benchmark.run import emit

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("THESIA_PRECOMPILE", "0")
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")
    return tiny_root(tmp_path)


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_and_agrees_with_the_reference(root, workload):
    result = run_tiny(root, workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = resolve(workload, False, root)
    assert set(result["metrics"]) == set(cell.metrics)
    out, err = io.StringIO(), io.StringIO()
    emit(result, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert err.getvalue().splitlines()[-1].startswith(list(line["checks"])[-1])
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(root, workload):
    cell = resolve(workload, False, root)
    numbers = control_numbers(cell, 2**31 + 9, "cpu")
    assert any(numbers[k] > limit for k, limit in cell.limits.items()), numbers


def _freeze_spectrograms(monkeypatch):
    """A knob turn that leaves the images as they were."""
    from thesia_tpu_torch.engine.manager import TrackManager

    monkeypatch.setattr(TrackManager, "set_setting", lambda self, tracklist, setting: None)
    monkeypatch.setattr(TrackManager, "update_all_specs_imgs", lambda self, tracklist: None)


def _half_the_stats_batch(monkeypatch):
    """The batched stats computed for the first half of the batch only, the
    rest given the mean of those."""
    from thesia_tpu_torch.dynamics import stats_device

    real = stats_device.calc_stats_batched

    def half(items, device, sources=None):
        keep = items[: max(len(items) // 2, 1)]
        got = real(keep, device, {k: v for k, v in (sources or {}).items()
                                  if k in {i for i, *_ in keep}} or None)
        first = next(iter(got.values()))
        return {i: got.get(i, first) for i, *_ in items}

    monkeypatch.setattr(stats_device, "calc_stats_batched", half)


def _alter_a_tile(monkeypatch):
    """Every first spectrogram tile of a channel comes out one colour off."""
    from thesia_tpu_torch.engine import images

    real = images.encode_tile_body_from_source

    def altered(src, mip_level, src_x0, *args):
        body = real(src, mip_level, src_x0, *args)
        if args[-4] == 0:  # origin_x: the first tile of the row
            body = bytes((b + 1) % 256 for b in body)
        return body

    monkeypatch.setattr(images, "encode_tile_body_from_source", altered)


def _alter_the_loudness(monkeypatch):
    """get_global_lufs answers 0.01 LU off."""
    from thesia_tpu_torch.engine import session

    real = session.EngineSession.get_global_lufs
    monkeypatch.setattr(session.EngineSession, "get_global_lufs",
                        lambda self, t: {**real(self, t), "value": real(self, t)["value"] + 0.01})


@pytest.mark.parametrize("fault,workload", [
    (_freeze_spectrograms, "song_memo.switch"),
    (_half_the_stats_batch, "song_memo.open"),
    (_alter_a_tile, "song_memo.open"),
    (_alter_a_tile, "lecture.open"),
    (_alter_the_loudness, "lecture.open"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, workload):
    fault(monkeypatch)
    result = run_tiny(root, workload, seconds=1.0)
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_a_traced_cell_on_the_card(root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run_tiny(root, "song_memo.open", trace=True, device="cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
