"""Device time of the port's main path on one CUDA card, by kernel and copy.

    python -m thesia_tpu_torch.tools.profile_main_path [--other DIR]   # from the repository root

Drives what ``chip_smoke.py`` drives -- add_tracks (the 5-min 48 kHz stereo
song and 60-s 16 kHz memo of ``signals.write_song_and_memo``, 16-bit WAVs) ->
apply_track_list_changes -> first
spectrogram tile -> set_spec_setting(Linear) -> a tile -> the Limiter switch
(guard clipping set to Limiter, then a LUFS target that puts the song's peak
6 dB over full scale, so K8 runs for it) -- in rounds in one process, each
round on a fresh EngineSession with its own settings: a synchronous warm-up
round, then profiled rounds: synchronous ones (defer=False, the images
drained inside the apply and switch steps, as the landing used to be part of
them) and a deferred one (the default: dispatch steps, then ``settle`` steps
that wait for ``settings_settled`` and the image streamer).  ``--other DIR``
loads DIR/thesia_tpu_torch as a second package (its own sources and build,
as ``bench_spec_fft`` does; unpack a parent with ``git archive``): each tree
gets its warm-up round and its synchronous rounds run in the turns other,
this, this, other; the deferred round and the recompute's parts are this
tree's alone.  Rounds run under torch.profiler with every thread's operators
recorded.  Prints the card's name and power limit, then JSON lines per
profiled round: the host wall of each step (synchronized), the device time
of each kernel or copy over the round (microseconds, the 15 largest; the
copy stream's device->host copies are the "Memcpy DtoH (Device -> Pinned)"
entries, the uploads the "Memcpy HtoD" ones, pinned or pageable by name), the
device ms by family (``FAMILIES``: K1/K2, K6, K9/K8, copies, the rest), the
launches and device ms of each hand kernel of csrc/dynamics.cu and
csrc/images.cu, the device ms of the operators run inside the manager's
``quantize`` (``k6.quantize``) and the image store's copies
(``k6.landing``: the landing and region fetches; the profiler attributes no
kernel launched through ctypes to the operator around it, so a hand
kernel's time is its family's), the device total and the device's idle
share of the round's wall time (device time summed over the compute and copy
streams, so overlapping copies can push the share below its true value).
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .. import runtime
from ..dsp import spectrogram
from . import signals
from .bench_spec_fft import import_tree

LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}


def load_tree(name: str, root: str | None) -> SimpleNamespace:
    """The engine modules of this package, or of the package in
    ``root``/thesia_tpu_torch imported as ``name``."""
    prefix = import_tree(name, root)
    sub = lambda s: importlib.import_module(f"{prefix}.{s}")  # noqa: E731
    return SimpleNamespace(session=sub("engine.session"), manager=sub("engine.manager"),
                           images=sub("engine.images"), colormap=sub("render.colormap"))


def one_round(tree: SimpleNamespace, paths: list[str], work: Path, deferred: bool) -> dict[str, float]:
    sess = tree.session.EngineSession(settings_dir=Path(tempfile.mkdtemp(prefix="config_", dir=work)))
    sess.init(tree.colormap.default_colormap_rgba8().reshape(-1).tolist())
    kw = {} if deferred else {"defer": False}

    def settle():
        if not (sess.settings_settled(timeout=600) and sess.tm.images.drain(timeout=600)):
            raise RuntimeError("the session did not settle")

    def limiter():
        hot = sess.get_global_lufs(0)["value"] - sess.get_max_peak_db(0)["value"] + 6.0
        sess.set_common_guard_clipping("Limiter", **kw)
        sess.set_common_normalize({"type": "LUFS", "target": hot}, **kw)

    if deferred:
        steps = (
            ("add", lambda: sess.add_tracks([0, 1], paths)),
            ("apply", sess.apply_track_list_changes),
            ("first_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("settle_apply", settle),
            ("set_linear", lambda: sess.set_spec_setting(LINEAR)),
            ("settle_linear", settle),
            ("linear_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("limiter", limiter),
            ("settle_limiter", settle),
        )
    else:
        steps = (
            ("add", lambda: sess.add_tracks([0, 1], paths)),
            ("apply", lambda: (sess.apply_track_list_changes(**kw), settle())),
            ("first_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("set_linear", lambda: (sess.set_spec_setting(LINEAR, **kw), settle())),
            ("linear_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("limiter", lambda: (limiter(), settle())),
        )
    walls = {}
    for name, fn in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    sess.tm.images.shutdown()
    return walls


PARTS = ("recompute", "reflect_pad", "row_bounds")
K6_SPANS = ("k6.quantize", "k6.landing")
FAMILIES = (("spec_fft", ("spec_fft",)), ("k6", ("k6_",)), ("k9_k8", ("k9_", "k8_")),
            ("dtoh", ("DtoH",)), ("htod", ("HtoD",)))


def family(key: str) -> str:
    return next((fam for fam, pats in FAMILIES if any(p in key for p in pats)), "other")


def _annotated(name: str, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return run


def annotate_recompute() -> None:
    """Name the recompute's parts in the trace (this process only; the
    profiler records the names on the thread that runs it)."""
    an = spectrogram.SpectrogramAnalyzer
    an.calc_spec_multi = _annotated("recompute", an.calc_spec_multi)
    spectrogram.reflect_pad_rows = _annotated("reflect_pad", spectrogram.reflect_pad_rows)
    for name in ("amin", "amax"):  # a dB's per-row bounds reduce dims (1, 2)
        plain = getattr(torch.Tensor, name)
        named = _annotated("row_bounds", plain)
        setattr(torch.Tensor, name, lambda t, *a, _p=plain, _n=named, **k: (
            _n if k.get("dim") == (1, 2) and t.dim() == 3 else _p)(t, *a, **k))


def annotate_images(tree: SimpleNamespace) -> None:
    """Name K6's spans in the trace: the manager's quantize and the image
    store's copies (this process only)."""
    store = tree.images.SpecImageStore
    tree.manager.TrackManager.quantize = _annotated("k6.quantize", tree.manager.TrackManager.quantize)
    store._to_host = _annotated("k6.landing", store._to_host)
    tree.images._Landing.put = _annotated("k6.landing", tree.images._Landing.put)


def _device_us(evt) -> float:
    total = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if total is None else total


def recompute_parts(paths: list[str]) -> None:
    """Song and memo recomputed by ``calc_spec_multi`` on this thread, mel
    and linear, three times each after a warm-up, under the profiler: the
    device time and calls of each named part, per recompute."""
    from ..dsp.framing import SpecSetting
    from ..io.wav import decode_wav

    annotate_recompute()
    an = spectrogram.SpectrogramAnalyzer("cuda")
    tracks = [(i, *decode_wav(Path(path).read_bytes())[:2]) for i, path in enumerate(paths)]
    for scale, setting in (("mel", SpecSetting()), ("linear", SpecSetting.from_json(LINEAR))):
        for key, wavs, sr in tracks:
            an.calc_spec_multi(wavs, sr, setting, cache_key=key, token=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                for key, wavs, sr in tracks:
                    an.calc_spec_multi(wavs, sr, setting, cache_key=key, token=1)
            torch.cuda.synchronize()
        parts = {name: {"device_ms": 0.0, "calls": 0} for name in PARTS + ("spec_fft_kernel",)}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and "spec_fft_kernel" in evt.key:
                parts["spec_fft_kernel"]["device_ms"] += evt.self_device_time_total / 1e3
                parts["spec_fft_kernel"]["calls"] += evt.count
            elif evt.device_type != DeviceType.CUDA and evt.key in PARTS:
                parts[evt.key]["device_ms"] += _device_us(evt) / 1e3
                parts[evt.key]["calls"] += evt.count
        per = parts["recompute"]["calls"] or 1
        print(json.dumps({"recompute": scale, "tracks": len(tracks), "parts": parts,
                          "device_ms_per_recompute": {k: v["device_ms"] / per
                                                      for k, v in parts.items()}}), flush=True)


def profiled_round(label: str, tree: SimpleNamespace, paths: list[str], work: Path,
                   deferred: bool) -> None:
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
        t0 = time.perf_counter()
        walls = one_round(tree, paths, work, deferred)
        wall = time.perf_counter() - t0
    print(json.dumps({"round": label, "wall_s": walls}), flush=True)
    device, spans = {}, {name: {"device_ms": 0.0, "calls": 0} for name in K6_SPANS}
    for evt in prof.key_averages():
        if evt.key in K6_SPANS:
            # an annotation also shows as a device-side span (first to last
            # kernel, gaps included), which is no device work: read its
            # operator's device time
            if evt.device_type != DeviceType.CUDA:
                spans[evt.key]["device_ms"] += _device_us(evt) / 1e3
                spans[evt.key]["calls"] += evt.count
        # device-side events only (kernels, copies, sets): an operator's event
        # (aten::copy_, aten::add) carries its kernels' device time as well, and
        # summing both would count that time twice
        elif evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            device[evt.key] = device.get(evt.key, 0.0) + evt.self_device_time_total
    total_us = sum(device.values())
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:15]:
        print(json.dumps({"round": label, "device_us": round(us, 1), "name": key[:120]}), flush=True)
    families: dict[str, float] = {}
    for key, us in device.items():
        families[family(key)] = families.get(family(key), 0.0) + us / 1e3
    # K9, K8 (csrc/dynamics.cu) and K6 (csrc/images.cu): launches and device ms of each kernel
    hand = {evt.key[:60]: {"count": evt.count, "ms": round(evt.self_device_time_total / 1e3, 4)}
            for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA
            and any(p in evt.key for p in ("k9_", "k8_", "k6_"))}
    print(json.dumps({"round": label, "hand_kernels": hand,
                      "families_ms": {k: round(v, 4) for k, v in families.items()},
                      "k6_spans": {k: {"device_ms": round(v["device_ms"], 4), "calls": v["calls"]}
                                   for k, v in spans.items()}}), flush=True)
    dtoh = {k: round(v / 1e3, 3) for k, v in device.items() if "DtoH" in k}
    htod = {k: round(v / 1e3, 3) for k, v in device.items() if "HtoD" in k}
    print(json.dumps({"round": label, "device_total_ms": round(total_us / 1e3, 3),
                      "dtoh_ms": dtoh, "htod_ms": htod, "round_wall_ms": round(wall * 1e3, 3),
                      "device_idle_share": round(1.0 - total_us / 1e6 / wall, 4)}), flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="a checkout whose thesia_tpu_torch runs in turns with this one")
    a = ap.parse_args(argv)
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="thesia_profile_"))
    paths = signals.write_song_and_memo(work)
    trees = {"this": load_tree("", None)}
    if a.other:
        trees["other"] = load_tree("other_thesia_tpu_torch", a.other)
    for label, tree in trees.items():
        annotate_images(tree)
        print(json.dumps({"round": f"warm-up.{label}", "wall_s": one_round(tree, paths, work, False)}),
              flush=True)
    order = ["other", "this", "this", "other"] if a.other else ["this"]
    for i, label in enumerate(order):
        profiled_round(f"sync.{label}.{i}", trees[label], paths, work, False)
    profiled_round("deferred", trees["this"], paths, work, True)
    recompute_parts(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
