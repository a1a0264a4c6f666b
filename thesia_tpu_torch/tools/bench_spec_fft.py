"""Device time of the spectrogram kernel (csrc/spec_fft.cu) and of the
recompute around it, at the main path's shapes, on one CUDA card; optionally
in turns with another checkout's kernel.

    python -m thesia_tpu_torch.tools.bench_spec_fft [--other DIR] [--order SEQ] [--n N]

Shapes: a 5-min 48 kHz stereo song and a 60-s 16 kHz mono memo at the
default settings (random samples from seed 0).  For each tree and each shape
and variant (mel, linear) it prints one JSON line with, from
``runtime.launch_ms`` (N calls back to back between two CUDA events, queued
behind a spin kernel, so the card never waits for the host; and the host
clock per call apart):

* ``kernel_ms`` / ``kernel_host_us``: the kernel on the rows the tree's
  ``calc_spec_multi`` gives it -- on this tree the raw rows, the reflect
  padding in the loader; a tree whose ``spec_db`` takes no ``pad`` gets the
  padded rows; ``kernel_bounds_ms`` / ``kernel_bounds_host_us`` (this
  tree): the same launch with the row bounds, as ``calc_spec_multi`` makes
  it (the bounds' start values copied in, then the kernel);
* ``pad_ms``: ``reflect_pad_rows`` of the raw rows (the tree's separate pass,
  or the pass this tree no longer runs), ``bounds_ms``: ``amin`` and
  ``amax`` of the dB over (frames, columns);
* ``recompute_ms`` / ``recompute_host_us``: the tree's
  ``SpectrogramAnalyzer.calc_spec_multi`` on the cached device wav (what a
  mel or linear switch issues per track);
* ``library_ms``: ``torch.fft.rfft`` of prebuilt windowed frames (cuFFT, a
  yardstick the port never calls), and the bound of the kernel's work
  (``kernels/spec_db.py: kernel_work`` at ``runtime.py``'s peaks);
* the first 16 hex digits of the SHA-256 of the kernel's output, and for
  the other tree the dB error of its output against this tree's
  (``db_error``).

``--other DIR`` loads DIR/thesia_tpu_torch as a second package (its own
sources, its own build) and ``--order`` (default ``other,this,this,other``
with ``--other``, else ``this``) says in which turns the trees run.  The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .. import runtime

SHAPES = (("48k", 48000, 2, 300.0), ("16k", 16000, 1, 60.0))


def import_tree(name: str, root: str | None) -> str:
    """The import prefix of this package, or of the package in
    ``root``/thesia_tpu_torch imported as ``name`` (its own sources, its own
    build directory)."""
    if root is None:
        return __package__.rsplit(".", 1)[0]
    pkg_dir = Path(root).resolve() / "thesia_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return name


def load_tree(name: str, root: str | None) -> SimpleNamespace:
    """The spectrogram modules of this package, or of the package in
    ``root``/thesia_tpu_torch imported as ``name``."""
    prefix = import_tree(name, root)
    sub = lambda s: importlib.import_module(f"{prefix}.{s}")  # noqa: E731
    return SimpleNamespace(kern=sub("kernels.spec_db"), spectrogram=sub("dsp.spectrogram"),
                           framing=sub("dsp.framing"), stft=sub("dsp.stft"))


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def bench_tree(label: str, tree: SimpleNamespace, dev, wavs_by_shape: dict, n: int,
               reference: dict) -> None:
    kern, spg = tree.kern, tree.spectrogram
    folded = "pad" in inspect.signature(kern.spec_db).parameters
    analyzer = spg.SpectrogramAnalyzer(dev)
    setting = tree.framing.SpecSetting()
    for shape, sr, _rows, _sec in SHAPES:
        wavs = wavs_by_shape[shape]
        hop, win, n_fft = setting.calc_framing_params(sr)
        pad = win // 2
        raw = analyzer.device_wav(wavs, shape, 1)
        padded = spg.reflect_pad_rows(raw, pad)
        n_frames = tree.stft.stft_frame_count(wavs.shape[1], win, hop)
        window = analyzer.window(win, n_fft)
        mel = analyzer.mel_fb(sr, n_fft)
        xw = (padded.unfold(-1, win, hop)[:, :n_frames] * window).contiguous()
        lib_ms = runtime.launch_ms(lambda: torch.fft.rfft(xw, n=n_fft), n=n, may_wait=True).ms
        del xw
        for variant, m in (("mel", mel), ("linear", None)):
            args = (hop, win, n_frames, window, n_fft, m)
            extra = {}
            if folded:
                call = lambda: kern.spec_db(raw, *args, pad=pad)  # noqa: E731
                out = call()
                work = kern.kernel_work(raw.shape[0], raw.shape[1], n_frames, win, n_fft, m,
                                        bounds=True)
                extra["kernel_bounds_ms"], extra["kernel_bounds_host_us"], _ = runtime.launch_ms(
                    lambda: kern.spec_db(raw, *args, pad=pad, bounds=True), n=n)
            else:
                call = lambda: kern.spec_db(padded, *args)  # noqa: E731
                out = call()
                work = kern.kernel_work(raw.shape[0], padded.shape[1], n_frames, win, n_fft, m)
            k_ms, k_us, _ = runtime.launch_ms(call, n=n)
            pad_ms = runtime.launch_ms(lambda: spg.reflect_pad_rows(raw, pad), n=n,
                                       may_wait=True).ms
            bounds_ms = runtime.launch_ms(
                lambda: (out.amin(dim=(1, 2)), out.amax(dim=(1, 2))), n=n, may_wait=True).ms
            st = setting if m is not None else tree.framing.SpecSetting.from_json(
                {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"})
            r_ms, r_us, _ = runtime.launch_ms(
                lambda: analyzer.calc_spec_multi(wavs, sr, st, cache_key=shape, token=1), n=n,
                may_wait=True)
            bound, by = runtime.bound_ms(work["bytes"], work["flop"])
            line = {"tree": label, "shape": shape, "variant": variant,
                    "kernel_ms": k_ms, "kernel_host_us": k_us, **extra, "pad_ms": pad_ms,
                    "bounds_ms": bounds_ms, "recompute_ms": r_ms, "recompute_host_us": r_us,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                    "mbytes": work["bytes"] / 1e6, "gflop": work["flop"] / 1e9,
                    "folded_pad_and_bounds": folded, "sha256": _sha(out)}
            key = (shape, variant)
            if key in reference:
                err = kern.db_error(reference[key].cpu().numpy(), out.cpu().numpy())
                line["vs_first_tree"] = err
            else:
                reference[key] = out
            print(json.dumps(line), flush=True)
            del out
        del raw, padded


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout whose thesia_tpu_torch runs in turns with this one")
    ap.add_argument("--order", help="comma-separated turns of 'this' and 'other'")
    ap.add_argument("--n", type=int, default=50, help="launches per timing (at least 20)")
    a = ap.parse_args(argv)
    order = (a.order or ("other,this,this,other" if a.other else "this")).split(",")
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    trees = {"this": load_tree("", None)}
    if a.other:
        trees["other"] = load_tree("other_thesia_tpu_torch", a.other)
    rng = np.random.default_rng(0)
    wavs_by_shape = {shape: (0.1 * rng.standard_normal((rows, int(sr * sec)))).astype(np.float32)
                     for shape, sr, rows, sec in SHAPES}
    reference: dict = {}
    for i, label in enumerate(order):
        bench_tree(f"{label}#{i}", trees[label], dev, wavs_by_shape, a.n, reference)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
