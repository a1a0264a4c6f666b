"""K6 (the u16 quantize and its device mips) on one CUDA card, in turns with
another checkout's K6.

    python -m thesia_tpu_torch.tools.bench_images [--other DIR] [--counts]

Run from the repository root.  ``--other DIR`` loads DIR/thesia_tpu_torch as
a second package (its own sources and build, as ``bench_spec_fft`` does),
and the trees run in the turns other, this, this, other.  At each of the
main path's four images (``SHAPES``: the song's mel and linear images, the
memo's mel image in the song's 48 kHz-tall image, the 1-hour lecture's mel
image; dB made on the card from a seed, -inf and NaN included) a tree's K6
is one call of ``kernels.images.quantize_mips`` (the hand-written kernel)
or, in a tree without it, ``engine.images._quantize_and_mips`` and
``_u16_bits`` of the image and each device mip (the torch-op chain and the
narrowing its landing did).  One JSON line a tree and shape: device ms by
``runtime.launch_ms`` over ``RUNS`` launches (the wrapper's host us apart;
the chain with ``may_wait``), the plain version's ms where the tree has one,
the bound of ``images_work``, the peak device MB of one call above its
input, the device kernels one call of the torch chain launches
(torch.profiler: count and distinct names), and a SHA-256 of the image and
mips, which every tree must share.  Prints the card's name and power limit
first.  ``--counts`` prints only the device kernels one kernel call
launches at each image (csrc/images.cu's, by torch.profiler; one JSON line,
for a fresh process, where the profiler misses none).  K6's share of a
main-path round is ``profile_main_path``'s.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib
import json
import statistics
import sys
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench_spec_fft import import_tree

# (name, channels, frames, dB columns, i_start, rows, height, mip levels): the
# images the main path quantizes (dsp/framing.py framing, chain_len levels 3+)
SHAPES = (
    ("song_mel", 2, 30001, 347, 0, 347, 347, (3, 4, 5)),
    ("song_linear", 2, 30001, 1025, 0, 1025, 1025, (3, 4, 5)),
    ("memo_mel", 1, 6001, 385, 0, 385, 521, (3,)),
    ("lecture_mel", 1, 360001, 385, 0, 385, 385, (3, 4, 5, 6, 7, 8, 9)),
)
MIN_VALUE = 254  # quantize_min_value of the default colormap's 258 entries
LO, SPAN = -103.25, 100.0
RUNS = 50  # launches a timed run


def load_tree(name: str, root: str | None) -> SimpleNamespace:
    prefix = import_tree(name, root)
    sub = lambda s: importlib.import_module(f"{prefix}.{s}")  # noqa: E731
    images = sub("engine.images")
    try:
        kimages = sub("kernels.images")
    except ModuleNotFoundError:
        kimages = None
    return SimpleNamespace(prefix=prefix, images=images, kimages=kimages, runtime=sub("runtime"))


def make_db(c: int, t: int, f: int, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    db = torch.rand((c, t, f), generator=g, device=dev) * -130.0
    u = torch.rand((c, t, f), generator=g, device=dev)
    db[u < 0.01] = -float("inf")
    db[u > 0.999] = float("nan")
    return db


def k6_call(tree, db, lo, span, n, i_start, rows, height, levels):
    """One K6 call of ``tree``: (img, mips) as u16 bits on the card."""
    kw = dict(i_start=i_start, n_rows=rows, height=height, min_value=MIN_VALUE, mip_levels=levels)
    if tree.kimages is not None:
        return tree.kimages.quantize_mips(db, lo, span, n, **kw)
    img, mips = tree.images._quantize_and_mips(db, lo, span, n, **kw)
    return tree.images._u16_bits(img), [tree.images._u16_bits(m) for m in mips]


def _kernel_names(fn) -> list[str]:
    """The device kernels (no copies or sets) of one call of ``fn`` after an
    unprofiled one, a name per launch."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and "Memcpy" not in e.name and "Memset" not in e.name]


def device_kernels(fn) -> dict:
    names = _kernel_names(fn)
    return {"launches": len(names), "distinct": len(set(names))}


def shape_inputs(name, c, frames, f, dev):
    db = make_db(c, frames, f, dev, seed=len(name))
    return (db, torch.tensor(LO, dtype=torch.float32, device=dev),
            torch.tensor(SPAN, dtype=torch.float32, device=dev))


def counts(tree, dev) -> dict:
    """{"quantize_mips": {shape: csrc/images.cu's kernels one call launches}}."""
    out = {}
    for name, c, frames, f, i0, rows, height, levels in SHAPES:
        db, lo, span = shape_inputs(name, c, frames, f, dev)
        call = functools.partial(k6_call, tree, db, lo, span, frames, i0, rows, height, levels)
        out[name] = sum("k6_" in n for n in _kernel_names(call))
        del db
        torch.cuda.empty_cache()
    return {"quantize_mips": out}


def sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bench_tree(label: str, tree, this, dev) -> list[dict]:
    rt = this.runtime
    out = []
    for name, c, frames, f, i0, rows, height, levels in SHAPES:
        db, lo, span = shape_inputs(name, c, frames, f, dev)
        call = functools.partial(k6_call, tree, db, lo, span, frames, i0, rows, height, levels)
        img, mips = call()
        digest = sha([img, *mips])
        del img, mips
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        t = rt.launch_ms(call, n=RUNS, may_wait=tree.kimages is None)
        # the profiler misses the kernels a ctypes wrapper launches after
        # many unprofiled calls (PERF.md, section 7): the chain's only
        row = {"tree": label, "shape": name, "ms": round(t.ms, 4), "host_us": round(t.host_us, 2),
               "host_waited": t.host_waited, "peak_mb": round(peak_mb, 2),
               "device_kernels": None if tree.kimages else device_kernels(call), "sha256": digest}
        if tree.kimages is not None:
            plain = functools.partial(tree.kimages.quantize_mips_reference, db, lo, span, frames,
                                      i_start=i0, n_rows=rows, height=height,
                                      min_value=MIN_VALUE, mip_levels=levels)
            p = rt.launch_ms(plain, n=20, may_wait=True)
            row.update(plain_ms=round(p.ms, 4), plain_host_waited=p.host_waited)
        work = this.kimages.images_work(c, rows, height, frames, levels)
        bound, by = rt.bound_ms(work["bytes"], work["flop"])
        row.update(bound_ms=round(bound, 4), bound_by=by, mbytes=round(work["bytes"] / 1e6, 2),
                   bound_share=round(bound / t.ms, 4))
        print(json.dumps(row), flush=True)
        out.append(row)
        del db
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="a checkout whose thesia_tpu_torch runs in turns with this one")
    ap.add_argument("--counts", action="store_true",
                    help="only the device kernels a kernel call launches, as one JSON line")
    a = ap.parse_args()
    order = ["other", "this", "this", "other"] if a.other else ["this"]
    trees = {"this": load_tree(None, None)}
    this = trees["this"]
    dev = this.runtime.resolve_device("cuda")
    if a.counts:
        print(json.dumps({"device_kernels": counts(this, dev)}), flush=True)
        return 0
    if a.other:
        trees["other"] = load_tree("other_thesia_tpu_torch", a.other)
    print(this.runtime.card_description(), flush=True)
    rows = []
    for label in order:
        rows += bench_tree(label, trees[label], this, dev)
    digests = {}
    for r in rows:
        digests.setdefault(r["shape"], set()).add(r["sha256"])
    same = all(len(v) == 1 for v in digests.values())
    summary = {}
    for label in trees:
        for name, *_ in SHAPES:
            ms = [r["ms"] for r in rows if r["tree"] == label and r["shape"] == name]
            if ms:
                summary[f"{label}.{name}"] = statistics.median(ms)
    print(json.dumps({"median_ms": summary, "images_equal_across_trees": same}), flush=True)
    if not same:
        raise AssertionError(f"the trees' images differ: {digests}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
