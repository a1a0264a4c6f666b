"""Run one cell of the benchmark of ``thesia_tpu_torch`` on an NVIDIA GPU.

    python3 benchmark/run.py --workload song_memo.open --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Set-up makes the cell's tracks from the seed,
writes them as WAVs into a new directory under TMPDIR, builds one
``EngineSession`` on the card as the service does (deferred switches, the
shape warmer on) and runs one pass of the cell's loop; the window then drives
``Commands.call`` for ``--seconds``.  Once the window has closed, the
program's state is freed and a sample of what the window answered is held
against the plain reference (``benchmark/harness/ref``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last comes
``checks``, each number compared beside its limit, which also close
standard error.  Without a card, or with fewer than the cell asks for, it
exits non-zero and prints no result; so it does if jax, jaxlib, flax or the
JAX package ``thesia_tpu`` is loaded after set-up or after the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # the checkout, not this directory, is the import root

FORBIDDEN = ("jax", "jaxlib", "flax", "thesia_tpu")


class ForbiddenModule(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def check_no_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModule(f"{when}: loaded {found}")


def _port_counters():
    """Launch counts of the port's hand kernels (the engine's, and apart the
    device warmup's and the shape warmer's)."""
    from thesia_tpu_torch.kernels import dynamics, images, spec_db

    fns = (images.quantize_mips, dynamics.lufs_stats, dynamics.limiter_gain)

    def read() -> dict:
        out = {}
        for prefix, warm in (("", False), ("warm.", True)):
            counts = spec_db.spec_db.warm_launches if warm else spec_db.spec_db.launches
            out[prefix + "spec_fft_mel"] = counts["mel"]
            out[prefix + "spec_fft_linear"] = counts["linear"]
            for fn in fns:
                out[prefix + fn.__name__] = fn.warm_launches if warm else fn.launches
        return out

    return read


def _port_spans():
    """Every span's lifetime count and seconds, read without the port's
    percentiles (cheap enough to take around each turn)."""
    from thesia_tpu_torch import obs

    def read() -> dict:
        with obs._stages_lock:
            return {n: (s.count, s.total) for n, s in obs._stages.items()}

    return read


def _host_probe() -> dict:
    """Fixed host work, timed after the window and again at the end of the
    run, to tell a slow machine from a slow program: a pure-Python loop, a
    copy of 256 MB between buffers that exist, and 256 MB newly allocated
    and written (page faults)."""
    import numpy as np

    def best(fn) -> float:
        out = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return min(out)

    a, b = np.ones(1 << 25), np.empty(1 << 25)
    return {"python_ms": best(lambda: sum(i * i for i in range(1_000_000))),
            "copy_ms": best(lambda: np.copyto(b, a)),
            "fault_ms": best(lambda: np.full(1 << 25, 1.0))}


# the profiler's count of each hand kernel, against these launch counters
PROFILER_VS_COUNTERS = {"spec_fft": ("spec_fft_mel", "spec_fft_linear"),
                        "k6": ("quantize_mips",), "k9": ("lufs_stats",),
                        "k8": ("limiter_gain",)}


def _span_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, s in after.items():
        b = before.get(name, {"count": 0, "total_ms": 0.0})
        if s["count"] > b["count"]:
            out[name] = {"count": s["count"] - b["count"], "total_ms": s["total_ms"] - b["total_ms"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result object.  ``device`` "cpu" is the
    CPU tests' route; the command line never takes it."""
    import numpy as np
    import torch

    from benchmark.harness import readers, signals
    from benchmark.harness import trace as tr
    from benchmark.harness.drive import Client, Loop, Session
    from benchmark.harness.ref.pipeline import Reference, compare
    from benchmark.harness.ref.render import colormap_rgba8

    on_card = torch.device(device).type == "cuda"
    workdir = tempfile.mkdtemp(prefix="thesia-bench-")
    try:
        tracer = tr.DeviceTrace(workdir) if trace and on_card else None
        if tracer:
            tracer.start()
        tracks, paths, shapes = [], [], []
        for i, spec in enumerate(cell.config["tracks"]):
            x = signals.make_track(spec, seed, i, device)
            path = os.path.join(workdir, f"{spec['name']}.wav")
            with open(path, "wb") as f:
                f.write(signals.wav_bytes_s16(x, int(spec["sr"])))
            tracks.append((x, int(spec["sr"])))
            paths.append(path)
            shapes.append((x.shape[0], x.shape[1], int(spec["sr"])))

        from thesia_tpu_torch import obs, runtime
        from thesia_tpu_torch.engine.service import (Commands, limit_malloc_arenas,
                                                     start_device_warmup)
        from thesia_tpu_torch.engine.session import EngineSession

        limit_malloc_arenas()
        session = EngineSession(device=device, settings_dir=os.path.join(workdir, "settings"))
        start_device_warmup(session)
        client = Client(Commands(session))
        client.call("init", colormapRgba=colormap_rgba8().reshape(-1).tolist())
        counters = _port_counters()
        loop = Loop(Session(client, paths, [c for c, _n, _sr in shapes], cell.mix,
                            cell.config["settings"]), seed, counters, _port_spans(),
                    warm_idle=lambda: session.tm.shape_warmer.drain(timeout=300))
        loop.setup()
        runtime.device_warmup(background=False, device=session.device)
        session.tm.shape_warmer.drain(timeout=300)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check_no_jax("after set-up")

        spans0, launches0 = obs.summary(), counters()
        warmer = session.tm.shape_warmer
        jobs0 = (warmer.compiled_count, warmer.failed_count)
        if tracer:
            tracer.window_start()
        window_s = loop.run(seconds)
        if tracer:
            tracer.window_end()
        elif on_card:
            torch.cuda.synchronize()
        launches_w = counters()
        jobs1 = (warmer.compiled_count, warmer.failed_count)
        spans = _span_delta(spans0, obs.summary())
        # what the window's commands handed the shape warmer runs out before
        # the launches are counted (and, traced, before the profiler stops)
        session.tm.shape_warmer.drain(timeout=300)
        if tracer:
            tracer.stop()
        launches = {k: v - launches0[k] for k, v in counters().items()}
        memory_peak = torch.cuda.max_memory_allocated(session.device) if on_card else 0
        check_no_jax("after the window")

        run = readers.Run(setup_s=setup_s, window_s=window_s, turns=loop.turns,
                          tile_ms=list(client.tile_ms), spans=spans, tracks=shapes,
                          states=list(loop.states),
                          warm={k: launches_w["warm." + k] - launches0["warm." + k]
                                for k in launches if not k.startswith("warm.")})
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(session.device) if on_card else "cpu",
                       "count": 1, "memory_peak_bytes": int(memory_peak)}
        breakdown = None
        if tracer:
            run.trace = tracer.read()
            for k, counter_keys in PROFILER_VS_COUNTERS.items():
                counted = sum(launches[c] + launches["warm." + c] for c in counter_keys)
                if run.trace["hand"][k] != counted:
                    raise AssertionError(
                        f"torch.profiler saw {run.trace['hand'][k]} {k} kernels from the "
                        f"window's start, the port's launch counters {counted}")
            device_info["busy_s"] = run.trace["busy_s"]
            device_info["window_s"] = run.trace["window_s"]
            phases = [p for t in loop.turns for p in t.phases]
            breakdown = {"device_ops": tr.top_ops(run.trace),
                         "idle_gaps": tr.idle_gaps(run.trace, phases)}
        metrics = {}
        for name, (unit, reader) in cell.metrics.items():
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": unit}
        print(f"turns {len(loop.turns)}, tile requests {len(run.tile_ms)}, window_s {window_s}",
              file=log)
        print("turn seconds " + " ".join(f"{t.kind}:{t.end - t.t0:.3f}" for t in loop.turns),
              file=log)
        steps: dict[str, list] = {}
        for name, a, b in (p for t in loop.turns for p in t.phases):
            steps.setdefault(name, []).append((b - a) / 1e6)
        print("step ms (median, max) " + ", ".join(
            f"{k} {sorted(v)[len(v) // 2]:.1f} {max(v):.1f}" for k, v in steps.items()), file=log)
        print(f"hand kernel launches in the window {launches}", file=log)
        print("warmers' launches in the window (left out of the roofline shares): "
              + " ".join(f"{k} {readers.warm_launches(run, k)}" for k in readers.LAUNCH_COUNTER),
              file=log)
        print(f"shape warmer in the window: {jobs1[0] - jobs0[0]} jobs run, "
              f"{jobs1[1] - jobs0[1]} failed", file=log)
        probe = _host_probe()

        # the program's state goes before the reference runs
        observed, attempted, failed = loop.observed, client.attempted, client.failed
        session.tm.images.shutdown()
        del loop, client, session, run, warmer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers = compare(Reference(tracks, device), observed)
        print(f"compared {numbers.pop('tiles_compared')} tiles of {len(observed)} turns "
              f"with the reference in {time.perf_counter() - t_ref:.1f} s", file=log)
        print("host probe (ms, best of 3) after the window " + " ".join(
            f"{k} {v:.2f}" for k, v in probe.items()) + ", at the end " + " ".join(
            f"{k} {v:.2f}" for k, v in _host_probe().items()), file=log)
        checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in cell.limits.items()}
        correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
        result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_info}
        if breakdown:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def production_env() -> None:
    """The service's defaults, whatever the environment says; the program's
    caches inside the checkout, at fixed paths."""
    os.environ["THESIA_DEFER_SETTINGS"] = "1"
    os.environ["THESIA_PRECOMPILE"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    production_env()
    from benchmark.harness.cells import resolve

    cell = resolve(args.workload, bool(args.trace), ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
        check_no_jax("before the result")
    except ForbiddenModule as e:
        print(f"forbidden module {e}", file=sys.stderr)
        return 4
    emit(result)
    return 0


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
