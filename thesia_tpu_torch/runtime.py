"""Device resolution, the f32 numeric policy, the process's device warmup,
the card's description, and the timing and peak rates that the measurement
scripts share.

The port's entry points run on the card ("cuda") unless the caller names
another ("cuda:1" or "cpu"); a CUDA device that is not there is an error,
never a reason to run on the CPU.  Matrix products
run in true f32 on the card (no TF32), matching the JAX package's
``Precision.HIGHEST``.

``device_warmup`` and ``warmup_done`` keep the semantics of
``thesia_tpu/runtime.py:40-83``: one daemon thread, joinable, whose failure
clears its handle so that the next call retries.  What they absorb differs:
the card compiles nothing per shape, so a fresh process pays instead for
the CUDA context, the kernel library (``kernels/build.py``), the upload
ring and its copy stream (``dsp/upload.py``), and the first launch of every
device program on the main path (CUDA loads each kernel's module at
its first launch).  The JAX package's ``configure_jax_cache`` has no
counterpart: the kernel library's ``_build/`` directory, named by a hash of
the sources, is the port's persistent build cache.  On the CPU the warmup
costs nothing.  Work done under ``warming()`` (the warmup, the shape
warmer's jobs) counts in the kernels' ``warm_launches`` and the uploads'
``warm_counters``, never in the main path's counts.  The warmup pauses
between its steps while a user's command runs (``foreground()``, entered by
the session's write commands): both would pay the same first launches, and
the command must not wait for the warmup's.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import statistics
import subprocess
import threading
import time
from typing import NamedTuple

import torch

log = logging.getLogger(__name__)

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit): HBM3
# bytes per second, f32 and f64 operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def set_fp32_policy() -> None:
    """Full f32 for matmuls and convolutions: TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    set_fp32_policy()
    return dev


_local = threading.local()


@contextlib.contextmanager
def warming():
    """Count the launches and uploads of this thread's block as warm ones."""
    prev = getattr(_local, "warming", False)
    _local.warming = True
    try:
        yield
    finally:
        _local.warming = prev


def is_warming() -> bool:
    return getattr(_local, "warming", False)


def count_launch(fn) -> None:
    """One launch of ``fn``'s program: in ``fn.warm_launches`` under
    ``warming()``, else in ``fn.launches``."""
    if is_warming():
        fn.warm_launches += 1
    else:
        fn.launches += 1


_lock = threading.Lock()
_thread: threading.Thread | None = None
_done = False
_foreground = threading.Condition()
_foreground_depth = 0


@contextlib.contextmanager
def foreground():
    """A user's command is running: the device warmup waits between its
    steps until none is."""
    global _foreground_depth
    with _foreground:
        _foreground_depth += 1
    try:
        yield
    finally:
        with _foreground:
            _foreground_depth -= 1
            _foreground.notify_all()


def yield_to_foreground() -> None:
    """Block while a ``foreground()`` command runs."""
    with _foreground:
        _foreground.wait_for(lambda: _foreground_depth == 0)


def _do_warmup(device: torch.device) -> None:
    global _done, _thread
    try:
        from .dsp.precompile import warm_device

        with warming():
            warm_device(device)
        _done = True
    except Exception:
        # clear the handle so that a later call retries instead of joining
        # this dead thread and reporting the card warm
        log.warning("device warmup failed; will retry on next use", exc_info=True)
        with _lock:
            if _thread is threading.current_thread():
                _thread = None


def warmup_done(device="cuda") -> bool:
    """True once the process's one-time device warmup has completed, and
    always on the CPU.  The shape warmer gates its jobs on it."""
    return _done or torch.device(device).type == "cpu"


def device_warmup(background: bool = False, device="cuda") -> None:
    """Absorb the process's one-time device costs (module docstring).

    With background=True the warmup runs on a daemon thread (service
    startup, the shape warmer's gate); a later foreground call joins it.
    Nothing to do on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return
    dev = resolve_device(dev)
    global _thread
    with _lock:
        if _done:
            return
        if _thread is None:
            _thread = threading.Thread(
                target=_do_warmup, args=(dev,), daemon=True, name="device-warmup"
            )
            _thread.start()
        t = _thread
    if not background:
        t.join()


def card_description() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, one
    line per card (the power limit bounds every number measured on it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event milliseconds of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


class Timing(NamedTuple):
    """``launch_ms``'s reading: device ms and host us a call, and whether the
    card waited for the host inside the timed run."""

    ms: float
    host_us: float
    host_waited: bool


def launch_ms(fn, n: int = 50, warmup: int = 3, may_wait: bool = False) -> Timing:
    """Device ms and host us per call of ``fn()`` on the current stream.

    Device: ``n`` calls back to back between two CUDA events, over ``n``.
    The events and the calls are queued behind a spin kernel
    (``torch.cuda._sleep``) long enough for the host to queue all of them,
    so the card runs them without waiting for the host: the time is the
    card's, not the wrapper's.  If the spin had ended before the last call
    was queued (a host stall: the garbage collector, another thread), the
    card may have waited inside the window, so the run is repeated behind a
    spin four times longer, twice at most.  If the card still waited, a
    ``fn`` that never synchronizes (a kernel's wrapper) raises; with
    ``may_wait`` (a plain version or a library call, which may synchronize
    or wait on the allocator inside) the last run is returned with
    ``host_waited`` set: a time that holds the host's waits.  Host: the host
    clock around ``n`` calls without a synchronize (the wrapper's checks,
    allocation and launch), over ``n``, measured first on an idle card.  The
    garbage collector is off while the calls are queued."""
    if n < 20:
        raise ValueError(f"launch_ms: time at least 20 calls, not {n}")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    collecting = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        # twice the host's queueing time at an SM clock of at most 2 GHz
        spin = int(2 * n * host_s * 2e9) + 2_000_000
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            waited = e0.query()  # the spin was over before the last call was queued
            e1.synchronize()
            if not waited:
                break
            spin *= 4
    finally:
        if collecting:
            gc.enable()
    if waited and not may_wait:
        raise RuntimeError("launch_ms: the card waited for the host in each of three runs")
    return Timing(e0.elapsed_time(e1) / n, host_s * 1e6, waited)


def bound_ms(n_bytes: float, flop: float, flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take for work that moves ``n_bytes`` and
    does ``flop`` operations at ``flop_per_s`` (default f32; F64_FLOP_PER_S
    for f64), and which of the two sets it."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flop / flop_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= flop_ms else (flop_ms, "operations")
