"""Device resolution, the f32 numeric policy, the card's description, and
the timing and peak rates that the measurement scripts share.

The port's entry points run on the card ("cuda") unless the caller names
another ("cuda:1" or "cpu"); a CUDA device that is not there is an error,
never a reason to run on the CPU.  Matrix products
run in true f32 on the card (no TF32), matching the JAX package's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit): HBM3
# bytes per second, f32 operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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


def bound_ms(n_bytes: float, flop: float) -> tuple[float, str]:
    """The least time the card could take for work that moves ``n_bytes`` and
    does ``flop`` f32 operations, and which of the two sets it."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flop / F32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= flop_ms else (flop_ms, "operations")
