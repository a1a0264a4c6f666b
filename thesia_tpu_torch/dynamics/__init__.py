"""Dynamics: stats and LUFS, normalize, guard clipping, the limiter.

Port of ``thesia_tpu/dynamics/``: the host modules are copies of their
originals; ``stats_device`` holds the batched device routes of K8 and K9
(CUDA kernels on a card, ``kernels/dynamics.py``) and their plain versions,
float64 torch programs."""

from .stats import AudioStats, GuardClippingStats, calc_stats
from .loudness import integrated_lufs, k_weighting_coeffs, momentary_loudness
from .normalize import NormalizeTarget, calc_normalize_gain
from .guard import GuardClippingMode, GuardClippingResult, guard_clipping
from .limiter import LimiterManager, PerfectLimiter, exponential_release_scan
from .envelope import (
    BoxFilter,
    BoxStackFilter,
    BoxSum,
    PeakHold,
    box_filter_signal,
    box_stack_signal,
    sliding_max,
    sliding_min,
)

__all__ = [
    "AudioStats",
    "GuardClippingStats",
    "calc_stats",
    "integrated_lufs",
    "k_weighting_coeffs",
    "momentary_loudness",
    "NormalizeTarget",
    "calc_normalize_gain",
    "GuardClippingMode",
    "GuardClippingResult",
    "guard_clipping",
    "LimiterManager",
    "PerfectLimiter",
    "exponential_release_scan",
    "BoxFilter",
    "BoxStackFilter",
    "BoxSum",
    "PeakHold",
    "box_filter_signal",
    "box_stack_signal",
    "sliding_max",
    "sliding_min",
]
