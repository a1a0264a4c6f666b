"""Dynamics: stats and LUFS, normalize, guard clipping, the limiter.

Port of ``thesia_tpu/dynamics/``: the host modules are copies of their
originals; ``stats_device`` holds the float64 device programs (K8, K9) as
torch operations."""

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
