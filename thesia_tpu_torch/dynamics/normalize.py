"""Loudness/peak normalization targets.

Host copy of ``thesia_tpu/dynamics/normalize.py`` (unchanged, f32 roundings
included); pinned by ``tests/test_torch_hostcopies.py``.

reference: src-tauri/src/core/dynamics/normalize.rs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .stats import AudioStats


@dataclasses.dataclass(frozen=True)
class NormalizeTarget:
    """type in {'Off', 'LUFS', 'RMSdB', 'PeakdB'}; target in dB/LUFS."""

    type: str = "Off"
    target: float = 0.0

    def to_json(self) -> dict:
        if self.type == "Off":
            return {"type": "Off"}
        return {"type": self.type, "target": self.target}

    @classmethod
    def from_json(cls, d: dict) -> "NormalizeTarget":
        """Validates fully at parse time: with deferred switches the engine
        answers OK at dispatch, so input that is guaranteed to fail must be
        rejected HERE (mirrors serde rejecting an unknown enum variant)."""
        kind = d.get("type", "Off")
        if kind == "Off":
            return cls()
        if kind not in ("LUFS", "RMSdB", "PeakdB"):
            raise ValueError(f"unknown normalize type {kind!r}")
        target = float(d["target"])
        if not np.isfinite(target):
            raise ValueError("normalize target must be finite")
        if kind == "PeakdB" and target > 0.0:
            raise ValueError("PeakdB target must be <= 0 dB")
        return cls(type=kind, target=target)


def calc_normalize_gain(target: NormalizeTarget, stats: AudioStats) -> float:
    """Gain from ORIGINAL (pre-gain) stats. reference: normalize.rs:23-45."""
    f32 = np.float32
    if target.type == "LUFS":
        return float(f32(10.0) ** (f32(f32(target.target) - f32(stats.global_lufs)) / f32(20.0)))
    if target.type == "RMSdB":
        return float(f32(10.0) ** (f32(f32(target.target) - f32(stats.rms_db)) / f32(20.0)))
    if target.type == "PeakdB":
        if target.target > 0.0:  # enforced at parse; keep the invariant hard
            raise ValueError("PeakdB target must be <= 0 dB")
        return float(f32(10.0) ** (f32(f32(target.target) - f32(stats.max_peak_db)) / f32(20.0)))
    return 1.0
