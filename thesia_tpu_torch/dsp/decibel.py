"""librosa-style amplitude/power <-> dB with exact edge-case semantics.

Port of ``thesia_tpu/dsp/decibel.py``: the scalar functions
(``db_from_amp_scalar``, ``db_from_power_scalar``) are copied as they are;
the array functions work on torch tensors.  With the default amin=0: x == 0
maps to exactly -inf, x < 0, -0.0 or NaN maps to NaN.  reference:
src-tauri/src/core/dynamics/decibel.rs:11-248.
"""

from __future__ import annotations

import math

import torch

AMIN_AMP_DEFAULT = 0.0
AMIN_POWER_DEFAULT = 0.0


def _log_for_db(x: torch.Tensor, ref_value: float, amin: float) -> torch.Tensor:
    """log10(x) - log10(ref), with the amin floor rules of the reference.

    reference: src-tauri/src/core/dynamics/decibel.rs:170-195.
    """
    if amin < 0.0:
        raise ValueError(f"amin must be >= 0, got {amin}")
    if math.isnan(ref_value):
        return x
    if math.copysign(1.0, ref_value) < 0.0:  # is_sign_negative: incl. -0.0
        return torch.full_like(x, math.nan)
    log_amin = math.log10(amin) if amin > 0 else -math.inf
    log_ref = math.log10(ref_value) if ref_value > amin else log_amin
    out_for_small = log_amin - log_ref
    invalid = torch.isnan(x) | torch.signbit(x)  # -0.0 is invalid too
    # guard the log10 input so no spurious nan leaks from masked lanes
    safe = torch.where(x > amin, x, torch.ones_like(x))
    big = torch.log10(safe) - log_ref
    small = torch.full_like(x, out_for_small)
    return torch.where(invalid, torch.full_like(x, math.nan), torch.where(x > amin, big, small))


def db_from_amp(x: torch.Tensor, ref_value: float = 1.0, amin: float = AMIN_AMP_DEFAULT):
    """20*log10(x/ref). reference: decibel.rs:197-202."""
    return 20.0 * _log_for_db(x, ref_value, amin)


def db_from_power(x: torch.Tensor, ref_value: float = 1.0, amin: float = AMIN_POWER_DEFAULT):
    """10*log10(x/ref). reference: decibel.rs:204-209."""
    return 10.0 * _log_for_db(x, ref_value, amin)


def amp_from_db(x: torch.Tensor, ref_value: float = 1.0):
    """ref * 10^(x/20). reference: decibel.rs:221-224."""
    return ref_value * torch.pow(10.0, 0.05 * x)


def power_from_db(x: torch.Tensor, ref_value: float = 1.0):
    """ref * 10^(x/10). reference: decibel.rs:226-229."""
    return ref_value * torch.pow(10.0, 0.1 * x)


def _is_sign_negative(v: float) -> bool:
    """Rust f64::is_sign_negative: true for -0.0 too (x < 0.0 is not)."""
    return math.copysign(1.0, v) < 0.0


def db_from_amp_scalar(x: float, ref_value: float = 1.0, amin: float = AMIN_AMP_DEFAULT) -> float:
    """Pure-python scalar version (host-side stats paths).
    reference: decibel.rs:66-91 (-0.0 is sign-negative -> NaN, like the
    array path's signbit check)."""
    if math.isnan(ref_value) or _is_sign_negative(ref_value):
        return math.nan
    log_amin = math.log10(amin) if amin > 0 else -math.inf
    log_ref = math.log10(ref_value) if ref_value > amin else log_amin
    if math.isnan(x) or _is_sign_negative(x):
        return math.nan
    if x > amin:
        return 20.0 * (math.log10(x) - log_ref)
    return 20.0 * (log_amin - log_ref)


def db_from_power_scalar(x: float, ref_value: float = 1.0, amin: float = AMIN_POWER_DEFAULT) -> float:
    if math.isnan(ref_value) or _is_sign_negative(ref_value):
        return math.nan
    log_amin = math.log10(amin) if amin > 0 else -math.inf
    log_ref = math.log10(ref_value) if ref_value > amin else log_amin
    if math.isnan(x) or _is_sign_negative(x):
        return math.nan
    if x > amin:
        return 10.0 * (math.log10(x) - log_ref)
    return 10.0 * (log_amin - log_ref)
