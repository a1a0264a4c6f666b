"""The limiter's gain sequence of the benchmark's plain reference, in PyTorch.

Frozen from ``thesia_tpu_torch/dynamics/limiter.py`` (``PerfectLimiter``:
the per-frame gain chain, its parameters and latency compensation) and
``dynamics/envelope.py`` (the box-stack lengths), with the vectorized
whole-signal formulation of those files run as torch operations on the
reference's device: the sliding minimum by van Herk's block scans, the
exponential release as an associative log-scan, the box filters as cumsum
differences.  nothing here imports the port, and the port never imports this.

Per-frame gain chain (reference: src-tauri/src/core/dynamics/limiter.rs:45-172):
    v      = max |x| across channels
    raw    = threshold / (v + eps)      if v > threshold else 1
    ph     = sliding min of raw over hold window (attack+hold ms)
    rel    = y_t = min(ph_t, y_{t-1} + (ph_t-y_{t-1})*slew)
    smooth = 3 cascaded box filters over the attack window (history = 1)
    gain   = min(smooth, 1)
with ``attack`` trailing zero frames and the first ``attack`` gains dropped.
"""

from __future__ import annotations

import numpy as np
import torch

_HARDCODED_RATIOS = [
    1.0, 0.582241861690, 0.417758138310, 0.404078562416, 0.334851475794,
    0.261069961789, 0.307944914938, 0.273699452340, 0.229132636010,
    0.189222996712, 0.248329349789, 0.229253789144, 0.201191468123,
    0.173033035122, 0.148192357821, 0.205275202874, 0.198413552119,
    0.178256637764, 0.157821404506, 0.138663023387, 0.121570179349,
]


def optimal_ratios(num_layers: int) -> np.ndarray:
    """reference: envelope.rs:290-316."""
    assert num_layers > 0
    if num_layers <= 6:
        i_start = num_layers * (num_layers - 1) // 2
        return np.array(_HARDCODED_RATIOS[i_start : i_start + num_layers])
    n = float(num_layers)
    inv_n = 1.0 / n
    sqrt_n = np.sqrt(n)
    p = 1.0 - inv_n
    k = 1.0 + 4.5 / sqrt_n + 0.08 * sqrt_n
    x = np.arange(num_layers) * inv_n
    result = 2.0 ** (p * np.exp(-x * k) * x - x)
    return result / result.sum()


def stack_layer_lengths(size: int, ratios: np.ndarray) -> list[int]:
    """Distribute impulse-response length over layers. reference: envelope.rs:229-265."""
    ratios = np.asarray(ratios, np.float64)
    ratios = ratios / ratios.sum()
    order = size - 1
    lengths = []
    errs = []
    total = 0
    for r in ratios:
        lf = r * order
        lo = int(lf)
        lengths.append(lo + 1)
        errs.append(lo - lf)
        total += lo
    for _ in range(total, order):
        i = int(np.argmin(errs))
        lengths[i] += 1
        errs[i] += 1.0
    return lengths


def sliding_min(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[t] = min(x[t-window+1 .. t]); +inf history."""
    n = x.shape[-1]
    if window <= 1:
        return x.clone()
    pad_front = window - 1
    n_blocks = -(-(pad_front + n) // window)
    pad_back = n_blocks * window - pad_front - n
    inf = torch.full((1,), torch.inf, dtype=x.dtype, device=x.device)
    xp = torch.cat([inf.expand(pad_front), x, inf.expand(pad_back)]).reshape(n_blocks, window)
    fwd = torch.cummin(xp, dim=1).values.reshape(-1)
    bwd = torch.cummin(xp.flip(1), dim=1).values.flip(1).reshape(-1)
    j = torch.arange(n, device=x.device) + pad_front
    return torch.minimum(bwd[j - window + 1], fwd[j])


def box_filter(x: torch.Tensor, length: int, fill: float) -> torch.Tensor:
    """Moving average of the last ``length`` samples, pre-history ``fill``."""
    if length <= 1:
        return x.clone()
    xe = torch.cat([torch.full((length - 1,), fill, dtype=x.dtype, device=x.device), x])
    c = torch.cumsum(xe, 0)
    out = torch.empty_like(x)
    out[0] = c[length - 1]
    out[1:] = c[length:] - c[: x.shape[0] - 1]
    return out / length


def release_scan(x: torch.Tensor, release_samples: float, y0: float = 1.0) -> torch.Tensor:
    """y_t = min(x_t, y_{t-1} + (x_t - y_{t-1}) slew), slew = 1/(release+1), as
    compositions of f_t(y) = min(c_t, a y + b_t), (A2,B2,C2) o (A1,B1,C1) =
    (A2 A1, A2 B1 + B2, min(C2, A2 C1 + B2)), doubling the span each pass."""
    n = x.shape[-1]
    slew = 1.0 / (release_samples + 1.0)
    A = torch.full_like(x, 1.0 - slew)
    B = slew * x
    C = x.clone()
    shift = 1
    while shift < n:
        A2, B2, C2 = A[shift:], B[shift:], C[shift:]
        A1, B1, C1 = A[:-shift], B[:-shift], C[:-shift]
        A, B, C = (torch.cat([A[:shift], A2 * A1]), torch.cat([B[:shift], A2 * B1 + B2]),
                   torch.cat([C[:shift], torch.minimum(C2, A2 * C1 + B2)]))
        shift *= 2
    return torch.minimum(C, A * y0 + B)


class PerfectLimiter:
    """reference: limiter.rs:45-172."""

    def __init__(
        self,
        sr: int,
        threshold: float = 1.0,
        attack_ms: float = 5.0,
        hold_ms: float = 15.0,
        release_ms: float = 40.0,
    ):
        assert threshold > np.finfo(np.float32).eps
        self.sr = sr
        self.threshold = float(threshold)
        ms_to_samples = lambda x: x * sr / 1000.0
        self.attack = int(np.floor(ms_to_samples(attack_ms) + 0.5))
        self.hold_length = int(np.floor(ms_to_samples(attack_ms + hold_ms) + 0.5))
        self.release_samples = ms_to_samples(release_ms)

    def calc_gain_seq(self, wavs: np.ndarray, dtype=np.float64, device="cpu") -> np.ndarray:
        """Gain sequence (latency-compensated), shape (n_samples,), in
        ``dtype`` (float64 as the port states it; float32 for the control)."""
        dt = torch.float64 if dtype == np.float64 else torch.float32
        x = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(wavs))).to(device, dt)
        # NaN-ignoring channel maximum, like the reference's f32::max fold
        v = torch.nan_to_num(x.abs(), nan=0.0).amax(0)
        v = torch.cat([v, torch.zeros(self.attack, dtype=dt, device=v.device)])
        eps = torch.finfo(dt).eps
        raw = torch.where(v > self.threshold, self.threshold / (v + eps), torch.ones_like(v))
        gain = release_scan(sliding_min(raw, max(self.hold_length, 1)), self.release_samples)
        if self.attack > 0:
            for length in stack_layer_lengths(self.attack, optimal_ratios(3)):
                gain = box_filter(gain, max(length, 1), 1.0)
        return torch.clamp(gain, max=1.0)[self.attack:].cpu().numpy()
