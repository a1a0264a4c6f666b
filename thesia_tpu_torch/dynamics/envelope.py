"""Envelope primitives: sliding sum/average, cascaded box filters, peak hold.

Host copy of ``thesia_tpu/dynamics/envelope.py`` (numpy, unchanged);
pinned by ``tests/test_torch_hostcopies.py``.

Ported semantics from the reference (reference:
src-tauri/src/core/dynamics/envelope.rs, itself a port of Signalsmith DSP).
Two forms are provided:

  * streaming classes (`BoxSum`, `BoxFilter`, `BoxStackFilter`, `PeakHold`)
    with per-sample `step` — the bit-parity reference used by tests;
  * vectorized whole-signal functions (`sliding_max`, `box_filter_signal`,
    `box_stack_signal`) used by the production limiter path — O(n) numpy
    (van Herk-Gil-Werman for sliding max, cumsum for box sums).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Streaming reference implementations


class BoxSum:
    """O(1) sliding-window sum. reference: envelope.rs:10-87."""

    def __init__(self, max_length: int):
        self.buf_len = max_length + 1
        self.reset(0.0)

    def reset(self, value: float) -> None:
        self.index = 0
        self.sum = 0.0
        self.buffer = np.zeros(self.buf_len)
        s = 0.0
        for i in range(self.buf_len):
            self.buffer[i] = s
            s += value
        self.wrap_jump = s

    def read(self, width: int) -> float:
        if self.index >= width:
            return self.sum - self.buffer[self.index - width]
        return self.sum + self.wrap_jump - self.buffer[self.index + self.buf_len - width]

    def write(self, value: float) -> None:
        self.index += 1
        if self.index == self.buf_len:
            self.index = 0
            self.wrap_jump = self.sum
            self.sum = 0.0
        self.sum += value
        self.buffer[self.index] = self.sum

    def step(self, value: float, width: int) -> float:
        self.write(value)
        return self.read(width)


class BoxFilter:
    """Moving average over `length` samples. reference: envelope.rs:89-138."""

    def __init__(self, max_length: int):
        assert max_length > 0
        self.box_sum = BoxSum(max_length)
        self.length = max_length
        self.max_length = max_length
        self.multiplier = 1.0 / max_length

    def set(self, length: int) -> None:
        assert length > 0
        self.length = length
        self.multiplier = 1.0 / length
        if length > self.max_length:
            self.box_sum = BoxSum(length)
            self.max_length = length

    def reset(self, fill: float) -> None:
        self.box_sum.reset(fill)

    def step(self, value: float) -> float:
        return self.box_sum.step(value, self.length) * self.multiplier


# reference: envelope.rs:190-204
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


class BoxStackFilter:
    """Cascade of box filters. reference: envelope.rs:178-328."""

    def __init__(self, max_size: int, num_layers: int):
        ratios = optimal_ratios(num_layers)
        lengths = stack_layer_lengths(max_size, ratios)
        self.filters = [BoxFilter(max(l, 1)) for l in lengths]
        for f, l in zip(self.filters, lengths):
            f.set(max(l, 1))

    def reset(self, fill: float) -> None:
        for f in self.filters:
            f.reset(fill)

    def step(self, value: float) -> float:
        for f in self.filters:
            value = f.step(value)
        return value


class PeakHold:
    """Constant-time sliding max (three-region reverse-cummax algorithm).

    This streaming version is a simple deque-free equivalent: it keeps the
    last `hold_length` values and takes their max (O(H) per step — used only
    in tests; the production path uses the O(1)-amortized vectorized
    sliding_max below).  reference: envelope.rs:330-506.
    """

    def __init__(self, sr: int, hold_ms: float):
        # floor at 1: a hold window that rounds to 0 (tiny hold_ms at low
        # sr) must degrade to "pass the current value through", not crash
        # max([]) (the reference handles zero-length holds)
        self.hold_length = max(int(np.floor(sr * hold_ms / 1000.0 + 0.5)), 1)
        self.reset(-np.inf)

    def reset(self, fill: float) -> None:
        self.buffer = [fill] * self.hold_length

    def step(self, value: float) -> float:
        self.buffer.append(value)
        if len(self.buffer) > self.hold_length:
            self.buffer.pop(0)
        return max(self.buffer)


# ---------------------------------------------------------------------------
# Vectorized whole-signal forms (production path)


def sliding_max(x: np.ndarray, window: int) -> np.ndarray:
    """out[t] = max(x[max(t-window+1, -inf padding) .. t]); -inf history.

    van Herk-Gil-Werman: O(n) with two block-wise cummax passes.
    """
    x = np.asarray(x)
    n = x.shape[-1]
    if window <= 1:
        return x.copy()
    pad_front = window - 1
    n_tot = pad_front + n
    n_blocks = -(-n_tot // window)
    pad_back = n_blocks * window - n_tot
    xp = np.concatenate(
        [np.full(pad_front, -np.inf, x.dtype), x, np.full(pad_back, -np.inf, x.dtype)]
    ).reshape(n_blocks, window)
    fwd = np.maximum.accumulate(xp, axis=1).reshape(-1)
    bwd = np.maximum.accumulate(xp[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    # out[t] over padded coords: window ending at j = pad_front + t
    j = np.arange(n) + pad_front
    i = j - window + 1
    return np.maximum(bwd[i], fwd[j])


def sliding_min(x: np.ndarray, window: int) -> np.ndarray:
    return -sliding_max(-np.asarray(x), window)


def box_filter_signal(x: np.ndarray, length: int, fill: float) -> np.ndarray:
    """Moving average of the last `length` samples, pre-history = fill."""
    if length <= 1:
        return np.asarray(x, np.float64).copy()
    xe = np.concatenate([np.full(length - 1, fill, np.float64), np.asarray(x, np.float64)])
    c = np.cumsum(xe)
    out = np.empty(len(x), np.float64)
    out[0] = c[length - 1]
    out[1:] = c[length:] - c[: len(x) - 1]
    return out / length


def box_stack_signal(x: np.ndarray, size: int, num_layers: int, fill: float) -> np.ndarray:
    """Cascaded box filters with Signalsmith-optimal length ratios."""
    lengths = stack_layer_lengths(size, optimal_ratios(num_layers))
    out = np.asarray(x, np.float64)
    for l in lengths:
        out = box_filter_signal(out, max(l, 1), fill)
    return out
