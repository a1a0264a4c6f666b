"""Lookahead limiter (Signalsmith-style), vectorized for batch processing.

Host copy of ``thesia_tpu/dynamics/limiter.py`` (unchanged; it calls the
port's own ``native.limiter_gain_seq``); pinned by
``tests/test_torch_hostcopies.py``.

reference: src-tauri/src/core/dynamics/limiter.rs:45-172.

Per-frame gain chain (f64):
    v      = max |x| across channels
    raw    = threshold / (v + eps)      if v > threshold else 1
    ph     = sliding min of raw over hold window (attack+hold ms)
    rel    = exponential release:  y_t = min(ph_t, y_{t-1} + (ph_t-y_{t-1})*slew)
    smooth = 3 cascaded box filters over the attack window (history = 1)
    gain   = min(smooth, 1)
with `attack` samples of latency compensated by feeding `attack` trailing
zero frames and dropping the first `attack` gains
(reference: limiter.rs:110-135).

The reference computes this as a per-sample streaming loop; here every stage
is a whole-signal O(n) vectorized pass:
  * sliding min  -> van Herk-Gil-Werman block cummax
  * release      -> the recurrence y = min(c, a*y + b) is closed under
                    composition ((A,B,C) tuples), so it admits an associative
                    scan; the numpy path uses a Hillis-Steele log-scan
  * box stack    -> cumsum differences
"""

from __future__ import annotations

import numpy as np

from .envelope import box_stack_signal, sliding_min

_F64_EPS = float(np.finfo(np.float64).eps)


def exponential_release_scan(x: np.ndarray, release_samples: float, y0: float = 1.0) -> np.ndarray:
    """y_t = min(x_t, y_{t-1} + (x_t - y_{t-1}) * slew), slew = 1/(release+1).

    Associative form: step t is f_t(y) = min(c_t, a*y + b_t) with
    a = 1 - slew, b_t = slew*x_t, c_t = x_t.  Composition:
    (A2,B2,C2) o (A1,B1,C1) = (A2*A1, A2*B1 + B2, min(C2, A2*C1 + B2)).
    reference: limiter.rs:10-43.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    slew = 1.0 / (release_samples + 1.0)
    a = 1.0 - slew
    A = np.full(n, a)
    B = slew * x
    C = x.copy()
    shift = 1
    while shift < n:
        # compose prefix [t-shift] into [t]
        A2, B2, C2 = A[shift:], B[shift:], C[shift:]
        A1, B1, C1 = A[:-shift], B[:-shift], C[:-shift]
        newA = A2 * A1
        newB = A2 * B1 + B2
        newC = np.minimum(C2, A2 * C1 + B2)
        A[shift:], B[shift:], C[shift:] = newA, newB, newC
        shift *= 2
    return np.minimum(C, A * y0 + B)


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

    def calc_gain_seq(self, wavs: np.ndarray) -> np.ndarray:
        """Gain sequence (latency-compensated), f64, shape (n_samples,).

        wavs: (n_ch, n_samples).  Prefers the native streaming implementation
        (bit-faithful fma/f64 sequencing); falls back to the vectorized
        numpy formulation (same values to ~1e-9).
        """
        wavs = np.atleast_2d(np.asarray(wavs))
        from .. import native

        if native.available():
            return native.limiter_gain_seq(
                wavs.astype(np.float32),
                self.sr,
                self.threshold,
                self.attack * 1000.0 / self.sr,
                (self.hold_length - self.attack) * 1000.0 / self.sr,
                self.release_samples * 1000.0 / self.sr,
            )
        # fmax ignores NaN like the reference's f32::max fold and the native
        # comparison loop (limiter.rs:148): a NaN in one channel must not
        # disable limiting of the finite channels (np.max would propagate)
        v = np.fmax.reduce(np.abs(wavs.astype(np.float64)), axis=0)
        # trailing `attack` zero frames for latency compensation -> raw gain 1
        v = np.concatenate([v, np.zeros(self.attack)])
        raw = np.where(v > self.threshold, self.threshold / (v + _F64_EPS), 1.0)
        ph = sliding_min(raw, max(self.hold_length, 1))
        rel = exponential_release_scan(ph, self.release_samples, 1.0)
        if self.attack > 0:
            sm = box_stack_signal(rel, self.attack, 3, 1.0)
        else:
            sm = rel
        gain = np.minimum(sm, 1.0)
        return gain[self.attack :]

    def process(self, wavs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (limited f32 (n_ch, n), gain_seq f32 (n,)).
        reference: limiter.rs:110-143."""
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        gain = self.calc_gain_seq(wavs)
        out = np.clip(wavs.astype(np.float64) * gain[None, :], -1.0, 1.0).astype(np.float32)
        return out, gain.astype(np.float32)


class LimiterManager:
    """Per-sample-rate limiter cache. reference: limiter.rs:246-258."""

    def __init__(self):
        self._limiters: dict[int, PerfectLimiter] = {}

    def get_or_insert(self, sr: int) -> PerfectLimiter:
        if sr not in self._limiters:
            self._limiters[sr] = PerfectLimiter(sr)
        return self._limiters[sr]
