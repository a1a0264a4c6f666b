"""Slaney-style (librosa) mel scale and triangular mel filterbank.

Frozen copy of ``thesia_tpu_torch/common/melscale.py`` for the benchmark's plain reference;
nothing here imports the port, and the port never imports this.

Host-side precompute: filterbanks are built once per (sr, n_fft) in numpy and
then live on device as the RHS of the spectrogram GEMM.  Semantics follow the
reference shared crate (reference: src-common/src/lib.rs:11-103): linear below
1 kHz (200/3 Hz per mel), logarithmic above with step ln(6.4)/27.
"""

from __future__ import annotations

import numpy as np

# reference: src-common/src/lib.rs:11-15
MEL_DIFF_2K_1K = 10.081880157308321  # hz_to_mel(2000) - hz_to_mel(1000)
MIN_LOG_MEL = 15
_MIN_LOG_HZ = 1000.0
_LOGSTEP = 0.06875177742094912  # ln(6.4) / 27
_LINEARSCALE = 200.0 / 3.0


def mel_to_hz(mel, dtype=None):
    """Mel -> Hz. Scalar or ndarray. reference: src-common/src/lib.rs:17-29."""
    mel = np.asarray(mel, dtype=dtype)
    dt = mel.dtype
    min_log_mel = dt.type(MIN_LOG_MEL)
    linear = dt.type(_LINEARSCALE) * mel
    log = dt.type(_MIN_LOG_HZ) * np.exp(dt.type(_LOGSTEP) * (mel - min_log_mel))
    out = np.where(mel < min_log_mel, linear, log)
    return out[()] if out.ndim == 0 else out


def hz_to_mel(hz, dtype=None):
    """Hz -> mel. Scalar or ndarray. reference: src-common/src/lib.rs:31-43."""
    hz = np.asarray(hz, dtype=dtype)
    dt = hz.dtype
    min_log_hz = dt.type(_MIN_LOG_HZ)
    linear = hz / dt.type(_LINEARSCALE)
    with np.errstate(divide="ignore", invalid="ignore"):
        log = dt.type(MIN_LOG_MEL) + np.log(hz / min_log_hz) / dt.type(_LOGSTEP)
    out = np.where(hz < min_log_hz, linear, log)
    return out[()] if out.ndim == 0 else out


def calc_mel_fb(sr, n_fft, n_mel, fmin=0.0, fmax=None, do_norm=True, dtype=np.float32):
    """Triangular mel filterbank, shape (n_fft//2 + 1, n_mel).

    Each mel filter ramps 0->1 over [mel_f[m], mel_f[m+1]] and 1->0 over
    [mel_f[m+1], mel_f[m+2]]; bins at or below the left edge get 0 weight.
    With do_norm, each filter is divided by max(sum, eps) so it sums to 1.
    reference: src-common/src/lib.rs:46-89.
    """
    assert n_fft % 2 == 0 and n_mel > 0
    dt = np.dtype(dtype)
    f_nyquist = dt.type(sr / 2.0)
    if fmax is None:
        fmax = f_nyquist
    n_freq = n_fft // 2 + 1

    linear_freqs = np.linspace(dt.type(0), f_nyquist, n_freq, dtype=dt)
    mel_freqs = mel_to_hz(
        np.linspace(hz_to_mel(dt.type(fmin)), hz_to_mel(dt.type(fmax)), n_mel + 2, dtype=dt)
    )

    weights = np.zeros((n_mel, n_freq), dtype=dt)
    f = linear_freqs
    for m in range(n_mel):
        lo, mid, hi = mel_freqs[m], mel_freqs[m + 1], mel_freqs[m + 2]
        up = (f > lo) & (f < mid)
        weights[m, up] = (f[up] - lo) / (mid - lo)
        weights[m, (f == mid) & (f > lo)] = 1.0
        down = (f > mid) & (f < hi)
        weights[m, down] = (hi - f[down]) / (hi - mid)
        if do_norm:
            weights[m] /= max(weights[m].sum(), np.finfo(dt).eps)
    return np.ascontiguousarray(weights.T)


def calc_mel_fb_default(sr, n_fft):
    """Auto-sized normalized f32 filterbank: the largest n_mel such that no
    mel filter is empty. reference: src-common/src/lib.rs:91-103."""
    f32 = np.float32
    ratio = hz_to_mel(f32(sr) / f32(2.0)) / hz_to_mel(f32(sr) / f32(n_fft))
    n_mel = int(f32(ratio) * f32(2.0) - f32(1.0))  # fma then truncate, as in the reference
    n_mel = min(n_mel, n_fft // 2 + 1)
    while True:
        mel_fb = calc_mel_fb(sr, n_fft, n_mel, 0.0, None, True, np.float32)
        if (mel_fb.sum(axis=0) > 0).all():
            return mel_fb
        n_mel -= 1
