"""EBU R128 / ITU-R BS.1770-4 loudness (integrated LUFS).

Frozen copy of ``thesia_tpu_torch/dynamics/loudness.py`` for the benchmark's plain reference;
nothing here imports the port, and the port never imports this.

Reimplements the algorithm used by the reference's `ebur128` crate
(reference: src-tauri/src/core/dynamics/stats.rs:44-86): K-weighting
pre-filter (high-shelf + high-pass biquads with coefficients derived for the
actual sample rate), 400 ms gating blocks at 75 % overlap (100 ms step),
-70 LUFS absolute gate, then a -10 LU relative gate, energy-averaged.

Host path uses scipy.signal.lfilter (f64).  A batched device path
(biquads as 2x2-matrix associative scans) lives in stats_device.py.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# Channel weights: L/R/C = 1.0, surround = 1.41 (BS.1770). For the viewer's
# mono/stereo tracks all channels weigh 1.0.
_SURROUND_WEIGHT = 1.41


def k_weighting_coeffs(sr: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(b1, a1, b2, a2) biquad coefficient arrays for sample rate `sr`.

    Stage 1: spherical-head high shelf; stage 2: high-pass.  Constants are
    the ones published in the BS.1770 derivation (as used by libebur128).
    """
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b1 = np.array([(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0,
                   (Vh - Vb * K / Q + K * K) / a0])
    a1 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])

    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + K / Q + K * K
    a2 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    b2 = np.array([1.0, -2.0, 1.0])
    return b1, a1, b2, a2


def k_weight(wavs: np.ndarray, sr: int) -> np.ndarray:
    """Apply the K-weighting cascade per channel. wavs: (n_ch, n) -> f64."""
    b1, a1, b2, a2 = k_weighting_coeffs(sr)
    x = np.asarray(wavs, np.float64)
    y = lfilter(b1, a1, x, axis=-1)
    return lfilter(b2, a2, y, axis=-1)


def _block_energies(filtered: np.ndarray, sr: int) -> np.ndarray:
    """Per-gating-block energy z_j = sum_ch w_ch * mean(sq) over 400 ms
    windows stepped by 100 ms. Returns shape (n_blocks,) (possibly empty)."""
    n_ch, n = filtered.shape
    s100 = (sr + 5) // 10  # samples per 100 ms (libebur128 rounding)
    win = 4 * s100
    if n < win or s100 == 0:
        return np.zeros(0)
    n_blocks = (n - win) // s100 + 1
    sq = filtered**2
    csum = np.concatenate([np.zeros((n_ch, 1)), np.cumsum(sq, axis=-1)], axis=-1)
    starts = np.arange(n_blocks) * s100
    block_sums = csum[:, starts + win] - csum[:, starts]  # (n_ch, n_blocks)
    weights = np.array([_SURROUND_WEIGHT if ch >= 3 else 1.0 for ch in range(n_ch)])
    return (weights[:, None] * block_sums / win).sum(axis=0)


def _loudness(energy):
    with np.errstate(divide="ignore"):
        return -0.691 + 10.0 * np.log10(energy)


# libebur128 histogram tables (ebur128.c init_histogram, reproduced by the
# reference's ebur128 crate).  1000 bins of 0.1 LU spanning [-70, +30) LUFS:
# boundary i sits at loudness -70 + i/10, the bin's representative energy at
# its center loudness -69.95 + i/10.  Blocks below boundary 0 are never
# stored (this IS the absolute gate); energies above the last boundary clamp
# into bin 999.
HIST_BOUNDARIES = 10.0 ** ((np.arange(1001) / 10.0 - 70.0 + 0.691) / 10.0)
HIST_ENERGIES = 10.0 ** ((np.arange(1000) / 10.0 - 69.95 + 0.691) / 10.0)
_RELATIVE_GATE_FACTOR = 10.0 ** (-10.0 / 10.0)


def quantize_blocks_to_histogram(z: np.ndarray) -> np.ndarray:
    """Map exact block energies to their libebur128 histogram-bin center
    energies, dropping blocks below the absolute gate.  Bin lookup matches
    ebur128's find_histogram_index: boundary[i] <= energy < boundary[i+1],
    clamped to bin 999 above the table."""
    z = z[z >= HIST_BOUNDARIES[0]]
    if z.size == 0:
        return z
    idx = np.clip(np.searchsorted(HIST_BOUNDARIES, z, side="right") - 1, 0, 999)
    return HIST_ENERGIES[idx]


def gated_lufs_from_blocks(z: np.ndarray, *, histogram: bool = True) -> float:
    """BS.1770 gating over 400 ms block energies: -70 LUFS absolute gate,
    then -10 LU relative gate, energy-averaged.

    Default (histogram=True) reproduces the reference EXACTLY: its ebur128
    crate is built with Mode::all() (reference: stats.rs:48), which enables
    the library's HISTOGRAM mode — each block energy is binned into a
    0.1-LU histogram and represented by its bin-center energy before the
    relative gate and the final energy average (ebur128's gated_loudness:
    relative_threshold from bin centers, then strict `center > threshold`).
    histogram=False gates over exact block energies (kept as
    cross-validation; differs from histogram mode by <= ~0.05 LU).  The
    three in-repo paths (scipy host, native C, device f64 scans) agree with
    each other to <=1e-9 in both modes (tests/test_dynamics_device.py) —
    with one caveat: a block energy within ~1 ulp of a bin BOUNDARY can
    quantize to different bins across paths (their reductions round
    differently), shifting the result by up to 0.1/N_gated LU; measure-zero
    for real audio but worth knowing if the cross-path test ever flakes.
    The relative gate keeps BS.1770's strict `>` comparison (in energy
    space over bin centers); whether libebur128 includes a bin whose center
    EXACTLY equals the threshold is reachable only at sub-ulp float
    coincidences."""
    if z.size == 0:
        return -np.inf
    if histogram:
        q = quantize_blocks_to_histogram(z)
        if q.size == 0:
            return -np.inf
        rel_threshold = q.mean() * _RELATIVE_GATE_FACTOR
        gated = q[q > rel_threshold]
        if gated.size == 0:
            return -np.inf
        return float(_loudness(gated.mean()))
    l_j = _loudness(z)
    above_abs = z[l_j > -70.0]
    if above_abs.size == 0:
        return -np.inf
    rel_threshold = _loudness(above_abs.mean()) - 10.0
    gated = z[(l_j > -70.0) & (l_j > rel_threshold)]
    if gated.size == 0:
        return -np.inf
    return float(_loudness(gated.mean()))


def integrated_lufs(wavs: np.ndarray, sr: int, *, histogram: bool = True) -> float:
    """Integrated (gated) loudness in LUFS; -inf if no gating blocks pass."""
    wavs = np.atleast_2d(np.asarray(wavs))
    z = _block_energies(k_weight(wavs, sr), sr)
    return gated_lufs_from_blocks(z, histogram=histogram)
