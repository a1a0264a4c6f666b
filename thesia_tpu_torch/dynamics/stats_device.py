"""Batched dynamics on the device in float64: the limiter gain chain (K8) and
LUFS with the basic stats (K9).

Port of ``thesia_tpu/dynamics/stats_device.py`` (``_limiter_gain_kernel``,
``_lufs_kernel`` and their callers).  On a card both run as hand-written
CUDA kernels (``kernels/dynamics.py``, ``csrc/dynamics.cu``: chunked O(n)
passes with carries, a constant number of launches); the torch programs
here, ``limiter_gain_program`` and ``lufs_program``, are their plain
versions, which the wrappers run for CPU tensors and the tests and
``chip_smoke.py`` hold the kernels against.  The algorithms are the JAX
package's:

  * K8, limiter gain (reference: src-tauri/src/core/dynamics/limiter.rs:45-172):
    NaN-ignoring cross-channel |max| -> raw gain threshold / (v + eps) ->
    van Herk/Gil-Werman sliding min (two ``torch.cummin`` passes over blocks)
    -> exponential release y' = min(c, a*y + b) as a Hillis-Steele doubling
    scan over (A, B, C) min-affine triples -> box-stack moving averages by
    cumsum -> min(., 1).  Every stage is causal, so a row zero-padded to at
    least n + attack + 1 reproduces the reference's appended-zeros latency
    handling; the caller reads [attack : attack + n].
  * K9, LUFS (reference: src-tauri/src/core/dynamics/stats.rs:44-86): the two
    K-weighting biquads as constant-matrix doubling scans (log2 n shifted
    combines with A^(2^k)), 400 ms / 100 ms gating-block sums by a cumsum
    over 100 ms segment sums (the decomposition the native route uses),
    ebur128's 0.1-LU histogram gating through ``torch.searchsorted`` on
    HIST_BOUNDARIES, and the sum of squares and peak.

Torch has no associative scan, so the plain versions write the doublings
out as shifted slices, one row at a time so that every slice is contiguous:
O(n log n) work in hundreds of launches, with temporaries of a few (rows, n)
float64 tensors (for a 5-minute 48 kHz stereo track about 115 MB each).

No buckets: rows are padded only to the longest member of their group.
Samples reach the device through the pinned upload of ``dsp/upload.py``, or
from the samples the spectrogram holds on the device for the same track
(``sources``: the cached device wav, times the track's f32 gain where the
guard left the gained samples as they were), so the stats and the limiter
upload nothing that the spectrogram does not read.

K10 (``kernels.dynamics.guard_peak`` / ``guard_apply``, plain versions
``guard_peak_program`` / ``guard_apply_program``) applies a track's normalize
gain and its guard to the original's device samples: ``GainPeaks`` (the first
pass and its peaks), ``guard_routes`` (tracks gained by K10 or by numpy).
Nothing here falls back to the host: a device failure raises, and the host
route is taken only where ``device_dynamics_preferred`` says so (and per key
for tracks shorter than one gating block).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import numpy as np
import torch

from ..dsp.decibel import db_from_amp_scalar, db_from_power_scalar
from ..dsp.upload import upload
from ..kernels import dynamics as kernels
from .. import obs
from ..obs import span
from ..runtime import count_launch, is_warming, resolve_device
from .envelope import optimal_ratios, stack_layer_lengths
from .loudness import _RELATIVE_GATE_FACTOR, _SURROUND_WEIGHT, k_weighting_coeffs
from .stats import AudioStats, calc_stats

_F64_EPS = float(np.finfo(np.float64).eps)

def device_dynamics_ok(device="cuda") -> bool:
    """True when ``device`` executes the float64 programs.  The JAX package
    probes its default backend (TPU backends without f64 emulation say no);
    torch runs float64 natively on the card and the CPU, so this probe runs
    one small float64 cumsum there and checks it, and a device that cannot
    be reached raises rather than answering no."""
    dev = resolve_device(device)
    got = torch.cumsum(torch.tensor([1.0, 2.0], dtype=torch.float64, device=dev), 0)
    return got.dtype == torch.float64 and float(got[-1]) == 3.0


def device_dynamics_preferred() -> bool:
    """Policy gate for the batched device programs.

    THESIA_DEVICE_DYNAMICS=1/0 forces the device programs on or off, as in
    the JAX package.  Unset, they run on the list's device, the CPU (as the
    JAX package does on its CPU backend, so the CPU tests exercise them) and
    a CUDA card alike: on an H100 the kernels beat the native streaming
    route, K9 by about 28x and K8 by about 41x in wall time at the main
    path's width (PERF.md §6, "K4, K8, K9"; tools/profile_dynamics.py).  Both
    devices run f64 natively, so there is no capability probe."""
    env = os.environ.get("THESIA_DEVICE_DYNAMICS")
    return env is None or env.lower() not in ("0", "false", "")


def holds_gating_block(n: int, sr: int) -> bool:
    """Whether n samples at ``sr`` hold one 400 ms gating block, K9's
    shortest track (libebur128's 100 ms rounding); shorter tracks, and rates
    under 5 Hz, keep the host's stats, and the host's guard with them."""
    s100 = (sr + 5) // 10
    return s100 > 0 and n >= 4 * s100


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array of its own: through pinned memory
    from a card (a pageable copy runs at a tenth of the rate), a copy on the
    CPU (not a view that would keep a whole batch alive)."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.numpy()
    return t.clone().numpy()


def _rows_on_device(members, n_ch: int, length: int, device, sources=None) -> torch.Tensor:
    """(B, n_ch, length) f32 on ``device``: each member's (C, n) samples,
    zero-padded in channels and time on the device.  A member whose key is in
    ``sources``, as (samples on ``device``, gain), is made on the device as
    float32(gain) times those samples, one f32 multiply (the host's
    ``np.float32(gain) * wavs``, bit for bit); the others are uploaded once
    each.  A lone member that fills the group is handed on as it is (read
    only), or as its product, without a zero-filled copy.  The stack of a
    group of more than one member is made under the span
    ``stats.rows_stack``."""
    global scaled_rows, warm_scaled_rows
    warming = is_warming()
    counts = warm_rows_from if warming else rows_from
    whole = len(members) == 1 and members[0][1].shape == (n_ch, length)
    with span("stats.rows_stack") if len(members) > 1 else contextlib.nullcontext():
        buf = None if whole else torch.zeros((len(members), n_ch, length),
                                             dtype=torch.float32, device=device)
        for i, (key, w) in enumerate(members):
            src, gain = (sources or {}).get(key, (None, 1.0))
            if src is None:
                src = upload(w, device).tensor_for()
                counts["upload"] += 1
            else:
                counts["device_wav"] += 1
            g = np.float32(gain)
            if g != 1.0 and warming:
                warm_scaled_rows += 1
            elif g != 1.0:
                scaled_rows += 1
            if whole:
                rows = src if g == 1.0 else torch.mul(src, float(g))
                return rows.reshape(1, n_ch, length).contiguous()
            dst = buf[i, : w.shape[0], : w.shape[1]]
            if g == 1.0:
                dst.copy_(src)
            else:
                torch.mul(src, float(g), out=dst)
    return buf


# ---------------------------------------------------------------------------
# K8: limiter gain chain


def _sliding_min(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[t] = min(x[t-window+1 .. t]) with +inf pre-history; (B, n) f64.

    van Herk/Gil-Werman: two cummins over (n_blocks, window) blocks."""
    if window <= 1:
        return x
    b, n = x.shape
    pad_front = window - 1
    n_tot = pad_front + n
    n_blocks = -(-n_tot // window)
    pad_back = n_blocks * window - n_tot
    inf = torch.full((b, 1), torch.inf, dtype=x.dtype, device=x.device)
    xp = torch.cat([inf.expand(b, pad_front), x, inf.expand(b, pad_back)], dim=1)
    xp = xp.reshape(b, n_blocks, window)
    fwd = torch.cummin(xp, dim=2).values.reshape(b, -1)
    bwd = torch.cummin(xp.flip(2), dim=2).values.flip(2).reshape(b, -1)
    # the window ending at padded index j = pad_front + t starts at i = t
    return torch.minimum(bwd[:, :n], fwd[:, pad_front : pad_front + n])


def _release_scan(x: torch.Tensor, slew: float) -> torch.Tensor:
    """y_t = min(x_t, y_{t-1} + (x_t - y_{t-1})*slew), y_{-1} = 1; (B, n).

    Step t is f_t(y) = min(c_t, a*y + b_t); composition closes over (A, B, C)
    triples, (A2,B2,C2) o (A1,B1,C1) = (A2*A1, A2*B1 + B2, min(C2, A2*C1 + B2)),
    composed by Hillis-Steele doubling (limiter.py exponential_release_scan).
    Each step computes the new suffixes from the old values, then writes
    them in place (the right-hand sides are whole temporaries, so no write
    overlaps a read)."""
    n = x.shape[1]
    A = torch.full_like(x, 1.0 - slew)
    B = slew * x
    C = x.clone()
    for a, b, c in zip(A, B, C):  # rows: contiguous slices
        shift = 1
        while shift < n:
            a1, b1, c1 = a[:-shift], b[:-shift], c[:-shift]
            a2, b2, c2 = a[shift:], b[shift:], c[shift:]
            new_c = torch.minimum(c2, torch.addcmul(b2, a2, c1))
            new_b = torch.addcmul(b2, a2, b1)
            new_a = a2 * a1
            c2.copy_(new_c)
            b2.copy_(new_b)
            a2.copy_(new_a)
            del new_a, new_b, new_c
            shift *= 2
    return torch.minimum(C, A * 1.0 + B)


def _box_filter(x: torch.Tensor, length: int, fill: float) -> torch.Tensor:
    """Moving average of the trailing ``length`` samples, pre-history = fill."""
    if length <= 1:
        return x
    b, n = x.shape
    pre = torch.full((b, length - 1), fill, dtype=x.dtype, device=x.device)
    c = torch.cumsum(torch.cat([pre, x], dim=1), dim=1)
    first = c[:, length - 1 : length]
    rest = c[:, length:] - c[:, : n - 1]
    return torch.cat([first, rest], dim=1) / length


def limiter_gain_program(wavs: torch.Tensor, threshold: float, slew: float, *,
                         hold_length: int, box_lengths) -> torch.Tensor:
    """K8: wavs (B, C, L) f32, zero-padded -> gain (B, L) f64, not yet
    latency-shifted (the caller reads [attack : attack + n])."""
    a = wavs.abs()
    # ignore NaNs in the cross-channel max like the reference's f32::max fold
    # and the native comparison loop: a NaN channel must not disable limiting
    # of the finite channels.  |x| and max are exact in f32, so widening the
    # max equals the max of the widened samples.
    v = torch.where(torch.isnan(a), -torch.inf, a).amax(dim=1).to(torch.float64)
    one = torch.ones((), dtype=torch.float64, device=v.device)
    raw = torch.where(v > threshold, threshold / (v + _F64_EPS), one)
    sm = _release_scan(_sliding_min(raw, max(hold_length, 1)), slew)
    for length in box_lengths:
        sm = _box_filter(sm, length, 1.0)
    return torch.minimum(sm, one)


def limiter_params(sr: int, attack_ms: float = 5.0, hold_ms: float = 15.0,
                   release_ms: float = 40.0) -> dict:
    """K8's parameters at ``sr``, as the JAX package derives them: ``attack``
    (the latency the caller reads past), ``hold_length``, ``slew`` and the
    box stack's ``box_lengths``."""
    ms = lambda x: x * sr / 1000.0  # noqa: E731
    attack = int(np.floor(ms(attack_ms) + 0.5))
    return {
        "attack": attack,
        "hold_length": int(np.floor(ms(attack_ms + hold_ms) + 0.5)),
        "slew": 1.0 / (ms(release_ms) + 1.0),
        "box_lengths": (tuple(max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3)))
                        if attack > 0 else ()),
    }


def limiter_gain_seqs_batched(
    items,
    device,
    threshold: float = 1.0,
    attack_ms: float = 5.0,
    hold_ms: float = 15.0,
    release_ms: float = 40.0,
    sources=None,
    land: bool = True,
) -> dict:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: gain (n,) f64} on the
    host, one K8 program per sample rate on ``device`` (the kernel on a card,
    ``limiter_gain_program`` on the CPU).  sources: as lufs_stats_batched's,
    the rows then made on the device; with ``land`` False each gain stays
    there, a view of its program's output."""
    groups: dict[int, list] = {}
    for key, wavs, sr in items:
        groups.setdefault(sr, []).append((key, np.atleast_2d(np.asarray(wavs, np.float32))))
    out: dict = {}
    for sr, members in groups.items():
        p = limiter_params(sr, attack_ms, hold_ms, release_ms)
        attack = p["attack"]
        length = max(w.shape[1] for _k, w in members) + attack + 1
        c_max = max(w.shape[0] for _k, w in members)
        rows = _rows_on_device(members, c_max, length, device, sources)
        gain = kernels.limiter_gain(rows, float(threshold), p["slew"],
                                    hold_length=p["hold_length"], box_lengths=p["box_lengths"])
        count_launch(limiter_gain_seqs_batched)
        for i, (key, w) in enumerate(members):
            # only the latency-shifted n samples come back, each its own array
            seq = gain[i, attack : attack + w.shape[1]]
            out[key] = to_host(seq) if land else seq
    return out


# ---------------------------------------------------------------------------
# K10: the gain and the guard on a track's device samples


def guard_peak_program(x: torch.Tensor, gain: float, keep: bool):
    """K10's first pass (``kernels.dynamics.guard_peak``): x (C, n) f32 ->
    (float32(gain) * x where ``keep`` asks for it, else None; (2, C) int32:
    each channel's abs max, NaN skipped, from 0, as float bits, and 1 where
    the channel holds a NaN)."""
    gained = torch.mul(x, float(np.float32(gain)))  # one f32 multiply, as numpy's
    a = gained.abs()
    nan = torch.isnan(a)
    peak = torch.where(nan, 0.0, a).amax(dim=1)
    bits = torch.stack([peak.view(torch.int32), nan.any(dim=1).to(torch.int32)])
    return (gained if keep else None), bits


def guard_apply_program(x: torch.Tensor, gain: float, mode: int, scale: float = 1.0,
                        gain_seq: torch.Tensor | None = None):
    """K10's second pass (``kernels.dynamics.guard_apply``): (y, stats, seq32)
    from x (C, n) f32, ``guard.guard_clipping``'s arithmetic on float32(gain)
    * x: np.clip's NaN passes through torch.clamp too, and the f64 product is
    rounded to f32 once."""
    gained = torch.mul(x, float(np.float32(gain)))
    stats = seq32 = None
    if mode == kernels.GUARD_GAIN:
        return gained, stats, seq32
    if mode == kernels.GUARD_CLIP:
        return torch.clamp(gained, -1.0, 1.0), (gained.abs() > 1.0).sum(dim=1), seq32
    s = scale if mode == kernels.GUARD_SCALE else gain_seq[None, :]
    y = torch.clamp(gained.to(torch.float64) * s, -1.0, 1.0).to(torch.float32)
    if mode == kernels.GUARD_SEQ:
        seq32 = gain_seq.to(torch.float32)
        stats = torch.stack([(seq32 != 1.0).sum(), 0xFFFFFFFF - kernels.ordered_key(seq32).amin()])
    return y, stats, seq32


class GainPeaks:
    """K10's first pass over a track's device samples ``x``, read on the host:
    ``gained`` (the f32 product on the device, or None), the channels'
    ``peaks`` (NaN skipped, from 0) and whether a channel holds a NaN
    (``has_nan``)."""

    def __init__(self, x: torch.Tensor, gain: float, keep: bool):
        self.x = x
        self.gained, bits = kernels.guard_peak(x, gain, keep)
        bits = bits.cpu()  # waits for the pass
        self.peaks = bits[0].view(torch.float32).tolist()
        self.has_nan = bool(bits[1].any())

    @property
    def peak(self) -> float:
        """The track's peak, ``stats.nan_safe_abs_max`` of the gained samples."""
        return max(self.peaks)


def count_guard_route(route: str) -> None:
    """One track gained and guarded by ``route`` ("device": K10; "host":
    numpy's ``guard.guard_clipping``), in the warm twin under warming()."""
    counts = warm_guard_routes if is_warming() else guard_routes
    counts[route] += 1


# ---------------------------------------------------------------------------
# K9: LUFS and basic stats


def _biquad_scan(x: torch.Tensor, A: np.ndarray, c: np.ndarray, b0: float) -> torch.Tensor:
    """DF2T biquad through a constant-matrix doubling scan; x (B, n) f64.

    State recurrence s_t = A s_{t-1} + c*x_t, output y_t = b0*x_t + s_{t-1}[0];
    after k doublings s holds the sum over the last 2^k inputs, and the next
    adds A^(2^k) times the state ``shift`` samples back (both components'
    increments are computed from the old state before either is added in
    place)."""
    n = x.shape[1]
    s0, s1 = x * float(c[0]), x * float(c[1])
    for r0, r1 in zip(s0, s1):  # rows: contiguous slices
        Ak = np.asarray(A, np.float64)
        shift = 1
        while shift < n:
            p0, p1 = r0[:-shift], r1[:-shift]
            u0 = torch.add(p0 * float(Ak[0, 0]), p1, alpha=float(Ak[0, 1]))
            u1 = torch.add(p0 * float(Ak[1, 0]), p1, alpha=float(Ak[1, 1]))
            r0[shift:] += u0
            r1[shift:] += u1
            del u0, u1
            Ak = Ak @ Ak
            shift *= 2
    z1_prev = torch.cat([torch.zeros_like(x[:, :1]), s0[:, :-1]], dim=1)
    return b0 * x + z1_prev


def _affine_from_biquad(b, a):
    """(A, c, b0) of s_t = A s_{t-1} + c x_t for a normalized biquad."""
    b0, b1, b2 = b
    a1, a2 = a[1], a[2]
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    c = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float64)
    return A, c, float(b0)


def lufs_program(wavs: torch.Tensor, ns: torch.Tensor, sr: int):
    """K9: wavs (B, C, L) f32 zero-padded past each row's valid length ns (B,)
    -> per item (lufs, sum_sq, peak), each (B,) f64.

    Gating: 400 ms blocks stepped by 100 ms, binned into ebur128's 0.1-LU
    histogram (bin-centre energies); the -70 LUFS absolute gate is the
    histogram floor, then a -10 LU relative gate over bin centres,
    energy-averaged (loudness.py histogram mode)."""
    s100 = (sr + 5) // 10
    win = 4 * s100
    x = wavs.to(torch.float64)
    b, c, length = x.shape
    n_blocks_max = max((length - win) // s100 + 1, 1)
    b1, a1, b2, a2 = k_weighting_coeffs(sr)
    y = _biquad_scan(x.reshape(b * c, length), *_affine_from_biquad(b1, a1))
    y = _biquad_scan(y, *_affine_from_biquad(b2, a2))
    # block j covers the 100 ms segments j .. j+3
    n_seg = length // s100
    sq = (y * y).reshape(b, c, length)[:, :, : n_seg * s100]
    seg = sq.reshape(b, c, n_seg, s100).sum(dim=3)
    csum = torch.cat([torch.zeros_like(seg[:, :, :1]), torch.cumsum(seg, dim=2)], dim=2)
    hi = csum[:, :, 4 : 4 + n_blocks_max]
    lo = csum[:, :, :n_blocks_max]
    weights = torch.tensor([_SURROUND_WEIGHT if ch >= 3 else 1.0 for ch in range(c)],
                           dtype=torch.float64, device=x.device)
    z = torch.einsum("c,bct->bt", weights, hi - lo) / win
    n_blocks = torch.clamp((ns - win) // s100 + 1, min=0)
    valid = torch.arange(n_blocks_max, device=x.device)[None, :] < n_blocks[:, None]
    boundaries, energies = kernels.hist_tables(x.device)
    idx = torch.clamp(torch.searchsorted(boundaries, z, right=True) - 1, 0, 999)
    zq = energies[idx]  # bin-centre energies
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    m_abs = valid & (z >= boundaries[0])
    cnt_abs = m_abs.sum(dim=1)
    mean_abs = torch.where(m_abs, zq, zero).sum(dim=1) / torch.clamp(cnt_abs, min=1)
    m_rel = m_abs & (zq > (mean_abs * _RELATIVE_GATE_FACTOR)[:, None])
    cnt_rel = m_rel.sum(dim=1)
    mean_rel = torch.where(m_rel, zq, zero).sum(dim=1) / torch.clamp(cnt_rel, min=1)
    lufs = torch.where(
        cnt_rel > 0, -0.691 + 10.0 * torch.log10(torch.clamp(mean_rel, min=1e-300)),
        torch.full_like(mean_rel, -torch.inf),
    )
    # basic stats on the raw samples (stats.rs:56-86 semantics); the zero
    # padding past ns adds nothing to either
    sum_sq = (x * x).sum(dim=(1, 2))
    peak = wavs.abs().amax(dim=(1, 2)).to(torch.float64)
    return lufs, sum_sq, peak


def lufs_stats_batched(items, device, sources=None) -> dict:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: (lufs, sum_sq, peak)}, one
    K9 program per (sr, n_ch) group on ``device`` (the kernel on a card,
    ``lufs_program`` on the CPU).  Keys of tracks shorter
    than one gating block (or of a sample rate under 5 Hz) stay absent:
    the caller computes them on the host.  sources: optional {key: (samples,
    gain)}, a (C, n) f32 tensor on ``device`` whose float32(gain) multiple is
    the item's wavs (``_rows_on_device``)."""
    groups: dict[tuple, list] = {}
    for key, wavs, sr in items:
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        if not holds_gating_block(wavs.shape[1], sr):
            continue
        groups.setdefault((sr, wavs.shape[0]), []).append((key, wavs))
    out: dict = {}
    for (sr, n_ch), members in groups.items():
        length = max(w.shape[1] for _k, w in members)
        rows = _rows_on_device(members, n_ch, length, device, sources)
        ns = torch.tensor([w.shape[1] for _k, w in members], dtype=torch.int64, device=device)
        lufs, sum_sq, peak = kernels.lufs_stats(rows, ns, sr)
        count_launch(lufs_stats_batched)
        _count_group(len(members))
        lufs, sum_sq, peak = (t.cpu().numpy() for t in (lufs, sum_sq, peak))
        for i, (key, _w) in enumerate(members):
            out[key] = (float(lufs[i]), float(sum_sq[i]), float(peak[i]))
    return out


def calc_stats_batched(items, device, sources=None) -> dict:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: AudioStats}, field for
    field as ``stats.calc_stats`` (its f32 roundings included,
    stats.rs:56-86).  Tracks too short for a gating block take the host
    path, each on its own.  sources: as lufs_stats_batched."""
    raw = lufs_stats_batched(items, device, sources)
    out = {}
    for key, wavs, sr in items:
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        if key not in raw:
            out[key] = calc_stats(wavs, sr)
            continue
        lufs, sum_sq, peak = raw[key]
        mean_squared = float(np.float32(sum_sq / wavs.size))
        out[key] = AudioStats(
            global_lufs=lufs,
            rms_db=float(np.float32(db_from_power_scalar(mean_squared))),
            max_peak=float(np.float32(peak)),
            max_peak_db=float(np.float32(db_from_amp_scalar(float(np.float32(peak))))),
        )
    return out


def integrated_lufs_device(wavs: np.ndarray, sr: int, device) -> float:
    """Single-track device LUFS (parity and measurement helper); -inf, the
    host convention, for a track shorter than one gating block."""
    res = lufs_stats_batched([(0, wavs, sr)], device)
    return res[0][0] if 0 in res else float("-inf")


# program launches, where the batches' rows came from, and how many of the
# device_wav rows were float32(gain) times a device wav (``scaled_rows``),
# since the last reset (plain integers); those made under runtime.warming()
# apart.  ``group_tracks``: {tracks in a K9 group: its launches}, the tracks
# each K9 launch took; while the span log is on (``obs.tracing``) each launch
# also leaves (time.time_ns(), tracks, made under warming()) in
# ``group_log``, which the benchmark reads by its turns' times
rows_from = {"device_wav": 0, "upload": 0}
warm_rows_from = {"device_wav": 0, "upload": 0}
# tracks a normalize or guard switch gained by each route (count_guard_route)
guard_routes = {"device": 0, "host": 0}
warm_guard_routes = {"device": 0, "host": 0}
scaled_rows = warm_scaled_rows = 0
group_tracks: dict[int, int] = {}
warm_group_tracks: dict[int, int] = {}
group_log: deque = deque(maxlen=4096)


def _count_group(tracks: int) -> None:
    warming = is_warming()
    counts = warm_group_tracks if warming else group_tracks
    counts[tracks] = counts.get(tracks, 0) + 1
    if obs.is_tracing():
        group_log.append((time.time_ns(), tracks, warming))


def reset_launches() -> None:
    global scaled_rows, warm_scaled_rows
    for fn in (limiter_gain_seqs_batched, lufs_stats_batched):
        fn.launches = fn.warm_launches = 0
    for counts in (rows_from, warm_rows_from):
        counts["device_wav"] = counts["upload"] = 0
    for counts in (guard_routes, warm_guard_routes):
        counts["device"] = counts["host"] = 0
    scaled_rows = warm_scaled_rows = 0
    group_tracks.clear()
    warm_group_tracks.clear()
    group_log.clear()


reset_launches()
