"""K9 (K-weighted LUFS with the sum of squares and the peak), K8 (the
limiter's gain sequence) and K10 (the normalize gain and the guard on a
track's samples) as hand-written CUDA kernels: their wrappers, the host
tables they read and the work they must do.

``lufs_stats`` and ``limiter_gain`` launch ``csrc/dynamics.cu`` for CUDA
tensors and run the plain versions for CPU tensors: the float64 torch
programs ``lufs_program`` and ``limiter_gain_program`` of
``dynamics/stats_device.py``, which take the same arguments and return the
same values.  Any other device, or a launch that fails, raises; nothing falls
back.  The kernels replace the JAX package's device programs
``_lufs_kernel`` (``thesia_tpu/dynamics/stats_device.py:264``) and
``_limiter_gain_kernel`` (``:161``); the source's header states their design.
``guard_peak`` and ``guard_apply``, K10's two passes, replace no device
program: the JAX package applies the gain and the guard in numpy
(``thesia_tpu/dynamics/guard.py:64-109``); their plain versions are
``guard_peak_program`` and ``guard_apply_program``.

The host tables: K9's two K-weighting biquads form the 4-state recurrence
S_t = M S_{t-1} + g x_t (``k9_matrix``).  A K9 block owns ``segments`` whole
100 ms segments (``chunk`` samples) and each of its ``THREADS`` threads one
run of ``run`` samples (``k9_plan``).  The first pass sums each run's samples
with the weights W[k] = M^k g (a run from zero ends in sum_t W[n-1-t] x_t);
the runs' end states are scanned with the powers of P = M^run
(``k9_tables``), the blocks' by the carry, K blocks a thread, with the powers
of M^(chunk K) (``k9_carry_table``); for each P the ladder P^(2^l), the lane
powers P^l and the warp powers P^(32 w), every power of M by exact squarings
in extended precision.  K8's chunk (``k8_plan``) is sized so that its last
pass's shared buffers (the chunk with its hold and box halos: the f32
channel maxima and their suffix maxima, and the f64 release values) stay
near ``K8_SMEM_TARGET``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import obs
from ..dynamics.loudness import (
    _RELATIVE_GATE_FACTOR,
    _SURROUND_WEIGHT,
    HIST_BOUNDARIES,
    HIST_ENERGIES,
    k_weighting_coeffs,
)
from ..runtime import count_launch
from . import build

THREADS = 256  # csrc/dynamics.cu: T, the threads of K9's passes
CARRY_THREADS = 512  # csrc/dynamics.cu: TC, the threads of k9_carry
K8_THREADS = 256  # csrc/dynamics.cu: T8, the threads of k8_spans and k8_gain
WARP = 32
K9_RUN_TARGET = 60  # samples a thread of a K9 pass, about
POW_STEPS = 10  # the ladder P^(2^l), l < POW_STEPS, covers 32 warps of 32 lanes
# doubles of one power table: the ladder, 32 lane powers, 33 warp powers
POW_TABLE = 16 * (POW_STEPS + WARP + WARP + 1)
K9_GATE_TILE = 1024  # 400 ms blocks a k9_gate block, at most
K8_MAX_BOXES = 4
K8_SMEM_TARGET = 110 * 1024
# shared memory a block may use on an H100, less K8's static scan buffers
K8_SMEM_LIMIT = 220 * 1024
# f64 operations a sample (two DF2T biquads of 9, the output's square and
# sum, the raw square and sum, the peak's |.| and max) and a gating block
# per channel (four segment sums and the weighted add; the bin search, the
# gates and the means once a block)
K9_FLOP_PER_SAMPLE = 24
K9_FLOP_PER_BLOCK_CHANNEL = 5
K9_FLOP_PER_BLOCK = 2 * 11 + 6


def _k9_run(chunk: int, threads: int, s100: int) -> int:
    """Samples a thread of a K9 pass: ceil(chunk / threads), odd where that
    stays within a segment (a stride of an odd number of words reads shared
    memory without bank conflicts)."""
    run = -(-chunk // threads)
    return run + 1 if run % 2 == 0 and run < s100 else run


def k9_plan(sr: int, threads: int = THREADS, segments: int | None = None,
            carry_threads: int = CARRY_THREADS) -> dict:
    """K9's schedule at ``sr``: s100 and win (100 ms and 400 ms in samples),
    ``segments`` G whole 100 ms segments a block owns (about K9_RUN_TARGET
    samples a thread, and at most s100: a thread's run touches at most two
    segments), ``chunk`` = G s100 samples, ``run`` samples a thread,
    ``carry_threads`` the block ends the carry scans at once."""
    s100 = (sr + 5) // 10
    if s100 < 1:
        raise ValueError(f"lufs_stats: sample rate {sr} has no 100 ms segment")
    if segments is None:
        segments = max(1, threads * K9_RUN_TARGET // s100)
        while segments > 1 and _k9_run(segments * s100, threads, s100) > s100:
            segments -= 1
    run = _k9_run(segments * s100, threads, s100)
    if run > s100:
        raise ValueError(f"lufs_stats: {segments} segments of {s100} over {threads} threads "
                         f"give runs of {run} samples, longer than a segment")
    return {"s100": s100, "win": 4 * s100, "segments": segments, "chunk": segments * s100,
            "run": run, "threads": threads, "carry_threads": carry_threads}


def k9_gate_tile(n_ch: int) -> int:
    """400 ms blocks a k9_gate block weighs: K9_GATE_TILE, fewer where its
    shared segment sums (n_ch rows of tile + 3) would pass 200 KB."""
    return max(1, min(K9_GATE_TILE, 200 * 1024 // (8 * n_ch) - 3))


def k9_coefficients(sr: int) -> np.ndarray:
    """(10,) f64, csrc/dynamics.cu K9Coef: per biquad (-a1, -a2, b1 - a1 b0,
    b2 - a2 b0, b0), the DF2T state recurrence of stats_device.py
    ``_affine_from_biquad``."""
    out = []
    for b, a in zip(*[iter(k_weighting_coeffs(sr))] * 2):
        out += [-a[1], -a[2], b[1] - a[1] * b[0], b[2] - a[2] * b[0], b[0]]
    return np.asarray(out, np.float64)


def k9_matrix(coef: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(M (4, 4), g (4,)) of the cascade S_t = M S_{t-1} + g x_t, S = (s0, s1,
    u0, u1): the second biquad's input is y = b0 x + s0."""
    na1, na2, c0, c1, b0, nb1, nb2, d0, d1, _e0 = coef
    m = np.array([[na1, 1.0, 0.0, 0.0], [na2, 0.0, 0.0, 0.0],
                  [d0, 0.0, nb1, 1.0], [d1, 0.0, nb2, 0.0]], np.float64)
    return m, np.array([c0, c1, d0 * b0, d1 * b0], np.float64)


class _Powers:
    """Powers of a 4x4 matrix by exact squarings in extended precision
    (np.longdouble), for the caller to round once to f64: one ladder
    m^(2^i) shared by every exponent, so m^e is the ladder's rungs of e's
    set bits multiplied lowest first (the products numpy's matrix_power
    takes).  K9's M is far from normal (two poles near 0.995; entries of its
    powers reach about 50 before they decay), so f64 squarings lose about
    1e-9 of M^1248; the wider products keep the tables near f64 rounding."""

    def __init__(self, m: np.ndarray):
        self.ladder = [m.astype(np.longdouble)]

    def __call__(self, e: int) -> np.ndarray:
        out, rung = np.eye(4, dtype=np.longdouble), 0
        while e:
            while rung >= len(self.ladder):
                self.ladder.append(self.ladder[-1] @ self.ladder[-1])
            if e & 1:
                out = out @ self.ladder[rung]
            e >>= 1
            rung += 1
        return out


def power_table(power: _Powers, base: int) -> np.ndarray:
    """(POW_TABLE,) for P = m^base, m the matrix of ``power``: the ladder
    P^(2^l) (l < POW_STEPS), the lane powers P^l (l < 32) element by element
    (entry e of lane l at 32 e + l, so a warp reads one entry without bank
    conflicts), the warp powers P^(32 w) (w <= 32), each 16 f64 row-major."""
    flat = lambda e: power(e).astype(np.float64).reshape(-1)  # noqa: E731
    lanes = np.stack([flat(base * l) for l in range(WARP)]).T
    return np.concatenate([flat(base << l) for l in range(POW_STEPS)] + [lanes.reshape(-1)]
                          + [flat(base * WARP * w) for w in range(WARP + 1)])


@functools.lru_cache(maxsize=16)
def _k9_powers(sr: int) -> _Powers:
    return _Powers(k9_matrix(k9_coefficients(sr))[0])


@functools.lru_cache(maxsize=32)
def k9_tables(sr: int, threads: int = THREADS, segments: int | None = None):
    """(coefficients (10,), table) of thesia_lufs_stats: the table holds the
    passes' weights W[k] = M^k g (k < run, 4 f64 each), then
    ``power_table`` of M^run (the threads' runs), then M^k for k <= run (a
    short last run's advance to the block's end).  Read-only (cached)."""
    plan = k9_plan(sr, threads, segments)
    coef = k9_coefficients(sr)
    g = k9_matrix(coef)[1]
    power = _k9_powers(sr)
    weights = [(power(k) @ g.astype(np.longdouble)).astype(np.float64) for k in range(plan["run"])]
    table = np.concatenate([np.concatenate(weights), power_table(power, plan["run"])]
                           + [power(k).astype(np.float64).reshape(-1)
                              for k in range(plan["run"] + 1)])
    coef.setflags(write=False)
    table.setflags(write=False)
    return coef, table


def carry_blocks(nb: int, carry_threads: int = CARRY_THREADS) -> int:
    """Block ends a k9_carry thread takes: the least power of two K with K
    carry_threads >= nb, at most 8 (a tile of states in shared memory), so
    that a row of up to 8 carry_threads blocks takes one scan."""
    k = 1
    while k * carry_threads < nb and k < 8:
        k *= 2
    return k


@functools.lru_cache(maxsize=64)
def k9_carry_table(sr: int, k: int, threads: int = THREADS,
                   segments: int | None = None) -> np.ndarray:
    """The carry's table: ``power_table`` of M^(chunk k), then M^chunk (16
    f64).  Read-only (cached)."""
    plan = k9_plan(sr, threads, segments)
    power = _k9_powers(sr)
    table = np.concatenate([power_table(power, plan["chunk"] * k),
                            power(plan["chunk"]).astype(np.float64).reshape(-1)])
    table.setflags(write=False)
    return table


# the sample rates whose K9 tables the device warmup builds ahead of a first add
COMMON_RATES = (8000, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000)


def warm_tables(sr: int) -> None:
    """Build (and cache) K9's host tables at ``sr`` for every carry width,
    so that the first add at that rate does not wait for their
    extended-precision products (a few ms a rate)."""
    k9_tables(sr)
    for k in (1, 2, 4, 8):
        k9_carry_table(sr, k)


_k9_dev: dict = {}


def k9_device_tables(sr: int, k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``k9_tables(sr)``'s table and ``k9_carry_table(sr, k)`` on ``device``,
    one copy (both 16-byte aligned: the first holds an even number of
    doubles), complete before any stream reads them (cached)."""
    key = (sr, k, device)
    if key not in _k9_dev:
        head = k9_tables(sr)[1]
        both = torch.from_numpy(np.concatenate([head, k9_carry_table(sr, k)])).to(device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        _k9_dev.setdefault(key, (both[:head.size], both[head.size:]))
    return _k9_dev[key]


def k8_plan(hold_length: int, box_lengths, chunk: int | None = None,
            threads: int = K8_THREADS) -> dict:
    """K8's schedule: ``hold`` (>= 1), the ``boxes`` longer than 1 and
    ``hbox`` = sum(box - 1) (the box stack's delay), ``chunk`` output
    positions a block (a multiple of ``threads``, at least 1024, sized so
    that k8_gain's shared memory stays near K8_SMEM_TARGET), ``buf`` the
    positions a block loads (the chunk, the box halo hbox and the hold halo
    hold - 1; a first-pass span, chunk long, the last up to chunk + hbox,
    fits too), ``m`` = chunk + hbox the release values of a k8_gain block,
    ``smem_bytes`` k8_gain's (about 8 buf for the f32 levels and suffix
    maxima, 8 m for the f64 release values, where a second channel is
    staged), ``spans_smem_bytes`` k8_spans' (about 12 buf: levels, suffix
    maxima, and the two channels staged)."""
    hold = max(int(hold_length), 1)
    boxes = tuple(int(l) for l in box_lengths if l > 1)
    if len(boxes) > K8_MAX_BOXES:
        raise ValueError(f"limiter_gain: at most {K8_MAX_BOXES} box filters, got {boxes}")
    hbox = sum(l - 1 for l in boxes)
    if chunk is None:
        halo = 8 * (hbox + hold + 2) + 16 + 8 * hbox
        chunk = max(1024, (K8_SMEM_TARGET - halo) // 16 // threads * threads)
    buf = chunk + hbox + hold - 1
    bufp = -(-buf // 4) * 4
    m = chunk + hbox
    return {"hold": hold, "boxes": boxes, "hbox": hbox, "chunk": chunk, "threads": threads,
            "buf": buf, "m": m, "smem_bytes": 8 * bufp + 16 + 8 * m,
            "spans_smem_bytes": 12 * bufp + 32}


def lufs_work(ns, n_ch: int, sr: int) -> dict:
    """What one K9 launch over items of ``ns`` valid samples a channel must
    move and compute, for its bound: ``bytes`` (each sample read once, the
    histogram tables, three f64 outputs an item) and ``flop`` (f64, an
    algorithm count: K9_FLOP_PER_SAMPLE a sample, the gating per 400 ms
    block)."""
    s100 = (sr + 5) // 10
    ns = [int(n) for n in ns]
    blocks = sum(max((n - 4 * s100) // s100 + 1, 0) for n in ns)
    samples = n_ch * sum(ns)
    return {
        "bytes": 4 * samples + 8 * (HIST_BOUNDARIES.size + HIST_ENERGIES.size) + 24 * len(ns),
        "flop": K9_FLOP_PER_SAMPLE * samples
        + blocks * (K9_FLOP_PER_BLOCK_CHANNEL * n_ch + K9_FLOP_PER_BLOCK),
    }


def limiter_work(n_items: int, n_ch: int, length: int, n_boxes: int = 3) -> dict:
    """What one K8 launch over (n_items, n_ch, length) must move and compute:
    ``bytes`` (each f32 sample read once, each f64 gain written once) and
    ``flop`` (f64, a position: the channel max 2 C, the gain's test, sum and
    quotient 3, a sliding max 3 (van Herk), the release step 3, each box's
    moving sum and scale 3, the final min 1)."""
    per = 2 * n_ch + 3 + 3 + 3 + 3 * n_boxes + 1
    return {"bytes": 4 * n_items * n_ch * length + 8 * n_items * length,
            "flop": per * n_items * length}


_hist: dict = {}


def hist_tables(device: torch.device):
    """HIST_BOUNDARIES / HIST_ENERGIES as f64 tensors on ``device`` (the
    kernel's and the plain version's), complete before any stream reads
    them."""
    if device not in _hist:
        tables = (torch.from_numpy(HIST_BOUNDARIES).to(device),
                  torch.from_numpy(HIST_ENERGIES).to(device))
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        _hist.setdefault(device, tables)
    return _hist[device]


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t.numel() else None)


def _check_rows(name: str, wavs: torch.Tensor) -> None:
    if wavs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {wavs.device}")
    if wavs.dtype != torch.float32 or wavs.dim() != 3 or not wavs.is_contiguous():
        raise ValueError(f"{name}: wavs must be a contiguous (B, C, L) float32 tensor, got "
                         f"{wavs.dtype} {tuple(wavs.shape)}")
    b, c, length = wavs.shape
    if not (1 <= b <= 65535 and 1 <= b * c <= 65535 and length < 1 << 31):
        raise ValueError(f"{name}: {tuple(wavs.shape)} out of the kernel's range")


def lufs_stats(wavs: torch.Tensor, ns: torch.Tensor, sr: int):
    """K9: wavs (B, C, L) f32, zero-padded past each item's valid length ns (B,)
    int64 -> (lufs, sum_sq, peak), each (B,) f64, as ``lufs_program``.  On a
    card, five launches on the current stream (no sync); two calls on the
    same samples give the same bits."""
    _check_rows("lufs_stats", wavs)
    if wavs.device.type == "cpu":
        from ..dynamics import stats_device

        return stats_device.lufs_program(wavs, ns, sr)
    b, c, length = wavs.shape
    if ns.device != wavs.device or ns.dtype != torch.int64 or ns.shape != (b,) \
            or not ns.is_contiguous():
        raise ValueError(f"lufs_stats: ns must be ({b},) int64 on {wavs.device}")
    plan = k9_plan(sr)
    coef, table_host = k9_tables(sr)
    # the coefficients, then M^k, k <= run (the full blocks' last run advance)
    host = np.concatenate([coef, table_host[4 * plan["run"] + POW_TABLE:]])
    nb_max = -(-length // plan["chunk"])
    n_seg_max = length // plan["s100"]
    n_gb_max = (length - plan["win"]) // plan["s100"] + 1 if length >= plan["win"] else 0
    tile = k9_gate_tile(c)
    carry_k = carry_blocks(nb_max)
    rows = b * c
    dev = wavs.device
    lib = build.library()
    with torch.cuda.device(dev):
        table, carry_table = k9_device_tables(sr, carry_k, dev)
        f64 = {"dtype": torch.float64, "device": dev}
        states = torch.empty((2, rows, nb_max, 4), **f64)  # block ends, block starts
        run_starts = torch.empty((rows, nb_max, plan["threads"], 4), **f64)
        part_sq = torch.empty((rows, nb_max), **f64)
        part_pk = torch.empty((rows, nb_max), dtype=torch.float32, device=dev)
        seg = torch.empty((rows, n_seg_max), **f64)
        bins = torch.empty((b, n_gb_max), dtype=torch.int16, device=dev)
        gate_part = torch.empty((b, -(-n_gb_max // tile), 2), **f64)
        out = torch.empty((3, b), **f64)
        bounds, energies = hist_tables(dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        obs.mark("launch.k9")
        rc = lib.thesia_lufs_stats(
            _ptr(wavs), _ptr(ns), b, c, length, plan["s100"], plan["segments"], plan["run"], tile,
            carry_k, host.ctypes.data_as(ctypes.c_void_p), _ptr(table), _ptr(carry_table),
            _SURROUND_WEIGHT, _RELATIVE_GATE_FACTOR, _ptr(states[0]), _ptr(states[1]),
            _ptr(run_starts), _ptr(part_sq), _ptr(part_pk), _ptr(seg), _ptr(bins), _ptr(gate_part),
            _ptr(bounds), _ptr(energies), _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), stream,
        )
    if rc != 0:
        raise RuntimeError(f"lufs_stats kernel launch failed: CUDA error {rc}")
    count_launch(lufs_stats)
    return out[0], out[1], out[2]


def limiter_gain(wavs: torch.Tensor, threshold: float, slew: float, *, hold_length: int,
                 box_lengths) -> torch.Tensor:
    """K8: wavs (B, C, L) f32, zero-padded -> gain (B, L) f64, not yet
    latency-shifted, as ``limiter_gain_program``.  On a card, three launches
    on the current stream (no sync).  The kernel takes a threshold >= 0 (its
    gains fall as the level rises, so the hold's minimum gain is the gain of
    the maximum level)."""
    _check_rows("limiter_gain", wavs)
    if wavs.device.type == "cpu":
        from ..dynamics import stats_device

        return stats_device.limiter_gain_program(wavs, threshold, slew, hold_length=hold_length,
                                                 box_lengths=box_lengths)
    if not threshold >= 0.0:
        raise ValueError(f"limiter_gain: the kernel takes a threshold >= 0, got {threshold}")
    b, c, length = wavs.shape
    plan = k8_plan(hold_length, box_lengths)
    if max(plan["smem_bytes"], plan["spans_smem_bytes"]) > K8_SMEM_LIMIT:
        raise ValueError(f"limiter_gain: hold {plan['hold']} and boxes {plan['boxes']} need "
                         f"{plan['smem_bytes']} bytes of shared memory")
    if length < 1:
        return torch.empty((b, 0), dtype=torch.float64, device=wavs.device)
    nb = -(-length // plan["chunk"])
    boxes = np.zeros(K8_MAX_BOXES, np.int64)
    boxes[: len(plan["boxes"])] = plan["boxes"]
    dev = wavs.device
    lib = build.library()
    with torch.cuda.device(dev):
        f64 = {"dtype": torch.float64, "device": dev}
        tri = torch.empty((b, nb, 3), **f64)
        starts = torch.empty((b, nb), **f64)
        out = torch.empty((b, length), **f64)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        obs.mark("launch.k8")
        rc = lib.thesia_limiter_gain(
            _ptr(wavs), b, c, length, float(threshold), float(slew), plan["hold"],
            boxes.ctypes.data_as(ctypes.c_void_p), len(plan["boxes"]), plan["chunk"],
            _ptr(tri), _ptr(starts), _ptr(out), plan["smem_bytes"], stream,
        )
    if rc != 0:
        raise RuntimeError(f"limiter_gain kernel launch failed: CUDA error {rc}")
    count_launch(limiter_gain)
    return out


def _check_track(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (C, n) float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    c, n = x.shape
    if not (1 <= c <= 65535 and 1 <= n < 1 << 40):
        raise ValueError(f"{name}: {tuple(x.shape)} out of the kernel's range")


def guard_peak(x: torch.Tensor, gain: float, keep: bool = False):
    """K10's first pass over one track's samples x (C, n) f32: (gained, bits).
    gained: float32(gain) * x, (C, n) f32, where ``keep`` asks for it, else
    None; bits (2, C) int32: row 0 the bits of each channel's abs max of
    gained, NaN skipped, from 0 (``stats.nan_safe_abs_max``), row 1 1 where
    the channel holds a NaN.  ``guard_peak_program`` for CPU tensors; on a
    card one launch on the current stream (no sync)."""
    _check_track("guard_peak", x)
    g = float(np.float32(gain))
    if x.device.type == "cpu":
        from ..dynamics import stats_device

        return stats_device.guard_peak_program(x, g, keep)
    c, n = x.shape
    dev = x.device
    lib = build.library()
    with torch.cuda.device(dev):
        bits = torch.zeros((2, c), dtype=torch.int32, device=dev)
        gained = torch.empty_like(x) if keep else None
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        obs.mark("launch.k10")
        rc = lib.thesia_guard_peak(_ptr(x), c, n, g, _ptr(gained) if keep else None,
                                   _ptr(bits[0]), _ptr(bits[1]), stream)
    if rc != 0:
        raise RuntimeError(f"guard_peak kernel launch failed: CUDA error {rc}")
    count_launch(guard_peak)
    return gained, bits


# K10's second pass: its modes (csrc/dynamics.cu K10_*)
GUARD_GAIN, GUARD_CLIP, GUARD_SCALE, GUARD_SEQ = range(4)


def guard_apply(x: torch.Tensor, gain: float, mode: int, scale: float = 1.0,
                gain_seq: torch.Tensor | None = None):
    """K10's second pass: (y, stats, seq32).  y (C, n) f32 is the guard of
    gained = float32(gain) * x: GUARD_GAIN gained; GUARD_CLIP clamp(gained,
    -1, 1), stats (C,) int64 each channel's count of |gained| > 1; GUARD_SCALE
    float32(clip(float64(gained) * scale, -1, 1)); GUARD_SEQ the same with
    gain_seq (n,) f64 in place of scale, seq32 (n,) f32 its gains rounded to
    f32, stats (2,) int64 [their count of != 1, ~ordered key of their least
    value] (``gain_seq_min``).  stats and seq32 are None where the mode has
    none.  ``guard_apply_program`` for CPU tensors; on a card one launch on
    the current stream (no sync)."""
    _check_track("guard_apply", x)
    c, n = x.shape
    if mode not in (GUARD_GAIN, GUARD_CLIP, GUARD_SCALE, GUARD_SEQ):
        raise ValueError(f"guard_apply: no mode {mode}")
    if mode == GUARD_SEQ and (gain_seq is None or gain_seq.dtype != torch.float64
                              or gain_seq.shape != (n,) or not gain_seq.is_contiguous()
                              or gain_seq.device != x.device):
        raise ValueError(f"guard_apply: the gains must be a contiguous ({n},) float64 tensor "
                         f"on {x.device}")
    g = float(np.float32(gain))
    if x.device.type == "cpu":
        from ..dynamics import stats_device

        return stats_device.guard_apply_program(x, g, mode, scale, gain_seq)
    dev = x.device
    lib = build.library()
    with torch.cuda.device(dev):
        y = torch.empty_like(x)
        seq32 = torch.empty(n, dtype=torch.float32, device=dev) if mode == GUARD_SEQ else None
        stats = torch.zeros(c if mode == GUARD_CLIP else 2, dtype=torch.int64, device=dev) \
            if mode in (GUARD_CLIP, GUARD_SEQ) else None
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        obs.mark("launch.k10")
        rc = lib.thesia_guard_apply(
            _ptr(x), c, n, g, mode, float(scale),
            _ptr(gain_seq) if seq32 is not None else None,
            _ptr(seq32) if seq32 is not None else None, _ptr(y),
            _ptr(stats) if stats is not None else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"guard_apply kernel launch failed: CUDA error {rc}")
    count_launch(guard_apply)
    return y, stats, seq32


def ordered_key(f32: torch.Tensor) -> torch.Tensor:
    """The int64 key of each float32 value that orders as the values do
    (csrc/dynamics.cu ordered_key), NaN aside."""
    u = f32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def gain_seq_min(inverted_key: int) -> float:
    """The float32 value whose ``ordered_key`` is 0xffffffff minus
    ``inverted_key`` (GUARD_SEQ's stats[1])."""
    key = 0xFFFFFFFF - int(inverted_key)
    u = key & 0x7FFFFFFF if key & 0x80000000 else 0xFFFFFFFF - key
    return float(np.uint32(u).view(np.float32))


def guard_work(n_ch: int, n: int, mode: int, keep: bool = False) -> dict:
    """Bytes one K10 pass over (n_ch, n) must move, for its bound: the first
    (``mode`` None) reads the samples and writes gained where ``keep`` asks;
    the second reads them and writes y, GUARD_SEQ also reads the f64 gains
    and writes their f32.  A few operations a sample: bytes bound."""
    samples = n_ch * n
    if mode is None:
        return {"bytes": 4 * samples * (2 if keep else 1), "flop": 2 * samples}
    seq = 12 * n if mode == GUARD_SEQ else 0
    return {"bytes": 8 * samples + seq, "flop": 4 * samples}


def reset_launches() -> None:
    """Every count to 0: ``launches`` (the main path's) and ``warm_launches``
    (under runtime.warming())."""
    for fn in (lufs_stats, limiter_gain, guard_peak, guard_apply):
        fn.launches = fn.warm_launches = 0


reset_launches()
