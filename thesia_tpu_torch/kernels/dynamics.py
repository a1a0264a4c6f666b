"""K9 (K-weighted LUFS with the sum of squares and the peak) and K8 (the
limiter's gain sequence) as hand-written CUDA kernels: their wrappers, the
host tables they read and the work they must do.

``lufs_stats`` and ``limiter_gain`` launch ``csrc/dynamics.cu`` for CUDA
tensors and run the plain versions for CPU tensors: the float64 torch
programs ``lufs_program`` and ``limiter_gain_program`` of
``dynamics/stats_device.py``, which take the same arguments and return the
same values.  Any other device, or a launch that fails, raises; nothing falls
back.  The kernels replace the JAX package's device programs
``_lufs_kernel`` (``thesia_tpu/dynamics/stats_device.py:264``) and
``_limiter_gain_kernel`` (``:161``); the source's header states their design.

The host tables: K9's two K-weighting biquads form the 4-state recurrence
S_t = M S_{t-1} + g x_t (``k9_matrix``); a block of ``THREADS`` threads scans
its threads' end states with the powers M^(S 2^i) and the carry pass scans
the blocks' with M^(ch 2^i), ch = G s100 the samples a block owns
(``k9_plan``, ``k9_tables``), each power an f64 product of exact squarings.
K8's chunk (``k8_plan``) is sized so that the first pass's two shared
buffers, the chunk with its hold and box halos in float64, stay near
``K8_SMEM_TARGET``; that pass leaves the hold values in the output row, the
last pass reads them there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..dynamics.loudness import (
    _RELATIVE_GATE_FACTOR,
    _SURROUND_WEIGHT,
    HIST_BOUNDARIES,
    HIST_ENERGIES,
    k_weighting_coeffs,
)
from ..runtime import count_launch
from . import build

THREADS = 256  # csrc/dynamics.cu: T
K9_SUBS = (16, 8, 4, 2, 1)  # samples a thread of a K9 round, at most s100
K9_MAX_SEGMENTS = 4 * THREADS
K8_MAX_BOXES = 4
K8_SMEM_TARGET = 100 * 1024
# shared memory a block may use on an H100, less K8's static scan buffer
K8_SMEM_LIMIT = 227 * 1024 - 24 * THREADS - 64
# f64 operations a sample (two DF2T biquads of 9, the output's square and
# sum, the raw square and sum, the peak's |.| and max) and a gating block
# per channel (four segment sums and the weighted add; the bin search, the
# gates and the means once a block)
K9_FLOP_PER_SAMPLE = 24
K9_FLOP_PER_BLOCK_CHANNEL = 5
K9_FLOP_PER_BLOCK = 2 * 11 + 6


def k9_plan(sr: int, threads: int = THREADS, sub: int | None = None,
            segments: int | None = None) -> dict:
    """K9's schedule at ``sr``: s100 and win (100 ms and 400 ms in samples),
    ``sub`` S samples a thread of a round (the largest of K9_SUBS not above
    s100, so a thread's samples touch at most two segments), ``segments``
    G whole 100 ms segments a block owns (about four rounds of threads * S
    samples), ``chunk`` = G s100 samples."""
    s100 = (sr + 5) // 10
    if s100 < 1:
        raise ValueError(f"lufs_stats: sample rate {sr} has no 100 ms segment")
    if sub is None:
        sub = max(s for s in K9_SUBS if s <= s100)
    if segments is None:
        segments = max(1, min(K9_MAX_SEGMENTS, 4 * threads * sub // s100))
    return {"s100": s100, "win": 4 * s100, "sub": sub, "segments": segments,
            "chunk": segments * s100, "threads": threads}


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


def matrix_power(m: np.ndarray, e: int) -> np.ndarray:
    """m^e in f64 by squaring."""
    out = np.eye(m.shape[0])
    sq = m.copy()
    while e:
        if e & 1:
            out = out @ sq
        sq = sq @ sq
        e >>= 1
    return out


def power_ladder(m: np.ndarray, base: int, count: int) -> np.ndarray:
    """(count, 4, 4): m^(base 2^i), i < count."""
    p = matrix_power(m, base)
    out = []
    for _ in range(count):
        out.append(p)
        p = p @ p
    return np.stack(out)


@functools.lru_cache(maxsize=32)
def k9_tables(sr: int, threads: int = THREADS, sub: int | None = None,
              segments: int | None = None) -> np.ndarray:
    """The table thesia_lufs_stats copies into its kernels' arguments: the
    10 coefficients, then log2(threads) powers M^(S 2^i), then as many M^(ch
    2^i), each 16 f64 row-major.  Read-only (cached)."""
    plan = k9_plan(sr, threads, sub, segments)
    coef = k9_coefficients(sr)
    m, _g = k9_matrix(coef)
    steps = threads.bit_length() - 1
    out = np.concatenate([coef, power_ladder(m, plan["sub"], steps).reshape(-1),
                          power_ladder(m, plan["chunk"], steps).reshape(-1)])
    out.setflags(write=False)
    return out


def k8_plan(hold_length: int, box_lengths, chunk: int | None = None) -> dict:
    """K8's schedule: ``hold`` (>= 1), the ``boxes`` longer than 1 and
    ``hbox`` = sum(box - 1) (the box stack's delay), ``chunk`` output
    positions a block (a multiple of THREADS, at least 1024, sized so that
    k8_chunks' two f64 buffers of ``span`` = chunk + hbox + hold - 1 fill
    about K8_SMEM_TARGET bytes), ``smem_bytes`` theirs (k8_gain's two
    buffers hold chunk + hbox)."""
    hold = max(int(hold_length), 1)
    boxes = tuple(int(l) for l in box_lengths if l > 1)
    if len(boxes) > K8_MAX_BOXES:
        raise ValueError(f"limiter_gain: at most {K8_MAX_BOXES} box filters, got {boxes}")
    hbox = sum(l - 1 for l in boxes)
    halo = hbox + hold - 1
    if chunk is None:
        chunk = max(1024, (K8_SMEM_TARGET // 16 - halo) // THREADS * THREADS)
    span = chunk + halo
    return {"hold": hold, "boxes": boxes, "hbox": hbox, "chunk": chunk, "span": span,
            "smem_bytes": 16 * span}


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
    quotient 3, a sliding min 3 (van Herk), the release step 3, each box's
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
    card, four launches on the current stream (no sync); two calls on the
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
    tables = k9_tables(sr)
    nb_max = -(-length // plan["chunk"])
    n_seg_max = length // plan["s100"]
    rows = b * c
    dev = wavs.device
    lib = build.library()
    with torch.cuda.device(dev):
        f64 = {"dtype": torch.float64, "device": dev}
        states = torch.empty((2, rows, nb_max, 4), **f64)  # block ends, block starts
        part_sq = torch.empty((rows, nb_max), **f64)
        part_pk = torch.empty((rows, nb_max), dtype=torch.float32, device=dev)
        seg = torch.empty((rows, n_seg_max), **f64)
        out = torch.empty((3, b), **f64)
        bounds, energies = hist_tables(dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.thesia_lufs_stats(
            _ptr(wavs), _ptr(ns), b, c, length, plan["s100"], plan["segments"], plan["sub"],
            tables.ctypes.data_as(ctypes.c_void_p), _SURROUND_WEIGHT, _RELATIVE_GATE_FACTOR,
            _ptr(states[0]), _ptr(states[1]), _ptr(part_sq), _ptr(part_pk), _ptr(seg),
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
    on the current stream (no sync)."""
    _check_rows("limiter_gain", wavs)
    if wavs.device.type == "cpu":
        from ..dynamics import stats_device

        return stats_device.limiter_gain_program(wavs, threshold, slew, hold_length=hold_length,
                                                 box_lengths=box_lengths)
    b, c, length = wavs.shape
    plan = k8_plan(hold_length, box_lengths)
    if plan["smem_bytes"] > K8_SMEM_LIMIT:
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
        halo = torch.empty((b, nb, plan["hbox"]), **f64)
        out = torch.empty((b, length), **f64)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.thesia_limiter_gain(
            _ptr(wavs), b, c, length, float(threshold), float(slew), plan["hold"],
            boxes.ctypes.data_as(ctypes.c_void_p), len(plan["boxes"]), plan["chunk"],
            _ptr(tri), _ptr(starts), _ptr(halo), _ptr(out), plan["smem_bytes"], stream,
        )
    if rc != 0:
        raise RuntimeError(f"limiter_gain kernel launch failed: CUDA error {rc}")
    count_launch(limiter_gain)
    return out


def reset_launches() -> None:
    """Every count to 0: ``launches`` (the main path's) and ``warm_launches``
    (under runtime.warming())."""
    for fn in (lufs_stats, limiter_gain):
        fn.launches = fn.warm_launches = 0


reset_launches()
