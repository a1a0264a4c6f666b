"""Fused framed real FFT -> |.| -> (mel) -> dB: the hand-written CUDA kernel and
its plain PyTorch version.

``spec_db`` launches ``csrc/spec_fft.cu`` for CUDA tensors and runs
``spec_db_reference`` (the window-folded DFT as two matrix products, the JAX
package's route) for CPU tensors; any other device, or a CUDA launch that
fails, raises.  The kernel replaces the Pallas kernels ``spec_db_pallas``
(mel, K1) and ``spec_db_pallas_linear`` (linear, K2) in
``tests/pallas_spec.py``.

Frames are read from the raw rows in place, the reflect padding (K3 of the
JAX program) folded into the loader: frame ``t`` of row ``c`` holds samples
``(t0 + t)*hop - pad ..`` ``+ win - 1`` of the row's first ``n_c`` samples
(``row_n[c]``, default the rows' width) through the cyclic reflect map of
``dsp/stft.py`` (``reflect_indices_torch``), each multiplied by the row's
gain ``gains[c]`` when gains are given (the normalize gain, ``(x * g) * w``
as in the JAX package), windowed by ``window`` (win,) and transformed at
``n_fft`` points (a power of two from 1 to 32768, at least win).  ``pad =
0`` reads rows padded beforehand as they are.  With ``bounds=True`` the
launch also returns each row's min and max dB over its valid frames (``t0 +
t`` below the frame count of ``n_c``) and its columns, as the JAX package's
``_spec_multi_impl`` masks them.

Two ranges serve the device mesh (``parallel/sharding.py``) without a copy:
the rows may be a view whose rows lie further apart than its width (the
kernel takes the row stride), so a shard of the "time" axis passes
``padded[:, t0*hop : (t1-1)*hop + win]``; and ``col0``, ``n_cols`` select
the output columns a shard of the "freq" axis writes.  Either range computes
its entries exactly as the whole launch does.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import threading
import weakref

import numpy as np
import torch

from .. import obs
from ..dsp.stft import make_dft_matrices, reflect_indices_torch
from ..runtime import is_warming
from . import build

MAX_N_FFT = 1 << 15
# n_fft of the register schedule (csrc/spec_fft.cu: spec_fft_kernel_regs):
# h = n_fft/2 = 32 L points in the registers of L lanes, warps of 32 / L
# frames, REG_WARPS warps per CTA
REG_N_FFTS = (64, 2048)
REG_WARPS = 4


def reg_warp_buffer(lanes: int) -> int:
    """Complex values of a warp's shared buffer in the register schedule
    (Layout::WARP_BUF): 32 / L groups of S = 32 L + 32 + (L mod 16)."""
    return (32 // lanes) * (32 * lanes + 32 + (lanes & 15))
# the shared-memory schedule of the other sizes: complex values of one CTA's
# FFT buffers (frames per CTA = this / (n_fft/2)) and threads per CTA
CTA_COMPLEX = 2048
THREADS = 128
# shared memory a block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024


def db_from_amplitude(x: torch.Tensor) -> torch.Tensor:
    """20*log10(x) with exactly -inf where x == 0 (dB with amin 0)."""
    pos = x > 0
    return torch.where(
        pos, 20.0 * torch.log10(torch.where(pos, x, 1.0)), -torch.inf
    )


def frame_count(n, pad: int, win: int, hop: int):
    """Frames of a row of ``n`` samples, padded by ``pad`` on each side
    (``dsp/stft.py: stft_frame_count`` at pad = win // 2); n may be a
    tensor."""
    if isinstance(n, torch.Tensor):
        return torch.where(n + 2 * pad >= win, torch.div(n + 2 * pad - win, hop,
                                                           rounding_mode="floor") + 1, 0)
    return (n + 2 * pad - win) // hop + 1 if n + 2 * pad >= win else 0


def frame_samples(rows, hop: int, win: int, n_frames: int, pad: int = 0, row_n=None,
                  t0: int = 0):
    """(C, (n_frames - 1)*hop + win) samples that frames t0 .. t0 + n_frames - 1
    read: ``rows`` itself (a view) when pad is 0 and every row is whole, else
    gathered through each row's reflect map (``reflect_indices_torch``)."""
    q0, q1 = t0 * hop - pad, (t0 + n_frames - 1) * hop + win - pad
    if pad == 0 and row_n is None:
        return rows[:, q0:q1]
    ns = [rows.shape[1]] * rows.shape[0] if row_n is None else [int(n) for n in row_n.tolist()]
    out = torch.empty((rows.shape[0], q1 - q0), dtype=rows.dtype, device=rows.device)
    for n in sorted(set(ns)):
        sel = torch.tensor([m == n for m in ns], device=rows.device)
        out[sel] = rows[sel][:, reflect_indices_torch(n, -q0, q1 - n, rows.device)]
    return out


def spec_db_reference(rows, hop: int, win: int, n_frames: int, cw, sw, mel=None, gains=None,
                      col0: int = 0, n_cols: int | None = None, *, pad: int = 0, row_n=None,
                      t0: int = 0, bounds: bool = False):
    """Plain PyTorch version of the kernel: (C, L) raw rows -> (C, n_frames,
    M|F) dB, with cw/sw the window-folded DFT matrices (win, F) of
    ``dft_matrices``.  The rows are reflect-padded by ``pad`` (over each
    row's ``row_n`` samples; ``frame_samples``) and framed from frame
    ``t0``; ``gains`` (C,) multiplies each row first (the JAX package's
    ``raw * gain``).  ``col0``, ``n_cols``: only those output columns, as
    slices of the linear matrices or of the filterbank.  ``bounds``: also
    return each row's min and max over its valid frames, -> (db, row_min,
    row_max)."""
    x = frame_samples(rows, hop, win, n_frames, pad, row_n, t0)
    if gains is not None:
        x = x * gains[:, None]
    frames = x.unfold(-1, win, hop)[:, :n_frames]
    cols = sw.shape[1] if mel is None else mel.shape[1]
    if n_cols is not None and (col0, n_cols) != (0, cols):
        if mel is None:
            cw, sw = cw[:, col0:col0 + n_cols], sw[:, col0:col0 + n_cols]
        else:
            mel = mel[:, col0:col0 + n_cols]
    re = torch.matmul(frames, cw)
    im = torch.matmul(frames, sw)
    out = torch.sqrt(re * re + im * im)
    if mel is not None:
        out = torch.matmul(out, mel)
    db = db_from_amplitude(out)
    if not bounds:
        return db
    n = torch.full((rows.shape[0],), rows.shape[1], device=rows.device) if row_n is None else row_n
    t = t0 + torch.arange(n_frames, device=rows.device)
    valid = (t[None, :] < frame_count(n.to(torch.int64), pad, win, hop)[:, None])[..., None]
    return (db, torch.where(valid, db, torch.inf).amin(dim=(1, 2)),
            torch.where(valid, db, -torch.inf).amax(dim=(1, 2)))


@functools.lru_cache(maxsize=8)
def _dft_matrices_np(window_bytes: bytes, n_fft: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    window = np.frombuffer(window_bytes, np.float32)
    return make_dft_matrices(window, n_fft, (n_fft - window.shape[0]) // 2, dtype)


def dft_matrices(window: torch.Tensor, n_fft: int, dtype=torch.float32):
    """The window-folded DFT matrices (win, n_fft/2 + 1) of the JAX analyzer
    (window centred in n_fft), built in float64 and cast to ``dtype``, on
    window's device."""
    key = np.ascontiguousarray(window.detach().cpu().numpy(), np.float32).tobytes()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cw, sw = _dft_matrices_np(key, n_fft, np_dtype)
    return (torch.from_numpy(cw.copy()).to(window.device),
            torch.from_numpy(sw.copy()).to(window.device))


def uses_registers(n_fft: int) -> bool:
    """Does n_fft run the register schedule (else the shared-memory one)?"""
    return REG_N_FFTS[0] <= n_fft <= REG_N_FFTS[1]


def twiddle_exponents(n_fft: int, registers: bool | None = None) -> np.ndarray:
    """Exponents m of the kernel's twiddles W^m = e^{-2 pi i m / n_fft}, in the
    order it reads them, h = max(n_fft/2, 1), for the register schedule or
    the shared-memory one (default: ``uses_registers(n_fft)``).

    Register schedule (h = 32 L): W_32^e for e < 32
    (exponent e n_fft/32), the 32-point stage's W_h^{b k1} at k1 L + b for
    k1 < 32, b < L (exponent 2 b k1), the split's W^k for k <= h/2.
    Shared-memory schedule (csrc/spec_fft.cu, span_planes): the split's W^k
    for k < h; the radix-2 stage's W^2b for b < h/2; then for every span S =
    4, 8, .., h the planes W_S^j, W_S^2j, W_S^3j (exponent k*j*n_fft/S) for
    j < S/4."""
    h = max(n_fft // 2, 1)
    if uses_registers(n_fft) if registers is None else registers:
        lanes = h // 32
        k1, b = np.meshgrid(np.arange(32), np.arange(lanes), indexing="ij")
        parts = [np.arange(32) * (n_fft // 32), (2 * b * k1).reshape(-1), np.arange(h // 2 + 1)]
        return np.concatenate(parts).astype(np.int64)
    parts = [np.arange(h), 2 * np.arange(h // 2)]
    span = 4
    while span <= h:
        j = np.arange(span // 4)
        parts += [k * j * (n_fft // span) for k in (1, 2, 3)]
        span *= 2
    return np.concatenate(parts).astype(np.int64)


def twiddle_table(n_fft: int, registers: bool | None = None) -> np.ndarray:
    """(n, 2) f32: (cos, -sin)(2 pi m / n_fft) for the exponents m of
    ``twiddle_exponents``, computed in float64 and rounded once."""
    ang = 2.0 * np.pi * twiddle_exponents(n_fft, registers).astype(np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


_twiddles: dict[tuple[int, torch.device, bool], torch.Tensor] = {}
_bounds_starts: dict[tuple[int, torch.device], torch.Tensor] = {}


def _bounds_start(n_rows: int, device: torch.device) -> torch.Tensor:
    """(2, n_rows) f32: +inf, then -inf, on device (a launch clones it: one
    copy, not two fills).  Made once per row count, complete before any
    stream reads it."""
    key = (n_rows, device)
    if key not in _bounds_starts:
        start = torch.tensor([torch.inf, -torch.inf], device=device)[:, None] \
            .expand(2, n_rows).contiguous()
        torch.cuda.current_stream(device).synchronize()
        _bounds_starts.setdefault(key, start)
    return _bounds_starts[key]


def _device_twiddles(n_fft: int, device: torch.device, registers: bool | None = None
                     ) -> torch.Tensor:
    registers = uses_registers(n_fft) if registers is None else registers
    key = (n_fft, device, registers)
    if key not in _twiddles:
        _twiddles[key] = torch.from_numpy(twiddle_table(n_fft, registers)).to(device)
    return _twiddles[key]


def launch_plan(n_fft: int, n_frames: int, n_rows: int, mel: bool, win: int,
                n_cols: int = 0, sched_bytes: int = 0) -> dict:
    """The launch's schedule and dynamic shared bytes.  Register schedule:
    lanes per frame, frames per warp, warps per CTA and the frame groups the
    persistent CTAs walk (their number comes from the card's occupancy);
    the mel variant adds its flattened filterbank's ``sched_bytes``.
    Shared-memory schedule (the other sizes, and a mel launch of more than
    h columns or whose filterbank does not fit): frames and threads per
    CTA and the grid."""
    h = max(n_fft // 2, 1)
    smem = (REG_WARPS * reg_warp_buffer(max(h // 32, 1)) * 8 + (32 + h + h // 2 + 1) * 8
            + (win // 4 + 1) * 16)
    smem += sched_bytes if mel else 0
    # the mel variant keeps its n_cols column sums past the magnitudes in
    # the FFT's buffer and its flattened filterbank (sched_bytes) in shared
    # memory
    if uses_registers(n_fft) and not (mel and (n_cols > h or smem > SMEM_LIMIT)):
        frames = 32 // (h // 32)
        return {"schedule": "registers", "lanes": h // 32, "frames_per_warp": frames,
                "warps": REG_WARPS, "smem_bytes": smem, "groups": n_rows * -(-n_frames // frames)}
    frames = max(1, CTA_COMPLEX // h)
    smem = frames * h * 8 + (frames * (n_fft // 2 + 1) * 4 if mel else 0)
    return {
        "schedule": "shared", "frames_per_cta": frames, "threads": THREADS, "smem_bytes": smem,
        "grid": (-(-n_frames // frames), n_rows),
    }


def bin_pairs(n_fft: int, col0: int, n_cols: int) -> tuple[int, int]:
    """[p0, p1): the bin pairs (k, h-k), k <= h/2, that the linear variant
    computes for output columns [col0, col0 + n_cols): those with k or h-k
    in range, hulled into one run of k (csrc/spec_fft.cu: thesia_spec_fft)."""
    h = max(n_fft // 2, 1)
    n_pairs = h // 2 + 1
    c1 = col0 + n_cols
    runs = [(col0, min(c1, n_pairs)), (max(h - c1 + 1, 0), min(h - col0, h // 2) + 1)]
    runs = [(a, b) for a, b in runs if a < b]
    return (min(a for a, _ in runs), max(b for _, b in runs)) if runs else (0, 0)


def kernel_work(n_rows: int, row_len: int, n_frames: int, win: int, n_fft: int, mel=None,
                gained: bool = False, col0: int = 0, n_cols: int | None = None,
                bounds: bool = False) -> dict:
    """What one launch must move and compute, for its bound: ``bytes`` (each
    input read once -- rows of ``row_len`` samples (the raw rows' n when the
    loader pads them, the padded width when they were padded beforehand),
    window, twiddles, the packed filterbank of the launch's columns -- and
    the output written once, with the two f32 bounds per row when
    ``bounds``) and ``flop``, an algorithm count of the f32 operations per
    frame, the same whichever schedule of csrc/spec_fft.cu runs it, with h =
    max(n_fft/2, 1); ``col0``, ``n_cols`` a launch's output columns (default
    all), whose FFT is whole:

    * window: one product per sample, ``win``, and as many again for the
      row's gain when ``gained`` (which reads one f32 per row);
    * h-point complex FFT, counted as a radix-4 DIF FFT (a radix-2 level
      first when log2 h is odd): 10 per radix-2 butterfly (two complex sums,
      one complex product) and 34 per radix-4 butterfly (ten for the four
      first complex sums and y0, eight for each of the three outputs that
      take a twiddle: a complex sum and a complex product), h/2 and h/4 of
      them a level;
    * real split, one bin pair (k, h-k) at a time (``pair_power``): 24 for
      0 < k <= h/2 (E and O: four sums, four halvings; W^k O: six; X[k] and
      X[h-k]: four; two powers: six), 4 at k = 0;
    * linear: a log2 and a scale per bin; mel: a sqrt per bin, a multiply-add
      (2) per filterbank weight, a log2 and a scale per column.

    ``dft_gemm_flop``: the same spectrogram as the window-folded DFT GEMM
    (4*win*F a frame) with the sparse mel product."""
    h = max(n_fft // 2, 1)
    log2h = h.bit_length() - 1
    n_freq = n_fft // 2 + 1
    cols = n_freq if mel is None else mel.shape[1]
    cols = cols if n_cols is None else n_cols
    nnz = 0 if mel is None else int((mel[:, col0:col0 + cols] != 0).sum())
    fft = (h // 2) * 10 * (log2h % 2) + (h // 4) * 34 * (log2h // 2)
    p0, p1 = (0, h // 2 + 1) if mel is not None else bin_pairs(n_fft, col0, cols)
    split = (4 if p0 == 0 < p1 else 0) + 24 * (p1 - max(p0, 1))
    tail = 2 * cols if mel is None else n_freq + 2 * nnz + 2 * cols
    frames = n_rows * n_frames
    pack = 0 if mel is None else 4 * (2 * cols + 1 + nnz)
    load = 2 * win if gained else win
    return {
        "bytes": 4 * (n_rows * row_len + win + frames * cols + (n_rows if gained else 0)
                      + (2 * n_rows if bounds else 0))
        + 8 * len(twiddle_exponents(n_fft)) + pack,
        "flop": frames * (load + fft + split + tail),
        "dft_gemm_flop": frames * (4 * win * n_freq + 2 * nnz),
    }


def mel_pack(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The filterbank (F, M) as the kernel walks it: per column m the first
    nonzero row ``lo[m]`` and the weights of rows lo[m] .. (the band up to its
    last nonzero row) at ``w[off[m] : off[m+1]]``; an all-zero column has an
    empty band.  int32/int32/f32 on mel's device."""
    n_freq, n_mel = mel.shape
    nz = (mel != 0).to(torch.int32)
    has = nz.amax(0) > 0
    lo = torch.where(has, nz.argmax(0), 0)
    hi = torch.where(has, n_freq - nz.flip(0).argmax(0), 0)
    width = hi - lo
    off = torch.zeros(n_mel + 1, dtype=torch.int64, device=mel.device)
    off[1:] = torch.cumsum(width, 0)
    total = int(off[-1])
    col = torch.repeat_interleave(torch.arange(n_mel, device=mel.device), width, output_size=total)
    row = lo[col] + torch.arange(total, device=mel.device) - off[col]
    w = mel[row, col].contiguous()
    return lo.to(torch.int32).contiguous(), off.to(torch.int32).contiguous(), w


def mel_schedule(mel: np.ndarray, lanes: int, col0: int = 0, n_cols: int | None = None):
    """The filterbank (F, M) flattened for the register schedule's mel
    epilogue: columns [col0, col0 + n_cols) dealt to ``lanes`` lanes (the
    widest first, each to the least loaded lane: the lanes step together,
    so the longest list sets the time), each column as its band's entries
    (bin, weight) from its first to its last nonzero row, in order (an
    empty column one entry of weight 0), its last entry also carrying the
    column.  Returns (n_sched, lanes, 2) int32: ``bin | (column - col0 + 1)
    << 12`` at a column's last entry, else ``bin``; the weight's f32 bits;
    lists padded with (0, 0.0).  Each column's sum is the band's in order,
    whatever the lane, so any column range sums as the whole launch.  The
    lists' length is a multiple of 8 (the kernel reads them in chunks)."""
    mel = np.asarray(mel, np.float32)[:, col0:col0 + (mel.shape[1] - col0 if n_cols is None
                                                       else n_cols)]
    n_freq, n_cols = mel.shape
    nz = mel != 0
    has = nz.any(0)
    lo = np.where(has, nz.argmax(0), 0)
    width = np.where(has, n_freq - nz[::-1].argmax(0) - lo, 1)  # an empty column: one entry
    lists = [[] for _ in range(lanes)]
    heap = [(0, lane) for lane in range(lanes)]
    for i in sorted(range(n_cols), key=lambda i: (-width[i], i)):
        load, lane = heapq.heappop(heap)
        lists[lane].append(i)
        heapq.heappush(heap, (load + int(width[i]), lane))
    n_sched = -(-max(int(width[cols].sum()) for cols in lists if cols) // 8) * 8
    out = np.zeros((n_sched, lanes, 2), np.int32)
    for lane, cols in enumerate(lists):
        if not cols:
            continue
        cols = np.sort(cols)
        w = width[cols]
        col = np.repeat(cols, w)
        rows = lo[col] + np.arange(w.sum()) - np.repeat(np.cumsum(w) - w, w)
        code = rows.astype(np.int32)
        code[np.cumsum(w) - 1] |= ((cols + 1) << 12).astype(np.int32)
        out[:len(code), lane, 0] = code
        out[:len(code), lane, 1] = np.where(has[col], mel[rows, col], 0.0).astype(
            np.float32).view(np.int32)
    return out


def mel_tables(mel: torch.Tensor, n_fft: int, win: int, col0: int, n_cols: int):
    """The filterbank as a launch of these columns reads it, built once per
    tensor and cached: (flattened schedule, None) for the register schedule
    (``mel_schedule``), (None, packed bands) for the shared-memory one
    (``mel_pack``).  The shape warmer builds them ahead of the engine."""
    if uses_registers(n_fft) and n_cols <= n_fft // 2:
        sched = _cached_mel_schedule(mel, n_fft // 64, col0, n_cols)
        plan = launch_plan(n_fft, 1, 1, True, win, n_cols, sched.numel() * 4)
        if plan["schedule"] == "registers":
            return sched, None
    return None, _cached_mel_pack(mel)


# mel_pack per filterbank tensor: id -> (weak reference, version, pack); the
# shape warmer packs on its own thread
_packs: dict[int, tuple] = {}
_packs_lock = threading.Lock()


_schedules: dict[tuple, tuple] = {}


def _cached_mel_schedule(mel: torch.Tensor, lanes: int, col0: int, n_cols: int) -> torch.Tensor:
    """``mel_schedule`` of a filterbank tensor on its device, built once per
    (tensor, version, lanes, columns); the first build reads the filterbank
    back to the host (a sync)."""
    key = (id(mel), lanes, col0, n_cols)
    with _packs_lock:
        hit = _schedules.get(key)
    if hit is not None and hit[0]() is mel and hit[1] == mel._version:
        return hit[2]
    sched = torch.from_numpy(mel_schedule(mel.detach().cpu().numpy(), lanes, col0, n_cols))
    sched = sched.to(mel.device)
    if mel.is_cuda:
        torch.cuda.current_stream(mel.device).synchronize()
    with _packs_lock:
        for k in [k for k, v in _schedules.items() if v[0]() is None]:
            del _schedules[k]
        _schedules[key] = (weakref.ref(mel), mel._version, sched)
    return sched


def _cached_mel_pack(mel: torch.Tensor):
    with _packs_lock:
        hit = _packs.get(id(mel))
    if hit is not None and hit[0]() is mel and hit[1] == mel._version:
        return hit[2]
    pack = mel_pack(mel)
    with _packs_lock:
        for key in [k for k, v in _packs.items() if v[0]() is None]:
            del _packs[key]
        _packs[id(mel)] = (weakref.ref(mel), mel._version, pack)
    return pack


# The kernel's accuracy contract against the plain version evaluated in
# float64: an f32 evaluation's amplitude error stays within a few eps of the
# row's loudest entry (max_scaled), so dB agree to 1e-3 within 60 dB of the
# row max; -inf exact.  The plain version in float32 is no such reference: its
# window-folded DFT matrices are rounded to f32, which alone moves entries
# 50-60 dB below the row max by more than 1e-3 dB (tests/test_torch_kernels.py:
# test_f32_dft_gemm_is_no_reference_at_the_contract)
SCALED_TOL = 3e-5
TOP60_TOL_DB = 1e-3


def within_tolerance(err: dict) -> bool:
    """``db_error`` of the kernel against the float64 plain version meets the
    contract."""
    return (err["inf_equal"] and err["max_scaled"] <= SCALED_TOL
            and err["max_abs_top60"] <= TOP60_TOL_DB)


def db_error(ref, got) -> dict:
    """How far ``got`` dB lies from ``ref`` dB, both (C, T, F) arrays.

    ``max_abs``: max |dB difference| over entries finite in ``ref``;
    ``max_abs_top60``: the same over entries within 60 dB of their row's max;
    ``max_scaled``: max of |dB difference| * 10**((v - row_max) / 20), i.e. the
    amplitude error relative to the row's loudest entry.  Two f32 evaluations
    that round in other places differ by a few eps of the row's amplitude,
    which is a dB error growing tenfold per 20 dB below the max;
    ``max_scaled`` is flat in that model.
    ``inf_equal``: -inf (exact zero amplitude) in the same places."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    fin = np.isfinite(ref)
    row_max = np.max(np.where(fin, ref, -np.inf), axis=(1, 2), keepdims=True)
    with np.errstate(over="ignore", invalid="ignore"):
        diff = np.where(fin, np.abs(got - ref), 0.0)
        scaled = np.where(fin, diff * 10.0 ** ((ref - row_max) / 20.0), 0.0)
    top = fin & (ref > row_max - 60.0)
    return {
        "max_abs": float(diff.max(initial=0.0)),
        "max_abs_top60": float(np.where(top, diff, 0.0).max(initial=0.0)),
        "max_scaled": float(scaled.max(initial=0.0)),
        "inf_equal": bool((np.isneginf(ref) == np.isneginf(got)).all()),
    }


def _check(rows, hop, win, n_frames, window, n_fft, mel, gains, col0, n_cols, pad, row_n,
           t0) -> None:
    dev = rows.device
    tensors = {"rows": rows, "window": window}
    if mel is not None:
        tensors["mel"] = mel
    if gains is not None:
        tensors["gains"] = gains
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"spec_db: {name} is on {t.device}, rows on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"spec_db: {name} must be float32, got {t.dtype}")
        if name != "rows" and not t.is_contiguous():
            raise ValueError(f"spec_db: {name} must be contiguous")
    if rows.dim() != 2 or window.shape != (win,):
        raise ValueError(f"spec_db: rows {tuple(rows.shape)} must be (C, L), window (win,)")
    if rows.stride(1) != 1 or (rows.shape[0] > 1 and rows.stride(0) < rows.shape[1]):
        raise ValueError(f"spec_db: rows must be contiguous, strides {rows.stride()}")
    cols = n_fft // 2 + 1 if mel is None else mel.shape[1]
    if not (0 <= col0 and 0 <= n_cols and col0 + n_cols <= cols):
        raise ValueError(f"spec_db: columns [{col0}, {col0 + n_cols}) of {cols}")
    if not (1 <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"spec_db: n_fft {n_fft} is not a power of two in [1, {MAX_N_FFT}]")
    if mel is not None and (mel.dim() != 2 or mel.shape[0] != n_fft // 2 + 1):
        raise ValueError(f"spec_db: mel {tuple(mel.shape)} vs {n_fft // 2 + 1} bins")
    c, length = rows.shape
    if gains is not None and gains.shape != (c,):
        raise ValueError(f"spec_db: gains {tuple(gains.shape)} must be ({c},), one per row")
    if hop < 1 or not 1 <= win <= n_fft or n_frames < 0 or not 1 <= c <= 65535:
        raise ValueError(f"spec_db: bad framing hop={hop} win={win} n_fft={n_fft} rows={c}")
    if not (0 <= pad <= 1 << 20 and t0 >= 0 and 1 <= length < 1 << 30):
        raise ValueError(f"spec_db: bad padding pad={pad} t0={t0} width={length}")
    if n_frames and (t0 + n_frames - 1) * hop + win > length + 2 * pad:
        raise ValueError(f"spec_db: frames {t0}..{t0 + n_frames - 1} of {win} at hop {hop} "
                         f"exceed {length} samples padded by {pad}")
    if row_n is not None:
        if row_n.device != dev or row_n.dtype != torch.int32 or row_n.shape != (c,) \
                or not row_n.is_contiguous():
            raise ValueError(f"spec_db: row_n must be ({c},) int32 on {dev}")
        lo, hi = (int(v) for v in torch.aminmax(row_n))  # a host sync, for the check
        if lo < 1 or hi > length:
            raise ValueError(f"spec_db: row_n in [{lo}, {hi}], rows of {length} samples")


def spec_db(rows, hop: int, win: int, n_frames: int, window, n_fft: int, mel=None,
            *, pad: int = 0, row_n=None, t0: int = 0, gains=None, col0: int = 0,
            n_cols: int | None = None, bounds: bool = False):
    """(C, L) f32 rows -> (C, n_frames, M) dB with ``mel`` (F, M), or (C,
    n_frames, F) dB without it; F = n_fft/2 + 1.  Frame t reads samples (t0 +
    t)*hop - pad .. of each row, reflect-padded over its ``row_n`` (C,)
    int32 samples (None: the rows' width L; a given row_n is checked on the
    host, a sync).  ``gains`` (C,) f32, or None for none: each row's samples
    are multiplied by its gain before the window (a gain of 1 leaves the
    output bitwise unchanged).  ``col0``, ``n_cols`` (default: every
    column): only output columns [col0, col0 + n_cols), (C, n_frames,
    n_cols).  The rows may be a view whose rows lie further apart than L.
    ``bounds``: return (db, row_min, row_max), the (C,) min and max dB of
    each row over its valid frames (``frame_count`` of its samples) and the
    columns; +inf and -inf for a row without one."""
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spec_db: no kernel for device {rows.device}")
    all_cols = n_fft // 2 + 1 if mel is None else mel.shape[1]
    if n_cols is None:
        n_cols = all_cols - col0
    _check(rows, hop, win, n_frames, window, n_fft, mel, gains, col0, n_cols, pad, row_n, t0)
    c, length = rows.shape
    if n_frames == 0 or n_cols == 0:
        out = torch.empty((c, n_frames, n_cols), dtype=torch.float32, device=rows.device)
        if not bounds:
            return out
        return (out, torch.full((c,), torch.inf, device=rows.device),
                torch.full((c,), -torch.inf, device=rows.device))
    if rows.device.type == "cpu":
        cw, sw = dft_matrices(window, n_fft)
        return spec_db_reference(rows, hop, win, n_frames, cw, sw, mel, gains, col0, n_cols,
                                 pad=pad, row_n=row_n, t0=t0, bounds=bounds)
    sched, pack = mel_tables(mel, n_fft, win, col0, n_cols) if mel is not None else (None, None)
    plan = launch_plan(n_fft, n_frames, c, mel is not None, win, n_cols,
                       0 if sched is None else sched.numel() * 4)
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"spec_db: n_fft {n_fft} needs {plan['smem_bytes']} bytes of shared memory")
    lib = build.library()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(rows.device):
        out = torch.empty((c, n_frames, n_cols), dtype=torch.float32, device=rows.device)
        # row_min, row_max: +inf, -inf, lowered and raised by the kernel
        ext = _bounds_start(c, rows.device).clone() if bounds else None
        tw = _device_twiddles(n_fft, rows.device, plan["schedule"] == "registers")
        lo, off, w = pack if pack is not None else (None, None, None)
        stream = ctypes.c_void_p(torch.cuda.current_stream(rows.device).cuda_stream)
        obs.mark("launch.spec_fft")
        rc = lib.thesia_spec_fft(
            ptr(rows), c, rows.stride(0) if c > 1 else length, ptr(row_n), length, pad, t0,
            hop, win, n_frames, ptr(window), ptr(gains), n_fft, ptr(tw),
            ptr(lo), ptr(off), ptr(w), ptr(sched), 0 if sched is None else sched.shape[0],
            0 if mel is None else all_cols, col0, n_cols,
            plan.get("frames_per_cta", 0), plan["smem_bytes"], ptr(out),
            ptr(ext), ctypes.c_void_p(None if ext is None else ext.data_ptr() + 4 * c), stream,
        )
    variant = "linear" if mel is None else "mel"
    if rc != 0:
        raise RuntimeError(f"spec_db {variant} kernel launch failed: CUDA error {rc}")
    (spec_db.warm_launches if is_warming() else spec_db.launches)[variant] += 1
    return out if ext is None else (out, *ext.unbind(0))


# kernel launches per variant since the last reset (plain integers): the
# main path's, and apart from them those of the device warmup and the shape
# warmer (runtime.warming())
spec_db.launches = {"mel": 0, "linear": 0}
spec_db.warm_launches = {"mel": 0, "linear": 0}


def reset_launches() -> None:
    for counts in (spec_db.launches, spec_db.warm_launches):
        for k in counts:
            counts[k] = 0
