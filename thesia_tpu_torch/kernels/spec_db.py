"""Fused framed real FFT -> |.| -> (mel) -> dB: the hand-written CUDA kernel and
its plain PyTorch version.

``spec_db`` launches ``csrc/spec_fft.cu`` for CUDA tensors and runs
``spec_db_reference`` (the window-folded DFT as two matrix products, the JAX
package's route) for CPU tensors; any other device, or a CUDA launch that
fails, raises.  The kernel replaces the Pallas kernels ``spec_db_pallas``
(mel, K1) and ``spec_db_pallas_linear`` (linear, K2) in
``tests/pallas_spec.py``.

Frames are read from the reflect-padded rows in place: frame ``t`` of row ``c``
is ``padded[c, t*hop : t*hop + win]``, each sample multiplied by the row's
gain ``gains[c]`` when gains are given (the normalize gain, ``(x * g) * w``
as in the JAX package), windowed by ``window`` (win,) and transformed at
``n_fft`` points (a power of two from 1 to 32768, at least win).

Two ranges serve the device mesh (``parallel/sharding.py``) without a copy:
``padded`` may be a view whose rows lie further apart than its width (the
kernel takes the row stride), so a shard of the "time" axis passes
``padded[:, t0*hop : (t1-1)*hop + win]``; and ``col0``, ``n_cols`` select
the output columns a shard of the "freq" axis writes.  Either range computes
its entries exactly as the whole launch does.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import numpy as np
import torch

from ..dsp.stft import make_dft_matrices
from ..runtime import is_warming
from . import build

MAX_N_FFT = 1 << 15
# complex values of one CTA's FFT buffers (frames per CTA = this / (n_fft/2))
# and threads per CTA (at most MAX_THREADS of csrc/spec_fft.cu): one radix-16
# task per thread at n_fft <= 4096.  Chosen by tools/bench_spec_fft.py on an
# H100 (PERF.md)
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


def spec_db_reference(padded, hop: int, win: int, n_frames: int, cw, sw, mel=None, gains=None,
                      col0: int = 0, n_cols: int | None = None):
    """Plain PyTorch version of the kernel: (C, L) rows -> (C, n_frames, M|F) dB,
    with cw/sw the window-folded DFT matrices (win, F) of ``dft_matrices``;
    ``gains`` (C,) multiplies each row first (the JAX package's
    ``raw * gain``).  ``col0``, ``n_cols``: only those output columns, as
    slices of the linear matrices or of the filterbank."""
    if gains is not None:
        padded = padded * gains[:, None]
    frames = padded.unfold(-1, win, hop)[:, :n_frames]
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
    return db_from_amplitude(out)


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


def twiddle_exponents(n_fft: int) -> np.ndarray:
    """Exponents m of the kernel's twiddles W^m = e^{-2 pi i m / n_fft}, in the
    order its stages read them (csrc/spec_fft.cu, span_planes): the real
    split's W^k for k < h = max(n_fft/2, 1); the radix-2 stage's W^2b for
    b < h/2; then for every span S = 4, 8, .., h the planes W_S^j, W_S^2j,
    W_S^3j (exponent k*j*n_fft/S) for j < S/4."""
    h = max(n_fft // 2, 1)
    parts = [np.arange(h), 2 * np.arange(h // 2)]
    span = 4
    while span <= h:
        j = np.arange(span // 4)
        parts += [k * j * (n_fft // span) for k in (1, 2, 3)]
        span *= 2
    return np.concatenate(parts).astype(np.int64)


def twiddle_table(n_fft: int) -> np.ndarray:
    """(n, 2) f32: (cos, -sin)(2 pi m / n_fft) for the exponents m of
    ``twiddle_exponents``, computed in float64 and rounded once."""
    ang = 2.0 * np.pi * twiddle_exponents(n_fft).astype(np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


_twiddles: dict[tuple[int, torch.device], torch.Tensor] = {}


def _device_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    key = (n_fft, device)
    if key not in _twiddles:
        _twiddles[key] = torch.from_numpy(twiddle_table(n_fft)).to(device)
    return _twiddles[key]


def launch_plan(n_fft: int, n_frames: int, n_rows: int, mel: bool,
                cta_complex: int = CTA_COMPLEX, threads: int = THREADS) -> dict:
    """Frames per CTA, threads, dynamic shared bytes and grid of one launch
    with ``cta_complex`` complex values of frames per CTA."""
    h = max(n_fft // 2, 1)
    frames = max(1, cta_complex // h)
    smem = frames * h * 8 + (frames * (n_fft // 2 + 1) * 4 if mel else 0)
    return {
        "frames_per_cta": frames, "threads": threads, "smem_bytes": smem,
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
                gained: bool = False, col0: int = 0, n_cols: int | None = None) -> dict:
    """What one launch must move and compute, for its bound: ``bytes`` (each
    input read once -- rows of ``row_len`` samples, window, twiddles, the
    packed filterbank of the launch's columns -- and the output written
    once) and ``flop``, the f32 operations that csrc/spec_fft.cu does per
    frame, with h = max(n_fft/2, 1); ``col0``, ``n_cols`` a launch's output
    columns (default all), whose FFT is whole:

    * window: one product per sample, ``win``, and as many again for the
      row's gain when ``gained`` (which reads one f32 per row);
    * h-point complex FFT: 10 per radix-2 butterfly (two complex sums, one
      complex product) and 34 per radix-4 butterfly (ten for the four first
      complex sums and y0, eight for each of the three outputs that take a
      twiddle: a complex sum and a complex product), h/2 and h/4 of them a
      level;
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
        "bytes": 4 * (n_rows * row_len + win + frames * cols + (n_rows if gained else 0))
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


# mel_pack per filterbank tensor: id -> (weak reference, version, pack); the
# shape warmer packs on its own thread
_packs: dict[int, tuple] = {}
_packs_lock = threading.Lock()


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


def _check(padded, hop, win, n_frames, window, n_fft, mel, gains, col0, n_cols) -> None:
    dev = padded.device
    tensors = {"padded": padded, "window": window}
    if mel is not None:
        tensors["mel"] = mel
    if gains is not None:
        tensors["gains"] = gains
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"spec_db: {name} is on {t.device}, padded on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"spec_db: {name} must be float32, got {t.dtype}")
        if name != "padded" and not t.is_contiguous():
            raise ValueError(f"spec_db: {name} must be contiguous")
    if padded.dim() != 2 or window.shape != (win,):
        raise ValueError(f"spec_db: padded {tuple(padded.shape)} must be (C, L), window (win,)")
    if padded.stride(1) != 1 or (padded.shape[0] > 1 and padded.stride(0) < padded.shape[1]):
        raise ValueError(f"spec_db: padded rows must be contiguous, strides {padded.stride()}")
    cols = n_fft // 2 + 1 if mel is None else mel.shape[1]
    if not (0 <= col0 and 0 <= n_cols and col0 + n_cols <= cols):
        raise ValueError(f"spec_db: columns [{col0}, {col0 + n_cols}) of {cols}")
    if not (1 <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"spec_db: n_fft {n_fft} is not a power of two in [1, {MAX_N_FFT}]")
    if mel is not None and (mel.dim() != 2 or mel.shape[0] != n_fft // 2 + 1):
        raise ValueError(f"spec_db: mel {tuple(mel.shape)} vs {n_fft // 2 + 1} bins")
    c, length = padded.shape
    if gains is not None and gains.shape != (c,):
        raise ValueError(f"spec_db: gains {tuple(gains.shape)} must be ({c},), one per row")
    if hop < 1 or not 1 <= win <= n_fft or n_frames < 0 or not 1 <= c <= 65535:
        raise ValueError(f"spec_db: bad framing hop={hop} win={win} n_fft={n_fft} rows={c}")
    if n_frames and (n_frames - 1) * hop + win > length:
        raise ValueError(f"spec_db: {n_frames} frames of {win} at hop {hop} exceed {length}")


def spec_db(padded, hop: int, win: int, n_frames: int, window, n_fft: int, mel=None,
            *, gains=None, col0: int = 0, n_cols: int | None = None,
            cta_complex: int = CTA_COMPLEX, threads: int = THREADS):
    """(C, L) padded f32 rows -> (C, n_frames, M) dB with ``mel`` (F, M), or
    (C, n_frames, F) dB without it; F = n_fft/2 + 1.  ``gains`` (C,) f32, or
    None for none: each row's samples are multiplied by its gain before the
    window (a gain of 1 leaves the output bitwise unchanged).  ``col0``,
    ``n_cols`` (default: every column): only output columns [col0, col0 +
    n_cols), (C, n_frames, n_cols).  ``padded`` may be a view whose rows lie
    further apart than L.  ``cta_complex`` and ``threads`` set the kernel's
    launch plan (``launch_plan``)."""
    if padded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spec_db: no kernel for device {padded.device}")
    all_cols = n_fft // 2 + 1 if mel is None else mel.shape[1]
    if n_cols is None:
        n_cols = all_cols - col0
    _check(padded, hop, win, n_frames, window, n_fft, mel, gains, col0, n_cols)
    if padded.device.type == "cpu":
        cw, sw = dft_matrices(window, n_fft)
        return spec_db_reference(padded, hop, win, n_frames, cw, sw, mel, gains, col0, n_cols)
    c, length = padded.shape
    out = torch.empty((c, n_frames, n_cols), dtype=torch.float32, device=padded.device)
    if n_frames == 0 or n_cols == 0:
        return out
    plan = launch_plan(n_fft, n_frames, c, mel is not None, cta_complex, threads)
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"spec_db: n_fft {n_fft} needs {plan['smem_bytes']} bytes of shared memory")
    lib = build.library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    null = ctypes.c_void_p(None)
    with torch.cuda.device(padded.device):
        tw = _device_twiddles(n_fft, padded.device)
        lo, off, w = _cached_mel_pack(mel) if mel is not None else (None, None, None)
        stream = ctypes.c_void_p(torch.cuda.current_stream(padded.device).cuda_stream)
        rc = lib.thesia_spec_fft(
            ptr(padded), c, padded.stride(0) if c > 1 else length, hop, win, n_frames,
            ptr(window), null if gains is None else ptr(gains), n_fft, ptr(tw),
            null if lo is None else ptr(lo), null if off is None else ptr(off),
            null if w is None else ptr(w), 0 if mel is None else all_cols, col0, n_cols,
            plan["frames_per_cta"], plan["threads"], plan["smem_bytes"], ptr(out), stream,
        )
    variant = "linear" if mel is None else "mel"
    if rc != 0:
        raise RuntimeError(f"spec_db {variant} kernel launch failed: CUDA error {rc}")
    (spec_db.warm_launches if is_warming() else spec_db.launches)[variant] += 1
    return out


# kernel launches per variant since the last reset (plain integers): the
# main path's, and apart from them those of the device warmup and the shape
# warmer (runtime.warming())
spec_db.launches = {"mel": 0, "linear": 0}
spec_db.warm_launches = {"mel": 0, "linear": 0}


def reset_launches() -> None:
    for counts in (spec_db.launches, spec_db.warm_launches):
        for k in counts:
            counts[k] = 0
