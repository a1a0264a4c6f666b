"""Shape warmer: prepays, off the interactive path, what a fresh process
would otherwise pay inside a user's first add or settings change.

Port of ``thesia_tpu/dsp/precompile.py``.  The JAX package AOT-compiles the
XLA programs of the current and neighbouring settings, because an unseen
shape compiles inside the user's call.  On the card nothing is compiled per
shape; what a fresh process pays instead is

  * the first launch of each device program (CUDA loads a kernel's
    module at its first launch), the kernel library, the upload ring and its
    copy stream: ``warm_device``, run once per process by
    ``runtime.device_warmup``;
  * per setting, the host-built tables the engine would otherwise build
    inline: the window, the mel filterbank and its packed form
    (``kernels/spec_db.py: mel_tables``: the flattened schedule or the
    packed bands, as the launch reads it), the FFT kernel's twiddles
    (``_device_twiddles``), and cuFFT's plan where ``use_rfft_for`` routes to
    ``torch.fft``: the jobs of ``spec_jobs_for`` / ``spec_full_job`` /
    ``spec_groups_job``, each ending with one small launch of the kernel
    variant at that setting's statics.

The JAX package's ``quantize_jobs`` has no counterpart: K6's kernel is the
same at every setting's statics, so once the device warmup has launched it
a job per setting prepays nothing (measured in fresh
processes on the card, PERF.md).

The control logic is the JAX package's: ``enabled`` (``THESIA_PRECOMPILE``,
default on), ``neighbor_settings`` (nearest knob first) and
``_detent_index`` are copies of ``thesia_tpu/dsp/precompile.py:48-102``
(``tests/test_torch_hostcopies.py`` pins them), and ``ShapeWarmer`` keeps
``:154-254``: new submissions supersede pending work by generation, jobs
dedup by key, ``interactive()`` pauses job starts, ``drain`` waits, the idle
thread clears its handle under the lock, and jobs wait for the device
warmup.  Where the port differs:

  * a job's make function returns None when there is nothing to warm (the
    JAX one raises, and the warmer skips it silently); a make function or
    job that raises counts in ``failed_count`` and is logged at warning
    level, and the engine later builds the same tables inline;
  * every job runs on the warmer's own CUDA stream under
    ``runtime.warming()``, so its launches and uploads count apart from the
    main path's; the tables it publishes are allocated on the card's default
    stream, the stream the engine computes on, and recorded on the warmer's
    stream while its launch reads them;
  * ``ShapeWarmer.job_ms`` keeps each job kind's milliseconds: what the job
    prepaid is at most that;
  * ``group_signature`` and ``_single_track_bucket`` have no counterpart (the
    port has no wav-size buckets and no batched program); under a device
    mesh (``parallel/sharding.py``, passed as ``shardings`` like the JAX
    hooks pass it) a spectrogram job builds the tables and launches once on
    each distinct device of the mesh, at the column range of that device's
    first shard, since ``calc_specs_batched`` shards every batch then, one
    track or more.

Tests turn the warmer off (``tests/conftest.py`` sets
``THESIA_PRECOMPILE=0``); the warmer's own tests enable it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time

import numpy as np
import torch

from .. import obs, runtime
from ..common.freqscale import FreqScale
from ..parallel import sharding
from .framing import SpecSetting
from .stft import stft_frame_count

log = logging.getLogger(__name__)

# t_overlap detents and win_ms presets the UI exposes
T_OVERLAP_VALUES = (1, 2, 4, 8, 16, 32)
WIN_MS_PRESETS = (10.0, 20.0, 40.0, 80.0)

# frames of a job's small launch
WARM_FRAMES = 17


def enabled() -> bool:
    return os.environ.get("THESIA_PRECOMPILE", "1") != "0"


def neighbor_settings(cur: SpecSetting) -> list[SpecSetting]:
    """Settings one knob away from `cur`, NEAREST knob first: +-1 t_overlap
    detent, the adjacent win_ms presets, the other freq scale, then the long
    tail by distance."""
    out: list[SpecSetting] = []
    seen = {(cur.win_ms, cur.t_overlap, cur.f_overlap, cur.freq_scale)}

    def add(s: SpecSetting):
        k = (s.win_ms, s.t_overlap, s.f_overlap, s.freq_scale)
        if k not in seen:
            seen.add(k)
            out.append(s)

    # detent-distance orderings around the current values
    t_by_dist = sorted(
        T_OVERLAP_VALUES,
        key=lambda t: (abs(_detent_index(T_OVERLAP_VALUES, t)
                           - _detent_index(T_OVERLAP_VALUES, cur.t_overlap)), t),
    )
    w_by_dist = sorted(
        WIN_MS_PRESETS,
        key=lambda w: (abs(_detent_index(WIN_MS_PRESETS, w)
                           - _detent_index(WIN_MS_PRESETS, cur.win_ms)), w),
    )
    other = FreqScale.Linear if cur.freq_scale is FreqScale.Mel else FreqScale.Mel
    # tier 1: one detent away on each knob
    for t in t_by_dist[:3]:  # cur (skipped by seen) + its two neighbors
        add(dataclasses.replace(cur, t_overlap=t))
    for wm in w_by_dist[:3]:
        add(dataclasses.replace(cur, win_ms=wm))
    add(dataclasses.replace(cur, freq_scale=other))
    # tier 2: the remaining detents, still by distance
    for t in t_by_dist[3:]:
        add(dataclasses.replace(cur, t_overlap=t))
    for wm in w_by_dist[3:]:
        add(dataclasses.replace(cur, win_ms=wm))
    return out


def _detent_index(values: tuple, v) -> int:
    """Index of the detent closest to v (v may sit between presets)."""
    return min(range(len(values)), key=lambda i: abs(values[i] - v))


class _Handed:
    """A warm job and the span that handed it to the warmer: the parent of
    its ``warm.<kind>`` root span."""

    __slots__ = ("make", "trace_parent")

    def __init__(self, make, trace_parent):
        self.make = make
        self.trace_parent = trace_parent

    def __call__(self):
        return self.make()


def handed(jobs) -> list:
    """``jobs`` as ``ShapeWarmer.submit`` takes them, each carrying the span
    open here while tracing is on (``obs.current()``)."""
    parent = obs.current()
    return list(jobs) if parent is None else [_Handed(make, parent) for make in jobs]


class ShapeWarmer:
    """Serial background warmer; new submissions supersede pending work.

    Interactive calls (adds, applies, settings changes) take priority:
    `with warmer.interactive():` pauses job starts until the block exits."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._gen = 0
        self._pending = None  # (gen, jobs)
        self._wake = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._compiled: set = set()
        self._interactive_depth = 0
        self.compiled_count = 0
        self.failed_count = 0
        self.job_ms: dict[str, list[float]] = {}
        self._stream = None

    @contextlib.contextmanager
    def interactive(self):
        """Pause new warm-job starts while an interactive op runs."""
        with self._lock:
            self._interactive_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._interactive_depth -= 1
                self._wake.notify_all()

    def submit(self, jobs) -> None:
        """jobs: list of zero-arg callables returning a (dedup_key, run) pair,
        or None when there is nothing to warm; run() does the warm."""
        if not enabled():
            return
        with self._lock:
            self._gen += 1
            self._pending = (self._gen, list(jobs))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="shape-warmer", daemon=True
                )
                self._thread.start()
            self._wake.notify_all()

    def drain(self, timeout: float | None = None) -> bool:
        with self._lock:
            return self._wake.wait_for(lambda: self._pending is None, timeout=timeout)

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None:
                    self._wake.wait(timeout=5.0)
                    if self._pending is None:
                        # idle exit; clear the handle UNDER THE LOCK so a
                        # submit racing this exit sees a dead worker and
                        # restarts one (is_alive() alone races: the thread
                        # can have decided to return but not terminated yet,
                        # stranding the submitted jobs forever)
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                gen, jobs = self._pending
            i = 0
            while i < len(jobs):
                with self._lock:
                    # interactive ops pre-empt the warmer between jobs
                    self._wake.wait_for(lambda: self._interactive_depth == 0)
                    if self._pending is not None and self._pending[0] != gen:
                        break  # superseded
                if not runtime.warmup_done(self.device):
                    # the process's one-time device costs come first (the
                    # interactive add may absorb them meanwhile); start the
                    # background warmup and re-check without consuming a job
                    runtime.device_warmup(background=True, device=self.device)
                    time.sleep(0.25)
                    continue
                make = jobs[i]
                i += 1
                self.run_now(make)
            with self._lock:
                if self._pending is not None and self._pending[0] == gen:
                    self._pending = None
                    self._wake.notify_all()

    def run_now(self, make) -> bool:
        """Build and run one job on the calling thread, unless its key was
        warmed already; True when it ran.  A make function or job that
        raises counts in failed_count."""
        try:
            got = make()
        except Exception:
            self.failed_count += 1
            log.warning("shape warm job could not be built", exc_info=True)
            return False
        if got is None:
            return False
        key, run = got
        if key in self._compiled:
            return False
        t0 = time.perf_counter()
        try:
            with runtime.warming(), self._on_stream(), \
                    obs.root_span(f"warm.{key[0]}", getattr(make, "trace_parent", None)):
                run()
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        except Exception:
            self.failed_count += 1
            log.warning("shape warm job %s failed", key[0], exc_info=True)
            return False
        self._compiled.add(key)
        self.compiled_count += 1
        self.job_ms.setdefault(key[0], []).append((time.perf_counter() - t0) * 1e3)
        return True

    @contextlib.contextmanager
    def _on_stream(self):
        """The warmer's own CUDA stream (none on the CPU)."""
        if self.device.type != "cuda":
            yield
            return
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            yield


@contextlib.contextmanager
def _engine_stream(device: torch.device):
    """Allocate on the stream the engine computes on (the device's default
    stream): the tables a job publishes are the engine's from then on."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.stream(torch.cuda.default_stream(device)):
        yield


def _read_on_current_stream(device: torch.device, tensors) -> None:
    """Order the current (warmer's) stream after the default stream's table
    uploads, and keep the tables' memory from reuse until it has read them."""
    if device.type != "cuda":
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_stream(torch.cuda.default_stream(device))
    for t in tensors:
        t.record_stream(cur)


def _spec_statics(sr: int, setting: SpecSetting, device="cpu"):
    """What a spectrogram launch at (sr, setting) on ``device`` depends on:
    (sr, hop, win, n_fft, use_mel, rfft)."""
    from .spectrogram import use_rfft_for

    hop, win, n_fft = setting.calc_framing_params(sr)
    return (sr, hop, win, n_fft, setting.freq_scale is FreqScale.Mel,
            use_rfft_for(win, n_fft, device))


def _warm_targets(analyzer, statics, shardings) -> list[tuple]:
    """(device, col0, n_cols) of each launch a job makes: the analyzer's
    device with every column, or under a mesh the first shard on each
    distinct device, at its columns (whole on the rfft route)."""
    if shardings is None:
        return [(analyzer.device, 0, None)]
    sr, _hop, _win, n_fft, use_mel, rfft = statics
    cols = analyzer.mel_fb(sr, n_fft).shape[1] if use_mel else n_fft // 2 + 1
    col_blocks = sharding.blocks(cols, shardings.n_freq if shardings.freq_parallel else 1)
    targets, seen = [], set()
    for plane in shardings.devices:
        for row in plane:
            for dev, (c0, c1) in zip(row, col_blocks):
                if dev not in seen:
                    seen.add(dev)
                    targets.append((dev, 0, None) if rfft else (dev, c0, c1 - c0))
    return targets


def _warm_spec(analyzer, statics, shardings=None) -> None:
    """Build the setting's tables where the engine looks for them, then one
    small launch of the spectrogram program at these statics, on every
    device the engine's recompute launches on."""
    from ..kernels.spec_db import _device_twiddles, launch_plan, mel_tables, spec_db
    from .spectrogram import _spec_db_rfft, reflect_pad_rows

    sr, hop, win, n_fft, use_mel, rfft = statics
    for dev, col0, n_cols in _warm_targets(analyzer, statics, shardings):
        with _engine_stream(dev):
            window = analyzer.window(win, n_fft, dev)
            mel = analyzer.mel_fb(sr, n_fft, dev) if use_mel else None
            tables = [window] if mel is None else [window, mel]
            if dev.type == "cuda" and not rfft:
                cols = n_cols if n_cols is not None else (
                    mel.shape[1] if mel is not None else n_fft // 2 + 1) - col0
                if mel is not None:
                    sched, pack = mel_tables(mel, n_fft, win, col0, cols)
                    tables.extend([sched] if sched is not None else pack)
                registers = launch_plan(n_fft, 1, 1, mel is not None, win, cols, (
                    0 if mel is None or sched is None else sched.numel() * 4)
                )["schedule"] == "registers"
                tables.append(_device_twiddles(n_fft, dev, registers))
        _read_on_current_stream(dev, tables)
        n = win + (WARM_FRAMES - 1) * hop
        raw = torch.linspace(-0.5, 0.5, n, device=dev).reshape(1, n)
        frames = stft_frame_count(n, win, hop)
        if rfft:
            _spec_db_rfft(reflect_pad_rows(raw, win // 2), hop, win, frames, window, n_fft, mel)
        else:
            spec_db(raw, hop, win, frames, window, n_fft, mel, pad=win // 2, col0=col0,
                    n_cols=n_cols)


def spec_full_job(analyzer, shape, sr, setting: SpecSetting, shardings=None):
    """Job callable warming one track's spectrogram at `setting`: its tables
    and one small launch (the engine's per-track ``calc_spec_multi``), on
    each device of ``shardings``' mesh when one is given."""

    def make():
        _c, n = shape
        statics = _spec_statics(sr, setting, analyzer.device)
        _sr, hop, win, _n_fft, _mel, _rfft = statics
        if stft_frame_count(n, win, hop) == 0:
            return None  # no frames: nothing runs on the device
        return ("spec_full", statics, shardings), lambda: _warm_spec(analyzer, statics, shardings)

    return make


def spec_groups_job(analyzer, items, setting: SpecSetting, shardings=None):
    """Job callable warming the spectrogram of several tracks at `setting`:
    every distinct (sr, statics) group once, on each device of
    ``shardings``' mesh when one is given."""

    def make():
        groups = []
        for _key, (_c, n), sr in items:
            statics = _spec_statics(sr, setting, analyzer.device)
            _sr, hop, win, _n_fft, _mel, _rfft = statics
            if stft_frame_count(n, win, hop) > 0 and statics not in groups:
                groups.append(statics)
        if not groups:
            return None

        def run():
            for statics in groups:
                _warm_spec(analyzer, statics, shardings)

        return ("spec_groups", tuple(groups), shardings), run

    return make


def spec_jobs_for(analyzer, items, setting: SpecSetting, shardings=None):
    """The spectrogram warm jobs for `items` [(key, (n_ch, n), sr)] under
    `setting` and the active sharding (``sharding.active_spec_sharding()``,
    or None): the single-track job for one track, the group job for more."""
    if len(items) == 1:
        _key, shape, sr = items[0]
        return [spec_full_job(analyzer, shape, sr, setting, shardings)]
    return [spec_groups_job(analyzer, items, setting, shardings)]


def warm_device(device: torch.device) -> None:
    """One small launch of every device program on the main path, the
    kernel library, the upload ring with one pinned upload and one read-back
    (``runtime.device_warmup`` runs it once per process, under
    ``runtime.warming()``, on a stream of its own).

    The input is a second of 48 kHz stereo (and its first channel as a mono
    track): the default setting's framing at the common rate, K1 and K2, the
    row bounds and the global range, K6 (the quantize with a device mip level)
    and a copy of its image to the host, K9 and K8 through their batched wrappers, K4's three
    formats on the upload's copy stream, and cuFFT's first plan, in the
    order a first add and apply reach them; then K9's host tables at the
    common sample rates (``kernels.dynamics.warm_tables``).  Between steps it
    waits while a user's command runs (``runtime.foreground()``)."""
    from ..dynamics import stats_device
    from ..engine.manager import _global_range_device
    from ..kernels import build, pcm
    from ..kernels import dynamics as kdyn
    from ..kernels.images import quantize_mips
    from ..kernels.spec_db import spec_db
    from ..render.colormap import quantize_min_value
    from .spectrogram import SpectrogramAnalyzer
    from .upload import upload

    pause = runtime.yield_to_foreground  # between steps: a command runs first
    torch.zeros(1, device=device)  # the CUDA context
    build.library()
    sr = 48000
    t = np.arange(sr, dtype=np.float64) / sr
    wav = np.stack([0.5 * np.sin(2 * np.pi * 440.0 * t),
                    0.3 * np.sin(2 * np.pi * 1000.0 * t)]).astype(np.float32)
    an = SpectrogramAnalyzer(device)
    stream = torch.cuda.Stream(device)
    items = [(0, wav, sr), (1, wav[:1], sr)]
    with torch.cuda.stream(stream):
        # in the order an add and its apply reach them: the upload, the
        # add's stats (K9), the spectrogram (K1) and its bounds, the apply's
        # range and quantize; then K2, K8, K4 and cuFFT
        pause()
        raw = upload(wav, device).tensor_for()
        raw.cpu()
        pause()
        stats_device.calc_stats_batched(items, device)
        setting = SpecSetting()
        hop, win, n_fft = setting.calc_framing_params(sr)
        window = an.window(win, n_fft)
        mel = an.mel_fb(sr, n_fft)
        bounds = []
        for rows in (raw, raw[:1]):
            pause()
            n_frames = stft_frame_count(rows.shape[1], win, hop)
            gains = torch.full((rows.shape[0],), 0.5, dtype=torch.float32, device=device)
            db, row_min, row_max = spec_db(rows, hop, win, n_frames, window, n_fft, mel,
                                           pad=win // 2, gains=gains, bounds=True)
            bounds.append((row_min, row_max))
        pause()
        gmin, gmax, span = _global_range_device(bounds, 100.0)
        float(gmin), float(gmax)
        img, _mips = quantize_mips(
            db, gmin, span, n_frames, i_start=0, n_rows=db.shape[-1], height=db.shape[-1],
            min_value=quantize_min_value(258), mip_levels=(3,),
        )
        img[0, :, : n_frames // 2].contiguous().cpu()
        for rows in (raw, raw[:1]):
            pause()
            spec_db(rows, hop, win, n_frames, window, n_fft, None, pad=win // 2)
        pause()
        stats_device.limiter_gain_seqs_batched(items[:1], device)
        # K4 on the copy stream, as the big-WAV prefetch runs it
        interleaved = np.ascontiguousarray(wav.T)
        s16 = (interleaved * 32767).astype("<i2").reshape(-1).view(np.uint8)
        s24 = np.ascontiguousarray(
            (interleaved * 8388607).astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        ).reshape(-1)
        for payload, fmt in ((s16, "s16"), (s24, "s24"),
                             (interleaved.reshape(-1).view(np.uint8), "f32")):
            pause()
            up = upload(payload, device)
            with torch.cuda.stream(up.stream):
                if fmt == "s24":
                    pcm.deinterleave_s24(up.tensor, 2)
                else:
                    pcm.deinterleave_flat(
                        up.tensor.view(torch.int16 if fmt == "s16" else torch.float32), 2)
            stream.wait_stream(up.stream)
        pause()
        frames = raw.unfold(-1, win, hop)[:, :WARM_FRAMES] * window
        torch.fft.rfft(frames, n=n_fft).abs()
    stream.synchronize()
    for rate in kdyn.COMMON_RATES:
        pause()
        kdyn.warm_tables(rate)
