#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, one line each (any failure raises and the exit code is non-zero):

1. card    -- nvidia-smi name and power limit, torch's device name.
2. build   -- nvcc builds thesia_tpu_torch/csrc into a shared library; seconds,
              registers, spill bytes and stack of every kernel (ptxas -v; the
              phase fails if a kernel of the main path's sizes, any of
              csrc/dynamics.cu's eight or either of csrc/images.cu's two
              spills or is missing, or a csrc/images.cu kernel has a stack
              frame); g++ builds the port's native host library.
3. kernels -- the fused framed FFT->|.|->mel->dB kernel (mel and linear
              variants) as calc_spec_multi launches it (raw rows, the reflect
              padding in its loader, the row bounds in its epilogue) vs its
              plain PyTorch version (the window-folded DFT as matrix products)
              at the main path's shapes (48 kHz stereo 5 min, 16 kHz mono 60
              s): dB error and -inf mask against the plain version evaluated
              in float64 (the gate: kernels/spec_db.py SCALED_TOL,
              TOP60_TOL_DB) and in float32 (-inf and SCALED_TOL only: its own
              f32 rounding exceeds TOP60_TOL_DB); the folded padding bitwise
              equal to the same kernel on a padded copy, the bounds bitwise
              equal to amin/amax of its output; device ms of the kernel, the
              plain version and torch.fft.rfft of the windowed frames (a
              yardstick the port never calls), each a run of launches between
              two CUDA events (runtime.launch_ms), and the wrapper's host us
              per launch; the bound of the kernel's work on the card.
4. main    -- EngineSession(device="cuda"): init -> add_tracks (a 5-minute
              48 kHz stereo song and a 60-second 16 kHz voice memo, written as
              16-bit WAVs) -> apply_track_list_changes -> metadata ->
              spectrogram tiles -> waveform tile; checks the mel kernel ran,
              every spectrogram tensor is on the card, tile geometry, and the
              device-built mips equal the host mip chain bit for bit.
5. linear  -- set_spec_setting(Linear) -> tile; checks the linear kernel and,
              over phases 4-5, K6's kernel ran.
6. compare -- track 0 channel 0: the kernel's dB vs the plain version on the
              same card, and the u16 image vs the ones quantized from it.
7. dynamics.stats -- back to the default mel setting; stats (K9: LUFS, RMS,
              peak) of both tracks through the device route (K9's kernel,
              csrc/dynamics.cu) and through the native streaming route,
              with times and |dLUFS|; the session's getters, its stats
              bitwise equal to a second kernel call; then (the session's
              shape warmer drained and paused) K9's kernel against its
              plain version (the float64 torch program) on the same device
              rows, group by group: LUFS within 1e-9, peaks
              equal, sums of squares within 1e-12 relative, two calls
              bitwise equal, device ms of both (runtime.launch_ms) and the
              bound (bytes; f64 at 34 TFLOP/s).
8. dynamics.normalize -- set_common_normalize to a LUFS target that keeps
              every track under 0 dBFS: the gain is applied in the kernel
              (no upload), the song's max dB moves by 20 log10(gain).
9. dynamics.limiter -- Limiter mode and a target that drives the song over
              0 dBFS: K8's kernel on the card (its launches are the path
              "dynamics.limiter"), its gains vs the native streaming
              limiter (1e-9), times of both routes, the kernel against its
              plain version as K9's; the limiter gain, guard-clip stats and
              waveform tile; then [dynamics.clip]: Clip, isClipped and the
              pre-clip waveform tile.

10. deferred.main -- a second session on the same song and memo in the
              default, deferred mode: add wall, apply dispatch ms, the first
              tile's ms and whether a region fetch or the host served it,
              settle s (settings_settled + drain + synchronize), the landing's
              CUDA-event ms on the copy stream; then remove and re-add the
              memo (an incremental deferred apply: probe and reconcile).  Every
              u16 image and device mip is bit-equal to phase 4's.
11. deferred.switches -- on that session, deferred: Linear, back to mel, a
              LUFS normalize, the Limiter engaged, Clip (dispatch ms and settle
              s each), then a churn of eight alternating switches that must
              settle with isComputing false everywhere and images bit-equal
              to a synchronous session given the final settings.
12. long.hour16k -- first [dynamics.lecture], a measurement: K9's kernel on
              the lecture alone (device ms, host us, bound) beside the host
              stats' wall (a single-track add takes the host route), and K8's
              on the lecture scaled to a peak of 2 (device ms, host us,
              bound; within 1e-9 of the plain version's stages with each box
              sum taken window by window, k8_windowed, since the plain
              version's cumulative box sums over 57.6 M positions drift by a
              few 1e-9: that difference is reported).  Then a
              new session adds a 1-hour 16 kHz mono lecture (57.6 M
              samples, 360 001 frames x 385 mel rows): add wall, apply
              dispatch ms, the whole-track tile (deepest mip), a mid-track
              full-res tile while streaming, the region-fetch count, settle s,
              landing ms; every tile fetched mid-stream is byte-identical to
              the same tile after the drain.

13. prefetch.s16, prefetch.s24, prefetch.f32 -- the big-WAV prefetch: the
              1-hour 16 kHz lecture (115 MB 16-bit), a 6-minute 48 kHz stereo
              24-bit WAV (104 MB) and a 3-minute 48 kHz stereo float WAV (69
              MB, its data chunk off 4-byte alignment) each added to a new
              session at the default threshold: add wall, adopted and failed
              prefetches (the phase fails unless the prefetch was adopted and
              none failed), bytes uploaded, K4's CUDA-event ms against its
              bound and its plain version, the adopted device wav equal to
              the host decode (torch.equal after a copy back); then apply, and
              every u16 image and device mip bit-equal to a second session
              whose _PREFETCH_MIN_FILE_BYTES lies above the file's size, whose
              add wall stands beside.

14. service -- ``python -m thesia_tpu_torch --port 0`` as a child process on
              the card (deferred mode), driven over HTTP on 127.0.0.1: the
              viewer's files, init, /upload of the memo, add_tracks (the song
              and the uploaded memo), apply (polling isComputing), spectrogram
              and waveform tiles at several levels, the time, frequency, dB
              and amplitude axes, Linear and back to mel, the player with the
              /events WebSocket and /player/pcm, /debug/metrics (the child's
              kernel launches), /debug/profile during a mel->Linear switch
              (its trace must name spec_fft_kernel), malformed requests (no
              500).  An in-process EngineSession() fed the same commands
              through the service's command table gives bit-equal tiles and
              equal axis answers; the line reports the child's start, the
              HTTP wall per command kind measured by a client process of its
              own against the same call in process, the first and warm tile
              over HTTP, the add's and apply's settle and the bytes received
              (the parts of the child's start: tools/profile_service_start.py)
              and the child's shape warmer (compiled, idle, failed: none may
              fail) with its warm launches.  The child must exit on SIGTERM.
15. coldstart -- fresh processes on the card (``tools/coldstart.py``), each
              a session's first commands, in turns with the shape warmer on
              and off (THESIA_PRECOMPILE=0): the song and memo's first add
              (and its stats.batched span), first synchronous apply (and its
              spec.quantize span), first Linear switch and first 20 ms window
              switch (the neighbours the warmer prepared), three processes
              each; the lecture's first add, two each.  Prints the medians of
              both modes; fails unless no warm job failed, the warm launches
              are counted apart (none with the warmer off, some with it on,
              the same main-path launches in both), and every u16 image of a
              warmed process is bit-equal to the unwarmed one's.

After [compare], [mesh.tracks], [mesh.time] and [mesh.freq] run the song +
memo and the 1-hour lecture under virtual device meshes of the card repeated
four times (parallel/sharding.py: (4, 1, 1), (1, 4, 1), (1, 1, 4); the
shards run in turn, so the walls measure the mesh's overhead, not a
speed-up) and, where more than one card is visible, [mesh.cards] under a
"tracks" mesh over every card.  Each line: calc_specs_batched's dB and row
bounds torch.equal to the unsharded analyzer's (mel and linear), with the
launches per variant equal to the shards of the batch; an EngineSession
with the mesh active whose u16 images and device mips after add, apply and
a Linear switch are bit-equal to [main]'s (its launches are the path
"mesh.<name>" of the kernels line); the median wall of the sharded
recompute of song + memo beside the unsharded one; the peer-copy bytes;
each song shard's CUDA-event kernel ms against the bound of its
kernel_work; the card's name and power limit; the seconds since the mesh
phases began.

Phases 4-9 run their commands synchronously (defer=False) and drain the
image streamer inside their clocks, so their walls compare with earlier
runs, where the landing was part of the command.  Phases 10-12 fail on any
settings-switch-failed event and on any failed stream chunk.

After [linear], [upload] reports the [main] add's host-to-device traffic:
the bytes and uploads counted by dsp/upload.py against the tracks' f32
sample bytes (the phase fails unless each track was uploaded once), the copy
stream's CUDA-event ms, the ``spec.h2d_upload`` span, where K9's batch rows
came from (the cached device wav or an upload), and the song's upload alone
on a fresh analyzer.  After [dynamics.clip], [player] drives the session's
playback commands: requested_sr after the apply, set_track_player,
resume/seek/pause, set_volume_db, a remote audio client whose pulled chunks
are byte-equal to the engine fill on the track's interleaved samples, and
player-state-changed events.

Phase 3 also prints [kernels.images.*]: K6 (csrc/images.cu, the u16
quantize and its device mips) at the main path's four images (the song's mel
and linear, the memo's mel in the song's taller image, the 1-hour lecture's
mel; tools/bench_images.py SHAPES) bit-equal to its plain version, with
device ms of both, the bound of images_work and the kernel's share of it,
the peak device MB of a call, the ptxas stack of each k6_* kernel, and its
device kernels (torch.profiler in a fresh process: tools/bench_images.py
--counts); [kernels.dynamics]: the device kernels one
call of K9's kernel launches per (sr, channels) group and K8's
(torch.profiler in a fresh process, at most six a group), beside their
plain versions'; and
[kernels.gain.*]: both kernels with per-row gains != 1
against the plain version with the same gains in float64 (the same gate),
null gains bitwise equal to gains of 1.0, and gains in the kernel bitwise
equal to the kernel on rows multiplied beforehand; device ms by
runtime.launch_ms.

The line before the last is {"kernels": [...]}: K1/K2, K4's two torch
programs, K9, K8 and K6 (launch counts summed over the paths of phases 4-5,
9, 10-14, each
counted from 0 just before its path and read just after -- the service's in
the child, which starts from 0 and reports them in /debug/metrics; the
launches of the device warmup and the shape warmer are counted apart, in
``warm_launches``; errors and times
measured here; for K4 ``max_abs_err`` is the largest |difference| from the
host decode, and plain_ms the JAX package's formulation as torch ops; for K1/K2 ``max_abs_err`` is
the largest |dB difference| from the float32 plain version over every
finite entry of both shapes, ``max_abs_top60_vs_f64`` and
``max_scaled_vs_f64`` the gated errors from the float64 one; for K9 the
largest |dLUFS| from the plain version, for K8 the largest |d gain|, their
times and bounds at the song + memo width and the song's, for K6 the largest
|u16 difference| over the four images and the song's mel image's numbers,
``library_ms`` null: no one PyTorch call computes any of them); the last
line is {"ok": true,
"device": ...}.
It imports numpy, torch and the port, nothing of jax or of the JAX package.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def timed(fn):
    """(result, wall seconds, CUDA-event ms) of one command, synchronized."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, e0.elapsed_time(e1)


def settle(sess) -> None:
    """Every deferred switch applied, every image landed, the card idle."""
    if not (sess.settings_settled(timeout=900) and sess.tm.images.drain(timeout=900)):
        raise AssertionError("the session did not settle within 900 s")
    torch.cuda.synchronize()


def settled(sess, fn):
    """fn() and then settle(sess): a command whose clock covers its landing."""
    out = fn()
    settle(sess)
    return out


def dispatched(sess, fn):
    """(result, dispatch ms, settle s) of a command: the host time until it
    returns, and until the session has settled after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    settle(sess)
    return out, dispatch_ms, time.perf_counter() - t0


class Watch:
    """Records what a session's image store is handed (the device images and
    mips of every quantize, which the store drops once they have landed) and
    the session's settings-switch-failed events."""

    def __init__(self, sess):
        self.sess = sess
        self.entries = {}  # track id -> the latest TrackImages
        self.failures = []
        store = sess.tm.images
        orig = store.set_images

        def recording(track_id, images):
            self.entries[track_id] = (images, images.dev_img, dict(images.dev_mips))
            orig(track_id, images)

        store.set_images = recording
        sess.add_listener(lambda name, payload: self.failures.append((name, payload))
                          if name == "settings-switch-failed" else None)

    def device_mips(self, land_u16) -> dict:
        """{(track, level): host u16 copy of that device mip}."""
        return {(tid, level): land_u16([mip])[0]
                for tid, (_t, _img, mips) in self.entries.items() for level, mip in mips.items()}

    def copy_ms(self) -> float:
        return sum(t.copy_ms for t, _img, _mips in self.entries.values())

    def check_clean(self, where: str) -> None:
        failed = self.sess.tm.images.stream_failures
        retried = {tid: t.stream_retries for tid, (t, _i, _m) in self.entries.items() if t.stream_retries}
        if self.failures or failed or retried:
            raise AssertionError(f"{where}: switch failures {self.failures}, stream failures "
                                 f"{failed}, retries {retried}")


def host_images(sess) -> dict:
    """{(track, channel): u16 copy} of every landed image (drains first)."""
    return {k: np.array(v) for k, v in sess.tm.spec_imgs.items()}


def assert_same_images(where: str, got: dict, want: dict) -> None:
    if got.keys() != want.keys():
        raise AssertionError(f"{where}: image keys {sorted(got)} != {sorted(want)}")
    for k in want:
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{where}: image {k} differs")


def region_fetches(m) -> int:
    return m.obs.summary().get("tile.region_d2h", {}).get("count", 0)


def port_modules() -> SimpleNamespace:
    """The port's modules this script drives.  Imported after the CUDA check,
    so that the script alone, outside the repository, fails before them."""
    from thesia_tpu_torch import native, obs, runtime
    from thesia_tpu_torch.common.freqscale import FreqScale
    from thesia_tpu_torch.dynamics import stats as dyn_stats
    from thesia_tpu_torch.dynamics import stats_device
    from thesia_tpu_torch.dynamics.limiter import PerfectLimiter
    from thesia_tpu_torch.dsp.framing import SpecSetting
    from thesia_tpu_torch.dsp import spectrogram, upload
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer, reflect_pad_rows
    from thesia_tpu_torch.dsp.stft import stft_frame_count
    from thesia_tpu_torch.engine.images import land_u16
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import decode_wav, encode_wav_s16, probe_wav
    from thesia_tpu_torch.kernels import build, pcm, spec_db
    from thesia_tpu_torch.kernels import dynamics as kdyn
    from thesia_tpu_torch.kernels import images as kimages
    from thesia_tpu_torch.parallel import sharding
    from thesia_tpu_torch.player.mixing import render_block
    from thesia_tpu_torch.render import colormap, tiles
    from thesia_tpu_torch.tools import bench_images, profile_dynamics, signals

    return SimpleNamespace(
        native=native, obs=obs, runtime=runtime, dyn_stats=dyn_stats, stats_device=stats_device,
        PerfectLimiter=PerfectLimiter, FreqScale=FreqScale, SpecSetting=SpecSetting,
        SpectrogramAnalyzer=SpectrogramAnalyzer, reflect_pad_rows=reflect_pad_rows,
        stft_frame_count=stft_frame_count, land_u16=land_u16, EngineSession=EngineSession,
        encode_wav_s16=encode_wav_s16, decode_wav=decode_wav, probe_wav=probe_wav, build=build,
        spec_db=spec_db, pcm=pcm, spectrogram=spectrogram, upload=upload,
        render_block=render_block, colormap=colormap, tiles=tiles, signals=signals,
        sharding=sharding, kdyn=kdyn, kimages=kimages, profile_dynamics=profile_dynamics,
        bench_images=bench_images,
    )


K4 = ("deinterleave_flat", "deinterleave_s24")
# the hand kernels besides K1/K2, one entry each: (wrapper name, the module
# of m that holds it, its source, the JAX function it replaces)
HAND = (("lufs_stats", "kdyn", "thesia_tpu_torch/csrc/dynamics.cu",
         "thesia_tpu/dynamics/stats_device.py:264"),  # K9
        ("limiter_gain", "kdyn", "thesia_tpu_torch/csrc/dynamics.cu",
         "thesia_tpu/dynamics/stats_device.py:161"),  # K8
        ("quantize_mips", "kimages", "thesia_tpu_torch/csrc/images.cu",
         "thesia_tpu/engine/images.py:91"))  # K6
DYN = tuple(name for name, *_ in HAND)
# K10's two passes (csrc/dynamics.cu), which replace numpy's gain and guard
# (thesia_tpu/dynamics/guard.py:64-109) and no device program
K10 = ("guard_peak", "guard_apply")


def reset_counts(m) -> None:
    """Every kernel's launch count to 0 (the spectrogram kernel, K4 and the
    HAND kernels), the warm launches' too."""
    m.spec_db.reset_launches()
    m.pcm.reset_launches()
    for module in dict.fromkeys(mod for _n, mod, *_ in HAND):
        getattr(m, module).reset_launches()


def launch_counts(m) -> dict:
    """{kernel: launches since reset_counts}: "mel", "linear", K4's and the
    HAND kernels', and under "warm" those of the device warmup and the shape
    warmer apart."""
    wrappers = {name: getattr(getattr(m, mod), name) for name, mod, *_ in HAND}
    wrappers.update({name: getattr(m.kdyn, name) for name in K10})
    return {**m.spec_db.spec_db.launches, **{k: getattr(m.pcm, k).launches for k in K4},
            **{k: w.launches for k, w in wrappers.items()},
            "warm": {**m.spec_db.spec_db.warm_launches,
                     **{k: getattr(m.pcm, k).warm_launches for k in K4},
                     **{k: w.warm_launches for k, w in wrappers.items()}}}


def dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel, dtype, gains=None):
    """The plain version (window-folded DFT matrices) in ``dtype``, as f32."""
    cw, sw = m.spec_db.dft_matrices(window, n_fft, dtype)
    mel = None if mel is None else mel.to(dtype)
    gains = None if gains is None else gains.to(dtype)
    return m.spec_db.spec_db_reference(
        padded.to(dtype), hop, win, n_frames, cw, sw, mel, gains).float()


def median_wall(fn, reps: int = 3):
    """(last result, median wall seconds) of ``reps`` synchronized calls."""
    walls = []
    for _ in range(reps):
        out, wall, _ms = timed(fn)
        walls.append(wall)
    return out, sorted(walls)[len(walls) // 2]


def kernels_gain_phase(m, dev, analyzer, setting, song_wavs, memo_wavs) -> None:
    """K1 and K2 with per-row gains at the main path's shapes."""
    kern, sig = m.spec_db, m.signals
    for label, wavs, sr, row_gains in (("48k", song_wavs, sig.SONG_SR, (0.3, 1.7)),
                                       ("16k", memo_wavs, sig.MEMO_SR, (1.7,))):
        hop, win, n_fft = setting.calc_framing_params(sr)
        window = analyzer.window(win, n_fft)
        mel = analyzer.mel_fb(sr, n_fft)
        raw = torch.from_numpy(wavs).to(dev)
        pad = win // 2
        padded = m.reflect_pad_rows(raw, pad)
        n_frames = m.stft_frame_count(wavs.shape[1], win, hop)
        n_rows = wavs.shape[0]
        gains = torch.tensor(row_gains, dtype=torch.float32, device=dev)
        ones = torch.ones(n_rows, dtype=torch.float32, device=dev)
        premultiplied = raw * gains[:, None]
        for variant, mel_ in (("mel", mel), ("linear", None)):
            args = (hop, win, n_frames, window, n_fft, mel_)
            got = kern.spec_db(raw, *args, pad=pad, gains=gains)
            null = kern.spec_db(raw, *args, pad=pad)
            null_bitwise = torch.equal(null, kern.spec_db(raw, *args, pad=pad, gains=ones))
            premul_bitwise = torch.equal(got, kern.spec_db(premultiplied, *args, pad=pad))
            ref64 = dft_plain(m, padded, *args, torch.float64, gains)
            torch.cuda.synchronize()
            err = kern.db_error(ref64.cpu().numpy(), got.cpu().numpy())
            del got, null, ref64
            k_ms, k_us, _ = m.runtime.launch_ms(
                lambda: kern.spec_db(raw, *args, pad=pad, gains=gains, bounds=True))
            k0_ms = m.runtime.launch_ms(lambda: kern.spec_db(raw, *args, pad=pad, bounds=True)).ms
            work = kern.kernel_work(n_rows, raw.shape[1], n_frames, win, n_fft, mel_,
                                    gained=True, bounds=True)
            bound_ms, bound_by = m.runtime.bound_ms(work["bytes"], work["flop"])
            phase(f"kernels.gain.{variant}.{label}", gains=list(row_gains),
                  vs_f64_top60=err["max_abs_top60"], vs_f64_scaled=err["max_scaled"],
                  vs_f64_inf_equal=err["inf_equal"], vs_f64_max_abs=err["max_abs"],
                  null_equals_ones_bitwise=null_bitwise,
                  gained_equals_premultiplied_bitwise=premul_bitwise,
                  gained_ms=round(k_ms, 4), gained_host_us=round(k_us, 2),
                  ungained_ms=round(k0_ms, 4), bound_ms=round(bound_ms, 4), bound_by=bound_by)
            if not (kern.within_tolerance(err) and null_bitwise and premul_bitwise):
                raise AssertionError(f"spec_db {variant} {label} with gains: {err}, null "
                                     f"{null_bitwise}, premultiplied {premul_bitwise}")
        del raw, padded, premultiplied


def kernels_phase(m, dev, analyzer, setting, song_wavs, memo_wavs, ptxas) -> dict:
    """[kernels.*]: K1 and K2 as calc_spec_multi launches them at the main
    path's shapes against the plain version; returns the numbers of the
    {"kernels": ...} line."""
    kern, sig = m.spec_db, m.signals
    summary = {"mel": {}, "linear": {}}
    for label, wavs, sr in (("48k", song_wavs, sig.SONG_SR), ("16k", memo_wavs, sig.MEMO_SR)):
        hop, win, n_fft = setting.calc_framing_params(sr)
        window = analyzer.window(win, n_fft)
        mel = analyzer.mel_fb(sr, n_fft)
        raw = torch.from_numpy(wavs).to(dev)
        pad = win // 2
        padded = m.reflect_pad_rows(raw, pad)
        n_frames = m.stft_frame_count(wavs.shape[1], win, hop)
        n_rows = wavs.shape[0]
        xw = (padded.unfold(-1, win, hop)[:, :n_frames] * window).contiguous()
        for variant, mel_ in (("mel", mel), ("linear", None)):
            # as calc_spec_multi launches it: raw rows, the padding in the
            # loader, the row bounds in the epilogue
            launch = lambda: kern.spec_db(raw, hop, win, n_frames, window, n_fft, mel_,  # noqa: E731
                                          pad=pad, bounds=True)
            got, row_min, row_max = launch()
            folded_bitwise = torch.equal(got, kern.spec_db(padded, hop, win, n_frames, window,
                                                           n_fft, mel_))
            bounds_bitwise = (torch.equal(row_min, got.amin(dim=(1, 2)))
                              and torch.equal(row_max, got.amax(dim=(1, 2))))
            ref64 = dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel_, torch.float64)
            ref32 = dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel_, torch.float32)
            torch.cuda.synchronize()
            got_np, ref64_np, ref32_np = got.cpu().numpy(), ref64.cpu().numpy(), ref32.cpu().numpy()
            err64 = kern.db_error(ref64_np, got_np)
            err32 = kern.db_error(ref32_np, got_np)
            plain_err = kern.db_error(ref64_np, ref32_np)
            del got, ref64, ref32, got_np, ref64_np, ref32_np
            cw, sw = kern.dft_matrices(window, n_fft)
            # device ms: a run of launches between two events; host us apart
            k_ms, k_us, _ = m.runtime.launch_ms(launch)
            p_ms, _, p_waited = m.runtime.launch_ms(
                lambda: kern.spec_db_reference(raw, hop, win, n_frames, cw, sw, mel_, pad=pad,
                                               bounds=True), n=20, may_wait=True)
            lib_ms, _, lib_waited = m.runtime.launch_ms(lambda: torch.fft.rfft(xw, n=n_fft),
                                                        may_wait=True)
            cols = n_fft // 2 + 1 if mel_ is None else mel_.shape[1]
            work = kern.kernel_work(n_rows, raw.shape[1], n_frames, win, n_fft, mel_, bounds=True)
            bound_ms, bound_by = m.runtime.bound_ms(work["bytes"], work["flop"])
            phase(f"kernels.{variant}.{label}",
                  shape=(n_rows, n_frames, win, n_fft, cols),
                  vs_f64_top60=err64["max_abs_top60"], vs_f64_scaled=err64["max_scaled"],
                  vs_f64_inf_equal=err64["inf_equal"], vs_f64_max_abs=err64["max_abs"],
                  vs_f32_top60=err32["max_abs_top60"], vs_f32_scaled=err32["max_scaled"],
                  vs_f32_inf_equal=err32["inf_equal"], vs_f32_max_abs=err32["max_abs"],
                  plain_f32_vs_f64_top60=plain_err["max_abs_top60"],
                  folded_padding_bitwise=folded_bitwise, bounds_bitwise=bounds_bitwise,
                  kernel_ms=round(k_ms, 4), kernel_host_us=round(k_us, 2),
                  plain_ms=round(p_ms, 4), library_ms=round(lib_ms, 4),
                  plain_host_waited=p_waited, library_host_waited=lib_waited,
                  bound_ms=round(bound_ms, 4), bound_by=bound_by, mbytes=round(work["bytes"] / 1e6, 2),
                  gflop=round(work["flop"] / 1e9, 3), bound_share=round(bound_ms / k_ms, 4),
                  ptxas=[k for k in ptxas if k["kernel"] == (
                      f"registers<{n_fft // 64},{variant}>" if kern.uses_registers(n_fft)
                      else f"shared<{variant}>")])
            # the gate's reference is the float64 plain version (kernels/
            # spec_db.py: SCALED_TOL); the float32 one must still agree on
            # -inf and on the scaled error
            if not (kern.within_tolerance(err64) and err32["inf_equal"]
                    and err32["max_scaled"] <= kern.SCALED_TOL):
                raise AssertionError(f"spec_db {variant} {label} disagrees with plain: {err64} / {err32}")
            if not (folded_bitwise and bounds_bitwise):
                raise AssertionError(f"spec_db {variant} {label}: folded padding bitwise "
                                     f"{folded_bitwise}, bounds bitwise {bounds_bitwise}")
            s = summary[variant]
            s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err32["max_abs"])
            s["max_abs_top60_vs_f64"] = max(s.get("max_abs_top60_vs_f64", 0.0), err64["max_abs_top60"])
            s["max_scaled_vs_f64"] = max(s.get("max_scaled_vs_f64", 0.0), err64["max_scaled"])
            if label == "48k":
                s.update(ms=k_ms, host_us=k_us, plain_ms=p_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        del raw, padded, xw

    return summary


def span_totals(m) -> dict:
    """Host milliseconds per obs span since the last ``obs.reset()``."""
    return {k: round(v["total_ms"], 1) for k, v in m.obs.summary().items()}


def lufs_close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-9


def fresh_counts(tool: str) -> dict:
    """The device kernels that ``python -m thesia_tpu_torch.tools.<tool>
    --counts`` counts by torch.profiler in a fresh process: later in a
    process that has run thousands of unprofiled kernels, a profile loses
    some of a call's kernels, or all (tools/profile_dynamics.py
    --profiler-check).  Returns {name: {input: count}}."""
    out = subprocess.run([sys.executable, "-m", f"thesia_tpu_torch.tools.{tool}", "--counts"],
                         capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    if out.returncode != 0:
        raise AssertionError(f"the counting process of {tool} failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["device_kernels"]


def dynamics_kernels_phase(m) -> dict:
    """[kernels.dynamics]: the device kernels one call of K9's kernel launches
    for each (sr, channels) group of song + memo, and K8's on the song scaled
    by 3.6, against their plain versions' (at most six a group; fresh_counts
    of tools/profile_dynamics.py).  Returns {name: {group: count}}."""
    counts = fresh_counts("profile_dynamics")
    phase("kernels.dynamics", **counts)
    for name in ("lufs_stats", "limiter_gain"):
        if not all(1 <= c <= m.profile_dynamics.MAX_KERNELS_PER_GROUP for c in counts[name].values()):
            raise AssertionError(f"{name}: device kernels a group {counts[name]}")
    return counts


def images_kernel_phase(m, dev, ptxas) -> dict:
    """[kernels.images.*]: K6 (csrc/images.cu) at the main path's four images
    (tools/bench_images.py SHAPES: dB made on the card from a seed, -inf and
    NaN included) against its plain version on the same inputs, bit for bit:
    device ms of both (runtime.launch_ms; the plain version's with
    host_waited), the bound of images_work, the peak device MB of one call,
    the device kernels a call launches (fresh_counts of
    tools/bench_images.py; the phase fails unless they are k6_quantize and a
    k6_halve for each TILE_LEVELS-th level below the deepest).  Returns the
    numbers of the {"kernels": ...} line (the song's mel image, the apply's
    largest, every shape under by_shape, and the counts)."""
    ki, bi = m.kimages, m.bench_images
    counts = fresh_counts("bench_images")["quantize_mips"]
    out = {"max_abs_err": 0, "by_shape": {}, "device_kernels": counts}
    for name, c, frames, f, i0, rows, height, levels in bi.SHAPES:
        db = bi.make_db(c, frames, f, dev, seed=len(name))
        lo = torch.tensor(bi.LO, dtype=torch.float32, device=dev)
        span = torch.tensor(bi.SPAN, dtype=torch.float32, device=dev)
        kw = dict(i_start=i0, n_rows=rows, height=height, min_value=bi.MIN_VALUE, mip_levels=levels)
        launch = lambda: ki.quantize_mips(db, lo, span, frames, **kw)  # noqa: E731
        plain = lambda: ki.quantize_mips_reference(db, lo, span, frames, **kw)  # noqa: E731
        before = ki.quantize_mips.launches
        got, want = launch(), plain()
        launched = ki.quantize_mips.launches - before
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  for g, w in zip([got[0], *got[1]], [want[0], *want[1]]))
        equal = err == 0 and all(g.shape == w.shape for g, w in zip(got[1], want[1]))
        del got, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launch()
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        k = m.runtime.launch_ms(launch)
        p = m.runtime.launch_ms(plain, n=20, may_wait=True)
        work = ki.images_work(c, rows, height, frames, levels)
        bound, by = m.runtime.bound_ms(work["bytes"], work["flop"])
        device_kernels = counts[name]
        phase(f"kernels.images.{name}", shape=(c, height, frames), rows=(i0, rows), levels=levels,
              bit_equal_plain=equal, max_abs_err=err, kernel_ms=round(k.ms, 4),
              kernel_host_us=round(k.host_us, 2), plain_ms=round(p.ms, 4),
              plain_host_waited=p.host_waited, bound_ms=round(bound, 4), bound_by=by,
              mbytes=round(work["bytes"] / 1e6, 2), bound_share=round(bound / k.ms, 4),
              peak_mb=round(peak_mb, 2), launches=launched, device_kernels=device_kernels,
              ptxas_stack={x["kernel"]: x["stack"] for x in ptxas if x["kernel"].startswith("k6_")},
              ptxas=[x for x in ptxas if x["kernel"].startswith("k6_")])
        designed = 1 + len(range(ki.TILE_LEVELS, max(levels), ki.TILE_LEVELS))
        if not equal or launched != 1 or device_kernels != designed:
            raise AssertionError(f"K6 {name}: max |kernel - plain| {err}, launches {launched}, "
                                 f"device kernels {device_kernels} (designed {designed})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["by_shape"][name] = {"ms": k.ms, "plain_ms": p.ms, "bound_ms": bound,
                                 "peak_mb": peak_mb}
        if name == "song_mel":
            out.update(ms=k.ms, host_us=k.host_us, plain_ms=p.ms, bound_ms=bound, bound_by=by)
        del db
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def warmer_quiet(sess):
    """The session's shape warmer drained and paused (it warms neighbour
    shapes on the card after a settings change), so that a kernel's device
    time measured meanwhile is its own."""
    warmer = sess.tm.shape_warmer
    if not warmer.drain(timeout=300):
        raise AssertionError("the shape warmer did not drain within 300 s")
    with warmer.interactive():
        torch.cuda.synchronize()
        yield


def k9_kernel_check(m, dev, items) -> dict:
    """K9's kernel against its plain version on the same device rows, group
    by group: LUFS within 1e-9, peaks equal, sums of squares within 1e-12
    relative, two kernel calls bitwise equal; device ms and host us of the
    kernel and device ms of the plain version (runtime.launch_ms), the bound
    of the work."""
    kd, sd, rt = m.kdyn, m.stats_device, m.runtime
    out = {"max_abs_err": 0.0, "max_rel_sum_sq": 0.0, "ms": 0.0, "host_us": 0.0, "plain_ms": 0.0,
           "plain_host_waited": False, "bound_ms": 0.0}
    for sr, rows, ns in m.profile_dynamics.group_rows(items, dev):
        label = f"{sr}x{rows.shape[1]}"
        got, again, want = ([t.cpu().numpy() for t in r] for r in (
            kd.lufs_stats(rows, ns, sr), kd.lufs_stats(rows, ns, sr), sd.lufs_program(rows, ns, sr)))
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, again)):
            raise AssertionError(f"K9 {label}: two kernel calls differ: {got} {again}")
        rel = float(np.max(np.abs(got[1] - want[1]) / np.maximum(np.abs(want[1]), 1e-300)))
        if not (all(lufs_close(a, b) for a, b in zip(got[0], want[0])) and rel <= 1e-12
                and np.array_equal(got[2], want[2])):
            raise AssertionError(f"K9 {label}: kernel {got} vs plain {want}")
        finite = np.isfinite(want[0])
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float(np.abs(got[0] - want[0])[finite].max(initial=0.0)))
        out["max_rel_sum_sq"] = max(out["max_rel_sum_sq"], rel)
        ms, host_us, _ = rt.launch_ms(lambda: kd.lufs_stats(rows, ns, sr))
        plain_ms, _, waited = rt.launch_ms(lambda: sd.lufs_program(rows, ns, sr), n=20, warmup=1,
                                           may_wait=True)
        work = kd.lufs_work(ns.tolist(), rows.shape[1], sr)
        bound, out["bound_by"] = rt.bound_ms(work["bytes"], work["flop"], rt.F64_FLOP_PER_S)
        out["ms"] += ms
        out["host_us"] += host_us
        out["plain_ms"] += plain_ms
        out["plain_host_waited"] |= waited
        out["bound_ms"] += bound
    return out


def k8_kernel_check(m, dev, gained, sr) -> dict:
    """K8's kernel against its plain version on the song's device rows (gains
    within 1e-9, two kernel calls bitwise equal), with times and bound as
    k9_kernel_check."""
    kd, sd, rt = m.kdyn, m.stats_device, m.runtime
    p = sd.limiter_params(sr)
    rows = sd._rows_on_device([(0, gained)], gained.shape[0], gained.shape[1] + p["attack"] + 1, dev)
    kw = {"hold_length": p["hold_length"], "box_lengths": p["box_lengths"]}
    kernel = lambda: kd.limiter_gain(rows, 1.0, p["slew"], **kw)  # noqa: E731
    plain = lambda: sd.limiter_gain_program(rows, 1.0, p["slew"], **kw)  # noqa: E731
    got, again, want = kernel(), kernel(), plain()
    if not torch.equal(got, again):
        raise AssertionError("K8: two kernel calls differ")
    err = float((got - want).abs().max())
    if not err <= 1e-9:
        raise AssertionError(f"K8: kernel vs plain {err}")
    del got, again, want
    ms, host_us, _ = rt.launch_ms(kernel)
    plain_ms, _, waited = rt.launch_ms(plain, n=20, warmup=1, may_wait=True)
    work = kd.limiter_work(1, rows.shape[1], rows.shape[2], len(p["box_lengths"]))
    bound, bound_by = rt.bound_ms(work["bytes"], work["flop"], rt.F64_FLOP_PER_S)
    return {"max_abs_err": err, "ms": ms, "host_us": host_us, "plain_ms": plain_ms,
            "plain_host_waited": waited,
            "bound_ms": bound, "bound_by": bound_by}


def dynamics_phases(m, sess, dev, path_launches) -> tuple[dict, dict]:
    """Stats, normalize and guard clipping through the session's commands;
    K9's and K8's kernels against their plain versions.  Returns their
    measurements (k9_kernel_check, k8_kernel_check)."""
    sd, kern, sig = m.stats_device, m.spec_db, m.signals
    tl = sess.tracklist
    policy_device = sd.device_dynamics_preferred()

    # 7. stats: both routes at full width, then the session's getters
    _, mel_s, _ = timed(lambda: settled(sess, lambda: sess.set_spec_setting(
        m.SpecSetting().to_json(), defer=False)))
    items = [(tid, tl[tid].original.wavs, tl[tid].sr) for tid in (0, 1)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sd.reset_launches()
    dev_stats, first_s, first_ms = timed(lambda: sd.calc_stats_batched(items, dev))
    k9_launches = sd.lufs_stats_batched.launches
    k9_peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    _, dev_s = median_wall(lambda: sd.calc_stats_batched(items, dev))

    def native_route():
        with concurrent.futures.ThreadPoolExecutor() as pool:
            stats = pool.map(lambda it: m.dyn_stats.calc_stats(it[1], it[2]), items)
            return dict(zip((0, 1), stats))

    nat_stats, nat_s = median_wall(native_route)
    song_s = [median_wall(lambda: sd.calc_stats_batched(items[:1], dev))[1],
              median_wall(lambda: m.dyn_stats.calc_stats(items[0][1], items[0][2]))[1]]
    dlufs = [abs(dev_stats[t].global_lufs - nat_stats[t].global_lufs) for t in (0, 1)]
    session_route = dev_stats if policy_device else nat_stats
    getters = {t: (sess.get_global_lufs(t), sess.get_rms_db(t), sess.get_max_peak_db(t))
               for t in (0, 1)}
    with warmer_quiet(sess):
        k9 = k9_kernel_check(m, dev, items)
    phase("dynamics.stats", policy_device=policy_device, restore_mel_wall_s=round(mel_s, 4),
          device_first_wall_s=round(first_s, 4), device_first_event_ms=round(first_ms, 3),
          device_wall_s=round(dev_s, 4), native_wall_s=round(nat_s, 4),
          song_device_wall_s=round(song_s[0], 4), song_native_wall_s=round(song_s[1], 4),
          k9_launches=k9_launches, k9_peak_mb=round(k9_peak_mb, 1),
          k9_kernel_ms=round(k9["ms"], 4), k9_kernel_host_us=round(k9["host_us"], 1),
          k9_plain_ms=round(k9["plain_ms"], 3), k9_plain_host_waited=k9["plain_host_waited"],
          k9_bound_ms=round(k9["bound_ms"], 4),
          k9_bound_by=k9["bound_by"],
          k9_max_abs_lufs_vs_plain=k9["max_abs_err"], k9_max_rel_sum_sq=k9["max_rel_sum_sq"],
          dlufs=dlufs, getters=getters)
    for t in (0, 1):
        a, b = dev_stats[t], nat_stats[t]
        if not (dlufs[t] <= 1e-9 and a.max_peak == b.max_peak and a.max_peak_db == b.max_peak_db
                and abs(a.rms_db - b.rms_db) < 1e-5):
            raise AssertionError(f"track {t} stats: device {a} vs native {b}")
        if tl[t].original.stats != session_route[t]:
            raise AssertionError(f"track {t}: session stats {tl[t].original.stats} "
                                 f"are not the {'device' if policy_device else 'native'} route's")
        if getters[t][0] != {"type": "Finite", "value": tl[t].stats.global_lufs}:
            raise AssertionError(f"get_global_lufs({t}) = {getters[t][0]}")
    if k9_launches != 2:
        raise AssertionError(f"K9 ran {k9_launches} times for two (sr, channels) groups")

    # 8. normalize with the guard a no-op: the gain goes into the kernel
    stats = [tl[t].original.stats for t in (0, 1)]
    target = min(st.global_lufs - st.max_peak_db for st in stats) - 3.0
    max_before = float(sess.tm.specs[0].row_max.max())
    kern.reset_launches()
    m.obs.reset()
    _, norm_s, norm_ms = timed(lambda: settled(sess, lambda: sess.set_common_normalize(
        {"type": "LUFS", "target": target}, defer=False)))
    norm_spans = span_totals(m)
    uploads = m.obs.summary().get("spec.h2d_upload", {}).get("count", 0)
    launches = dict(kern.spec_db.launches)
    gains = [tl[t].device_scalar_gain() for t in (0, 1)]
    moved = float(sess.tm.specs[0].row_max.max()) - max_before
    want = 20.0 * np.log10(float(np.float32(gains[0])))
    tile = m.tiles.decode_spectrogram_tile(sess.get_spectrogram_tile("0_0", 0, 0, 0, 0))
    phase("dynamics.normalize", target_lufs=round(target, 4), gains=gains,
          wall_s=round(norm_s, 4), event_ms=round(norm_ms, 3), launches=launches,
          h2d_uploads=uploads, spans_ms=norm_spans, song_max_db_moved=moved, want_db=want,
          get_common_normalize=sess.get_common_normalize(), tile_width=tile["width"])
    if None in gains or 1.0 in gains or uploads != 0 or launches["mel"] != 2:
        raise AssertionError(f"normalize: gains {gains}, uploads {uploads}, {launches}")
    if abs(moved - want) > kern.TOP60_TOL_DB:
        raise AssertionError(f"song max dB moved {moved}, want {want}")

    # 9. Limiter, then Clip
    _, lim_s, lim_ms = timed(lambda: settled(sess, lambda: sess.set_common_guard_clipping(
        "Limiter", defer=False)))
    song = tl[0]
    hot = stats[0].global_lufs - stats[0].max_peak_db + 6.0
    sd.reset_launches()
    reset_counts(m)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m.obs.reset()
    _, hot_s, hot_ms = timed(lambda: settled(sess, lambda: sess.set_common_normalize(
        {"type": "LUFS", "target": hot}, defer=False)))
    path_launches["dynamics.limiter"] = launch_counts(m)
    hot_spans = span_totals(m)
    k8_launches = sd.limiter_gain_seqs_batched.launches
    k8_peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    hot_launches = dict(kern.spec_db.launches)
    g = np.float32(song.audio.applied_scalar_gain)
    gained = (g * song.original.wavs).astype(np.float32)
    native_seq, nat_lim_s = median_wall(lambda: m.PerfectLimiter(sig.SONG_SR).calc_gain_seq(gained))
    dev_seq, dev_lim_s = median_wall(
        lambda: sd.limiter_gain_seqs_batched([(0, gained, sig.SONG_SR)], dev)[0])
    seq_err = float(np.abs(dev_seq - native_seq).max())
    stored_err = float(np.abs(song.audio.guard_clip_result.gain_seq[0]
                              - native_seq.astype(np.float32)).max())
    limiter_gain = sess.get_limiter_gain(0)
    gcs = sess.get_guard_clip_stats(0)
    rev = sess.tile_cache.waveform_revision
    wtile = sess.get_waveform_tile("0_0", 4, 0)
    limited_tile = wtile == m.tiles.encode_waveform_tile(song.audio.wavs[0], rev, 4, 0)
    unlimited_tile = wtile == m.tiles.encode_waveform_tile(gained[0], rev, 4, 0)
    with warmer_quiet(sess):
        k8 = k8_kernel_check(m, dev, gained, sig.SONG_SR)
    phase("dynamics.limiter", set_limiter_wall_s=round(lim_s, 4), set_limiter_event_ms=round(lim_ms, 3),
          target_lufs=round(hot, 4), song_gain=float(g), normalize_wall_s=round(hot_s, 4),
          normalize_event_ms=round(hot_ms, 3), spans_ms=hot_spans, k8_launches=k8_launches,
          launches=hot_launches,
          k8_peak_mb=round(k8_peak_mb, 1), device_wall_s=round(dev_lim_s, 4),
          native_wall_s=round(nat_lim_s, 4),
          k8_kernel_ms=round(k8["ms"], 4), k8_kernel_host_us=round(k8["host_us"], 1),
          k8_plain_ms=round(k8["plain_ms"], 3), k8_plain_host_waited=k8["plain_host_waited"],
          k8_bound_ms=round(k8["bound_ms"], 4),
          k8_bound_by=k8["bound_by"], k8_max_abs_vs_plain=k8["max_abs_err"],
          kernel_launches=path_launches["dynamics.limiter"],
          max_abs_gain_vs_native=seq_err, stored_f32_vs_native=stored_err,
          min_gain=float(native_seq.min()), limiter_gain_len=len(limiter_gain or []),
          guard_clip_stats=gcs, waveform_tile_is_limited=limited_tile)
    if policy_device and (k8_launches < 1 or path_launches["dynamics.limiter"]["limiter_gain"] < 1):
        raise AssertionError("the Limiter switch did not run K8's kernel on the card")
    if not (seq_err <= 1e-9 and stored_err <= 1e-6 and limiter_gain and min(limiter_gain) < 1.0
            and gcs and "reduced by" in gcs[0][1] and limited_tile and not unlimited_tile):
        raise AssertionError(f"limiter: gains {seq_err} / {stored_err}, stats {gcs}, "
                             f"tile limited {limited_tile} unlimited {unlimited_tile}")
    _, clip_s, clip_ms = timed(lambda: settled(sess, lambda: sess.set_common_guard_clipping(
        "Clip", defer=False)))
    meta = sess.get_audio_render_metadata("0_0")
    before = song.audio.guard_clip_result.wav_before_clip
    wtile = sess.get_waveform_tile("0_0", 4, 0)
    clip_tile = wtile == m.tiles.encode_waveform_tile(before[0], sess.tile_cache.waveform_revision, 4, 0)
    gcs = sess.get_guard_clip_stats(0)
    phase("dynamics.clip", wall_s=round(clip_s, 4), event_ms=round(clip_ms, 3),
          is_clipped=meta["isClipped"], waveform_tile_is_pre_clip=clip_tile,
          guard_clip_stats=gcs, max_abs_sample=float(np.abs(song.audio.wavs).max()))
    if not (meta["isClipped"] and clip_tile and gcs and float(np.abs(song.audio.wavs).max()) <= 1.0):
        raise AssertionError(f"clip: metadata {meta}, tile {clip_tile}, stats {gcs}")
    return k9, k8


def guard_kernel_phase(m, dev, tracks) -> dict:
    """[kernels.guard]: K10's two passes against their plain versions on the
    card at each of ``tracks``' shapes (the song's and the memo's), each
    mode, bit for bit (NaN, infinities, -0, a subnormal, exact +-1 and the
    top of the range planted at the start), two kernel calls alike; device
    ms, host us, the plain version's ms and the bound of each.  Returns the
    kernel entry's numbers at the first shape, the passes of a Clip turn
    summed."""
    kd, sd, rt = m.kdyn, m.stats_device, m.runtime

    def bits(outs):
        return [None if t is None else t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in outs]

    def same(a, b):
        return all((p is None and q is None) or (p is not None and q is not None and torch.equal(p, q))
                   for p, q in zip(bits(a), bits(b)))

    shapes = {}
    for label, wavs in tracks.items():
        host = np.array(wavs, np.float32)
        host[0, :8] = (np.nan, np.inf, -np.inf, -0.0, 1e-40, 1.0, -1.0, 3.4e38)
        x = torch.from_numpy(host).to(dev)
        c, n = host.shape
        gain = 1.7
        seq = torch.from_numpy(np.random.default_rng(0).uniform(0.25, 1.0, n)).to(dev)
        seq[::3] = 1.0
        cases = {"peak": (None, lambda: kd.guard_peak(x, gain, True),
                          lambda: sd.guard_peak_program(x, gain, True))}
        for name, mode, scale in (("gain", kd.GUARD_GAIN, 1.0), ("clip", kd.GUARD_CLIP, 1.0),
                                  ("scale", kd.GUARD_SCALE, 1.0 / 1.7), ("seq", kd.GUARD_SEQ, 1.0)):
            gs = seq if mode == kd.GUARD_SEQ else None
            cases[name] = (
                mode, lambda mode=mode, scale=scale, gs=gs: kd.guard_apply(x, gain, mode, scale, gs),
                lambda mode=mode, scale=scale, gs=gs: sd.guard_apply_program(x, gain, mode, scale, gs))
        out = {}
        for name, (mode, kernel, plain) in cases.items():
            got, again, want = kernel(), kernel(), plain()
            if not (same(got, want) and same(got, again)):
                raise AssertionError(f"K10 {label} {name}: the kernel differs from its plain "
                                     f"version or itself")
            del got, again, want
            ms, host_us, _ = rt.launch_ms(kernel)
            plain_ms, _, waited = rt.launch_ms(plain, n=20, warmup=1, may_wait=True)
            work = kd.guard_work(c, n, mode, keep=True)
            bound, bound_by = rt.bound_ms(work["bytes"], work["flop"])
            out[name] = {"ms": round(ms, 4), "host_us": round(host_us, 1),
                         "plain_ms": round(plain_ms, 4), "plain_host_waited": waited,
                         "bound_ms": round(bound, 4), "bound_by": bound_by,
                         "roofline_pct": round(100.0 * bound / ms, 1)}
        shapes[label] = {"shape": (c, n), **out}
        del x, seq
    phase("kernels.guard", routes=dict(sd.guard_routes), **shapes)
    turn = [shapes[next(iter(tracks))][k] for k in ("peak", "clip")]  # a Clip turn's passes
    return {"max_abs_err": 0.0, "ms": sum(p["ms"] for p in turn),
            "host_us": sum(p["host_us"] for p in turn),
            "plain_ms": sum(p["plain_ms"] for p in turn),
            "bound_ms": sum(p["bound_ms"] for p in turn), "bound_by": "bytes"}


def k8_windowed(sd, rows, threshold, slew, hold_length, box_lengths):
    """K8's function as the plain version computes it, but each box filter's
    moving sum taken window by window instead of as a difference of running
    sums: on the lecture's 57.6 M positions the plain version's cumsum reaches
    about 6e7, where one rounding is 7e-9, so its box means drift by a few
    1e-9; a window's own sum of at most 98 terms near 1 errs by about 1e-14."""
    a = rows.abs()
    v = torch.where(torch.isnan(a), -torch.inf, a).amax(dim=1).to(torch.float64)
    one = torch.ones((), dtype=torch.float64, device=v.device)
    raw = torch.where(v > threshold, threshold / (v + sd._F64_EPS), one)
    sm = sd._release_scan(sd._sliding_min(raw, max(hold_length, 1)), slew)
    for length in box_lengths:
        if length > 1:
            pre = torch.ones((sm.shape[0], length - 1), dtype=sm.dtype, device=sm.device)
            sm = torch.cat([pre, sm], dim=1).unfold(1, length, 1).sum(dim=-1) / length
    return torch.minimum(sm, one)


def lecture_stats_phase(m, dev, wav) -> None:
    """[dynamics.lecture]: K9's kernel on the 1-hour 16 kHz lecture alone, a
    measurement (a single-track add takes the host route): device ms and host
    us, against the host stats' wall and LUFS; then K8's kernel on the
    lecture scaled to a peak of 2 (as [dynamics.limiter] scales the song):
    device ms, host us and bound, held within 1e-9 of ``k8_windowed`` (the
    plain version's difference from both is reported: its cumsum box sums
    drift on rows this long)."""
    sr, rt, kd, sd = m.signals.LECTURE_SR, m.runtime, m.kdyn, m.stats_device
    (_sr, rows, ns), = m.profile_dynamics.group_rows([(0, wav, sr)], dev)
    lufs = float(kd.lufs_stats(rows, ns, sr)[0])
    ms, host_us, _ = rt.launch_ms(lambda: kd.lufs_stats(rows, ns, sr), n=20)
    host, host_s = median_wall(lambda: m.dyn_stats.calc_stats(wav, sr))
    work = kd.lufs_work([wav.shape[1]], 1, sr)
    del rows
    gained = (wav * np.float32(2.0 / np.abs(wav).max())).astype(np.float32)
    p = sd.limiter_params(sr)
    rows = sd._rows_on_device([(0, gained)], 1, gained.shape[1] + p["attack"] + 1, dev)
    kw = {"hold_length": p["hold_length"], "box_lengths": p["box_lengths"]}
    kernel = lambda: kd.limiter_gain(rows, 1.0, p["slew"], **kw)  # noqa: E731
    got, again = kernel(), kernel()
    if not torch.equal(got, again):
        raise AssertionError("K8 on the lecture: two kernel calls differ")
    windowed = k8_windowed(sd, rows, 1.0, p["slew"], **kw)
    plain = sd.limiter_gain_program(rows, 1.0, p["slew"], **kw)
    k8_err = float((got - windowed).abs().max())
    k8_plain_err = float((got - plain).abs().max())
    plain_windowed_err = float((plain - windowed).abs().max())
    del got, again, windowed, plain
    k8_ms, k8_host_us, _ = rt.launch_ms(kernel, n=20)
    k8_work = kd.limiter_work(1, 1, rows.shape[2], len(p["box_lengths"]))
    phase("dynamics.lecture", samples=wav.shape[1], k9_kernel_ms=round(ms, 4),
          k9_kernel_host_us=round(host_us, 1),
          k9_bound_ms=round(rt.bound_ms(work["bytes"], work["flop"], rt.F64_FLOP_PER_S)[0], 4),
          host_stats_wall_s=round(host_s, 4), dlufs_vs_host=abs(lufs - host.global_lufs),
          k8_kernel_ms=round(k8_ms, 4), k8_kernel_host_us=round(k8_host_us, 1),
          k8_bound_ms=round(rt.bound_ms(k8_work["bytes"], k8_work["flop"], rt.F64_FLOP_PER_S)[0], 4),
          k8_max_abs_vs_windowed=k8_err, k8_max_abs_vs_plain=k8_plain_err,
          plain_max_abs_vs_windowed=plain_windowed_err)
    if not lufs_close(lufs, host.global_lufs):
        raise AssertionError(f"lecture LUFS: kernel {lufs} vs host {host.global_lufs}")
    if not k8_err <= 1e-9:
        raise AssertionError(f"K8 on the lecture: {k8_err} from the windowed box sums")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    m = port_modules()
    kern = m.spec_db

    # 1. card
    card = m.runtime.card_description()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    phase("card", nvidia_smi=repr(card), torch_name=repr(kind), count=torch.cuda.device_count())
    dev = m.runtime.resolve_device("cuda")

    # 2. build
    m.build.library()
    ptxas = m.build.ptxas_report(m.build.build_info["log"])
    t0 = time.perf_counter()
    native_ok = m.native.available()
    phase("build", seconds=round(m.build.build_info["seconds"], 3),
          compiled=m.build.build_info["compiled"],
          kernels={k["kernel"]: (k["registers"], k["spill_stores"], k["spill_loads"], k["stack"])
                   for k in ptxas},
          native=native_ok, native_seconds=round(time.perf_counter() - t0, 3))
    if not native_ok:
        raise RuntimeError("the port's native host library did not build")
    # the main path's sizes (n_fft 1024 and 2048: 16 and 32 lanes a frame)
    main_kernels = [k for k in ptxas if k["kernel"] in
                    {f"registers<{lanes},{v}>" for lanes in (16, 32) for v in ("mel", "linear")}]
    if len(main_kernels) != 4 or any(k["spill_stores"] for k in main_kernels):
        raise AssertionError(f"the main path's kernels spill or are missing: {main_kernels}")
    dyn_kernels = [k for k in ptxas if k["kernel"].startswith(("k9_", "k8_", "k10_"))]
    if len(dyn_kernels) != 13 or any(k["spill_stores"] for k in dyn_kernels):
        raise AssertionError(f"csrc/dynamics.cu's kernels spill or are missing: {dyn_kernels}")
    img_kernels = [k for k in ptxas if k["kernel"].startswith("k6_")]
    if len(img_kernels) != 2 or any(k["stack"] or k["spill_stores"] or k["spill_loads"]
                                    for k in img_kernels):
        raise AssertionError(f"csrc/images.cu's kernels spill, use stack or are missing: "
                             f"{img_kernels}")

    # 3. kernels vs plain at the main path's shapes
    sig = m.signals
    rng = np.random.default_rng(0)
    song_wavs, memo_wavs = sig.song(rng), sig.voice_memo(rng)
    analyzer = m.SpectrogramAnalyzer(dev)
    setting = m.SpecSetting()
    summary = kernels_phase(m, dev, analyzer, setting, song_wavs, memo_wavs, ptxas)
    kernels_gain_phase(m, dev, analyzer, setting, song_wavs, memo_wavs)
    dyn_counts = dynamics_kernels_phase(m)
    k6 = images_kernel_phase(m, dev, ptxas)

    # 4. main path (synchronous commands; the clock covers the landing)
    work = Path(tempfile.mkdtemp(prefix="thesia_chip_smoke_"))
    atexit.register(shutil.rmtree, work, True)  # about 0.5 GB of WAVs
    paths = [str(work / "song_48k_stereo.wav"), str(work / "memo_16k_mono.wav")]
    Path(paths[0]).write_bytes(m.encode_wav_s16(song_wavs, sig.SONG_SR))
    Path(paths[1]).write_bytes(m.encode_wav_s16(memo_wavs, sig.MEMO_SR))
    cmap = m.colormap.default_colormap_rgba8().reshape(-1).tolist()
    sess = m.EngineSession(settings_dir=work / "config")
    if sess.device != dev:
        raise AssertionError(f"EngineSession() runs on {sess.device}, not on {dev}")
    sess.init(cmap)
    watch = Watch(sess)
    reset_counts(m)
    m.stats_device.reset_launches()
    m.upload.reset_counters()
    m.obs.reset()
    added, add_s, add_ms = timed(lambda: sess.add_tracks([0, 1], paths))
    add_spans = span_totals(m)
    mel_after_add = kern.spec_db.launches["mel"]
    k9_in_add = m.stats_device.lufs_stats_batched.launches
    add_upload = {**m.upload.counters, "copy_stream_ms": m.upload.copy_stream_ms(),
                  "rows_from": dict(m.stats_device.rows_from)}
    if added != [0, 1] or mel_after_add < 1:
        raise AssertionError(f"add_tracks added {added}, mel kernel launches {mel_after_add}")
    m.obs.reset()
    updated, apply_s, apply_ms = timed(
        lambda: settled(sess, lambda: sess.apply_track_list_changes(defer=False)))
    apply_spans = span_totals(m)
    add_upload["uploads_after_apply"] = m.upload.counters["uploads"]
    requested_sr = sess.player.requested_sr
    if requested_sr != max(sig.SONG_SR, sig.MEMO_SR):
        raise AssertionError(f"player.requested_sr {requested_sr} after the apply")
    meta = {k: sess.get_audio_render_metadata(k) for k in ("0_0", "1_0")}
    for tid, res in sess.tm.specs.items():
        if not (res.db.device == res.row_min.device == res.row_max.device == dev):
            raise AssertionError(f"track {tid} spectrogram is not on the card")
    tile_checks = []
    first = None
    mid = {tid: sess.tm.images.geometry(tid)[1] // 512 // 2 for tid in (0, 1)}
    for args in (("0_0", 0, 0, 0, 0), ("0_1", 0, 0, mid[0], 0), ("1_0", 0, 0, mid[1], 0),
                 ("0_0", 5, 0, 0, 0)):
        tile, tile_s, tile_ms = timed(lambda: sess.get_spectrogram_tile(*args))
        first = first or (tile_s, tile_ms)
        d = m.tiles.decode_spectrogram_tile(tile)
        tid = int(args[0].split("_")[0])
        h, w = sess.tm.images.geometry(tid)
        g = m.tiles.spectrogram_tile_geometry(h, w, *args[1:])
        if (d["width"], d["height"]) != (g["width"], g["height"]) or g["width"] == 0:
            raise AssertionError(f"tile {args}: {d['width']}x{d['height']} vs {g}")
        if len(tile) != 40 + 4 * g["width"] * g["height"]:
            raise AssertionError(f"tile {args}: {len(tile)} bytes")
        tile_checks.append(f"{args[0]}@{args[1]}/{args[3]}:{d['width']}x{d['height']}")
    sync_images = host_images(sess)
    sync_mips = watch.device_mips(m.land_u16)
    for (tid, level), dev_mip in sync_mips.items():
        for ch in range(dev_mip.shape[0]):
            if not np.array_equal(dev_mip[ch], sess.tm.images.host_image(tid, ch).mips()[level - 1]):
                raise AssertionError(f"track {tid} ch {ch}: device mip {level} != host chain")
    wtile = m.tiles.decode_waveform_tile(sess.get_waveform_tile("0_0", 4, 0))
    if wtile["binCount"] != 1024 or not np.isfinite(wtile["bins"]).all():
        raise AssertionError(f"waveform tile: {wtile['binCount']} bins")
    phase("main", added=added, updated=updated,
          add_wall_s=round(add_s, 4), add_event_ms=round(add_ms, 3),
          apply_wall_s=round(apply_s, 4), apply_event_ms=round(apply_ms, 3),
          apply_spans_ms=apply_spans, sync_landing_copy_stream_ms=round(watch.copy_ms(), 3),
          first_tile_wall_s=round(first[0], 5), first_tile_event_ms=round(first[1], 3),
          add_spans_ms=add_spans, mel_launches_in_add=mel_after_add, k9_launches_in_add=k9_in_add,
          tiles=tile_checks,
          device_mip_levels_equal=len(sync_mips),
          spec_shapes={k: tuple(v.db.shape) for k, v in sess.tm.specs.items()},
          image_geometry={k: (m_["spectrogramHeight"], m_["spectrogramWidth"])
                          for k, m_ in meta.items()},
          max_db=sess.get_max_db(), min_db=sess.get_min_db(), player_requested_sr=requested_sr)
    if not sync_mips:
        raise AssertionError("no device mip level was checked")

    # 5. linear
    _, set_s, set_ms = timed(lambda: settled(sess, lambda: sess.set_spec_setting(LINEAR, defer=False)))
    tile, tile_s, tile_ms = timed(lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0))
    d = m.tiles.decode_spectrogram_tile(tile)
    h, w = sess.tm.images.geometry(0)
    g = m.tiles.spectrogram_tile_geometry(h, w, 0, 0, 0, 0)
    launches = launch_counts(m)
    path_launches = {"main": dict(launches)}
    if (min(launches["linear"], launches["quantize_mips"]) < 1
            or (d["width"], d["height"]) != (g["width"], g["height"])):
        raise AssertionError(f"linear: launches {launches}, tile {d['width']}x{d['height']} vs {g}")
    if sess.tm.setting.freq_scale is not m.FreqScale.Linear:
        raise AssertionError("set_spec_setting did not switch to Linear")
    phase("linear", set_wall_s=round(set_s, 4), set_event_ms=round(set_ms, 3),
          tile_wall_s=round(tile_s, 5), tile_event_ms=round(tile_ms, 3),
          launches=launches, image_height=h)
    linear_images = host_images(sess)
    linear_mips = watch.device_mips(m.land_u16)
    upload_phase(m, sess, dev, add_upload, add_spans)

    # 6. compare the main path's kernel output with the plain version
    res = sess.tm.specs[0]
    hop, win, n_fft = sess.tm.setting.calc_framing_params(sig.SONG_SR)
    window = sess.tm.spec_analyzer.window(win, n_fft)
    raw = torch.from_numpy(sess.tracklist[0].audio.wavs[:1]).to(dev)
    padded = m.reflect_pad_rows(raw, win // 2)
    lo, span_ = sess.tm._quant_scalars()
    got_u16 = np.asarray(sess.tm.images.host_image(0, 0))
    fields = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        ref = dft_plain(m, padded, hop, win, res.n_frames, window, n_fft, None, dtype)
        err = kern.db_error(ref.cpu().numpy(), res.db[:1].cpu().numpy())
        ref_img, _ = sess.tm.quantize(sig.SONG_SR, ref.contiguous(), res.n_frames, lo, span_)
        ref_u16 = m.land_u16([ref_img])[0][0]
        fields.update({
            f"{name}_max_abs_db_top60": err["max_abs_top60"], f"{name}_max_scaled": err["max_scaled"],
            f"{name}_inf_equal": err["inf_equal"],
            f"{name}_u16_pixels_differ": float(np.mean(ref_u16 != got_u16)),
            f"{name}_u16_max_step": int(np.abs(ref_u16.astype(np.int64) - got_u16).max()),
        })
        if name == "f64" and not kern.within_tolerance(err):
            raise AssertionError(f"main-path dB disagrees with plain: {err}")
        if not (err["inf_equal"] and err["max_scaled"] <= kern.SCALED_TOL):
            raise AssertionError(f"main-path dB disagrees with the {name} plain version: {err}")
    phase("compare", track="0_0", **fields)

    # the device mesh: virtual meshes of this card, and the cards when more
    # than one is visible
    t0 = time.perf_counter()
    lecture_wav = sig.lecture(np.random.default_rng(1))
    lecture_make_s = time.perf_counter() - t0
    mesh_phases(m, dev, work, paths, cmap, (song_wavs, memo_wavs, lecture_wav),
                {"mel": (sync_images, sync_mips), "linear": (linear_images, linear_mips)},
                path_launches)
    del linear_images, linear_mips

    # 7-9. dynamics, then the player
    k9, k8 = dynamics_phases(m, sess, dev, path_launches)
    with warmer_quiet(sess):
        k10 = guard_kernel_phase(m, dev, {"song": sess.tracklist[0].original.wavs,
                                          "memo": sess.tracklist[1].original.wavs})
    player_phase(m, sess)
    watch.check_clean("phases 4-9")
    del sess, watch

    # 10-12. the deferred engine (the default mode)
    os.environ.pop("THESIA_DEFER_SETTINGS", None)
    sess2, watch2 = deferred_main_phase(m, work, paths, cmap, sync_images, sync_mips, path_launches)
    deferred_switches_phase(m, work, paths, cmap, sess2, watch2, path_launches)
    del sess2, watch2
    lecture_stats_phase(m, dev, lecture_wav)
    lecture = long_phase(m, work, cmap, path_launches, lecture_wav, lecture_make_s)
    del lecture_wav

    # 13. the big-WAV prefetch of each format
    k4 = {}
    rng = np.random.default_rng(2)
    files = (("s16", lecture, sig.LECTURE_SR),
             ("s24", (sig.song(rng, 360.0), False), sig.SONG_SR),
             ("f32", (sig.song(rng, 180.0), True), sig.SONG_SR))
    for fmt, source, sr in files:
        if isinstance(source, Path):
            path = source
        else:
            path = work / f"prefetch_{fmt}.wav"
            path.write_bytes(sig.wav_bytes(source[0], sr, fmt, list_chunk=source[1]))
            del source
        prefetch_phase(m, dev, work, cmap, fmt, path, path_launches, k4)

    # 14. the service the viewer talks to, as a process of its own
    service_phase(m, work, paths, cmap, path_launches)

    # 15. a fresh process's first commands, with the shape warmer on and off
    coldstart_phase(work, paths, lecture)

    # result lines
    total = {v: sum(p.get(v, 0) for p in path_launches.values())
             for v in ("mel", "linear") + K4 + DYN}
    kernels = []
    for variant, replaces in (("mel", "tests/pallas_spec.py:131"), ("linear", "tests/pallas_spec.py:98")):
        s = summary[variant]
        kernels.append({
            "name": f"spec_fft_{variant}", "route": "cuda",
            "source": "thesia_tpu_torch/csrc/spec_fft.cu", "replaces": replaces,
            "launches": total[variant], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "host_us": s["host_us"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "max_abs_top60_vs_f64": s["max_abs_top60_vs_f64"],
            "max_scaled_vs_f64": s["max_scaled_vs_f64"],
            "launches_by_path": {k: p[variant] for k, p in path_launches.items()},
            "warm_launches": sum(p["warm"][variant] for p in path_launches.values()),
        })
    for name, replaces in (("deinterleave_flat", "thesia_tpu/dsp/spectrogram.py:77"),
                           ("deinterleave_s24", "thesia_tpu/dsp/spectrogram.py:96")):
        kernels.append({
            "name": name, "route": "torch ops", "source": "thesia_tpu_torch/kernels/pcm.py",
            "replaces": replaces, "launches": total[name], **k4[name],
            "launches_by_path": {k: p.get(name, 0) for k, p in path_launches.items()
                                 if p.get(name, 0)},
            "warm_launches": sum(p["warm"][name] for p in path_launches.values()),
        })
        if total[name] < 1:
            raise AssertionError(f"K4 {name} was not launched on any path")
    measured = {"lufs_stats": k9, "limiter_gain": k8, "quantize_mips": k6}
    device_kernels = {**dyn_counts, "quantize_mips": k6["device_kernels"]}
    for name, _module, source, replaces in HAND:
        s = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "host_us": s["host_us"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": None,
            "device_kernels_per_group": device_kernels[name],
            "launches_by_path": {k: p.get(name, 0) for k, p in path_launches.items()
                                 if p.get(name, 0)},
            "warm_launches": sum(p["warm"].get(name, 0) for p in path_launches.values()),
        })
        if total[name] < 1:
            raise AssertionError(f"{name} was not launched on any path")
    k10_launches = {k: sum(p.get(name, 0) for name in K10) for k, p in path_launches.items()
                    if any(p.get(name, 0) for name in K10)}
    kernels.append({
        "name": "guard_apply", "route": "cuda", "source": "thesia_tpu_torch/csrc/dynamics.cu",
        "replaces": "numpy: thesia_tpu/dynamics/guard.py:64-109",
        "launches": sum(k10_launches.values()), **k10, "library_ms": None,
        "launches_by_path": k10_launches,
        "warm_launches": sum(p["warm"].get(name, 0) for p in path_launches.values() for name in K10),
    })
    if not k10_launches:
        raise AssertionError("K10 was not launched on any path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


VIRTUAL_MESHES = (("tracks", 1, 1), ("time", 4, 1), ("freq", 1, 4))  # (name, time, freq)


def batch_shards(m, sh, analyzer, items, setting) -> int:
    """Launches a sharded calc_specs_batched makes for ``items``: the shards
    of each (sr, hop, win, n_fft) batch."""
    groups = {}
    for _key, wavs, sr, *_ in items:
        groups.setdefault(setting.calc_framing_params(sr) + (sr,), []).append(wavs)
    total = 0
    for (hop, win, n_fft, sr), members in groups.items():
        rows = sum(w.shape[0] for w in members)
        frames = max(m.stft_frame_count(w.shape[1], win, hop) for w in members)
        mel = setting.freq_scale is m.FreqScale.Mel
        cols = analyzer.mel_fb(sr, n_fft).shape[1] if mel else n_fft // 2 + 1
        total += len(m.sharding.shard_plan(sh, rows, frames, cols))
    return total


def sharded(m, mesh, fn):
    """fn() with ``mesh`` active."""
    m.sharding.set_active_mesh(mesh)
    try:
        return fn()
    finally:
        m.sharding.set_active_mesh(None)


def mesh_phases(m, dev, work, paths, cmap, wavs, main_images, path_launches) -> None:
    """[mesh.*]: calc_specs_batched and an EngineSession under each mesh
    against the unsharded analyzer and [main]'s images (module docstring)."""
    kern, sig, shd = m.spec_db, m.signals, m.sharding
    start = time.perf_counter()
    song_wavs, memo_wavs, lecture_wav = wavs
    an = m.SpectrogramAnalyzer(dev)
    batches = {"song_memo": [(0, song_wavs, sig.SONG_SR, 1), (1, memo_wavs, sig.MEMO_SR, 2)],
               "lecture": [(2, lecture_wav, sig.LECTURE_SR, 3)]}
    settings = {"mel": m.SpecSetting(), "linear": m.SpecSetting.from_json(LINEAR)}
    meshes = [(name, shd.make_mesh(devices=[dev] * 4, time_parallel=t, freq_parallel=f))
              for name, t, f in VIRTUAL_MESHES]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", shd.make_mesh()))
    fields = {name: {"mesh": dict(mesh.shape), "equal": [], "launches": {}} for name, mesh in meshes}
    for variant, setting in settings.items():
        for batch, items in batches.items():
            ref = an.calc_specs_batched(items, setting)
            for name, mesh in meshes:
                sh = shd.spec_sharding(mesh, freq_parallel=True, time_parallel=True)
                reset_counts(m)
                got = sharded(m, mesh, lambda: an.calc_specs_batched(items, setting))
                torch.cuda.synchronize()
                launches = kern.spec_db.launches[variant]
                want = batch_shards(m, sh, an, items, setting)
                for key, res in ref.items():
                    g = got[key]
                    if not (torch.equal(g.db, res.db) and torch.equal(g.row_min, res.row_min)
                            and torch.equal(g.row_max, res.row_max)):
                        raise AssertionError(f"mesh.{name}: {batch} {variant} track {key} differs")
                if launches != want:
                    raise AssertionError(f"mesh.{name}: {batch} {variant}: {launches} launches "
                                         f"for {want} shards")
                fields[name]["equal"].append(f"{batch}.{variant}")
                fields[name]["launches"][f"{batch}.{variant}"] = launches
                del got
            del ref
    items = batches["song_memo"]
    _, single_s = median_wall(lambda: an.calc_specs_batched(items, settings["mel"]))
    # each song shard's kernel alone, against the bound of its work
    hop, win, n_fft = settings["mel"].calc_framing_params(sig.SONG_SR)
    window, mel = an.window(win, n_fft), an.mel_fb(sig.SONG_SR, n_fft)
    padded = m.reflect_pad_rows(an.device_wav(song_wavs, 0, 1), win // 2)
    n_frames = m.stft_frame_count(song_wavs.shape[1], win, hop)
    for name, mesh in meshes:
        f = fields[name]
        _, f["recompute_wall_s"] = median_wall(
            lambda: sharded(m, mesh, lambda: an.calc_specs_batched(items, settings["mel"])))
        f["unsharded_wall_s"] = single_s
        sh = shd.spec_sharding(mesh, freq_parallel=True, time_parallel=True)
        shards = []
        for s in shd.shard_plan(sh, padded.shape[0], n_frames, mel.shape[1]):
            x = padded[s.r0:s.r1, s.t0 * hop:(s.t1 - 1) * hop + win].to(s.device)
            args = (x, hop, win, s.t1 - s.t0, an.window(win, n_fft, s.device), n_fft,
                    an.mel_fb(sig.SONG_SR, n_fft, s.device))
            with torch.cuda.device(s.device):
                ms = m.runtime.launch_ms(
                    lambda: kern.spec_db(*args, col0=s.c0, n_cols=s.c1 - s.c0)).ms
            work_ = kern.kernel_work(s.r1 - s.r0, x.shape[1], s.t1 - s.t0, win, n_fft, mel,
                                     col0=s.c0, n_cols=s.c1 - s.c0)
            bound, by = m.runtime.bound_ms(work_["bytes"], work_["flop"])
            shards.append({"device": str(s.device), "rows": (s.r0, s.r1), "frames": (s.t0, s.t1),
                           "cols": (s.c0, s.c1), "ms": round(ms, 4), "bound_ms": round(bound, 4),
                           "bound_by": by})
        f["song_mel_shards"] = shards
    del padded

    # an EngineSession under each mesh: add, apply, Linear, images vs [main]
    for name, mesh in meshes:
        f = fields[name]
        shd.set_active_mesh(mesh)
        try:
            sess = m.EngineSession(settings_dir=work / f"config_mesh_{name}")
            sess.init(cmap)
            watch = Watch(sess)
            reset_counts(m)
            shd.reset_counters()
            _, add_s, _ = timed(lambda: sess.add_tracks([0, 1], paths))
            _, apply_s, _ = timed(lambda: settled(sess, lambda: sess.apply_track_list_changes(
                defer=False)))
            images = {"mel": (host_images(sess), watch.device_mips(m.land_u16))}
            _, lin_s, _ = timed(lambda: settled(sess, lambda: sess.set_spec_setting(
                LINEAR, defer=False)))
            images["linear"] = (host_images(sess), watch.device_mips(m.land_u16))
            launches = launch_counts(m)
            f["peer_bytes"] = shd.peer_bytes()
            f["peer_copies"] = dict(shd.counters)
            watch.check_clean(f"mesh.{name}")
        finally:
            shd.set_active_mesh(None)
        path_launches[f"mesh.{name}"] = launches
        sh = shd.spec_sharding(mesh, freq_parallel=True, time_parallel=True)
        tl = sess.tracklist
        sess_items = [(t, tl[t].audio.wavs, tl[t].sr) for t in (0, 1)]
        want = {v: batch_shards(m, sh, an, sess_items, st) for v, st in settings.items()}
        if (launches["mel"], launches["linear"]) != (want["mel"], want["linear"]):
            raise AssertionError(f"mesh.{name}: session launches {launches}, shards {want}")
        for variant, (imgs, mips) in images.items():
            want_imgs, want_mips = main_images[variant]
            assert_same_images(f"mesh.{name} {variant}", imgs, want_imgs)
            if mips.keys() != want_mips.keys() or not all(
                    np.array_equal(mips[k], want_mips[k]) for k in want_mips):
                raise AssertionError(f"mesh.{name} {variant}: device mips differ from [main]'s")
        f.update(session_images_equal=[f"{v}:{len(images[v][0])}+{len(images[v][1])}mips"
                                       for v in images],
                 session_launches={"mel": launches["mel"], "linear": launches["linear"]},
                 session_add_wall_s=round(add_s, 4), session_apply_wall_s=round(apply_s, 4),
                 session_linear_wall_s=round(lin_s, 4))
        del sess, watch, images
        f["recompute_wall_s"] = round(f["recompute_wall_s"], 4)
        f["unsharded_wall_s"] = round(f["unsharded_wall_s"], 4)
        f["phase_elapsed_s"] = round(time.perf_counter() - start, 2)
        phase(f"mesh.{name}", card=repr(m.runtime.card_description()), **f)


def upload_phase(m, sess, dev, add_upload, add_spans) -> None:
    """[upload]: the [main] add's host-to-device traffic, and the decoded
    song's upload alone on a fresh analyzer (warm: wall and copy-stream ms)."""
    tl = sess.tracklist
    f32_bytes = sum(tl[t].original.wavs.nbytes for t in tl.all_ids())
    song = tl[0].original.wavs
    an = m.SpectrogramAnalyzer(dev)
    first = an.device_wav(song, None, None)
    host_equal = torch.equal(first.cpu(), torch.from_numpy(song))
    del first
    m.upload.reset_counters()
    _, wall = median_wall(lambda: an.device_wav(song, None, None), reps=5)
    song_ms = m.upload.copy_stream_ms() / 5
    rows = add_upload.pop("rows_from")
    phase("upload", add_bytes=add_upload["bytes"], add_uploads=add_upload["uploads"],
          uploads_after_apply=add_upload["uploads_after_apply"], tracks_f32_bytes=f32_bytes,
          bytes_share_of_f32=round(add_upload["bytes"] / f32_bytes, 4),
          copy_stream_ms=round(add_upload["copy_stream_ms"], 3),
          h2d_upload_span_ms=add_spans.get("spec.h2d_upload"), k9_rows_from=rows,
          song_upload_wall_ms=round(wall * 1e3, 3), song_upload_copy_stream_ms=round(song_ms, 3),
          song_upload_gb_per_s=round(song.nbytes / wall / 1e9, 3), song_upload_equals_host=host_equal)
    if (add_upload["uploads"] != len(tl.all_ids()) or add_upload["uploads_after_apply"] != len(tl.all_ids())
            or rows["upload"] or not rows["device_wav"] or not host_equal):
        raise AssertionError(f"upload: {add_upload}, K9 rows {rows}, equal {host_equal}: "
                             "not one upload per track")


def decode_pcm_chunk(chunk: bytes) -> dict:
    """The player's wire chunk: 32-byte header, then interleaved f32 frames."""
    n, ch, sr, flags, pos, ver, _pad = struct.unpack_from("<IIIIdII", chunk, 0)
    return {"n": n, "ch": ch, "sr": sr, "playing": bool(flags & 1), "pos": pos, "ver": ver,
            "data": np.frombuffer(chunk, np.float32, offset=32).reshape(n, ch)}


def player_phase(m, sess) -> None:
    """[player]: the session's playback commands and a remote audio client
    whose pulled chunks must equal the engine fill on the track's samples."""
    events = []
    sess.add_listener(lambda name, p: events.append(p) if name == "player-state-changed" else None)
    track = sess.tracklist[0]
    sr, n_ch = track.sr, track.n_ch
    player = sess.player
    cfg = player.attach_remote_audio(sr, 2)
    sess.set_volume_db(-6.0)
    sess.set_track_player(0, 1.0)
    sess.resume_player()
    samples, vol, frames = track.interleaved_samples(), player.playback.volume, 4800
    checks = []
    t0 = time.perf_counter()
    for i in range(3):
        d = decode_pcm_chunk(player.pull_pcm(frames))
        want = m.render_block(samples, n_ch, sr + i * frames, frames, 2, vol)
        checks.append(d["data"].tobytes() == want.tobytes() and d["playing"])
    pull_ms = (time.perf_counter() - t0) * 1e3 / 3
    pos = d["pos"]
    ver = d["ver"]
    sess.seek_player(2.0)
    d = decode_pcm_chunk(player.pull_pcm(frames))
    checks.append(d["ver"] == ver + 1 and d["data"].tobytes()
                  == m.render_block(samples, n_ch, 2 * sr, frames, 2, vol).tobytes())
    sess.pause_player()
    d = decode_pcm_chunk(player.pull_pcm(frames))
    checks.append(not d["playing"] and not d["data"].any())
    player.detach_remote_audio()
    phase("player", requested_sr=player.requested_sr, remote=cfg, volume=vol,
          chunks_equal_engine_fill=checks, position_after_3_pulls_s=pos,
          pull_ms=round(pull_ms, 3), state_events=len(events), state=player.state())
    if not (all(checks) and abs(pos - (sr + 3 * frames) / sr) < 1e-9 and events
            and abs(vol - 10 ** (-6 / 20)) < 1e-6):
        raise AssertionError(f"player: chunks {checks}, position {pos}, events {len(events)}")


class HttpClient:
    """A keep-alive client of the service (standard library), counting the
    bytes it receives."""

    def __init__(self, port: int, timeout: float = 300.0):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        self.received = 0

    def request(self, method, path, body=b"", headers=None):
        """(status, content type, body, wall seconds)."""
        t0 = time.perf_counter()
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        data = r.read()
        wall = time.perf_counter() - t0
        self.received += len(data)
        return r.status, r.getheader("Content-Type", ""), data, wall

    def post(self, path, obj=None, raw=None):
        body = raw if raw is not None else json.dumps({} if obj is None else obj).encode()
        return self.request("POST", path, body, {"Content-Type": "application/json"})

    def call(self, name, body=None):
        """(result or tile bytes, wall seconds) of a command that must answer 200."""
        status, _ct, data, wall = self.post(f"/api/{name}", body or {})
        if status != 200:
            raise AssertionError(f"[service] {name} {body}: HTTP {status} {data[:300]!r}")
        return (data if name in ("get_spectrogram_tile", "get_waveform_tile")
                else json.loads(data)["result"]), wall


def ws_connect(port: int):
    """A WebSocket client of /events (standard library): (socket, reader)."""
    import base64
    import hashlib
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /events HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rb")
    status = f.readline()
    headers = {}
    while (line := f.readline()) not in (b"\r\n", b""):
        name, _, value = line.decode().partition(":")
        headers[name.strip().lower()] = value.strip()
    want = base64.b64encode(hashlib.sha1(
        (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest()).decode()
    if not status.startswith(b"HTTP/1.1 101") or headers.get("sec-websocket-accept") != want:
        raise AssertionError(f"[service] WebSocket handshake: {status!r} {headers}")
    return sock, f


def ws_send(sock, opcode: int, payload: bytes) -> None:
    mask = os.urandom(4)
    sock.sendall(bytes([0x80 | opcode, 0x80 | len(payload)]) + mask
                 + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))


def ws_recv(f) -> tuple[int, bytes]:
    b0, b1 = f.read(2)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", f.read(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", f.read(8))
    return b0 & 0x0F, f.read(n)


def raw_request(port: int, data: bytes) -> bytes:
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(data)
        chunks = []
        while chunk := s.recv(65536):
            chunks.append(chunk)
    return b"".join(chunks)


def start_service(work: Path):
    """``python -m thesia_tpu_torch --port 0`` in the repository, on the card
    by default: (process, port, seconds until it listened).  Its log goes to
    a file in ``work``."""
    import queue
    import threading

    root = Path(__file__).resolve().parent
    path = os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, THESIA_TPU_CONFIG=str(work / "config_service"),
               THESIA_LOG_LEVEL="WARNING")
    env.pop("THESIA_DEFER_SETTINGS", None)
    log_path = work / "service.log"
    t0 = time.perf_counter()
    with open(log_path, "wb") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "thesia_tpu_torch", "--port", "0", "--media-dir", str(work)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=log_file, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    while True:
        try:
            line = lines.get(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        except queue.Empty:
            line = ""
        if "listening on http://127.0.0.1:" in line:
            return proc, int(line.strip().rsplit(":", 1)[1]), time.perf_counter() - t0
        if not line or proc.poll() is not None:
            proc.kill()
            proc.wait(timeout=60)
            raise AssertionError(f"[service] the child did not listen: {line!r}\n"
                                 + log_path.read_text()[-4000:])


# A client in a process of its own (standard library only): the first
# request of plan["first"], then the median wall of n requests of each kind,
# on one keep-alive connection -- the transport as a browser meets it, apart
# from the smoke's own threads
HTTP_TIMER = r"""
import http.client, json, sys, time
port, plan = int(sys.argv[1]), json.loads(sys.argv[2])
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
received = 0
def post(name, body):
    global received
    data = json.dumps(body).encode()
    t0 = time.perf_counter()
    conn.request("POST", "/api/" + name, data, {"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.read()
    wall = (time.perf_counter() - t0) * 1e3
    if r.status != 200:
        raise SystemExit(f"{name}: HTTP {r.status} {out[:200]!r}")
    received += len(out)
    return wall
first = post(*plan["first"])
kinds = {name: sorted(post(name, body) for _ in range(plan["n"]))[plan["n"] // 2]
         for name, body in plan["kinds"]}
print(json.dumps({"first_ms": first, "median_ms": kinds, "received": received}))
"""


def http_timer(port: int, plan: dict) -> dict:

    out = subprocess.run([sys.executable, "-c", HTTP_TIMER, str(port), json.dumps(plan)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"[service] the timing client failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def service_phase(m, work, paths, cmap, path_launches) -> None:
    """14. The service as a child process, against an in-process session."""
    proc, port, start_s = start_service(work)
    try:
        service_checks(m, work, paths, cmap, path_launches, proc, port, start_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def service_checks(m, work, paths, cmap, path_launches, proc, port, start_s):
    from thesia_tpu_torch.engine.service import Commands

    c = HttpClient(port)
    static = {p: c.request("GET", p)[:2] for p in ("/", "/js/app.js")}
    if static != {"/": (200, "text/html"), "/js/app.js": (200, "text/javascript")}:
        raise AssertionError(f"[service] static files: {static}")
    sock, wsf = ws_connect(port)
    ws_send(sock, 0x9, b"ready?")
    if ws_recv(wsf) != (0xA, b"ready?"):
        raise AssertionError("[service] the WebSocket did not answer a ping")

    # the same commands to the child over HTTP and to ``ref`` in process
    ref = m.EngineSession(settings_dir=work / "config_service_ref")
    cmds = Commands(ref)

    def in_process(name, body=None):
        status, want = cmds.call(name, body or {})
        if status != 200:
            raise AssertionError(f"[service] in process {name} {body}: {status} {want}")
        return want if isinstance(want, bytes) else json.loads(json.dumps(want))["result"]

    def both(name, body=None):
        got, wall = c.call(name, body)
        return got, in_process(name, body), wall

    def poll_settled(ids, since):
        while True:
            mds = {k: c.call("get_audio_render_metadata", {"idChStr": k})[0] for k in ids}
            if not any(md["isComputing"] for md in mds.values()):
                return mds, time.perf_counter() - since
            if time.perf_counter() - since > 900:
                raise AssertionError(f"[service] still computing after 900 s: {mds}")
            time.sleep(0.005)

    both("init", {"colormapRgba": cmap})
    memo = Path(paths[1]).read_bytes()
    boundary = "thesiaSmokeBoundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{Path(paths[1]).name}\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + memo + f"\r\n--{boundary}--\r\n".encode()
    status, _ct, data, upload_s = c.request(
        "POST", "/upload", body, {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    uploaded = json.loads(data)["result"] if status == 200 else None
    if uploaded is None or Path(uploaded).read_bytes() != memo:
        raise AssertionError(f"[service] upload: HTTP {status} {data[:200]!r}")
    track_paths = [paths[0], uploaded]
    ids = ("0_0", "0_1", "1_0")
    _, _, add_s = both("add_tracks", {"trackIds": [0, 1], "paths": track_paths})
    t0 = time.perf_counter()
    c.call("apply_track_list_changes")
    apply_ms = (time.perf_counter() - t0) * 1e3
    meta, apply_settle_s = poll_settled(ids, t0)
    in_process("apply_track_list_changes")
    settle(ref)

    mid = meta["0_0"]["spectrogramWidth"] // 512 // 2
    spec_args = [("0_0", 0, 0, 0, 0), ("0_1", 0, 0, mid, 0), ("1_0", 0, 0, 1, 0), ("0_0", 3, 1, 1, 0),
                 ("0_0", 6, 0, 0, 0)]
    wave_args = [("0_0", 0, 0), ("0_1", 4, 3), ("1_0", 10, 0)]
    spec_body = lambda a: dict(zip(("idChStr", "levelX", "levelY", "tileX", "tileY"), a))  # noqa: E731
    wave_body = lambda a: dict(zip(("idChStr", "level", "tileIndex"), a))  # noqa: E731
    equal = []

    def tiles(stage):
        for a in spec_args:
            got, want, _ = both("get_spectrogram_tile", spec_body(a))
            equal.append((stage, a, got == want))
        for a in wave_args:
            got, want, _ = both("get_waveform_tile", wave_body(a))
            equal.append((stage, a, got == want))

    axis_bodies = [
        ("calc_time_axis_markers", {"startSec": 0.0, "endSec": 300.0, "tickUnit": 10.0,
                                    "labelInterval": 3, "maxSec": 300.0}),
        ("calc_freq_axis_markers", {"hzRangeMin": 0.0, "hzRangeMax": 24000.0, "freqScale": "Mel",
                                    "maxNumTicks": 16, "maxNumLabels": 8, "maxTrackHz": 24000.0}),
        ("calc_dB_axis_markers", {"maxNumTicks": 11, "maxNumLabels": 6, "dBRangeMin": -100.0,
                                  "dBRangeMax": 0.0}),
        ("calc_amp_axis_markers", {"maxNumTicks": 5, "maxNumLabels": 3, "ampRangeMin": -1.0,
                                   "ampRangeMax": 1.0}),
    ]
    # the first tile of the child and warm walls per kind, from a client
    # process of its own, before the smoke's client fetches any tile
    kinds = {
        "get_spectrogram_tile": spec_body(spec_args[1]),
        "get_waveform_tile": wave_body(wave_args[1]),
        "get_audio_render_metadata": {"idChStr": "0_0"},
        "calc_time_axis_markers": axis_bodies[0][1],
        "is_dev": {},
    }
    timer = http_timer(port, {"first": ["get_spectrogram_tile", spec_body(spec_args[0])],
                              "kinds": list(kinds.items()), "n": 41})
    c.received += timer["received"]
    tiles("mel")
    axis_equal = [got == want for got, want, _ in (both(n, b) for n, b in axis_bodies)]

    # the profiler during a mel -> Linear switch made by a second request
    c.post("/debug/profile", {"durationMs": 50})  # the profiler's first start
    prof = {}

    def capture():
        pc = HttpClient(port)
        prof["reply"] = pc.post("/debug/profile", {"durationMs": 1000})
        c.received += pc.received

    t = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = t.submit(capture)
    time.sleep(0.25)
    t0 = time.perf_counter()
    c.call("set_spec_setting", {"specSetting": LINEAR})
    linear_meta, linear_settle_s = poll_settled(ids, t0)
    fut.result(timeout=300)
    t.shutdown()
    in_process("set_spec_setting", {"specSetting": LINEAR})
    settle(ref)
    status, _ct, data, _ = prof["reply"]
    trace_dir = json.loads(data)["result"] if status == 200 else None
    trace = (Path(trace_dir) / "trace.json").read_text() if trace_dir else ""
    kernel_events = trace.count("spec_fft_kernel")
    tiles("linear")
    t0 = time.perf_counter()
    c.call("set_spec_setting", {"specSetting": m.SpecSetting().to_json()})
    _, mel_settle_s = poll_settled(ids, t0)
    in_process("set_spec_setting", {"specSetting": m.SpecSetting().to_json()})
    settle(ref)
    tiles("mel again")

    # player: the WebSocket sees player-state-changed; a remote client pulls
    both("set_track_player", {"trackId": 0, "sec": 1.0})
    c.call("resume_player")
    events = []
    deadline = time.perf_counter() + 60
    while not any(e["event"] == "player-state-changed" and e["payload"].get("isPlaying")
                  for e in events):
        if time.perf_counter() > deadline:
            raise AssertionError(f"[service] no player-state-changed event: {events}")
        op, payload = ws_recv(wsf)
        if op == 0x1:
            events.append(json.loads(payload))
    attach = json.loads(c.post("/player/attach_pcm", {"sampleRate": 48000, "channels": 2})[2])
    status, ctype, chunk, _ = c.post("/player/pcm", {"frames": 4800})
    pcm = decode_pcm_chunk(chunk) if status == 200 else None
    c.call("pause_player")
    c.post("/player/detach_pcm", {})
    ws_send(sock, 0x8, struct.pack("!H", 1000))
    while (frame := ws_recv(wsf))[0] == 0x1:  # events still in flight
        pass
    closed = frame == (0x8, struct.pack("!H", 1000))
    wsf.close()
    sock.close()

    # transport overhead: HTTP wall (the timing client's medians) against the
    # same call in process
    overhead = {}
    for name, body in kinds.items():
        walls = []
        for _ in range(41):
            t0 = time.perf_counter()
            cmds.call(name, body)
            walls.append((time.perf_counter() - t0) * 1e3)
        http_ms, inproc_ms = timer["median_ms"][name], sorted(walls)[20]
        overhead[name] = {"http_ms": round(http_ms, 4), "in_process_ms": round(inproc_ms, 4),
                          "overhead_ms": round(http_ms - inproc_ms, 4)}
    first_tile_ms, warm_tile_ms = timer["first_ms"], overhead["get_spectrogram_tile"]["http_ms"]

    metrics = json.loads(c.request("GET", "/debug/metrics")[2])["result"]
    launches, warm = metrics["kernel_launches"], metrics["warm_kernel_launches"]
    path_launches["service"] = {"mel": launches["spec_fft_mel"], "linear": launches["spec_fft_linear"],
                                **{k: launches[k] for k in K4 + DYN},
                                "warm": {"mel": warm["spec_fft_mel"], "linear": warm["spec_fft_linear"],
                                         **{k: warm[k] for k in K4 + DYN}}}
    warmer = metrics["shape_warmer"]
    malformed = {
        "unknown command": c.post("/api/no_such_command", {})[0],
        "missing argument": c.post("/api/get_sample_rate", {})[0],
        "non-object body": c.post("/api/find_id_by_path", raw=b"[1, 2]")[0],
        "bad idChStr": c.post("/api/get_spectrogram_tile", {"idChStr": "1_2_3", "levelX": 0,
                                                             "levelY": 0, "tileX": 0, "tileY": 0})[0],
        "NaN dB range": c.post("/api/set_dB_range", raw=b'{"dBRange": NaN}')[0],
        "pcm body not an object": c.post("/player/pcm", raw=b"[1]")[0],
        "upload not multipart": c.post("/upload", {"file": 1})[0],
        "GET /events without upgrade": c.request("GET", "/events")[0],
        "../ path": int(raw_request(port, b"GET /js/../../engine/service.py HTTP/1.1\r\n"
                                          b"Connection: close\r\n\r\n")[9:12]),
        "junk request line": int(raw_request(port, b"HELLO\r\n\r\n")[9:12]),
        "chunked body": int(raw_request(port, b"POST /api/is_dev HTTP/1.1\r\nTransfer-Encoding: "
                                              b"chunked\r\n\r\n2\r\n{}\r\n0\r\n\r\n")[9:12]),
    }
    alive = c.call("is_dev")[0] is False
    received = c.received
    c.conn.close()
    ref.tm.images.shutdown()
    del ref, cmds

    proc.terminate()
    rc = proc.wait(timeout=120)
    try:
        os.kill(proc.pid, 0)
        gone = False
    except ProcessLookupError:
        gone = True

    tiles_equal = sum(ok for *_a, ok in equal)
    phase("service", start_to_listening_s=round(start_s, 3), upload_wall_s=round(upload_s, 4),
          add_http_wall_s=round(add_s, 4), apply_dispatch_http_ms=round(apply_ms, 3),
          apply_settle_s=round(apply_settle_s, 4), linear_settle_s=round(linear_settle_s, 4),
          mel_settle_s=round(mel_settle_s, 4), first_tile_http_ms=round(first_tile_ms, 3),
          warm_tile_http_ms=warm_tile_ms, tile_limit_ms=5.0, transport=overhead,
          tiles_bit_equal=f"{tiles_equal}/{len(equal)}", axis_equal=axis_equal,
          geometry={k: (v["spectrogramHeight"], v["spectrogramWidth"]) for k, v in meta.items()},
          linear_height=linear_meta["0_0"]["spectrogramHeight"],
          profile_trace_mb=round(len(trace) / 1e6, 3), spec_fft_kernel_in_trace=kernel_events,
          ws_events=len(events), ws_closed=closed, remote=attach.get("result"),
          pcm=None if pcm is None else {"n": pcm["n"], "playing": pcm["playing"],
                                        "nonzero": bool(pcm["data"].any())},
          launches=path_launches["service"], shape_warmer=warmer, malformed=malformed,
          bytes_received=received, exit_code=rc, child_gone=gone)
    if tiles_equal != len(equal) or not all(axis_equal):
        raise AssertionError(f"[service] differs from the in-process session: "
                             f"{[e for e in equal if not e[2]]}, axis {axis_equal}")
    if any(s >= 500 for s in malformed.values()) or not alive:
        raise AssertionError(f"[service] malformed requests: {malformed}, alive {alive}")
    if not (pcm and pcm["n"] == 4800 and pcm["playing"] and closed and events):
        raise AssertionError(f"[service] player: pcm {pcm}, events {len(events)}, closed {closed}")
    if linear_meta["0_0"]["spectrogramHeight"] != 1025:
        raise AssertionError(f"[service] Linear did not land: {linear_meta['0_0']}")
    if (kernel_events < 1 or launches["spec_fft_mel"] < 1 or launches["spec_fft_linear"] < 1):
        raise AssertionError(f"[service] kernels: {kernel_events} in the trace, launches {launches}")
    if rc != 0 or not gone:
        raise AssertionError(f"[service] the child exited with {rc}, gone {gone}")
    if warmer["failed"] or not warmer["compiled"]:
        raise AssertionError(f"[service] the child's shape warmer: {warmer}")


def coldstart_runs(work: Path, args: list[str], warm: str) -> dict:
    """One fresh process of tools/coldstart.py: its JSON line."""

    root = Path(__file__).resolve().parent
    path = os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, PYTHONPATH=path, THESIA_TPU_CONFIG=str(work / "config_coldstart"),
               THESIA_LOG_LEVEL="WARNING")
    out = subprocess.run([sys.executable, "-m", "thesia_tpu_torch.tools.coldstart", "--warm", warm,
                          *args], cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"[coldstart] --warm {warm} {args}: exit {out.returncode}\n"
                             + out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def coldstart_phase(work: Path, paths: list[str], lecture: Path) -> None:
    """15. First commands of fresh processes, the shape warmer on and off."""
    import statistics

    runs = {"on": [], "off": []}
    for rounds, args in ((3, list(paths)), (2, ["--lecture", str(lecture)])):
        for _ in range(rounds):
            for warm in ("on", "off"):
                runs[warm].append(coldstart_runs(work, args, warm))
    fields = {}
    for warm, rs in runs.items():
        keys = sorted({k for r in rs for k, v in r.items()
                       if k.endswith(("_s", "_ms")) and isinstance(v, (int, float))})
        fields[warm] = {k: statistics.median(r[k] for r in rs if k in r) for k in keys}
        fields[warm]["runs"] = len(rs)
    on, off = runs["on"], runs["off"]
    hashes = {}
    for r in on + off:
        for k, h in r["images_sha256"].items():
            hashes.setdefault(k, set()).add(h)
    equal = all(len(v) == 1 for v in hashes.values())
    compiled = [r["compiled"] for r in on]
    failed = sum(r["failed"] for r in on + off)
    warm_on = [sum(r["warm_launches"].values()) for r in on]
    warm_off = [sum(r["warm_launches"].values()) for r in off]
    main_same = all(a["launches"] == b["launches"] for a, b in zip(on, off))
    job_ms = {}
    for r in on:
        for k, v in r["job_ms"].items():
            job_ms.setdefault(k, []).append(v)
    phase("coldstart", warm_on=fields["on"], warm_off=fields["off"], compiled=compiled,
          failed=failed, warm_launches_on=warm_on, warm_launches_off=warm_off,
          main_launches_equal=main_same, job_ms_median={k: statistics.median(v) for k, v in job_ms.items()},
          images_bit_equal=equal, images_checked=sorted(hashes))
    if failed or not equal or not main_same or min(warm_on) < 1 or max(warm_off) != 0 or min(compiled) < 1:
        raise AssertionError(f"[coldstart] failed {failed}, images equal {equal}, main launches "
                             f"equal {main_same}, warm launches {warm_on} / {warm_off}, "
                             f"compiled {compiled}")


def prefetch_phase(m, dev, work, cmap, fmt, path, path_launches, k4) -> None:
    """13. One big WAV added through the prefetch, and again without it."""
    pcm = m.pcm
    data = path.read_bytes()
    planar, _sr, _codec = m.decode_wav(data)
    _tag, _bits, n_ch, _sr, payload = m.probe_wav(data)
    runs = {}
    for label, threshold in (("prefetch", None), ("plain", len(data) + 1)):
        sess = m.EngineSession(settings_dir=work / f"config_prefetch_{fmt}_{label}")
        if threshold is not None:
            sess._PREFETCH_MIN_FILE_BYTES = threshold
        sess.init(cmap)
        watch = Watch(sess)
        reset_counts(m)
        m.upload.reset_counters()
        m.obs.reset()
        added, add_s, _ = timed(lambda: sess.add_tracks([0], [str(path)]))
        an = sess.tm.spec_analyzer
        run = {"add_wall_s": round(add_s, 4), "adopted": an.prefetch_adopted,
               "failed": an.prefetch_failed, "bytes": m.upload.counters["bytes"],
               "uploads": m.upload.counters["uploads"],
               "copy_stream_ms": round(m.upload.copy_stream_ms(), 3),
               "spans_ms": span_totals(m)}
        original = sess.tracklist[0].original.wavs
        run["decode_equal"] = np.array_equal(original, planar)
        run["device_wav_equal"] = torch.equal(an._wav_cache[0][0].cpu(), torch.from_numpy(original))
        _, apply_s, _ = timed(lambda: settled(sess, lambda: sess.apply_track_list_changes(defer=False)))
        run["apply_wall_s"] = round(apply_s, 4)
        path_launches[f"prefetch.{fmt}" + ("" if threshold is None else ".plain")] = launch_counts(m)
        run["images"], run["mips"] = host_images(sess), watch.device_mips(m.land_u16)
        watch.check_clean(f"prefetch.{fmt} {label}")
        runs[label] = run
        del sess, watch, an
    pf, plain = runs["prefetch"], runs["plain"]
    assert_same_images(f"prefetch.{fmt} vs plain", pf.pop("images"), plain.pop("images"))
    assert_same_images(f"prefetch.{fmt} device mips vs plain", pf.pop("mips"), plain.pop("mips"))
    # K4 at this file's shape, on the payload as the prefetch uploads it
    width = {"s16": 2, "s24": 3, "f32": 4}[fmt]
    n = len(payload) // (width * n_ch)
    raw = torch.from_numpy(np.frombuffer(payload, np.uint8)[: n * width * n_ch].copy()).to(dev)
    if fmt == "s24":
        name, fn, ref, flat = "deinterleave_s24", pcm.deinterleave_s24, pcm.deinterleave_s24_reference, raw
    else:
        name, fn, ref = "deinterleave_flat", pcm.deinterleave_flat, pcm.deinterleave_flat_reference
        flat = raw.view(torch.int16 if fmt == "s16" else torch.float32)
    got = fn(flat, n_ch)
    plain_equal = torch.equal(got, ref(flat, n_ch))
    err = float((got.cpu() - torch.from_numpy(planar)).abs().max())
    del got
    k_ms = m.runtime.median_ms(lambda: fn(flat, n_ch))
    p_ms = m.runtime.median_ms(lambda: ref(flat, n_ch))
    bound, bound_by = m.runtime.bound_ms(raw.numel() + 4 * n_ch * n, 0)
    phase(f"prefetch.{fmt}", file_mb=round(len(data) / 1e6, 1), shape=(n_ch, n),
          prefetch=pf, plain=plain, images_and_mips_equal=True,
          launches=path_launches[f"prefetch.{fmt}"], k4=name, k4_ms=round(k_ms, 4),
          k4_plain_ms=round(p_ms, 4), k4_bound_ms=round(bound, 4), k4_max_abs_err=err,
          k4_equals_plain=plain_equal)
    if not (pf["adopted"] == 1 and pf["failed"] == 0 and plain["adopted"] == 0
            and pf["decode_equal"] and pf["device_wav_equal"] and plain["device_wav_equal"]):
        raise AssertionError(f"prefetch.{fmt}: {pf} / {plain}")
    if not (err == 0.0 and plain_equal and path_launches[f"prefetch.{fmt}"][name] >= 1):
        raise AssertionError(f"prefetch.{fmt}: K4 {name} error {err}, plain equal {plain_equal}")
    if name not in k4:
        k4[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None, "at": f"prefetch.{fmt}"}


def deferred_main_phase(m, work, paths, cmap, sync_images, sync_mips, path_launches):
    """10. The main path in the default (deferred) mode on a new session."""
    kern = m.spec_db
    sess = m.EngineSession(settings_dir=work / "config_deferred")
    sess.init(cmap)
    watch = Watch(sess)
    reset_counts(m)
    m.obs.reset()
    added, add_s, _ = timed(lambda: sess.add_tracks([0, 1], paths))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    updated = sess.apply_track_list_changes()
    apply_ms = (time.perf_counter() - t0) * 1e3
    pending = sess.tm.images.is_computing(0)
    before = region_fetches(m)
    t1 = time.perf_counter()
    tile = sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)
    first_tile_ms = (time.perf_counter() - t1) * 1e3
    first_from = "region fetch" if region_fetches(m) > before else "host image"
    settle(sess)
    settle_s = time.perf_counter() - t0
    path_launches["deferred.main"] = launch_counts(m)
    if sess.player.requested_sr != max(m.signals.SONG_SR, m.signals.MEMO_SR):
        raise AssertionError(f"deferred apply: player.requested_sr {sess.player.requested_sr}")
    landing_ms = watch.copy_ms()
    images = host_images(sess)
    assert_same_images("deferred.main vs main", images, sync_images)
    assert_same_images("deferred.main device mips vs main", watch.device_mips(m.land_u16), sync_mips)
    if tile != sess.get_spectrogram_tile("0_0", 0, 0, 0, 0):
        raise AssertionError("deferred.main: the first tile differs from the settled one")
    # an incremental deferred apply: the memo again -> probe, then reconcile
    # or confirm on the switch pool
    sess.remove_tracks([1])
    sess.add_tracks([1], paths[1:])
    _, re_apply_ms, re_settle_s = dispatched(sess, sess.apply_track_list_changes)
    assert_same_images("deferred.main re-add vs main", host_images(sess), sync_images)
    phase("deferred.main", added=added, updated=updated, add_wall_s=round(add_s, 4),
          apply_dispatch_ms=round(apply_ms, 3), computing_at_dispatch=pending,
          first_tile_ms=round(first_tile_ms, 3), first_tile_from=first_from,
          settle_s=round(settle_s, 4), landing_copy_stream_ms=round(landing_ms, 3),
          stream_span_ms=span_totals(m).get("spec.stream"),
          launches=path_launches["deferred.main"], images_equal_sync=len(images),
          device_mips_equal_sync=len(sync_mips), readd_apply_dispatch_ms=round(re_apply_ms, 3),
          readd_settle_s=round(re_settle_s, 4))
    if path_launches["deferred.main"]["mel"] < 1:
        raise AssertionError("deferred.main: the mel kernel did not run")
    watch.check_clean("deferred.main")
    return sess, watch


def deferred_switches_phase(m, work, paths, cmap, sess, watch, path_launches):
    """11. The four switch kinds deferred, then a churn."""
    kern = m.spec_db
    mel = m.SpecSetting().to_json()
    stats = [sess.tracklist[t].original.stats for t in (0, 1)]
    quiet = min(st.global_lufs - st.max_peak_db for st in stats) - 3.0
    hot = stats[0].global_lufs - stats[0].max_peak_db + 6.0
    reset_counts(m)
    steps = [
        ("linear", lambda: sess.set_spec_setting(LINEAR)),
        ("mel", lambda: sess.set_spec_setting(mel)),
        ("lufs", lambda: sess.set_common_normalize({"type": "LUFS", "target": quiet})),
        ("limiter", lambda: sess.set_common_guard_clipping("Limiter")),
        ("limiter_engaged", lambda: sess.set_common_normalize({"type": "LUFS", "target": hot})),
        ("clip", lambda: sess.set_common_guard_clipping("Clip")),
    ]
    times = {}
    for name, fn in steps:
        _, dispatch_ms, settle_s = dispatched(sess, fn)
        times[name] = (round(dispatch_ms, 3), round(settle_s, 4))
    if sess.tracklist.common_guard_clipping.value != "Clip" or \
            not sess.get_audio_render_metadata("0_0")["isClipped"]:
        raise AssertionError("deferred.switches: Clip did not land")
    # churn: eight alternating switches without waiting in between
    churn = []
    for i in range(8):
        if i % 2 == 0:
            churn.append(("spec", LINEAR if i % 4 == 0 else mel))
            sess.set_spec_setting(churn[-1][1])
        else:
            churn.append(("normalize", {"type": "LUFS", "target": quiet - i}))
            sess.set_common_normalize(churn[-1][1])
    t0 = time.perf_counter()
    settle(sess)
    churn_settle_s = time.perf_counter() - t0
    path_launches["deferred.switches"] = launch_counts(m)
    computing = {k: sess.get_audio_render_metadata(k)["isComputing"] for k in ("0_0", "0_1", "1_0")}
    if any(computing.values()):
        raise AssertionError(f"deferred.switches: still computing after settling: {computing}")
    final_spec, final_norm = mel, churn[-1][1]
    if sess.get_spec_setting() != final_spec or sess.get_common_normalize() != final_norm:
        raise AssertionError("deferred.switches: the last targets did not land")
    got = host_images(sess)
    ref = m.EngineSession(settings_dir=work / "config_sync_final")
    ref.init(cmap)
    ref.add_tracks([0, 1], paths)
    ref.apply_track_list_changes(defer=False)
    ref.set_spec_setting(final_spec, defer=False)
    ref.set_common_guard_clipping("Clip", defer=False)
    ref.set_common_normalize(final_norm, defer=False)
    settle(ref)
    assert_same_images("deferred.switches churn vs sync", got, host_images(ref))
    phase("deferred.switches", dispatch_ms_settle_s=times, churn=[k for k, _ in churn],
          churn_settle_s=round(churn_settle_s, 4), is_computing=computing,
          launches=path_launches["deferred.switches"], images_equal_sync=len(got),
          song_gain=float(sess.tracklist[0].audio.applied_scalar_gain), hot_lufs=round(hot, 4))
    if min(path_launches["deferred.switches"][v] for v in ("mel", "linear")) < 1:
        raise AssertionError(f"deferred.switches: launches {path_launches['deferred.switches']}")
    watch.check_clean("deferred.switches")


def long_phase(m, work, cmap, path_launches, wav, make_s):
    """12. A 1-hour 16 kHz lecture on a new session, deferred; ``wav`` its
    samples, made in ``make_s`` seconds."""
    kern, sig = m.spec_db, m.signals
    t0 = time.perf_counter()
    path = work / "lecture_16k_1h.wav"
    path.write_bytes(m.encode_wav_s16(wav, sig.LECTURE_SR))
    make_s += time.perf_counter() - t0
    wav_mb = path.stat().st_size / 1e6
    del wav
    sess = m.EngineSession(settings_dir=work / "config_long")
    sess.init(cmap)
    watch = Watch(sess)
    reset_counts(m)
    m.upload.reset_counters()
    m.obs.reset()
    added, add_s, _ = timed(lambda: sess.add_tracks([0], [str(path)]))
    add_spans = span_totals(m)
    an = sess.tm.spec_analyzer
    add_upload = {**m.upload.counters, "prefetch_adopted": an.prefetch_adopted,
                  "prefetch_failed": an.prefetch_failed, "copy_stream_ms": m.upload.copy_stream_ms()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.apply_track_list_changes()
    apply_ms = (time.perf_counter() - t0) * 1e3
    height, n_frames = sess.tm.images.geometry(0)
    whole_lx = max((n_frames - 1) // 512, 0).bit_length()  # the level where one tile holds it all
    mid = n_frames // 512 // 2
    requests = [(whole_lx, 0), (0, mid), (1, mid // 2), (4, mid // 16), (6, 0), (0, 0),
                (0, 2 * mid - 1)]
    interim, streaming = {}, []
    for lx, tx in requests:
        streaming.append(sess.tm.images.is_computing(0))
        t1 = time.perf_counter()
        interim[(lx, tx)] = sess.get_spectrogram_tile("0_0", lx, 0, tx, 0)
        interim[(lx, tx, "ms")] = (time.perf_counter() - t1) * 1e3
    fetches = region_fetches(m)
    settle(sess)
    settle_s = time.perf_counter() - t0
    path_launches["long.hour16k"] = launch_counts(m)
    for lx, tx in requests:
        if interim[(lx, tx)] != sess.get_spectrogram_tile("0_0", lx, 0, tx, 0):
            raise AssertionError(f"long.hour16k: tile level {lx} x {tx} differs after the drain")
    img = sess.tm.images.host_image(0, 0)
    phase("long.hour16k", samples=sess.tracklist[0].audio.wavs.shape[1], wav_mb=round(wav_mb, 1),
          make_wav_s=round(make_s, 2), added=added, add_wall_s=round(add_s, 4),
          apply_dispatch_ms=round(apply_ms, 3), geometry=(height, n_frames),
          image_mb=round(img.nbytes / 1e6, 1),
          whole_track_tile_ms=round(interim[(whole_lx, 0, "ms")], 3), whole_track_level=whole_lx,
          mid_full_res_tile_ms=round(interim[(0, mid, "ms")], 3),
          tile_ms={f"{lx}/{tx}": round(interim[(lx, tx, "ms")], 3) for lx, tx in requests},
          streaming_at_request=streaming, region_fetches=fetches, settle_s=round(settle_s, 4),
          landing_copy_stream_ms=round(watch.copy_ms(), 3),
          stream_span_ms=span_totals(m).get("spec.stream"),
          tiles_equal_after_drain=len(requests), launches=path_launches["long.hour16k"],
          add_spans_ms=add_spans, add_upload=add_upload)
    if (height, n_frames) != (385, 360001) or path_launches["long.hour16k"]["mel"] < 1:
        raise AssertionError(f"long.hour16k: geometry {(height, n_frames)}, "
                             f"launches {path_launches['long.hour16k']}")
    watch.check_clean("long.hour16k")
    if add_upload["prefetch_adopted"] != 1 or add_upload["prefetch_failed"]:
        raise AssertionError(f"long.hour16k: the prefetch was not adopted: {add_upload}")
    return path


if __name__ == "__main__":
    sys.exit(main())
