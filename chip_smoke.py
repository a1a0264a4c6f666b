#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, one line each (any failure raises and the exit code is non-zero):

1. card    -- nvidia-smi name and power limit, torch's device name.
2. build   -- nvcc builds thesia_tpu_torch/csrc into a shared library; seconds,
              registers per kernel; g++ builds the port's native host library.
3. kernels -- the fused framed FFT->|.|->mel->dB kernel (mel and linear
              variants) vs its plain PyTorch version (the window-folded DFT as
              matrix products) at the main path's shapes (48 kHz stereo 5 min,
              16 kHz mono 60 s): dB error and -inf mask against the plain
              version evaluated in float64 (the gate: kernels/spec_db.py
              SCALED_TOL, TOP60_TOL_DB) and in float32 (-inf and SCALED_TOL
              only: its own f32 rounding exceeds TOP60_TOL_DB); median
              CUDA-event times of the kernel, the plain version and
              torch.fft.rfft of the windowed frames (a yardstick the port
              never calls); the bound of the kernel's work on the card.
4. main    -- EngineSession(device="cuda"): init -> add_tracks (a 5-minute
              48 kHz stereo song and a 60-second 16 kHz voice memo, written as
              16-bit WAVs) -> apply_track_list_changes -> metadata ->
              spectrogram tiles -> waveform tile; checks the mel kernel ran,
              every spectrogram tensor is on the card, tile geometry, and the
              device-built mips equal the host mip chain bit for bit.
5. linear  -- set_spec_setting(Linear) -> tile; checks the linear kernel ran.
6. compare -- track 0 channel 0: the kernel's dB vs the plain version on the
              same card, and the u16 image vs the ones quantized from it.

The line before the last is {"kernels": [...]} (launch counts from phases 4-5,
errors and times measured here; ``max_abs_err`` is the largest |dB
difference| from the float32 plain version over every finite entry of both
shapes, ``max_abs_top60_vs_f64`` and ``max_scaled_vs_f64`` the gated errors
from the float64 one); the last line is {"ok": true, "device": ...}.
It imports numpy, torch and the port, nothing of jax or of the JAX package.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch


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


def port_modules() -> SimpleNamespace:
    """The port's modules this script drives.  Imported after the CUDA check,
    so that the script alone, outside the repository, fails before them."""
    from thesia_tpu_torch import native, runtime
    from thesia_tpu_torch.common.freqscale import FreqScale
    from thesia_tpu_torch.dsp.framing import SpecSetting
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer, reflect_pad_rows
    from thesia_tpu_torch.dsp.stft import stft_frame_count
    from thesia_tpu_torch.engine.images import land_u16
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_s16
    from thesia_tpu_torch.kernels import build, spec_db
    from thesia_tpu_torch.render import colormap, tiles
    from thesia_tpu_torch.tools import signals

    return SimpleNamespace(
        native=native, runtime=runtime, FreqScale=FreqScale, SpecSetting=SpecSetting,
        SpectrogramAnalyzer=SpectrogramAnalyzer, reflect_pad_rows=reflect_pad_rows,
        stft_frame_count=stft_frame_count, land_u16=land_u16, EngineSession=EngineSession,
        encode_wav_s16=encode_wav_s16, build=build, spec_db=spec_db, colormap=colormap,
        tiles=tiles, signals=signals,
    )


def dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel, dtype):
    """The plain version (window-folded DFT matrices) in ``dtype``, as f32."""
    cw, sw = m.spec_db.dft_matrices(window, n_fft, dtype)
    mel = None if mel is None else mel.to(dtype)
    return m.spec_db.spec_db_reference(
        padded.to(dtype), hop, win, n_frames, cw, sw, mel).float()


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
    regs = [ln.split("Used ")[1].split(",")[0] for ln in m.build.build_info["log"].splitlines()
            if "Used " in ln and "registers" in ln]
    t0 = time.perf_counter()
    native_ok = m.native.available()
    phase("build", seconds=round(m.build.build_info["seconds"], 3),
          compiled=m.build.build_info["compiled"], registers=regs,
          native=native_ok, native_seconds=round(time.perf_counter() - t0, 3))
    if not native_ok:
        raise RuntimeError("the port's native host library did not build")

    # 3. kernels vs plain at the main path's shapes
    sig = m.signals
    rng = np.random.default_rng(0)
    song_wavs, memo_wavs = sig.song(rng), sig.voice_memo(rng)
    analyzer = m.SpectrogramAnalyzer(dev)
    setting = m.SpecSetting()
    summary = {"mel": {}, "linear": {}}
    for label, wavs, sr in (("48k", song_wavs, sig.SONG_SR), ("16k", memo_wavs, sig.MEMO_SR)):
        hop, win, n_fft = setting.calc_framing_params(sr)
        window = analyzer.window(win, n_fft)
        mel = analyzer.mel_fb(sr, n_fft)
        raw = torch.from_numpy(wavs).to(dev)
        padded = m.reflect_pad_rows(raw, win // 2)
        n_frames = m.stft_frame_count(wavs.shape[1], win, hop)
        n_rows = wavs.shape[0]
        xw = (padded.unfold(-1, win, hop)[:, :n_frames] * window).contiguous()
        for variant, mel_ in (("mel", mel), ("linear", None)):
            got = kern.spec_db(padded, hop, win, n_frames, window, n_fft, mel_)
            ref64 = dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel_, torch.float64)
            ref32 = dft_plain(m, padded, hop, win, n_frames, window, n_fft, mel_, torch.float32)
            torch.cuda.synchronize()
            got_np, ref64_np, ref32_np = got.cpu().numpy(), ref64.cpu().numpy(), ref32.cpu().numpy()
            err64 = kern.db_error(ref64_np, got_np)
            err32 = kern.db_error(ref32_np, got_np)
            plain_err = kern.db_error(ref64_np, ref32_np)
            del got, ref64, ref32, got_np, ref64_np, ref32_np
            cw, sw = kern.dft_matrices(window, n_fft)
            k_ms = m.runtime.median_ms(
                lambda: kern.spec_db(padded, hop, win, n_frames, window, n_fft, mel_))
            p_ms = m.runtime.median_ms(
                lambda: kern.spec_db_reference(padded, hop, win, n_frames, cw, sw, mel_))
            lib_ms = m.runtime.median_ms(lambda: torch.fft.rfft(xw, n=n_fft))
            cols = n_fft // 2 + 1 if mel_ is None else mel_.shape[1]
            work = kern.kernel_work(n_rows, padded.shape[1], n_frames, win, n_fft, mel_)
            bound_ms, bound_by = m.runtime.bound_ms(work["bytes"], work["flop"])
            phase(f"kernels.{variant}.{label}",
                  shape=(n_rows, n_frames, win, n_fft, cols),
                  vs_f64_top60=err64["max_abs_top60"], vs_f64_scaled=err64["max_scaled"],
                  vs_f64_inf_equal=err64["inf_equal"], vs_f64_max_abs=err64["max_abs"],
                  vs_f32_top60=err32["max_abs_top60"], vs_f32_scaled=err32["max_scaled"],
                  vs_f32_inf_equal=err32["inf_equal"], vs_f32_max_abs=err32["max_abs"],
                  plain_f32_vs_f64_top60=plain_err["max_abs_top60"],
                  kernel_ms=round(k_ms, 4), plain_ms=round(p_ms, 4), library_ms=round(lib_ms, 4),
                  bound_ms=round(bound_ms, 4), bound_by=bound_by, mbytes=round(work["bytes"] / 1e6, 2),
                  gflop=round(work["flop"] / 1e9, 3), bound_share=round(bound_ms / k_ms, 4))
            # the gate's reference is the float64 plain version (kernels/
            # spec_db.py: SCALED_TOL); the float32 one must still agree on
            # -inf and on the scaled error
            if not (kern.within_tolerance(err64) and err32["inf_equal"]
                    and err32["max_scaled"] <= kern.SCALED_TOL):
                raise AssertionError(f"spec_db {variant} {label} disagrees with plain: {err64} / {err32}")
            s = summary[variant]
            s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err32["max_abs"])
            s["max_abs_top60_vs_f64"] = max(s.get("max_abs_top60_vs_f64", 0.0), err64["max_abs_top60"])
            s["max_scaled_vs_f64"] = max(s.get("max_scaled_vs_f64", 0.0), err64["max_scaled"])
            if label == "48k":
                s.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        del raw, padded, xw

    # 4. main path
    work = Path(tempfile.mkdtemp(prefix="thesia_chip_smoke_"))
    paths = [str(work / "song_48k_stereo.wav"), str(work / "memo_16k_mono.wav")]
    Path(paths[0]).write_bytes(m.encode_wav_s16(song_wavs, sig.SONG_SR))
    Path(paths[1]).write_bytes(m.encode_wav_s16(memo_wavs, sig.MEMO_SR))
    sess = m.EngineSession(settings_dir=work / "config")
    if sess.device != dev:
        raise AssertionError(f"EngineSession() runs on {sess.device}, not on {dev}")
    sess.init(m.colormap.default_colormap_rgba8().reshape(-1).tolist())
    kern.reset_launches()
    added, add_s, add_ms = timed(lambda: sess.add_tracks([0, 1], paths))
    mel_after_add = kern.spec_db.launches["mel"]
    if added != [0, 1] or mel_after_add < 1:
        raise AssertionError(f"add_tracks added {added}, mel kernel launches {mel_after_add}")
    updated, apply_s, apply_ms = timed(sess.apply_track_list_changes)
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
    mip_levels = 0
    for tid in (0, 1):
        imgs = sess.tm.images.get(tid)
        for level, dev_mip in imgs.device_mips.items():
            for ch in range(imgs.n_ch):
                host_chain = imgs.host[ch].mips()
                if not np.array_equal(dev_mip[ch], host_chain[level - 1]):
                    raise AssertionError(f"track {tid} ch {ch}: device mip {level} != host chain")
                mip_levels += 1
    wtile = m.tiles.decode_waveform_tile(sess.get_waveform_tile("0_0", 4, 0))
    if wtile["binCount"] != 1024 or not np.isfinite(wtile["bins"]).all():
        raise AssertionError(f"waveform tile: {wtile['binCount']} bins")
    phase("main", added=added, updated=updated,
          add_wall_s=round(add_s, 4), add_event_ms=round(add_ms, 3),
          apply_wall_s=round(apply_s, 4), apply_event_ms=round(apply_ms, 3),
          first_tile_wall_s=round(first[0], 5), first_tile_event_ms=round(first[1], 3),
          mel_launches_in_add=mel_after_add, tiles=tile_checks,
          device_mip_levels_equal=mip_levels,
          spec_shapes={k: tuple(v.db.shape) for k, v in sess.tm.specs.items()},
          image_geometry={k: (m_["spectrogramHeight"], m_["spectrogramWidth"])
                          for k, m_ in meta.items()},
          max_db=sess.get_max_db(), min_db=sess.get_min_db())
    if mip_levels == 0:
        raise AssertionError("no device mip level was checked")

    # 5. linear
    linear = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}
    _, set_s, set_ms = timed(lambda: sess.set_spec_setting(linear))
    tile, tile_s, tile_ms = timed(lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0))
    d = m.tiles.decode_spectrogram_tile(tile)
    h, w = sess.tm.images.geometry(0)
    g = m.tiles.spectrogram_tile_geometry(h, w, 0, 0, 0, 0)
    launches = dict(kern.spec_db.launches)
    if launches["linear"] < 1 or (d["width"], d["height"]) != (g["width"], g["height"]):
        raise AssertionError(f"linear: launches {launches}, tile {d['width']}x{d['height']} vs {g}")
    if sess.tm.setting.freq_scale is not m.FreqScale.Linear:
        raise AssertionError("set_spec_setting did not switch to Linear")
    phase("linear", set_wall_s=round(set_s, 4), set_event_ms=round(set_ms, 3),
          tile_wall_s=round(tile_s, 5), tile_event_ms=round(tile_ms, 3),
          launches=launches, image_height=h)

    # 6. compare the main path's kernel output with the plain version
    res = sess.tm.specs[0]
    hop, win, n_fft = sess.tm.setting.calc_framing_params(sig.SONG_SR)
    window = sess.tm.spec_analyzer.window(win, n_fft)
    raw = torch.from_numpy(sess.tracklist[0].audio.wavs[:1]).to(dev)
    padded = m.reflect_pad_rows(raw, win // 2)
    lo, span_ = sess.tm._quant_scalars()
    got_u16 = np.asarray(sess.tm.images.get(0).host[0])
    fields = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        ref = dft_plain(m, padded, hop, win, res.n_frames, window, n_fft, None, dtype)
        err = kern.db_error(ref.cpu().numpy(), res.db[:1].cpu().numpy())
        ref_img, _ = sess.tm.quantize(sig.SONG_SR, ref, res.n_frames, lo, span_)
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

    # 7. result lines
    kernels = []
    for variant, replaces in (("mel", "tests/pallas_spec.py:131"), ("linear", "tests/pallas_spec.py:98")):
        s = summary[variant]
        kernels.append({
            "name": f"spec_fft_{variant}", "route": "cuda",
            "source": "thesia_tpu_torch/csrc/spec_fft.cu", "replaces": replaces,
            "launches": launches[variant], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "max_abs_top60_vs_f64": s["max_abs_top60_vs_f64"],
            "max_scaled_vs_f64": s["max_scaled_vs_f64"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
