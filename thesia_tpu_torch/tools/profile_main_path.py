"""Device time of the port's main path on one CUDA card, by kernel and copy.

    python -m thesia_tpu_torch.tools.profile_main_path    # from the repository root

Drives what ``chip_smoke.py`` drives -- add_tracks (the 5-min 48 kHz stereo
song and 60-s 16 kHz memo of ``signals``, 16-bit WAVs) -> apply_track_list_changes -> first
spectrogram tile -> set_spec_setting(Linear) -> a tile -> the Limiter switch
(guard clipping set to Limiter, then a LUFS target that puts the song's peak
6 dB over full scale, so K8 runs for it) -- three times in one process, each
round on a fresh EngineSession with its own settings: a synchronous warm-up round, a
synchronous round (defer=False, the images drained inside the apply and
switch steps, as the landing used to be part of them) and a deferred round
(the default: dispatch steps, then ``settle`` steps that wait for
``settings_settled`` and the image streamer).  The last two run under
torch.profiler.  Prints the card's name and power limit, then JSON lines per
profiled round: the host wall of each step (synchronized), the device time
of each kernel or copy over the round (microseconds, the 15 largest; the
copy stream's device->host copies are the "Memcpy DtoH (Device -> Pinned)"
entries, the uploads the "Memcpy HtoD" ones, pinned or pageable by name), the
device total and the device's idle share of the round's wall
time (device time summed over the compute and copy streams, so overlapping
copies can push the share below its true value), and the launches and device
ms of each K9/K8 kernel (csrc/dynamics.cu).
"""

from __future__ import annotations

import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .. import runtime
from ..dsp import spectrogram
from ..engine.session import EngineSession
from ..io.wav import encode_wav_s16
from ..render.colormap import default_colormap_rgba8
from . import signals

LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}


def one_round(paths: list[str], work: Path, deferred: bool) -> dict[str, float]:
    sess = EngineSession(settings_dir=Path(tempfile.mkdtemp(prefix="config_", dir=work)))
    sess.init(default_colormap_rgba8().reshape(-1).tolist())
    kw = {} if deferred else {"defer": False}

    def settle():
        if not (sess.settings_settled(timeout=600) and sess.tm.images.drain(timeout=600)):
            raise RuntimeError("the session did not settle")

    def limiter():
        hot = sess.get_global_lufs(0)["value"] - sess.get_max_peak_db(0)["value"] + 6.0
        sess.set_common_guard_clipping("Limiter", **kw)
        sess.set_common_normalize({"type": "LUFS", "target": hot}, **kw)

    if deferred:
        steps = (
            ("add", lambda: sess.add_tracks([0, 1], paths)),
            ("apply", sess.apply_track_list_changes),
            ("first_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("settle_apply", settle),
            ("set_linear", lambda: sess.set_spec_setting(LINEAR)),
            ("settle_linear", settle),
            ("linear_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("limiter", limiter),
            ("settle_limiter", settle),
        )
    else:
        steps = (
            ("add", lambda: sess.add_tracks([0, 1], paths)),
            ("apply", lambda: (sess.apply_track_list_changes(**kw), settle())),
            ("first_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("set_linear", lambda: (sess.set_spec_setting(LINEAR, **kw), settle())),
            ("linear_tile", lambda: sess.get_spectrogram_tile("0_0", 0, 0, 0, 0)),
            ("limiter", lambda: (limiter(), settle())),
        )
    walls = {}
    for name, fn in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    sess.tm.images.shutdown()
    return walls


PARTS = ("recompute", "reflect_pad", "row_bounds")


def _annotated(name: str, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return run


def annotate_recompute() -> None:
    """Name the recompute's parts in the trace (this process only; the
    profiler records the names on the thread that runs it)."""
    an = spectrogram.SpectrogramAnalyzer
    an.calc_spec_multi = _annotated("recompute", an.calc_spec_multi)
    spectrogram.reflect_pad_rows = _annotated("reflect_pad", spectrogram.reflect_pad_rows)
    for name in ("amin", "amax"):  # a dB's per-row bounds reduce dims (1, 2)
        plain = getattr(torch.Tensor, name)
        named = _annotated("row_bounds", plain)
        setattr(torch.Tensor, name, lambda t, *a, _p=plain, _n=named, **k: (
            _n if k.get("dim") == (1, 2) and t.dim() == 3 else _p)(t, *a, **k))


def _device_us(evt) -> float:
    total = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if total is None else total


def recompute_parts(paths: list[str]) -> None:
    """Song and memo recomputed by ``calc_spec_multi`` on this thread, mel
    and linear, three times each after a warm-up, under the profiler: the
    device time and calls of each named part, per recompute."""
    from ..dsp.framing import SpecSetting
    from ..io.wav import decode_wav

    annotate_recompute()
    an = spectrogram.SpectrogramAnalyzer("cuda")
    tracks = [(i, *decode_wav(Path(path).read_bytes())[:2]) for i, path in enumerate(paths)]
    for scale, setting in (("mel", SpecSetting()), ("linear", SpecSetting.from_json(LINEAR))):
        for key, wavs, sr in tracks:
            an.calc_spec_multi(wavs, sr, setting, cache_key=key, token=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                for key, wavs, sr in tracks:
                    an.calc_spec_multi(wavs, sr, setting, cache_key=key, token=1)
            torch.cuda.synchronize()
        parts = {name: {"device_ms": 0.0, "calls": 0} for name in PARTS + ("spec_fft_kernel",)}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and "spec_fft_kernel" in evt.key:
                parts["spec_fft_kernel"]["device_ms"] += evt.self_device_time_total / 1e3
                parts["spec_fft_kernel"]["calls"] += evt.count
            elif evt.device_type != DeviceType.CUDA and evt.key in PARTS:
                parts[evt.key]["device_ms"] += _device_us(evt) / 1e3
                parts[evt.key]["calls"] += evt.count
        per = parts["recompute"]["calls"] or 1
        print(json.dumps({"recompute": scale, "tracks": len(tracks), "parts": parts,
                          "device_ms_per_recompute": {k: v["device_ms"] / per
                                                      for k, v in parts.items()}}), flush=True)


def profiled_round(label: str, paths: list[str], work: Path, deferred: bool) -> None:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        walls = one_round(paths, work, deferred)
        wall = time.perf_counter() - t0
    print(json.dumps({"round": label, "wall_s": walls}), flush=True)
    device = {}
    # device-side events only (kernels, copies, sets): an operator's event
    # (aten::copy_, aten::add) carries its kernels' device time as well, and
    # summing both would count that time twice
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            device[evt.key] = device.get(evt.key, 0.0) + evt.self_device_time_total
    total_us = sum(device.values())
    for key, us in sorted(device.items(), key=lambda kv: -kv[1])[:15]:
        print(json.dumps({"round": label, "device_us": round(us, 1), "name": key[:120]}), flush=True)
    # K9 and K8 (csrc/dynamics.cu): launches and device ms of each kernel
    dynamics = {evt.key[:60]: {"count": evt.count, "ms": round(evt.self_device_time_total / 1e3, 4)}
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA and ("k9_" in evt.key or "k8_" in evt.key)}
    print(json.dumps({"round": label, "dynamics_kernels": dynamics}), flush=True)
    dtoh = {k: round(v / 1e3, 3) for k, v in device.items() if "DtoH" in k}
    htod = {k: round(v / 1e3, 3) for k, v in device.items() if "HtoD" in k}
    print(json.dumps({"round": label, "device_total_ms": round(total_us / 1e3, 3),
                      "dtoh_ms": dtoh, "htod_ms": htod, "round_wall_ms": round(wall * 1e3, 3),
                      "device_idle_share": round(1.0 - total_us / 1e6 / wall, 4)}), flush=True)


def main() -> int:
    runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    rng = np.random.default_rng(0)
    work = Path(tempfile.mkdtemp(prefix="thesia_profile_"))
    paths = [str(work / "song_48k_stereo.wav"), str(work / "memo_16k_mono.wav")]
    Path(paths[0]).write_bytes(encode_wav_s16(signals.song(rng), signals.SONG_SR))
    Path(paths[1]).write_bytes(encode_wav_s16(signals.voice_memo(rng), signals.MEMO_SR))
    print(json.dumps({"round": "warm-up", "wall_s": one_round(paths, work, False)}), flush=True)
    profiled_round("sync", paths, work, False)
    profiled_round("deferred", paths, work, True)
    recompute_parts(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
