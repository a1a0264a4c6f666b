"""The plain reference of one session state, and the comparison that decides
``correct``.

``Reference(tracks, device, control)`` holds the tracks the benchmark wrote
(int16 samples, rate) and works out, for a state of the viewer's knobs
(spec setting, dB range, normalize target, guard mode), what the engine
should report: each track's stats, guard statistics and limiter gains, its
u16 image and mip chain, and any spectrogram or waveform tile.  It reads
nothing the port made.  With ``control`` set it is the benchmark's control:
each output in the precision just below the one the port states -- the
spectrogram with TF32 matrix products (the port: float32, TF32 off), the
dynamics in float32 (the port: float64), the waveform tiles from samples
rounded to bfloat16 (the port: float32 samples).  ``compare`` holds what the port answered in the
window (``Observation``) against it and returns the numbers that ``correct``
is judged by.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import dynamics, render
from . import spectrogram as spec
from .framing import SpecSetting


@dataclasses.dataclass
class Observation:
    """What the port answered at the end of one command: tile bytes by
    request, the track summary readers, and the limiter gains it held."""

    state: dict
    spec_tiles: dict  # (track, ch, lx, ly, tx, ty) -> bytes
    wave_tiles: dict  # (track, ch, level, tile) -> bytes
    summary: dict  # track -> {"lufs", "rms", "peak"}
    limiter: dict  # track -> f32 array or None


class Reference:
    def __init__(self, tracks: list[tuple[np.ndarray, int]], device, control: bool = False):
        self.tracks = [(x.astype(np.float32) / np.float32(32768.0), sr) for x, sr in tracks]
        self.device = torch.device(device)
        self.control = control
        self.precision = "tf32" if control else "float64"
        self.dtype = np.float32 if control else np.float64
        self._orig_stats = [dynamics.calc_stats(x, sr, self.dtype) for x, sr in self.tracks]
        self._state_key = None

    def _prepare(self, state: dict) -> None:
        key = repr(sorted((k, repr(v)) for k, v in state.items()))
        if key == self._state_key:
            return
        self._state_key = None
        setting = SpecSetting.from_json(state["spec"])
        self.guarded, self.stats = [], []
        for (x, sr), st in zip(self.tracks, self._orig_stats):
            gain = dynamics.normalize_gain(state["normalize"], st)
            g = dynamics.apply_gain_and_guard(x, sr, gain, state["guard"], self.dtype, self.device)
            self.guarded.append(g)
            self.stats.append(st if g.wavs is x else dynamics.calc_stats(g.wavs, sr, self.dtype))
        dbs = [spec.track_db(g.wavs, sr, setting, self.device, self.precision)
               for g, (_x, sr) in zip(self.guarded, self.tracks)]
        lo, hi = spec.global_range(dbs, float(state["db_range"]))
        max_sr = max(sr for _x, sr in self.tracks)
        minv = render.min_value(len(render.colormap_rgba8()))
        self.images = []
        for d, (_x, sr) in zip(dbs, self.tracks):
            self.images.append(spec.image(d, sr, max_sr, setting, lo, hi, minv))
        del dbs
        self._chains = {}
        self._state_key = key

    def chain(self, track: int, ch: int, depth: int) -> list[np.ndarray]:
        chain = self._chains.setdefault((track, ch), [self.images[track][ch]])
        n = render.chain_len(chain[0].shape[1])
        while len(chain) - 1 < min(depth, n):
            chain.append(render.halve_x_u16(chain[-1]))
        return chain

    def spec_tile(self, track, ch, lx, ly, tx, ty):
        return render.spectrogram_tile(self.chain(track, ch, lx), render.colormap_rgba8(),
                                       lx, ly, tx, ty)

    def wave_tile(self, track, ch, level, tile):
        wav = self.guarded[track].drawn[ch]
        if self.control:
            wav = torch.from_numpy(np.asarray(wav, np.float32)).bfloat16().float().numpy()
        return render.waveform_tile(wav, level, tile)

    def summary(self, track: int) -> dict:
        st = self.stats[track]
        return {"lufs": st.global_lufs, "rms": st.rms_db, "peak": st.max_peak_db}

    def limiter(self, track: int):
        g = self.guarded[track].gain_seq
        if g is None:
            return None
        return g if (g < 1.0).any() else np.ones(1, np.float32)

    def outputs(self, state: dict):
        self._prepare(state)
        return self


def _gap(a: float, b: float) -> float:
    if a == b or (math.isinf(a) and math.isinf(b) and (a > 0) == (b > 0)):
        return 0.0
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) if math.isfinite(a) and math.isfinite(b) else math.inf


def compare(ref: Reference, observations: list[Observation]) -> dict:
    """The numbers ``correct`` is judged by, each the worst over the
    observations: ``spec_px_off`` (the share of spectrogram tile pixels whose
    colour differs from the reference's; a tile of other geometry counts
    whole), ``wave_gap`` (the largest gap of a waveform tile's min, max or
    mean), ``stats_gap_db`` (the largest gap of LUFS, RMS dB or peak dB)
    and ``limiter_gap`` (the largest gap of a limiter
    gain; 1 where one side limits and the other does not)."""
    px_off = px_all = 0
    wave_gap = stats_gap = limiter_gap = 0.0
    # one reference pass a distinct state
    for ob in sorted(observations, key=lambda o: repr(sorted(o.state.items()))):
        r = ref.outputs(ob.state)
        for (t, ch, lx, ly, tx, ty), data in ob.spec_tiles.items():
            geo, want = r.spec_tile(t, ch, lx, ly, tx, ty)
            got_geo, got = render.decode_spectrogram_tile(data)
            n = want.shape[0] * want.shape[1]
            px_all += n
            if got_geo != geo or got.shape != want.shape:
                px_off += n
                continue
            px_off += int((got != want).any(axis=-1).sum())
        for (t, ch, level, tile), data in ob.wave_tiles.items():
            want = r.wave_tile(t, ch, level, tile)
            got = render.decode_waveform_tile(data).astype(np.float64)
            if got.shape != want.shape:
                wave_gap = math.inf
                continue
            if want.size:
                wave_gap = max(wave_gap, float(np.abs(got - want).max()))
        for t, got in ob.summary.items():
            want = r.summary(t)
            for k in ("lufs", "rms", "peak"):
                stats_gap = max(stats_gap, _gap(got[k], want[k]))
        for t, got in ob.limiter.items():
            want = r.limiter(t)
            if (got is None) != (want is None):
                limiter_gap = max(limiter_gap, 1.0)
            elif got is not None:
                got = np.asarray(got, np.float64).reshape(-1)
                if got.shape != want.shape:
                    limiter_gap = max(limiter_gap, 1.0)
                else:
                    limiter_gap = max(limiter_gap, float(np.abs(got - want).max()))
    return {"spec_px_off": px_off / px_all if px_all else 0.0, "wave_gap": wave_gap,
            "stats_gap_db": stats_gap, "limiter_gap": limiter_gap,
            "tiles_compared": len([1 for ob in observations for _ in ob.spec_tiles])
            + len([1 for ob in observations for _ in ob.wave_tiles])}
