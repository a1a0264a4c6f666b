"""Dry run of the engine's batched recompute on an n-shard device mesh.

    python -m thesia_tpu_torch.tools.dryrun_mesh [N] [--device cuda|cpu]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``.  The mesh
has N shards (default 8): the first N visible cards, or, where fewer are
visible, the first card repeated N times (a virtual mesh, whose shards run
in turn); with ``--device cpu``, the CPU repeated N times.  Three cases, each
checked against the same work without a mesh:

1. rows over "tracks" (N, 1, 1) through ``TrackManager``: three tracks added,
   applied, a settings change, a LUFS normalize (the per-row gains of the
   sharded launch), a removal and a re-add; every u16 image and a tile
   before and after the drain equal with and without the mesh;
2. one stereo track (2 rows) over "freq" (2, 1, N/2);
3. the same 2 rows over "time" (2, N/2, 1).

Cases 2 and 3 hold ``calc_specs_batched``'s dB and row bounds bitwise equal
to the unsharded path's (the freq case on the CPU to the kernel's accuracy
gate instead: the plain version's column slices of torch's CPU matmul are
not bitwise) and print the busiest shard's bytes and FLOP
(``kernels/spec_db.py: kernel_work``) as a ratio to rows-DP on (N, 1, 1),
where each shard computes one whole row.  The time case must stay under
1.5 / (N/2); the freq case asserts no ratio, because every freq shard of the
port computes the whole FFT of its frames.  On a card it also prints the
kernel launches of each case and the peer-copy bytes.  Ends with
``dryrun_mesh(N): OK``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..common.freqscale import FreqScale
from ..dsp.framing import SpecSetting
from ..dsp.spectrogram import SpectrogramAnalyzer
from ..dsp.stft import stft_frame_count
from ..kernels import spec_db
from ..parallel import sharding
from ..runtime import resolve_device

SR = 8000
SETTING = SpecSetting(win_ms=40.0, t_overlap=4, f_overlap=1)


def mesh_devices(n: int, device: torch.device) -> list[torch.device]:
    """The first n visible cards, else the first card (or the CPU) n times."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def shard_work(sh, items, setting: SpecSetting, analyzer) -> dict:
    """Bytes and FLOP of the busiest shard of a batch of ``items`` (one
    (sr, setting) group) under ``sh``."""
    sr = items[0][2]
    hop, win, n_fft = setting.calc_framing_params(sr)
    mel = analyzer.mel_fb(sr, n_fft) if setting.freq_scale is FreqScale.Mel else None
    rows = sum(np.atleast_2d(w).shape[0] for _k, w, *_ in items)
    t_max = max(stft_frame_count(np.atleast_2d(w).shape[-1], win, hop) for _k, w, *_ in items)
    cols = n_fft // 2 + 1 if mel is None else mel.shape[1]
    works = [spec_db.kernel_work(s.r1 - s.r0, (s.t1 - s.t0 - 1) * hop + win, s.t1 - s.t0, win,
                                 n_fft, mel, col0=s.c0, n_cols=s.c1 - s.c0)
             for s in sharding.shard_plan(sh, rows, t_max, cols)]
    return {"bytes": max(w["bytes"] for w in works), "flop": max(w["flop"] for w in works),
            "shards": len(works)}


def _batched(items, setting, device, mesh):
    sharding.set_active_mesh(mesh)
    try:
        return SpectrogramAnalyzer(device).calc_specs_batched(items, setting)
    finally:
        sharding.set_active_mesh(None)


def _opted_in(mesh) -> sharding.SpecSharding:
    """The sharding the engine applies under ``mesh`` (every axis of more
    than one shard opted in, as ``active_spec_sharding`` does)."""
    return sharding.spec_sharding(mesh, freq_parallel=True, time_parallel=True)


def _launches() -> int:
    return sum(spec_db.spec_db.launches.values())


def engine_case(devices, device: torch.device, tmp: Path) -> dict:
    """Case 1: the TrackManager sequence with and without the rows mesh."""
    from ..dynamics import NormalizeTarget
    from ..engine.manager import TrackManager
    from ..engine.track import TrackList
    from ..io.wav import encode_wav_f32
    from ..render.colormap import default_colormap_rgba8

    rng = np.random.default_rng(0)
    paths = []
    for i, (wsr, n_ch) in enumerate([(8000, 2), (8000, 1), (16000, 1)]):
        p = tmp / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.9, 0.9, (n_ch, wsr)).astype(np.float32), wsr))
        paths.append(str(p))
    cmap = default_colormap_rgba8().reshape(-1, 4)

    def run(mesh):
        sharding.set_active_mesh(mesh)
        try:
            tl, tm = TrackList(device), TrackManager(device)
            tm.add_tracks(tl, tl.add_tracks([0, 1, 2], paths))
            tm.apply_track_list_changes(tl)
            tm.set_setting(tl, SpecSetting(win_ms=20.0, t_overlap=2))
            tl.set_common_normalize(NormalizeTarget("LUFS", -30.0))
            tm.update_all_specs_imgs(tl)
            tm.remove_tracks(tl, tl.remove_tracks([1]))
            tm.apply_track_list_changes(tl)
            tl.add_tracks([3], [paths[1]])
            tm.add_tracks(tl, [3])
            tm.apply_track_list_changes(tl)
            interim = tm.images.tile_body(0, 0, cmap, 0, 0, 0, 0)
            tm.images.drain()
            settled = tm.images.tile_body(0, 0, cmap, 0, 0, 0, 0)
            assert interim == settled, "interim tile != settled tile"
            return {k: np.array(v) for k, v in tm.spec_imgs.items()}, settled
        finally:
            sharding.set_active_mesh(None)

    before = _launches()
    imgs_mesh, tile_mesh = run(sharding.make_mesh(devices=devices))
    launches = _launches() - before
    imgs_1, tile_1 = run(None)
    assert imgs_mesh.keys() == imgs_1.keys() and imgs_1, (sorted(imgs_mesh), sorted(imgs_1))
    for k in imgs_1:
        assert np.array_equal(imgs_mesh[k], imgs_1[k]), f"image {k} differs under the mesh"
    assert tile_mesh == tile_1, "mesh tile bytes != single-device tile bytes"
    return {"images_equal": len(imgs_1), "launches": launches}


def two_row_case(axis: str, devices, device: torch.device) -> dict:
    """Cases 2 and 3: one stereo track over "freq" or "time" against the
    unsharded result, and the busiest shard's work against rows-DP."""
    n = len(devices)
    k = n // 2
    rng = np.random.default_rng(3)
    items = [(0, rng.uniform(-1, 1, (2, 24000)).astype(np.float32), SR, 1)]
    mesh = sharding.make_mesh(devices=devices, **{f"{axis}_parallel": k})
    single = _batched(items, SETTING, device, None)
    before = _launches()
    got = _batched(items, SETTING, device, mesh)
    launches = _launches() - before
    a, b = got[0], single[0]
    exact = (torch.equal(a.db, b.db) and torch.equal(a.row_min, b.row_min)
             and torch.equal(a.row_max, b.row_max))
    if axis == "freq" and device.type == "cpu":
        err = spec_db.db_error(b.db.numpy(), a.db.numpy())
        assert spec_db.within_tolerance(err), f"freq shards vs unsharded: {err}"
    else:
        assert exact, f"{axis} shards differ from the unsharded result"
    analyzer = SpectrogramAnalyzer(device)
    work = shard_work(_opted_in(mesh), items, SETTING, analyzer)
    dp = shard_work(_opted_in(sharding.make_mesh(devices=devices)), items, SETTING, analyzer)
    ratio = {key: work[key] / dp[key] for key in ("bytes", "flop")}
    if axis == "time":
        assert ratio["flop"] < 1.5 / k, ratio
    return {"bitwise": exact, "shards": work["shards"], "launches": launches,
            "bytes_vs_rows_dp": round(ratio["bytes"], 4), "flop_vs_rows_dp": round(ratio["flop"], 4)}


def dryrun(n_devices: int = 8, device="cuda") -> dict:
    device = resolve_device(device)
    devices = mesh_devices(n_devices, device)
    assert n_devices % 2 == 0 and n_devices >= 4, "N must be even and at least 4"
    virtual = len(set(devices)) < n_devices
    sharding.reset_counters()
    out = {"devices": [str(d) for d in devices], "virtual": virtual}
    with tempfile.TemporaryDirectory(prefix="thesia_dryrun_mesh_") as tmp:
        out["rows"] = engine_case(devices, device, Path(tmp))
    out["freq"] = two_row_case("freq", devices, device)
    out["time"] = two_row_case("time", devices, device)
    out["peer_bytes"] = sharding.peer_bytes()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # no background warming in the dry run: a warm job still running when
    # the process exits would be cut off inside a torch call
    os.environ["THESIA_PRECOMPILE"] = "0"
    out = dryrun(args.n, args.device)
    for case in ("rows", "freq", "time"):
        print(f"[dryrun.{case}] " + " ".join(f"{k}={v}" for k, v in out[case].items()), flush=True)
    print(f"devices={out['devices']} virtual={out['virtual']} peer_bytes={out['peer_bytes']}")
    print(f"dryrun_mesh({args.n}): OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
