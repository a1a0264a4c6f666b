"""The port's device mesh (thesia_tpu_torch/parallel/sharding.py) against the
JAX package's (thesia_tpu/parallel/sharding.py, tests/test_parallel.py).

On the CPU the port's meshes are virtual: ``make_mesh(devices=["cpu"] * 8)``,
the counterpart of the JAX package's 8 virtual XLA CPU devices
(tests/conftest.py).  ``calc_specs_batched`` under a mesh is held:

  * against the port without a mesh, bitwise, on the "tracks" and "time"
    axes (frames and rows are independent rows of the plain version's
    matrix products, which torch's CPU matmul keeps bitwise at these sizes:
    at a few hundred frames it changes its blocking with the row count, and
    a 201-frame 16 kHz row split four ways differed by 7.6e-6 dB in 17
    frames with torch 2.13 on the CPU);
  * on the "freq" axis within tests/torch_parity.py's contract instead: the
    plain version multiplies column slices of its matrices there, which
    torch's CPU matmul does not promise to keep bitwise (on the card the
    kernel's columns are bitwise, the gpu case below);
  * against JAX's sharded ``calc_specs_batched`` on its 8 virtual devices
    within tests/torch_parity.py's contract, the same contract as unsharded.

Small sizes as in tests/test_parallel.py: 8 kHz, 4-6k samples, 1-3 tracks."""

import numpy as np
import pytest
import torch

import thesia_tpu.dsp.spectrogram as jax_spec
import thesia_tpu.parallel.sharding as jax_sharding
import thesia_tpu_torch.dsp.spectrogram as port_spec
from torch_parity import assert_db_close, db_limit
from thesia_tpu.common.freqscale import FreqScale as JaxFreqScale
from thesia_tpu.dsp import framing as jax_framing
from thesia_tpu_torch.common.freqscale import FreqScale
from thesia_tpu_torch.dsp import framing as port_framing
from thesia_tpu_torch.dsp import precompile
from thesia_tpu_torch.io.wav import encode_wav_f32
from thesia_tpu_torch.kernels import spec_db as spec_db_mod
from thesia_tpu_torch.parallel import sharding

CPU8 = ["cpu"] * 8
# (tracks, time, freq) meshes of 8 shards
MESHES = [(8, 1, 1), (4, 2, 1), (2, 1, 4), (1, 4, 2)]


def _items(seed=0, n=4096, sr=8000, gains=False):
    """Three tracks of 2, 1 and 2 channels, tokens tid + 1 (and per-track
    gains, the normalize's, when asked)."""
    rng = np.random.default_rng(seed)
    out = []
    for tid, c in enumerate([2, 1, 2]):
        item = (tid, rng.uniform(-1, 1, (c, n + 700 * tid)).astype(np.float32), sr, tid + 1)
        out.append(item + ((0.5, 1.0, 1.7)[tid],) if gains else item)
    return out


def _settings(scale):
    return (jax_framing.SpecSetting(freq_scale=JaxFreqScale(scale)),
            port_framing.SpecSetting(freq_scale=FreqScale(scale)))


def _port_mesh(shape, devices=CPU8):
    rows, time, freq = shape
    return sharding.make_mesh(devices=devices, time_parallel=time, freq_parallel=freq)


def _port_batched(items, setting, mesh):
    sharding.set_active_mesh(mesh)
    try:
        return port_spec.SpectrogramAnalyzer("cpu").calc_specs_batched(items, setting)
    finally:
        sharding.set_active_mesh(None)


def test_mesh_api_and_the_freq_time_opt_in():
    """Counterpart of test_active_mesh_forwards_freq_parallel_opt_in: a mesh
    built with freq_parallel or time_parallel above 1 opts that axis in; the
    default mesh is rows only; below two shards there is no sharding."""
    mesh = sharding.make_mesh(devices=CPU8, freq_parallel=2)
    assert mesh.axis_names == ("tracks", "time", "freq")
    assert mesh.shape == {"tracks": 4, "time": 1, "freq": 2} and mesh.size == 8
    assert mesh.devices.shape == (4, 1, 2) and mesh.devices[3, 0, 1] == torch.device("cpu")
    sharding.set_active_mesh(mesh)
    try:
        assert sharding.active_mesh() is mesh
        sh = sharding.active_spec_sharding()
        assert sh.freq_parallel and not sh.time_parallel and (sh.n_rows, sh.n_freq) == (4, 2)
    finally:
        sharding.set_active_mesh(None)
    assert sharding.active_spec_sharding() is None
    for mesh, freq, time in ((sharding.make_mesh(devices=CPU8), False, False),
                             (sharding.make_mesh(devices=CPU8, time_parallel=4), False, True)):
        sharding.set_active_mesh(mesh)
        try:
            sh = sharding.active_spec_sharding()
            assert (sh.freq_parallel, sh.time_parallel) == (freq, time)
        finally:
            sharding.set_active_mesh(None)
    sharding.set_active_mesh(sharding.make_mesh(devices=["cpu"]))
    try:
        assert sharding.active_spec_sharding() is None
    finally:
        sharding.set_active_mesh(None)
    assert not sharding.spec_sharding(sharding.make_mesh(devices=CPU8, freq_parallel=2)).freq_parallel
    assert sharding.make_mesh(4, devices=CPU8).size == 4
    with pytest.raises(AssertionError):
        sharding.make_mesh(devices=["cpu"] * 6, freq_parallel=4)
    assert sharding.auto_mesh() is None  # no card here
    assert hash(sharding.spec_sharding(mesh)) == hash(sharding.spec_sharding(mesh))


def test_pad_rows_for_equals_the_jax_function():
    for n in range(1, 9):
        jsh = jax_sharding.spec_sharding(jax_sharding.make_mesh(n))
        psh = sharding.spec_sharding(sharding.make_mesh(devices=["cpu"] * n))
        assert psh.n_rows == jsh.n_rows == n
        for rows in range(0, 40):
            assert sharding.pad_rows_for(psh, rows) == jax_sharding.pad_rows_for(jsh, rows)
            assert sharding.pad_rows_for(None, rows) == jax_sharding.pad_rows_for(None, rows)
    for f, t in ((2, 1), (1, 4), (2, 2)):
        jsh = jax_sharding.spec_sharding(jax_sharding.make_mesh(8, f, t))
        psh = sharding.spec_sharding(sharding.make_mesh(devices=CPU8, freq_parallel=f,
                                                        time_parallel=t))
        assert (psh.n_rows, psh.n_time, psh.n_freq) == (jsh.n_rows, jsh.n_time, jsh.n_freq)
        assert [sharding.pad_rows_for(psh, r) for r in range(20)] == \
            [jax_sharding.pad_rows_for(jsh, r) for r in range(20)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_shard_plan_places_rows_as_the_jax_package(shape):
    """Row r of a batch lies on tracks shard r // (pad_rows_for / n_rows);
    frames and columns split into contiguous blocks that cover them once;
    padding rows, frames past the end and columns past the end make no
    shard."""
    sh = sharding.spec_sharding(_port_mesh(shape), freq_parallel=True, time_parallel=True)
    for rows, n_frames, n_cols in ((5, 52, 87), (2, 3, 513), (1, 1, 1), (9, 100, 4)):
        plan = sharding.shard_plan(sh, rows, n_frames, n_cols)
        per = sharding.pad_rows_for(sh, rows) // sh.n_rows
        cover = np.zeros((rows, n_frames, n_cols), np.int64)
        for s in plan:
            assert s.r0 < s.r1 and s.t0 < s.t1 and s.c0 < s.c1
            assert s.r0 // per == (s.r1 - 1) // per
            cover[s.r0:s.r1, s.t0:s.t1, s.c0:s.c1] += 1
        assert (cover == 1).all()
        assert len({(s.r0, s.t0, s.c0) for s in plan}) == len(plan)
        assert all(s.device == torch.device("cpu") for s in plan)
    no_freq = sharding.shard_plan(sh, 2, 10, 50, use_freq=False)
    assert all((s.c0, s.c1) == (0, 50) for s in no_freq)


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_batch_is_the_unsharded_batch(shape, scale):
    """tracks and time: bitwise; freq: within the contract (CPU matmul on
    column slices), bounds within it too.  With per-track gains."""
    _js, s = _settings(scale)
    items = _items(gains=True)
    single = _port_batched(items, s, None)
    sharded = _port_batched(items, s, _port_mesh(shape))
    assert list(sharded) == [0, 1, 2]
    for tid, wavs, *_ in items:
        a, b = sharded[tid], single[tid]
        assert a.db.shape == b.db.shape and a.db.shape[0] == wavs.shape[0]
        assert a.n_frames == b.n_frames and a.db.is_contiguous()
        if shape[2] == 1:
            assert torch.equal(a.db, b.db)
            assert torch.equal(a.row_min, b.row_min) and torch.equal(a.row_max, b.row_max)
        else:
            assert_db_close(b.db.numpy(), a.db.numpy())
            row_max = b.row_max.numpy()
            assert (np.abs(a.row_max.numpy() - row_max) <= db_limit(row_max, row_max)).all()


@pytest.mark.parametrize("scale", ["Mel", "Linear"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_batch_matches_the_jax_sharded_batch(shape, scale):
    """The same mesh shape on both sides: the port on 8 virtual CPU shards,
    the JAX package on its 8 virtual XLA CPU devices."""
    js, s = _settings(scale)
    items = _items(seed=1)
    rows, time, freq = shape
    jax_sharding.set_active_mesh(jax_sharding.make_mesh(8, freq_parallel=freq, time_parallel=time))
    try:
        assert jax_sharding.active_spec_sharding() is not None
        jout = jax_spec.SpectrogramAnalyzer().calc_specs_batched(items, js)
    finally:
        jax_sharding.set_active_mesh(None)
    tout = _port_batched(items, s, _port_mesh(shape))
    for tid, *_ in items:
        jres, tres = jout[tid], tout[tid]
        want = np.asarray(jres.db_padded)[:, : jres.n_frames]
        assert tres.n_frames == jres.n_frames and tres.db.shape == want.shape
        assert_db_close(want, tres.db.numpy())
        jmin, jmax = jres.min_max_db()
        tmin, tmax = tres.min_max_db()
        assert abs(tmax - jmax) <= db_limit(jmax, jmax)
        assert abs(tmin - jmin) <= db_limit(jmin, jmax)


def test_short_tracks_stay_unsharded_and_the_mesh_starts_on_the_analyzer():
    """A track shorter than its window takes calc_spec_multi, as in the JAX
    package; a mesh whose first device is not the analyzer's raises."""
    _js, s = _settings("Mel")
    rng = np.random.default_rng(4)
    items = [(0, rng.uniform(-1, 1, (1, 100)).astype(np.float32), 8000, 1),
             (1, rng.uniform(-1, 1, (2, 5000)).astype(np.float32), 8000, 2)]
    single = _port_batched(items, s, None)
    sharded = _port_batched(items, s, _port_mesh((4, 2, 1)))
    for tid in (0, 1):
        assert torch.equal(sharded[tid].db, single[tid].db)

    class Elsewhere:
        device = torch.device("meta")

    sharding.set_active_mesh(_port_mesh((8, 1, 1)))
    try:
        analyzer = port_spec.SpectrogramAnalyzer("cpu")
        analyzer.device = Elsewhere.device
        with pytest.raises(ValueError, match="mesh starts on cpu"):
            analyzer.calc_specs_batched(items, s)
    finally:
        sharding.set_active_mesh(None)


def test_kernel_ranges_on_the_plain_route():
    """The wrapper's two ranges on the CPU: a view of the rows from frame t0
    (the time shard's input) gives frames t0.. of the whole launch bitwise;
    columns [c0, c1) give those columns within the contract; kernel_work's
    defaults are the whole launch."""
    rng = np.random.default_rng(8)
    hop, win, n_fft, n_frames = 80, 320, 512, 40
    padded = torch.from_numpy(rng.standard_normal((2, (n_frames - 1) * hop + win)).astype(np.float32))
    an = port_spec.SpectrogramAnalyzer("cpu")
    window, mel = an.window(win, n_fft), an.mel_fb(8000, n_fft)
    for m in (mel, None):
        full = spec_db_mod.spec_db(padded, hop, win, n_frames, window, n_fft, m)
        t0, t1 = 13, 29
        view = padded[:, t0 * hop:(t1 - 1) * hop + win]
        assert not view.is_contiguous()
        assert torch.equal(spec_db_mod.spec_db(view, hop, win, t1 - t0, window, n_fft, m),
                           full[:, t0:t1])
        cols = full.shape[-1]
        for c0, c1 in ((0, cols), (0, 7), (5, 40), (cols - 3, cols), (cols // 2, cols // 2 + 1)):
            got = spec_db_mod.spec_db(padded, hop, win, n_frames, window, n_fft, m,
                                      col0=c0, n_cols=c1 - c0)
            assert got.shape == (2, n_frames, c1 - c0)
            assert_db_close(full[..., c0:c1].numpy(), got.numpy())
        with pytest.raises(ValueError, match="columns"):
            spec_db_mod.spec_db(padded, hop, win, n_frames, window, n_fft, m, col0=cols - 1,
                                n_cols=2)
        whole = spec_db_mod.kernel_work(2, padded.shape[1], n_frames, win, n_fft, m)
        assert whole == spec_db_mod.kernel_work(2, padded.shape[1], n_frames, win, n_fft, m,
                                                col0=0, n_cols=cols)
        halves = [spec_db_mod.kernel_work(2, padded.shape[1], n_frames, win, n_fft, m, col0=c0,
                                          n_cols=c1 - c0) for c0, c1 in sharding.blocks(cols, 2)]
        out_bytes = 4 * 2 * n_frames * cols
        assert sum(h["bytes"] for h in halves) > whole["bytes"]  # each half reads the rows
        assert halves[0]["bytes"] < whole["bytes"] - out_bytes // 3
        assert all(h["flop"] < whole["flop"] for h in halves)


def _wav_paths(tmp_path, specs, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, (sr, n_ch, n) in enumerate(specs):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.9, 0.9, (n_ch, n)).astype(np.float32), sr))
        paths.append(str(p))
    return paths


def _manager_images(paths, mesh, setting=None):
    from thesia_tpu_torch.engine.manager import TrackManager
    from thesia_tpu_torch.engine.track import TrackList

    sharding.set_active_mesh(mesh)
    try:
        tl, tm = TrackList("cpu"), TrackManager("cpu")
        tm.add_tracks(tl, tl.add_tracks(list(range(len(paths))), paths))
        tm.apply_track_list_changes(tl)
        if setting is not None:
            tm.set_setting(tl, setting)
        return {k: np.array(v) for k, v in tm.spec_imgs.items()}
    finally:
        sharding.set_active_mesh(None)


def test_engine_spec_imgs_sharded_bitexact(tmp_path):
    """Counterpart of tests/test_parallel.py's case: TrackManager u16 images
    equal with and without a rows mesh."""
    paths = _wav_paths(tmp_path, [(8000, 2, 6000), (8000, 1, 6000), (8000, 2, 6000)], 1)
    sharded = _manager_images(paths, _port_mesh((8, 1, 1)))
    single = _manager_images(paths, None)
    assert sharded.keys() == single.keys() and single
    for k in single:
        np.testing.assert_array_equal(sharded[k], single[k])


def test_time_parallel_engine_sequence_bit_exact(tmp_path):
    """Counterpart of tests/test_parallel.py's case: a (2 tracks x 4 time)
    mesh, two rates, then a Linear switch; every u16 pixel equal."""
    paths = _wav_paths(tmp_path, [(8000, 2, 8000), (16000, 1, 16000)], 6)
    linear = port_framing.SpecSetting(freq_scale=FreqScale.Linear)
    for setting in (None, linear):
        sharded = _manager_images(paths, _port_mesh((2, 4, 1)), setting)
        single = _manager_images(paths, None, setting)
        assert sharded.keys() == single.keys() and single
        for k in single:
            np.testing.assert_array_equal(sharded[k], single[k])


def test_warm_jobs_follow_the_active_mesh(monkeypatch):
    """The warm hooks pass the active sharding to spec_jobs_for: a job's key
    names it, and its launches go to each distinct device of the mesh at
    the column range of that device's first shard."""
    from thesia_tpu_torch.engine.manager import TrackManager

    tm = TrackManager("cpu")
    captured = []
    monkeypatch.setenv("THESIA_PRECOMPILE", "1")
    monkeypatch.setattr(tm.shape_warmer, "submit", lambda jobs: captured.append(list(jobs)))
    mesh = _port_mesh((2, 1, 4))
    sharding.set_active_mesh(mesh)
    try:
        sh = sharding.active_spec_sharding()
        tm.warm_for_pending_add([], [("x.wav", (2, 48000), 16000)])
    finally:
        sharding.set_active_mesh(None)
    keys = [make()[0] for make in captured.pop()]
    assert keys[0] == ("spec_full", precompile._spec_statics(16000, tm.setting), sh)
    statics = precompile._spec_statics(16000, tm.setting)
    cols = tm.spec_analyzer.mel_fb(16000, statics[3]).shape[1]
    assert precompile._warm_targets(tm.spec_analyzer, statics, sh) == [
        (torch.device("cpu"), 0, sharding.blocks(cols, 4)[0][1])]
    assert precompile._warm_targets(tm.spec_analyzer, statics, None) == [
        (torch.device("cpu"), 0, None)]
    _make_key, run = precompile.spec_full_job(tm.spec_analyzer, (2, 48000), 16000, tm.setting,
                                              sh)()
    run()  # builds the tables and runs the small launch at that range


def test_peer_copy_counters():
    sharding.reset_counters()
    sharding.count_peer_copy(torch.device("cuda", 1), 400)
    sharding.count_peer_copy(torch.device("cuda", 1), 100)
    sharding.count_peer_copy(torch.device("cuda", 2), 8)
    assert sharding.counters == {"cuda:1": {"copies": 2, "bytes": 500},
                                 "cuda:2": {"copies": 1, "bytes": 8}}
    assert sharding.peer_bytes() == 508
    sharding.reset_counters()
    assert sharding.counters == {} and sharding.peer_bytes() == 0


def test_the_dry_run_on_the_cpu():
    from thesia_tpu_torch.tools import dryrun_mesh

    out = dryrun_mesh.dryrun(8, "cpu")
    assert out["virtual"] and out["peer_bytes"] == 0
    assert out["rows"]["images_equal"] == 4
    assert out["time"]["bitwise"] and out["time"]["flop_vs_rows_dp"] < 1.5 / 4
    assert out["freq"]["shards"] == out["time"]["shards"] == 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mel", "linear"])
def test_kernel_ranges_are_the_whole_launch_bitwise_on_the_card(cuda, variant):
    """The kernel on a frame range (a view from frame t0) and on column
    ranges (the first, a middle, the upper half's, a single one, the last)
    gives exactly the entries of the whole launch; and calc_specs_batched on
    virtual meshes of the card repeated 4 times is the unsharded result
    bitwise on every axis."""
    rng = np.random.default_rng(21)
    hop, win, n_fft, n_frames = 480, 1920, 2048, 70
    padded = torch.from_numpy(
        rng.standard_normal((3, (n_frames - 1) * hop + win)).astype(np.float32)).to(cuda)
    an = port_spec.SpectrogramAnalyzer(cuda)
    window = an.window(win, n_fft)
    mel = an.mel_fb(48000, n_fft) if variant == "mel" else None
    gains = torch.tensor([0.5, 1.0, 1.7], dtype=torch.float32, device=cuda)
    full = spec_db_mod.spec_db(padded, hop, win, n_frames, window, n_fft, mel, gains=gains)
    for t0, t1 in ((0, 17), (17, 18), (33, 70)):
        view = padded[1:, t0 * hop:(t1 - 1) * hop + win]
        got = spec_db_mod.spec_db(view, hop, win, t1 - t0, window, n_fft, mel, gains=gains[1:])
        assert torch.equal(got, full[1:, t0:t1])
    cols = full.shape[-1]
    # linear: 512 = n_fft / 4 is the bin that pairs with itself, 1024 the last
    single = (511, 512, 513) if variant == "linear" else (cols // 2,)
    for c0, c1 in ((0, cols // 4), (100, 230), (cols // 2, cols), (cols - 1, cols), (0, cols),
                   *((c, c + 1) for c in single)):
        got = spec_db_mod.spec_db(padded, hop, win, n_frames, window, n_fft, mel, gains=gains,
                                  col0=c0, n_cols=c1 - c0)
        assert torch.equal(got, full[..., c0:c1])
    setting = port_framing.SpecSetting(
        freq_scale=FreqScale.Mel if variant == "mel" else FreqScale.Linear)
    items = [(0, rng.uniform(-1, 1, (2, 48000)).astype(np.float32), 48000, 1, 0.5),
             (1, rng.uniform(-1, 1, (1, 30000)).astype(np.float32), 48000, 2)]
    single = an.calc_specs_batched(items, setting)
    for shape in ((4, 1, 1), (1, 4, 1), (1, 1, 4), (2, 1, 2)):
        sharding.set_active_mesh(_port_mesh(shape, [cuda] * 4))
        try:
            sharded = port_spec.SpectrogramAnalyzer(cuda).calc_specs_batched(items, setting)
        finally:
            sharding.set_active_mesh(None)
        for tid in (0, 1):
            assert torch.equal(sharded[tid].db, single[tid].db), (shape, tid)
            assert torch.equal(sharded[tid].row_min, single[tid].row_min)


@pytest.mark.parametrize("n_fft", [1, 2, 8, 512, 2048])
def test_bin_pairs_are_the_pairs_that_touch_the_columns(n_fft):
    """The linear variant walks the run of bin pairs (k, h-k) that touch its
    columns: every touching pair is in it, and its ends touch."""
    h = max(n_fft // 2, 1)
    n_freq = n_fft // 2 + 1
    pairs = range(h // 2 + 1)

    def touches(k, c0, c1):
        return c0 <= k < c1 or (h - k != k and h < n_freq and c0 <= h - k < c1)

    for c0 in range(0, n_freq, max(1, n_freq // 7)):
        for c1 in sorted({c0 + 1, (c0 + n_freq) // 2 + 1, n_freq}):
            p0, p1 = spec_db_mod.bin_pairs(n_fft, c0, c1 - c0)
            hit = [k for k in pairs if touches(k, c0, c1)]
            assert hit and p0 == hit[0] and p1 == hit[-1] + 1, (c0, c1)
