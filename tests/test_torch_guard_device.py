"""The gain and the guard on the device (K10, ``kernels.dynamics.guard_peak``
and ``guard_apply``; their plain versions ``stats_device.guard_peak_program``
and ``guard_apply_program`` on the CPU).

A TrackList with a device wav store (the session's TrackManager) applies a
normalize or guard switch to each track's original device samples and lands
one f32 copy.  It is held bit for bit to the host route, numpy's
``guard.guard_clipping`` behind ``Audio.mutate``, on the same tracks with the
same original stats: ``Audio.wavs``, the guard-clip result (kind, pre-clip
waveform, global gain, f32 gains) and every ``GuardClippingStats``.  The host
route is THESIA_DEVICE_DYNAMICS=0's, except where a two-track Limiter
engages: there both lists take K8's gains (the host route under the device
policy: K8 on numpy's rows, numpy's apply), since the native limiter rounds
its gains otherwise.  A lone track whose Limiter engages, a track shorter
than a gating block and a NaN track that the Limiter engages on keep the
host route.  The same comparisons run on the card under the ``gpu`` marker,
and the kernel against its plain version at edge values."""

import math

import numpy as np
import pytest
import torch

from thesia_tpu_torch import obs
from thesia_tpu_torch.dynamics import stats_device
from thesia_tpu_torch.dynamics.guard import GuardClippingMode, guard_clipping
from thesia_tpu_torch.dynamics.normalize import NormalizeTarget
from thesia_tpu_torch.engine.manager import TrackManager
from thesia_tpu_torch.engine.session import EngineSession
from thesia_tpu_torch.engine.track import TrackList
from thesia_tpu_torch.io.wav import encode_wav_f32
from thesia_tpu_torch.kernels import dynamics as kdyn

SR = 8000
EDGES = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, -1e-45, 1.0, -1.0,
                  np.nextafter(np.float32(1.0), np.float32(2.0)), 3.4e38, -3.4e38, 0.5],
                 np.float32)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _signal(rng, c, n, amp):
    t = np.arange(n) / SR
    tone = np.sin(2 * np.pi * 220.0 * t)[None, :] * np.linspace(0.2, 1.0, c)[:, None]
    return (amp * (0.7 * tone + 0.3 * rng.uniform(-1, 1, (c, n)))).astype(np.float32)


def _tracks(kind):
    """(samples, rate) of each track of a list: a stereo 8 kHz track beside a
    mono 16 kHz one, and the variant ``kind`` asks for."""
    rng = np.random.default_rng(11)
    tracks = [(_signal(rng, 2, 3 * SR // 2, 0.6), SR), (_signal(rng, 1, 2 * SR, 0.3), 2 * SR)]
    if kind == "nan":
        tracks[0][0][1, 100:140] = np.nan
    elif kind == "short":  # shorter than a 400 ms gating block
        tracks.append((_signal(rng, 1, 4 * SR // 10 - 1, 0.5), SR))
    elif kind == "silent":  # LUFS -inf: a non-finite gain
        tracks.append((np.zeros((2, SR), np.float32), SR))
    return tracks


def _lists(tmp_path, tracks, device):
    """The same tracks in a list with the device route and in one without."""
    paths = []
    for i, (w, sr) in enumerate(tracks):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(w, sr))
        paths.append(str(p))
    tm = TrackManager(device)
    on_device, host = TrackList(device, samples=tm.samples), TrackList(device)
    ids = list(range(len(paths)))
    assert on_device.add_tracks(ids, paths) == ids and host.add_tracks(ids, paths) == ids
    for t in ids:  # one set of stats, so that both lists take the same gains
        host[t].original.stats = on_device[t].original.stats
    return on_device, host, tm


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def _same_audio(got, want):
    """Every field a reader takes from a track's Audio, bit for bit."""
    if want is None or got is None:
        return got is want
    r, q = got.guard_clip_result, want.guard_clip_result
    arrays = [(got.wavs, want.wavs), (r.wav_before_clip, q.wav_before_clip), (r.gain_seq, q.gain_seq)]
    return (all((a is None and b is None) or (a is not None and b is not None and _bits_equal(a, b))
                for a, b in arrays)
            and r.kind == q.kind and r.shape == q.shape
            and type(r.global_gain) is type(q.global_gain) and r.global_gain == q.global_gain
            and got.guard_clip_stats == want.guard_clip_stats
            and getattr(got, "applied_scalar_gain", None) == getattr(want, "applied_scalar_gain", None))


def _switch(tl, mode, target):
    tl.set_common_guard_clipping(mode)
    tl.set_common_normalize(target)


LOUD, QUIET = NormalizeTarget("LUFS", 0.0), NormalizeTarget("LUFS", -40.0)
MODES = {  # (guard, target, whether the host route takes K8's gains)
    "clip_overs": (GuardClippingMode.Clip, LOUD, False),
    "clip_quiet": (GuardClippingMode.Clip, QUIET, False),
    "reduce_over": (GuardClippingMode.ReduceGlobalLevel, LOUD, False),
    "reduce_quiet": (GuardClippingMode.ReduceGlobalLevel, QUIET, False),
    "limiter_engaged": (GuardClippingMode.Limiter, LOUD, True),
    "limiter_quiet": (GuardClippingMode.Limiter, QUIET, False),
}
# tracks the device list hands to the host route: (track kind, mode) -> ids
HOST_ROUTE = {("short", m): {2} for m in MODES} | {("nan", "limiter_engaged"): {0}}


@pytest.mark.parametrize("kind", ["two_rates", "nan", "short", "silent", "gain_one"])
@pytest.mark.parametrize("case", list(MODES))
def test_the_device_route_is_the_host_route_bit_for_bit(tmp_path, monkeypatch, device, kind, case):
    """Each mode, with and without samples over full scale, on a stereo 8 kHz
    track beside a mono 16 kHz one, and beside NaN samples, a track under a
    gating block, a silent track (non-finite gain) or a gain of exactly 1.
    guard_routes counts each gained track once, on the route it took."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    mode, target, k8 = MODES[case]
    on_device, host, tm = _lists(tmp_path, _tracks(kind), device)
    try:
        if kind == "gain_one":  # track 1 at its own loudness: gain 1
            target = NormalizeTarget("LUFS", float(np.float32(on_device[1].original.stats.global_lufs)))
        stats_device.reset_launches()
        _switch(on_device, mode, target)
        routes = dict(stats_device.guard_routes)
        if not k8:
            monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
        _switch(host, mode, target)
        ids = on_device.all_ids()
        gained = [t for t in ids if on_device[t].audio is not on_device[t].original]
        host_ids = HOST_ROUTE.get((kind, case), set()) & set(gained)
        assert routes == {"device": len(gained) - len(host_ids), "host": len(host_ids)}, routes
        if kind == "gain_one":
            assert 1 not in gained and 0 in gained
        if kind == "silent":
            assert 2 not in gained
        for t in ids:
            got, want = on_device[t], host[t]
            assert (got.audio is got.original) == (want.audio is want.original), t
            if got.audio is not got.original:
                assert _same_audio(got.audio, want.audio), (case, kind, t)
            assert got.device_scalar_gain() == want.device_scalar_gain(), t
            assert got.format_guard_clip_stats(mode) == want.format_guard_clip_stats(mode), t
    finally:
        tm.images.shutdown()


@pytest.mark.parametrize("loud", [True, False])
def test_a_lone_track_whose_limiter_engages_keeps_the_native_limiter(tmp_path, monkeypatch,
                                                                     device, loud):
    """A lone track under the Limiter: where it engages, the host route (the
    native streaming limiter, as THESIA_DEVICE_DYNAMICS=0 runs it); where it
    does not, K10."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    on_device, host, tm = _lists(tmp_path, _tracks("two_rates")[:1], device)
    try:
        stats_device.reset_launches()
        _switch(on_device, GuardClippingMode.Limiter, LOUD if loud else QUIET)
        assert stats_device.guard_routes == ({"device": 0, "host": 1} if loud
                                             else {"device": 1, "host": 0})
        assert stats_device.limiter_gain_seqs_batched.launches == 0
        monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
        _switch(host, GuardClippingMode.Limiter, LOUD if loud else QUIET)
        assert _same_audio(on_device[0].audio, host[0].audio)
        assert (on_device[0].audio.guard_clipping_gain() < 1.0).any() == loud
    finally:
        tm.images.shutdown()


def test_the_host_policy_and_a_list_without_a_store_take_the_host_route(tmp_path, monkeypatch):
    """THESIA_DEVICE_DYNAMICS=0 keeps numpy's guard on a list with a store, and
    a list without one keeps it under either policy."""
    on_device, host, tm = _lists(tmp_path, _tracks("two_rates"), "cpu")
    try:
        for tl, env in ((on_device, "0"), (host, None)):
            if env is None:
                monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
            else:
                monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", env)
            stats_device.reset_launches()
            _switch(tl, GuardClippingMode.Clip, LOUD)
            assert stats_device.guard_routes == {"device": 0, "host": 2}
    finally:
        tm.images.shutdown()


def test_a_guarded_switch_and_back_uploads_nothing(tmp_path, monkeypatch):
    """A CPU session of two tracks: a switch whose guard changes samples and
    one back to a no-op guard open no ``spec.h2d_upload`` span (K10 reads
    the original's cached copy and leaves the post-guard samples beside it),
    each gained track counts once on the device route, and the device steps
    run under the spans the readers know, the landing as ``guard.land``."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    tracks = _tracks("two_rates")
    paths = []
    for i, (w, sr) in enumerate(tracks):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(w, sr))
        paths.append(str(p))
    s = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    obs.tracing(True)
    try:
        assert s.add_tracks([0, 1], paths) == [0, 1]
        s.apply_track_list_changes()
        s.set_common_guard_clipping("Clip", defer=False)
        obs.span_log()
        stats_device.reset_launches()
        s.set_common_normalize({"type": "LUFS", "target": 0.0}, defer=False)  # clamps
        assert all(s.tracklist[t].device_scalar_gain() is None for t in (0, 1))
        s.set_common_normalize({"type": "LUFS", "target": -40.0}, defer=False)  # no-op guard
        assert all(s.tracklist[t].device_scalar_gain() not in (None, 1.0) for t in (0, 1))
        names = [r[0] for r in obs.span_log()]
        assert "spec.h2d_upload" not in names
        assert {"normalize", "gain_apply", "guard_clipping", "guard_clipping.Clip",
                "guard.land", "stats.batched", "spec.recompute"} <= set(names)
        assert stats_device.guard_routes == {"device": 4, "host": 0}
        assert stats_device.rows_from["upload"] == 0
        an = s.tm.spec_analyzer
        assert set(an._wav_cache) == {0, 1, (0, "guarded"), (1, "guarded")}
    finally:
        obs.tracing(False)
        obs.span_log()
        s.tm.images.shutdown()


# -- the kernel's arithmetic -------------------------------------------------------


def _edge_rows(n=4099):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.5, 1.5, (2, n)).astype(np.float32)
    x[0, :EDGES.size] = EDGES
    x[1, -EDGES.size:] = EDGES[::-1]
    return x


@pytest.mark.parametrize("mode", list(GuardClippingMode))
@pytest.mark.parametrize("gain", [1.7, 0.3])
def test_the_plain_versions_are_numpys_guard(mode, gain):
    """guard_peak_program and guard_apply_program on NaN, infinities, +-0,
    subnormals, exact +-1 and the top of the range give numpy's product,
    nan_safe_abs_max and guard_clipping (given K8's gains for the Limiter),
    bit for bit."""
    x = _edge_rows()
    g = np.float32(gain)
    want_gained = (g * x).astype(np.float32, copy=False)
    gained, bits = stats_device.guard_peak_program(torch.from_numpy(x), gain, True)
    assert _bits_equal(gained.numpy(), want_gained)
    peaks = bits[0].view(torch.float32).tolist()
    for ch in range(2):
        row = want_gained[ch]
        assert peaks[ch] == float(np.fmax.reduce(np.abs(row), initial=np.float32(0)))
    assert bits[1].tolist() == [1, 1]
    peak = max(peaks)
    seq = np.random.default_rng(2).uniform(0.2, 1.0, x.shape[1])
    seq[::4] = 1.0
    op, scale = {GuardClippingMode.Clip: (kdyn.GUARD_CLIP, 1.0),
                 GuardClippingMode.ReduceGlobalLevel: (kdyn.GUARD_SCALE, 1.0 / peak),
                 GuardClippingMode.Limiter: (kdyn.GUARD_SEQ, 1.0)}[mode]
    y, stats, seq32 = stats_device.guard_apply_program(
        torch.from_numpy(x), gain, op, scale, torch.from_numpy(seq))
    want, result = guard_clipping(want_gained, SR, mode, gain_seq=seq)
    assert _bits_equal(y.numpy(), want)
    if mode is GuardClippingMode.Clip:
        assert stats.tolist() == [int((np.abs(r) > 1.0).sum()) for r in want_gained]
    elif mode is GuardClippingMode.Limiter:
        assert _bits_equal(seq32.numpy(), result.gain_seq[0])
        assert stats[0] == int((result.gain_seq != 1.0).sum())
        assert kdyn.gain_seq_min(int(stats[1])) == float(result.gain_seq.min())


@pytest.mark.parametrize("values", [[0.25, 1.0, 0.5], [-0.0, 0.0], [-2.0, 3.0, -1e-45], [1.0]])
def test_the_least_gain_survives_the_ordered_key(values):
    """GUARD_SEQ reduces its least f32 gain as a key that orders as the
    floats do; gain_seq_min reads it back exactly, negative values too."""
    f = torch.tensor(values, dtype=torch.float32)
    inverted = 0xFFFFFFFF - int(kdyn.ordered_key(f).amin())
    got = kdyn.gain_seq_min(inverted)
    assert got == float(min(values)) and math.copysign(1.0, got) == math.copysign(
        1.0, float(f[int(np.argmin(kdyn.ordered_key(f).numpy()))]))


@pytest.mark.parametrize("change,error", [
    ("f64", "float32"), ("3d", "float32"), ("strided", "contiguous"), ("meta", "no kernel"),
])
def test_the_wrappers_raise_on_what_the_kernel_does_not_take(change, error):
    x = torch.zeros((2, 100))
    x = {"f64": x.double(), "3d": x[None], "strided": x[:, ::2], "meta": x.to("meta")}[change]
    for call in (lambda: kdyn.guard_peak(x, 2.0), lambda: kdyn.guard_apply(x, 2.0, kdyn.GUARD_GAIN)):
        with pytest.raises(ValueError, match=error):
            call()
    ok = torch.zeros((2, 100))
    with pytest.raises(ValueError, match="float64"):
        kdyn.guard_apply(ok, 2.0, kdyn.GUARD_SEQ, gain_seq=torch.ones(100, dtype=torch.float32))
    with pytest.raises(ValueError, match="no mode"):
        kdyn.guard_apply(ok, 2.0, 7)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 4099, 1 << 20])
@pytest.mark.parametrize("gain", [1.7, 0.3])
def test_the_kernel_is_its_plain_version_on_the_card(n, gain):
    """Both passes, every mode, on the card: bit for bit as the plain
    version on the same device rows, two calls alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.from_numpy(_edge_rows(max(n, 2 * EDGES.size))[:, :n].copy()).to(dev)
    seq = torch.from_numpy(np.random.default_rng(3).uniform(0.2, 1.0, n)).to(dev)
    seq[::4] = 1.0

    def bits(outs):
        return [None if t is None else t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in outs]

    def same(a, b):
        return all((p is None and q is None) or torch.equal(p, q) for p, q in zip(bits(a), bits(b)))

    kdyn.reset_launches()
    for keep in (True, False):
        got, want = kdyn.guard_peak(x, gain, keep), stats_device.guard_peak_program(x, gain, keep)
        assert same(got, want) and same(got, kdyn.guard_peak(x, gain, keep)), keep
    for mode in (kdyn.GUARD_GAIN, kdyn.GUARD_CLIP, kdyn.GUARD_SCALE, kdyn.GUARD_SEQ):
        args = (x, gain, mode, 1.0 / 3.4e38 if mode == kdyn.GUARD_SCALE else 1.0,
                seq if mode == kdyn.GUARD_SEQ else None)
        got = kdyn.guard_apply(*args)
        assert same(got, stats_device.guard_apply_program(*args)), mode
        assert same(got, kdyn.guard_apply(*args)), mode
    torch.cuda.synchronize()
    assert kdyn.guard_peak.launches == 4 and kdyn.guard_apply.launches == 8
