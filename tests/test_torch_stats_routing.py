"""Where the port's whole-track stats come from.  Where the policy picks the
device, K9 (``stats_device.calc_stats_batched``; on the CPU its plain
version, ``lufs_program``) gives them: to a lone fresh track of one gating
block (400 ms) or longer, and to every track a normalize or guard switch
gained or guarded, right after the switch and before any getter, with rows
made from the samples the spectrogram holds on the device (the original
times float32(g) while the guard was a no-op, else the post-guard samples).
A track shorter than a gating block, and every track under
THESIA_DEVICE_DYNAMICS=0, takes the host ``calc_stats``.  The bars are the
suite's: LUFS within 1e-9, rms_db within 1e-5, peaks equal."""

import math

import numpy as np
import pytest
import torch

from thesia_tpu_torch.dynamics import stats_device
from thesia_tpu_torch.dynamics.guard import GuardClippingMode
from thesia_tpu_torch.dynamics.normalize import NormalizeTarget
from thesia_tpu_torch.dynamics.stats import calc_stats
from thesia_tpu_torch.engine.session import EngineSession
from thesia_tpu_torch.engine.track import TrackList
from thesia_tpu_torch.io.wav import encode_wav_f32

SR = 8000
BLOCK = 4 * ((SR + 5) // 10)  # one 400 ms gating block
LENGTHS = {"long": 3 * SR // 2, "short": BLOCK - 1}


def _wav(tmp_path, name, n, c=2, amp=0.5, seed=0):
    rng = np.random.default_rng(seed)
    p = tmp_path / name
    p.write_bytes(encode_wav_f32(rng.uniform(-amp, amp, (c, n)).astype(np.float32), SR))
    return str(p)


class CpuSamples:
    """A CPU fake of the device-sample store's interface
    (``engine/samples.py``), with no TrackManager behind it: a track's
    original as a tensor over its own numpy samples, and the post-guard
    samples the list hands back kept in a dict."""

    def __init__(self):
        self.kept = {}

    def original(self, tid, track):
        return torch.from_numpy(track.original.wavs)

    def current(self, tid, track):
        g = track.device_scalar_gain()
        return (self.kept[tid], 1.0) if g is None else (self.original(tid, track), g)

    def keep_guarded(self, tid, track, samples):
        self.kept[tid] = samples


def _close(got, want):
    lufs_ok = (math.isinf(got.global_lufs) and got.global_lufs == want.global_lufs) or \
        abs(got.global_lufs - want.global_lufs) < 1e-9
    return lufs_ok and abs(got.rms_db - want.rms_db) < 1e-5 and \
        got.max_peak == want.max_peak and got.max_peak_db == want.max_peak_db


@pytest.mark.parametrize("length,route,samples", [
    ("long", "device", True), ("long", "device", False), ("short", "device", True),
    ("long", "host", True), ("short", "host", True),
])
def test_a_lone_fresh_track(tmp_path, monkeypatch, length, route, samples):
    """One track added alone: K9 as a group of one when it holds a gating
    block (its rows from the source where one is given), the host
    ``calc_stats`` when it is shorter or the policy picks the host."""
    if route == "host":
        monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
    else:
        monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    path = _wav(tmp_path, "a.wav", LENGTHS[length])
    tl = TrackList("cpu", samples=CpuSamples() if samples else None)
    stats_device.reset_launches()
    assert tl.add_tracks([4], [path]) == [4]
    track = tl[4]
    want = calc_stats(track.original.wavs, SR)
    if length == "long" and route == "device":
        assert track.original._stats is not None  # given at add time
        assert stats_device.lufs_stats_batched.launches == 1
        assert stats_device.rows_from == {"device_wav": int(samples), "upload": int(not samples)}
        assert _close(track.stats, want), (track.stats, want)
    else:
        assert track.stats == want  # the host's, bit for bit
        assert stats_device.lufs_stats_batched.launches == 0
        assert stats_device.rows_from == {"device_wav": 0, "upload": 0}
    assert stats_device.scaled_rows == 0


def test_a_reloaded_track_takes_k9_before_normalize(tmp_path, monkeypatch):
    """reload_tracks gives a changed track's fresh original K9 stats, then
    normalizes it from them (and its gained audio gets K9 stats too)."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    path = _wav(tmp_path, "a.wav", 2 * SR, seed=6)
    tl = TrackList("cpu")
    tl.common_normalize = NormalizeTarget("LUFS", -30.0)
    assert tl.add_tracks([0], [path]) == [0]
    _wav(tmp_path, "a.wav", 2 * SR, seed=7)  # the file changes on disk
    stats_device.reset_launches()
    assert tl.reload_tracks([0]) == ([0], [0])
    track = tl[0]
    assert stats_device.lufs_stats_batched.launches == 2  # the original, then the gained audio
    assert _close(track.original.stats, calc_stats(track.original.wavs, SR))
    assert track.audio is not track.original and track.audio._stats is not None
    assert _close(track.audio.stats, calc_stats(track.audio.wavs, SR))


def test_a_lone_member_that_fills_its_group_is_handed_on(tmp_path):
    """The rows of a lone member whose source has the group's shape are the
    source itself (no zero-filled copy), or its float32 product."""
    w = np.random.default_rng(3).uniform(-1, 1, (2, 5000)).astype(np.float32)
    src = torch.from_numpy(w)
    rows = stats_device._rows_on_device([(0, w)], 2, 5000, torch.device("cpu"), {0: (src, 1.0)})
    assert rows.shape == (1, 2, 5000) and rows.data_ptr() == src.data_ptr()
    g = 0.3
    rows = stats_device._rows_on_device([(0, w)], 2, 5000, torch.device("cpu"), {0: (src, g)})
    np.testing.assert_array_equal(rows[0].numpy(), np.float32(g) * w)
    padded = stats_device._rows_on_device([(0, w)], 3, 6000, torch.device("cpu"), {0: (src, g)})
    np.testing.assert_array_equal(padded[0, :2, :5000].numpy(), np.float32(g) * w)
    assert not padded[0, 2:].any() and not padded[0, :, 5000:].any()


def test_gained_and_guarded_tracks_get_k9_stats_right_after_the_switch(tmp_path, monkeypatch):
    """A CPU session of two tracks under Clip: a normalize turn that leaves
    the guard a no-op gives each track K9 stats from float32(g) times its
    cached original (no upload), one that makes Clip clamp from its post-guard
    samples; both before any getter, both within the bars of the host's."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    paths = [_wav(tmp_path, "a.wav", 2 * SR, c=2, seed=1),
             _wav(tmp_path, "b.wav", 3 * SR // 2, c=1, amp=0.3, seed=2)]
    s = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    try:
        assert s.add_tracks([0, 1], paths) == [0, 1]
        s.apply_track_list_changes()
        s.set_common_guard_clipping("Clip", defer=False)
        tl = s.tracklist
        for turn, target, scaled in (("no-op guard", -30.0, True), ("clamps", 2.0, False)):
            stats_device.reset_launches()
            s.set_common_normalize({"type": "LUFS", "target": target}, defer=False)
            gains = {t: tl[t].device_scalar_gain() for t in (0, 1)}
            assert all((g is not None and g != 1.0) if scaled else g is None
                       for g in gains.values()), (turn, gains)
            # the stats are there before any getter asks
            assert all(tl[t].audio._stats is not None for t in (0, 1)), turn
            assert stats_device.scaled_rows == (2 if scaled else 0), turn
            assert stats_device.rows_from == {"device_wav": 2, "upload": 0}, turn
            assert stats_device.lufs_stats_batched.launches == 2, turn  # (8k, 2), (8k, 1)
            for t in (0, 1):
                audio = tl[t].audio
                assert _close(audio.stats, calc_stats(audio.wavs, SR)), (turn, t)
                if scaled:
                    samples, gain = s.tm.samples.current(t, tl[t])
                    rows = stats_device._rows_on_device(
                        [(0, audio.wavs)], audio.n_ch, len(audio), torch.device("cpu"),
                        {0: (samples, gain)})
                    want = np.float32(gains[t]) * tl[t].original.wavs
                    np.testing.assert_array_equal(rows[0].numpy(), want)
                    np.testing.assert_array_equal(audio.wavs, want)
    finally:
        s.tm.images.shutdown()


@pytest.mark.parametrize("mode", ["Clip", "ReduceGlobalLevel"])
def test_a_list_with_a_fake_store_takes_the_device_route_as_a_session_does(
        tmp_path, monkeypatch, mode):
    """A TrackList given only ``CpuSamples`` runs a guard switch and two
    normalize turns (one the guard acts on, one it leaves alone) on the device
    route, K10 and K9 on the fake's tensors; every track's Audio and stats
    are those of a CPU session's list on the same files, bit for bit."""
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    paths = [_wav(tmp_path, "a.wav", 2 * SR, c=2, seed=8),
             _wav(tmp_path, "b.wav", 3 * SR // 2, c=1, amp=0.3, seed=9)]
    tl = TrackList("cpu", samples=CpuSamples())
    s = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    try:
        assert tl.add_tracks([0, 1], paths) == s.add_tracks([0, 1], paths) == [0, 1]
        tl.set_common_guard_clipping(GuardClippingMode(mode))
        s.set_common_guard_clipping(mode, defer=False)
        for target, guard_acts in ((6.0, True), (-30.0, False)):
            stats_device.reset_launches()
            tl.set_common_normalize(NormalizeTarget("LUFS", target))
            assert stats_device.guard_routes == {"device": 2, "host": 0}, target
            s.set_common_normalize({"type": "LUFS", "target": target}, defer=False)
            for t in (0, 1):
                got, want = tl[t].audio, s.tracklist[t].audio
                assert (got.guard_clip_result.kind == "wav_before_clip") == (mode == "Clip")
                assert (tl[t].device_scalar_gain() is None) == guard_acts, (target, t)
                assert got.wavs.dtype == want.wavs.dtype
                np.testing.assert_array_equal(got.wavs.view(np.uint32), want.wavs.view(np.uint32))
                r, q = got.guard_clip_result, want.guard_clip_result
                assert (r.kind, r.shape, r.global_gain) == (q.kind, q.shape, q.global_gain)
                for a, b in ((r.wav_before_clip, q.wav_before_clip), (r.gain_seq, q.gain_seq)):
                    assert (a is None) == (b is None)
                    if a is not None:
                        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
                assert got.guard_clip_stats == want.guard_clip_stats
                assert got.applied_scalar_gain == want.applied_scalar_gain
                assert got.stats == want.stats and tl[t].original.stats == \
                    s.tracklist[t].original.stats, (target, t)
    finally:
        s.tm.images.shutdown()


def test_the_host_policy_leaves_gained_stats_lazy(tmp_path, monkeypatch):
    """THESIA_DEVICE_DYNAMICS=0: a switch launches nothing, and the getters'
    lazy host stats are ``calc_stats``'s, bit for bit."""
    monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
    paths = [_wav(tmp_path, "a.wav", 2 * SR, seed=4)]
    tl = TrackList("cpu")
    assert tl.add_tracks([0], paths) == [0]
    stats_device.reset_launches()
    tl.set_common_normalize(NormalizeTarget("LUFS", -30.0))
    assert tl[0].audio._stats is None
    assert stats_device.lufs_stats_batched.launches == 0
    assert tl[0].stats == calc_stats(tl[0].audio.wavs, SR)


# -- on the card -----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("members", [1, 2])
def test_scaled_rows_on_the_card_are_the_hosts_product(members):
    """float32(g) times a device wav on the card is ``np.float32(g) * wavs``
    bit for bit, a lone member and a padded group alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    ws = [rng.uniform(-2, 2, (2, 48000 + 7 * k)).astype(np.float32) for k in range(members)]
    ws[0][0, :4] = (1e-40, -1e-39, 3.4e38, 0.0)  # subnormals and the top of the range
    gains = [0.1234567, 1.7]
    sources = {k: (torch.from_numpy(w).to(dev), gains[k]) for k, w in enumerate(ws)}
    length = max(w.shape[1] for w in ws)
    rows = stats_device._rows_on_device(list(enumerate(ws)), 2, length, dev, sources)
    for k, w in enumerate(ws):
        np.testing.assert_array_equal(rows[k, :, : w.shape[1]].cpu().numpy(),
                                      np.float32(gains[k]) * w)
