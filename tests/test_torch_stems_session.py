"""A five-stem session on the port's CPU route: a song's mixture and four
stems, each a stereo 44.1 kHz track (the benchmark's ``stems_44k``
configuration cut to a few seconds), opened together through
``Commands.call``.

* The session's answers -- every track's dB, u16 image and viewport tiles,
  and the summary's stats -- agree with the benchmark's plain reference
  (``benchmark/harness/ref``: plain PyTorch and numpy, nothing of the port)
  under the limits of ``benchmark/limits/stems_44k.open.json``; the dB
  within the suite's contract (``torch_parity``).
* K9 over one group of five equals five groups of one, field for field: at
  equal lengths, with one member a few hundred samples short (zero padding,
  per-row ``ns``), and with members whose rows are float32(gain) times their
  samples (``scaled_rows``).  On the card the same holds for the kernel.
* The add's pool of decodes is one ``decode.pool`` span with a ``decode``
  child on a pool thread for each file; the group of five is stacked under
  one ``stats.rows_stack``; ``stats_device.group_tracks`` counts one launch
  of five tracks (song + memo: two of one), the warmers' launches apart.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import assert_db_close

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import signals  # noqa: E402
from benchmark.harness.drive import Client, Session  # noqa: E402
from benchmark.harness.ref import spectrogram as ref_spec  # noqa: E402
from benchmark.harness.ref.framing import SpecSetting  # noqa: E402
from benchmark.harness.ref.pipeline import Observation, Reference, compare  # noqa: E402
from benchmark.harness.ref import render  # noqa: E402
from benchmark.harness.ref.render import colormap_rgba8  # noqa: E402
from thesia_tpu_torch import obs, runtime  # noqa: E402
from thesia_tpu_torch.dynamics import stats_device  # noqa: E402
from thesia_tpu_torch.engine.service import Commands  # noqa: E402
from thesia_tpu_torch.engine.session import EngineSession  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark/configs/stems_44k.json").read_text())
LIMITS = json.loads((ROOT / "benchmark/limits/stems_44k.open.json").read_text())
MIX = json.loads((ROOT / "benchmark/traffic/open.json").read_text())
SEED = 2**31 + 77
SECONDS = 2.5
CPU = torch.device("cpu")


def _write(tmp_path, specs, seed):
    """(int16 samples, sr) and WAV paths of ``specs``, made from ``seed``."""
    tracks, paths = [], []
    for i, spec in enumerate(specs):
        x = signals.make_track(spec, seed, i, "cpu")
        path = tmp_path / f"{spec['name']}.wav"
        path.write_bytes(signals.wav_bytes_s16(x, int(spec["sr"])))
        tracks.append((x, int(spec["sr"])))
        paths.append(str(path))
    return tracks, paths


def _open(tmp_path, specs, seed=SEED):
    """A CPU session with ``specs`` opened through the command table as the
    benchmark's ``open`` turn does (add, apply, paint, settle, summary),
    with the span log on; returns what the reference needs and the log."""
    tracks, paths = _write(tmp_path, specs, seed)
    session = EngineSession(device="cpu", settings_dir=tmp_path / "cfg")
    client = Client(Commands(session))
    client.call("init", colormapRgba=colormap_rgba8().reshape(-1).tolist())
    sess = Session(client, paths, [int(s["channels"]) for s in specs], MIX,
                   CONFIG["settings"])
    sess.apply_settings()
    stats_device.reset_launches()
    obs.span_log()
    obs.tracing(True)
    try:
        client.call("add_tracks", trackIds=sess.ids, paths=paths)
        client.call("apply_track_list_changes")
        spec_tiles, wave_tiles = sess.paint(keep=True)
        sess.settle()
        summary = sess.summary()
    finally:
        obs.tracing(False)
    log = obs.span_log()
    tl = session.tracklist
    ob = Observation(state=dict(sess.state), spec_tiles=spec_tiles, wave_tiles=wave_tiles,
                     summary=summary, limiter={t: tl[t].guard_clipping_gain() for t in sess.ids})
    return session, tracks, ob, log


def _stems(seconds=SECONDS):
    return [{**t, "seconds": seconds} for t in CONFIG["tracks"]]


@pytest.fixture(scope="module")
def stems(tmp_path_factory):
    session, tracks, ob, log = _open(tmp_path_factory.mktemp("stems"), _stems())
    counts = (dict(stats_device.group_tracks), dict(stats_device.warm_group_tracks),
              list(stats_device.group_log), stats_device.lufs_stats_batched.launches)
    try:
        yield session, tracks, ob, log, counts
    finally:
        session.tm.images.shutdown()


def test_the_stems_configuration_is_five_aligned_stereo_44k_files():
    tracks = CONFIG["tracks"]
    assert [t["name"] for t in tracks] == ["mixture", "drums", "bass", "other", "vocals"]
    assert {(t["sr"], t["channels"], t["seconds"], t["bits"]) for t in tracks} == \
        {(44100, 2, 240, 16)}
    assert CONFIG["reduced"] == []


def test_the_session_agrees_with_the_plain_reference(stems):
    session, tracks, ob, _log, _counts = stems
    assert len(ob.summary) == 5 and len({k[:2] for k in ob.spec_tiles}) == 10
    numbers = compare(Reference(tracks, CPU), [ob])
    assert numbers["tiles_compared"] == len(ob.spec_tiles) + len(ob.wave_tiles)
    for k, limit in LIMITS.items():
        assert numbers[k] <= limit, (k, numbers[k], limit)


@pytest.mark.parametrize("track", range(5))
def test_each_tracks_db_and_image_agree_with_the_reference(stems, track):
    session, tracks, ob, _log, _counts = stems
    ref = Reference(tracks, CPU).outputs(ob.state)
    x, sr = ref.tracks[track]
    want_db = ref_spec.track_db(x, sr, SpecSetting.from_json(ob.state["spec"]), CPU)
    res = session.tm.specs[track]
    got_db = res.db[:, : res.n_frames].numpy()
    assert_db_close(want_db.numpy(), got_db)
    # the u16 images by the tiles' measure, the share of pixels whose colour
    # differs: the float32 dB rounds to another u16 value than the float64's
    # on about a tenth of the pixels here, and to another colour on 1e-4-6e-4
    lut = render._lut(colormap_rgba8())
    off = total = 0
    for ch in range(x.shape[0]):
        got = session.tm.get_spectrogram((track, ch))
        want = ref.images[track][ch]
        assert got.shape == want.shape and got.dtype == np.uint16
        off += int((lut[got] != lut[want]).any(axis=-1).sum())
        total += want.size
    assert off / total <= LIMITS["spec_px_off"], off / total


def test_the_add_decodes_in_one_pool_and_stacks_one_group(stems):
    *_, log, _counts = stems
    pools = [r for r in log if r[0] == "decode.pool"]
    assert len(pools) == 1
    pool = pools[0]
    decodes = [r for r in log if r[0] == "decode"]
    assert len(decodes) == 5 and all(r[2] == pool[1] for r in decodes)
    if (os.cpu_count() or 1) > 1:
        assert all(r[4] != pool[4] for r in decodes)  # on the pool's threads
    assert all(pool[5] <= r[5] and r[6] <= pool[6] for r in decodes)
    stacks = [r for r in log if r[0] == "stats.rows_stack"]
    assert len(stacks) == 1
    # inside the add's stats, under the add's command
    by_id = {r[1]: r for r in log}
    assert by_id[stacks[0][2]][0] == "stats.batched"
    assert by_id[stacks[0][3]][0] == "command.add_tracks"


def test_the_counter_reads_one_launch_of_five(stems):
    *_, (group, warm, group_log, launches) = stems
    assert group == {5: 1} and launches == 1
    assert warm == {}
    assert [(n, w) for _t, n, w in group_log] == [(5, False)]


def test_song_and_memo_are_two_groups_of_one_and_warm_launches_count_apart(tmp_path):
    specs = [{"name": "song", "signal": "song", "sr": 48000, "channels": 2, "seconds": 2.0},
             {"name": "memo", "signal": "voice_memo", "sr": 16000, "channels": 1,
              "seconds": 1.5}]
    session, tracks, ob, log = _open(tmp_path, specs)
    try:
        assert stats_device.group_tracks == {1: 2}
        assert not [r for r in log if r[0] == "stats.rows_stack"]  # each handed on whole
        assert len([r for r in log if r[0] == "decode.pool"]) == 1
        w = np.asarray(tracks[0][0], np.float32) / 32768.0
        with runtime.warming():
            stats_device.lufs_stats_batched([(0, w, 48000), (1, w, 48000)], CPU)
        assert stats_device.warm_group_tracks == {2: 1}
        assert stats_device.group_tracks == {1: 2}
        assert stats_device.warm_rows_from["upload"] == 2
    finally:
        session.tm.images.shutdown()
    stats_device.reset_launches()
    assert stats_device.group_tracks == stats_device.warm_group_tracks == {}
    assert not stats_device.group_log


def _members(case, seed=12):
    """Five stereo 44.1 kHz members: items for ``calc_stats_batched`` and,
    for ``gains``, the sources that make their rows as float32(g) times the
    samples on the device."""
    rng = np.random.default_rng(seed)
    n = int(1.2 * 44100)
    wavs = [(rng.uniform(-1, 1, (2, n)) * (0.1 + 0.15 * i)).astype(np.float32)
            for i in range(5)]
    if case == "one_shorter":
        wavs[3] = wavs[3][:, : n - 317]
    if case != "gains":
        return [(i, w, 44100) for i, w in enumerate(wavs)], None
    gains = [1.0, 0.5, 1.7, 1.0, 0.25]
    items = [(i, (np.float32(g) * w).astype(np.float32), 44100)
             for i, (w, g) in enumerate(zip(wavs, gains))]
    return items, {i: (torch.from_numpy(w), g) for i, (w, g) in enumerate(zip(wavs, gains))}


def _five_vs_ones(items, sources, device):
    def on(src):
        return None if src is None else {k: (s.to(device), g) for k, (s, g) in src.items()}

    five = stats_device.calc_stats_batched(items, device, on(sources))
    ones = {}
    for it in items:
        src = None if sources is None else {it[0]: sources[it[0]]}
        ones[it[0]] = stats_device.calc_stats_batched([it], device, on(src))[it[0]]
    return five, ones


@pytest.mark.parametrize("case", ["equal", "one_shorter", "gains"])
def test_k9_over_a_group_of_five_equals_five_groups_of_one(case):
    items, sources = _members(case)
    stats_device.reset_launches()
    five, ones = _five_vs_ones(items, sources, CPU)
    assert stats_device.group_tracks == {5: 1, 1: 5}
    assert stats_device.scaled_rows == (6 if case == "gains" else 0)
    for key in ones:
        assert five[key] == ones[key], (key, five[key], ones[key])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["equal", "one_shorter", "gains"])
def test_the_card_k9_over_a_group_of_five_equals_five_groups_of_one(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    items, sources = _members(case)
    five, ones = _five_vs_ones(items, sources, torch.device("cuda"))
    for key in ones:
        assert five[key] == ones[key], (key, five[key], ones[key])
