"""The port's SpecImageStore (thesia_tpu_torch/engine/images.py) on the CPU:
device images streamed to the host in the background, interim tiles served
from device regions and mips, viewport priority, the replace race, churn,
the host budget with requantize on miss, and failed chunks.  The cases
mirror tests/test_images.py; where that file relies on the stream still
being in flight, these hold the streamer at a gate so the interim paths run
for certain.  Every wait has a timeout and its result is asserted."""

import threading
import time

import numpy as np
import pytest
import torch

from thesia_tpu.render import tiles as jax_tiles
from thesia_tpu.render.mips import SpecImage as JaxSpecImage
from thesia_tpu_torch.engine import images as I
from thesia_tpu_torch.engine.manager import TrackManager
from thesia_tpu_torch.engine.track import TrackList
from thesia_tpu_torch.io.wav import encode_wav_f32
from thesia_tpu_torch.kernels import images as kimages
from thesia_tpu_torch.render.colormap import default_colormap_rgba8
from thesia_tpu_torch.render.mips import chain_len
from thesia_tpu_torch.render.tiles import spectrogram_tile_header

CMAP = default_colormap_rgba8()


def _write_tracks(d, specs, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, (sr, c, sec) in enumerate(specs):
        w = rng.uniform(-0.8, 0.8, (c, int(sr * sec))).astype(np.float32)
        p = d / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(w, sr))
        paths.append(str(p))
    return paths


def _manager(paths):
    tl = TrackList("cpu")
    tm = TrackManager("cpu")
    tm.add_tracks(tl, tl.add_tracks(list(range(len(paths))), paths))
    tm.apply_track_list_changes(tl)
    return tl, tm


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    paths = _write_tracks(tmp_path_factory.mktemp("imgs"), [(8000, 2, 30.0), (16000, 1, 10.0)], 11)
    tl, tm = _manager(paths)
    assert tm.images.drain(timeout=30)
    return tl, tm


class _Gate:
    """Holds the streamer inside its first yield (before any full-res chunk
    of the next entry lands) until released."""

    def __init__(self, monkeypatch, times=1):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.left = times
        orig = I.SpecImageStore._yield_to_interactive

        def gated(store):
            if self.left > 0:
                self.left -= 1
                self.entered.set()
                assert self.release.wait(10)
            orig(store)

        monkeypatch.setattr(I.SpecImageStore, "_yield_to_interactive", gated)


def _expected_image(tm, tl, tid):
    """The u16 image the manager's quantize gives for a track now."""
    res = tm.specs[tid]
    img, _ = tm.quantize(tl[tid].sr, res.db, res.n_frames, *tm._quant_scalars())
    return I.land_u16([img])[0]


def test_geometry_known_before_landing(engine, monkeypatch):
    tl, tm = engine
    gate = _Gate(monkeypatch)
    tm.set_db_range(tl, 90.0)
    assert gate.entered.wait(10)
    h, w = tm.images.geometry(0)
    assert h > 0 and w > 0 and tm.images.is_computing(0)
    assert tm.images.host_image(0, 0) is None
    gate.release.set()
    assert tm.images.drain(timeout=30)
    img = tm.images.host_image(0, 0)
    assert img is not None and img.shape == (h, w) and not tm.images.is_computing(0)
    tm.set_db_range(tl, 100.0)
    assert tm.images.drain(timeout=30)


def test_streamed_image_matches_device(engine):
    """Host bytes after streaming == the device image's u16 bits."""
    tl, tm = engine
    assert tm.images.drain(timeout=30)
    want = _expected_image(tm, tl, 0)
    for ch in range(2):
        img = tm.images.host_image(0, ch)
        assert img is not None and img.dtype == np.uint16
        np.testing.assert_array_equal(np.asarray(img), want[ch])
    assert not tm.images.is_computing(0)


def test_interim_region_tile_equals_final_tile(engine, monkeypatch):
    """Tiles served from device-region fetches before the host image lands
    are byte-identical to the tiles served after landing."""
    tl, tm = engine
    gate = _Gate(monkeypatch)
    tm.set_db_range(tl, 90.0)
    assert gate.entered.wait(10)
    interim = {args: tm.images.tile_body(0, 0, CMAP, *args)
               for args in [(0, 0, 0, 0), (1, 0, 0, 0), (3, 1, 0, 0), (2, 0, 1, 0)]}
    assert tm.images.is_computing(0)
    gate.release.set()
    assert tm.images.drain(timeout=30)
    for args, body in interim.items():
        assert body is not None
        assert body == tm.images.tile_body(0, 0, CMAP, *args), f"interim != final for {args}"
    tm.set_db_range(tl, 100.0)
    assert tm.images.drain(timeout=30)


def test_tile_header_and_empty_tiles(engine):
    _tl, tm = engine
    assert tm.images.drain(timeout=30)
    h, w = tm.images.geometry(0)
    assert tm.images.tile_body(0, 0, CMAP, 0, 0, 10**6, 0) == b""
    assert len(spectrogram_tile_header(7, h, w, 0, 0, 10**6, 0)) == 40
    assert tm.images.tile_body(0, 99, CMAP, 0, 0, 0, 0) is None
    assert tm.images.tile_body(42, 0, CMAP, 0, 0, 0, 0) is None


def test_remove_mid_stream_is_safe(engine, monkeypatch):
    tl, tm = engine
    gate = _Gate(monkeypatch)
    tm.set_db_range(tl, 80.0)
    assert gate.entered.wait(10)
    tm.images.remove(1)
    assert tm.images.geometry(1) is None
    gate.release.set()
    assert tm.images.drain(timeout=30)
    assert tm.images.host_image(1, 0) is None
    tm.update_all_specs_imgs(tl)
    assert tm.images.drain(timeout=30)
    assert tm.images.host_image(1, 0) is not None
    tm.set_db_range(tl, 100.0)
    assert tm.images.drain(timeout=30)


def test_concurrent_tiles_during_stream(engine):
    """Tile fetches from several threads while the streamer runs: no
    exceptions, all bodies equal the settled result."""
    tl, tm = engine
    tm.set_db_range(tl, 95.0)
    results, errors = {}, []

    def fetch(tid, args):
        try:
            results[(tid, args)] = tm.images.tile_body(tid, 0, CMAP, *args)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(tid, args))
               for tid in (0, 1) for args in [(0, 0, 0, 0), (2, 1, 0, 0), (4, 0, 0, 0)]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors
    assert tm.images.drain(timeout=30)
    for (tid, args), body in results.items():
        assert body == tm.images.tile_body(tid, 0, CMAP, *args)
    tm.set_db_range(tl, 100.0)
    assert tm.images.drain(timeout=30)


def _entry(tid, seed, h=8, n=32):
    img = np.random.default_rng(seed).integers(1, 65535, (1, h, n)).astype(np.uint16)
    return I.TrackImages(tid, 1, n, h, torch.from_numpy(img), {}), img[0]


def test_set_images_replace_mid_stream_streams_replacement(monkeypatch):
    """A replacement installed while the worker streams the OLD entry of the
    same id must stream (the id stays at the queue head)."""
    t_old, _ = _entry(0, 1)
    t_new, want = _entry(0, 2)
    store = I.SpecImageStore()
    entered, block = threading.Event(), threading.Event()
    orig = I.SpecImageStore._stream_one

    def slow(self, t):
        entered.set()
        assert block.wait(10)
        return orig(self, t)

    monkeypatch.setattr(I.SpecImageStore, "_stream_one", slow)
    store.set_images(0, t_old)
    assert entered.wait(10)
    store.set_images(0, t_new)
    block.set()
    assert store.drain(timeout=30)
    assert t_old.dropped and not t_old.complete
    assert t_new.complete
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), want)
    store.shutdown()


def test_store_churn_every_live_entry_lands():
    """Concurrent set_images / remove / drain churn leaves every live entry
    complete once the streamer is quiet."""
    store = I.SpecImageStore()
    stop = threading.Event()

    def churn(tid):
        rng = np.random.default_rng(100 + tid)
        seed = tid * 10_000
        while not stop.is_set():
            op = rng.integers(0, 10)
            seed += 1
            if op < 7:
                store.set_images(tid, _entry(tid, seed, 16, 64)[0])
            elif op < 9:
                store.remove(tid)
            else:
                store.drain(timeout=5)

    threads = [threading.Thread(target=churn, args=(tid,)) for tid in range(4)]
    for th in threads:
        th.start()
    time.sleep(1.0)
    stop.set()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert store.drain(timeout=30), "streamer failed to quiesce"
    with store._lock:
        live = dict(store._tracks)
    for tid, t in live.items():
        assert t.complete and not t.dropped, f"track {tid} stranded incomplete"
        assert store.host_image(tid, 0) is not None
    assert store.stream_failures == 0
    store.shutdown()


def test_interim_parity_covers_device_mips(tmp_path, monkeypatch):
    """Coarse LODs while streaming go through the host deepest mip, the
    device mips and locally halved regions; every level's tile equals the
    settled one.  A 90 s track has chain levels >= DEVICE_MIP_FROM."""
    tl, tm = _manager(_write_tracks(tmp_path, [(8000, 1, 90.0)], 17))
    assert tm.images.drain(timeout=30)
    _h, n_frames = tm.images.geometry(0)
    assert chain_len(n_frames) >= I.DEVICE_MIP_FROM and I.mip_plan(n_frames)
    gate = _Gate(monkeypatch)
    tm.set_db_range(tl, 90.0)
    assert gate.entered.wait(10)
    with tm.images._lock:
        t = tm.images._tracks[0]
    assert t.dev_mips and t.host_mips, "device mips / the deepest host mip missing"
    max_lx = (n_frames // 512).bit_length() + 1
    interim = {lx: tm.images.tile_body(0, 0, CMAP, lx, 0, 0, 0) for lx in range(max_lx + 1)}
    assert not t.complete
    gate.release.set()
    assert tm.images.drain(timeout=30)
    for lx, body in interim.items():
        assert body is not None, lx
        assert body == tm.images.tile_body(0, 0, CMAP, lx, 0, 0, 0), f"interim != final at levelX={lx}"


def test_landed_interval_bookkeeping():
    t = I.TrackImages(0, 1, 100, 4, torch.zeros((1, 4, 100), dtype=torch.uint16), {})
    t._merge_landed(10, 20)
    t._merge_landed(30, 40)
    assert t.covers(12, 18) and not t.covers(5, 12) and not t.covers(15, 35)
    t._merge_landed(0, 10)
    assert t.landed[0] == [0, 20]
    t._merge_landed(18, 32)
    assert t.landed == [[0, 40]]
    assert t.next_gap(1000) == (40, 100)
    assert t.next_gap(25) == (40, 65)
    t._merge_landed(40, 100)
    assert t.next_gap(1000) is None and t.covers(0, 100)


class _SliceLogger:
    """dev_img stand-in that records the (x0, x1) spans the streamer pulls."""

    def __init__(self, arr):
        self.arr = arr
        self.spans = []

    def __getitem__(self, key):
        _ch, _rows, cols = key
        if isinstance(cols, slice):
            self.spans.append((cols.start or 0, cols.stop))
        return self.arr[key]

    @property
    def device(self):
        return self.arr.device


def _logged(seed, h, n):
    data = np.random.default_rng(seed).integers(1, 65535, (1, h, n)).astype(np.uint16)
    return _SliceLogger(torch.from_numpy(data)), data[0]


def test_stream_hint_pulls_region_forward(monkeypatch):
    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)  # 1024-col chunks
    h, n = 4, 8192
    logger, want = _logged(3, h, n)
    t = I.TrackImages(0, 1, n, h, logger, {})
    t.stream_hint = (5120, 6144)
    store = I.SpecImageStore()
    store.set_images(0, t)
    assert store.drain(timeout=30)
    assert t.complete
    assert logger.spans[0] == (5120, 6144), logger.spans[:3]
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), want)
    assert sum(b - a for a, b in logger.spans) == n  # no column fetched twice
    store.shutdown()


def test_stream_hint_skips_already_landed_columns(monkeypatch):
    """A wider hint arriving after a region landed does not re-fetch the
    landed columns."""
    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 32)  # 4096-col chunks
    h, n = 4, 16384
    logger, want = _logged(5, h, n)
    t = I.TrackImages(0, 1, n, h, logger, {})
    t.stream_hint = (5120, 6144)
    store = I.SpecImageStore()
    gate = _Gate(monkeypatch)
    store.set_images(0, t)
    assert gate.entered.wait(10)
    with store._lock:
        t.stream_hint = (4096, 12288)
    gate.release.set()
    assert store.drain(timeout=30)
    assert t.complete
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), want)
    assert sum(b - a for a, b in logger.spans) == n, f"columns double-fetched: {logger.spans}"
    store.shutdown()


def test_tile_request_prioritizes_track_and_region(monkeypatch):
    """A tile request on a queued track moves it to the queue front with its
    region hint; the head track yields and resumes to completion."""
    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)
    h, n = 4, 8192
    t_a, want_a = _entry(0, 41, h, n)
    t_b, want_b = _entry(1, 42, h, n)
    store = I.SpecImageStore()
    gate = _Gate(monkeypatch)
    store.set_images(0, t_a)
    assert gate.entered.wait(10)  # A is mid-stream, held at the gate
    store.set_images(1, t_b)
    fetch = threading.Thread(target=lambda: store.tile_body(1, 0, CMAP, 1, 0, 3, 0), daemon=True)
    fetch.start()
    t0 = time.time()
    while t_b.stream_hint is None and time.time() - t0 < 10:
        time.sleep(0.01)
    assert t_b.stream_hint is not None
    with store._lock:
        assert store._queue[0] == 1
    gate.release.set()
    fetch.join(timeout=10)
    assert not fetch.is_alive()
    assert store.drain(timeout=30)
    assert t_a.complete and t_b.complete
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), want_a)
    np.testing.assert_array_equal(np.asarray(store.host_image(1, 0)), want_b)
    store.shutdown()


def test_priority_landed_region_serves_byte_identical(monkeypatch):
    """The three serving paths -- device region fetch, landed interval,
    settled host image -- give the same bytes, and the JAX encoder's bytes
    from the whole image."""
    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)
    h, n = 4, 8192
    t, want = _entry(0, 5, h, n)
    store = I.SpecImageStore()
    gate = _Gate(monkeypatch)
    store.set_images(0, t)
    assert gate.entered.wait(10)
    args = (0, 0, CMAP, 1, 0, 3, 0)
    from_device = store.tile_body(*args)
    assert t.stream_hint is not None
    gate.release.set()
    t0 = time.time()
    while time.time() - t0 < 10:
        with store._lock:
            if t.stream_hint is None or t.covers(*t.stream_hint):
                break
        time.sleep(0.01)
    from_interval = store.tile_body(*args)
    assert store.drain(timeout=30)
    from_settled = store.tile_body(*args)
    assert from_device == from_interval == from_settled
    whole = jax_tiles.encode_spectrogram_tile(JaxSpecImage(want), CMAP, 0, 1, 0, 3, 0)
    assert whole[40:] == from_settled
    store.shutdown()


def test_host_budget_evicts_and_reloads_on_miss(tmp_path, monkeypatch):
    """Under a tiny THESIA_IMG_CACHE_BYTES the older landed image is evicted
    to its geometry (never the most recent); a tile request requantizes it
    through the manager's reloader, byte-identical to an unbudgeted store."""
    paths = _write_tracks(tmp_path, [(8000, 1, 6.0), (8000, 1, 5.0)], 23)
    tl_ref, tm_ref = _manager(paths)
    monkeypatch.setenv("THESIA_IMG_CACHE_BYTES", "1")
    tl, tm = _manager(paths)
    assert tm.images.drain(timeout=30)
    evicted = [tid for tid in (0, 1) if tm.images.needs_reload(tid)]
    assert len(evicted) == 1
    tid = evicted[0]
    assert not tm.images.is_computing(tid) and tm.images.host_image(tid, 0) is None
    assert tm.images.geometry(tid) == tm_ref.images.geometry(tid)
    for args in ((0, 0, 0, 0), (2, 0, 0, 0)):
        body = tm.images.tile_body(tid, 0, CMAP, *args)
        assert body is not None and body == tm_ref.images.tile_body(tid, 0, CMAP, *args)
    assert tm.images.drain(timeout=30)
    assert tm.images.needs_reload(1 - tid)  # the reload made the other one the oldest
    assert tm.images.host_image(tid, 0) is not None


def test_three_failed_chunks_evict_then_reload(tmp_path, monkeypatch):
    """A chunk copy that keeps failing is retried three times; the fourth
    failure marks the entry evicted (isComputing off), and the next tile
    request requantizes and streams it again."""
    tl, tm = _manager(_write_tracks(tmp_path, [(8000, 1, 3.0)], 29))
    assert tm.images.drain(timeout=30)
    want = tm.images.tile_body(0, 0, CMAP, 0, 0, 0, 0)
    orig = I._Landing.put

    def failing(self, *a):
        raise RuntimeError("simulated copy failure")

    monkeypatch.setattr(I._Landing, "put", failing)
    tm.set_db_range(tl, 100.0)  # same range: a fresh quantize and stream
    assert tm.images.drain(timeout=30)
    t = tm.images._tracks[0]
    assert t.evicted and t.stream_retries == 4 and tm.images.stream_failures == 4
    assert not tm.images.is_computing(0)
    monkeypatch.setattr(I._Landing, "put", orig)
    assert tm.images.tile_body(0, 0, CMAP, 0, 0, 0, 0) == want
    assert tm.images.drain(timeout=30)
    assert tm.images.host_image(0, 0) is not None and tm.images.stream_failures == 4


def test_idle_streamer_ends_and_restarts():
    """The streamer thread ends after IDLE_EXIT_S without work; the next
    set_images starts another and it streams."""
    store = I.SpecImageStore()
    store.set_images(0, _entry(0, 1)[0])
    assert store.drain(timeout=30)
    worker = store._worker
    assert worker is not None
    worker.join(timeout=I.IDLE_EXIT_S + 10)
    assert not worker.is_alive() and store._worker is None
    t, want = _entry(1, 2)
    store.set_images(1, t)
    assert store.drain(timeout=30)
    np.testing.assert_array_equal(np.asarray(store.host_image(1, 0)), want)
    store.shutdown()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_copy_stream_landing_on_the_card(cuda, monkeypatch):
    """On the card the chunks go through the copy stream and the pinned
    ring (small chunks, so the ring wraps many times): the host image holds
    the device image's u16 bits, interim tiles from the device mips and from
    region fetches equal the landed ones, and the copy stream's time is
    recorded."""
    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 64 * 1024)
    h, n = 40, 9001
    data = np.random.default_rng(31).integers(0, 65536, (2, h, n)).astype(np.int32)
    img = torch.from_numpy(data).to(cuda)
    levels = tuple(I.mip_plan(n))
    mips, cur, level = [], img, 0
    for target in levels:
        while level < target:
            cur, level = kimages._halve_t(cur), level + 1
        mips.append(cur.to(kimages.IMAGE_DTYPE))
    img = img.to(kimages.IMAGE_DTYPE)
    store = I.SpecImageStore()
    gate = _Gate(monkeypatch)
    store.set_images(0, I.TrackImages(0, 2, n, h, img, dict(zip(levels, mips))))
    assert gate.entered.wait(30)
    requests = [(lx, tx) for lx in range(0, 6) for tx in (0, 3)]
    interim = {(ch, a): store.tile_body(0, ch, CMAP, a[0], 0, a[1], 0) for ch in (0, 1) for a in requests}
    gate.release.set()
    assert store.drain(timeout=60)
    t = store._tracks[0]
    assert t.complete and t.copy_ms > 0 and store.stream_failures == 0
    for ch in (0, 1):
        np.testing.assert_array_equal(np.asarray(store.host_image(0, ch)), data[ch].astype(np.uint16))
    for (ch, a), body in interim.items():
        assert body is not None and body == store.tile_body(0, ch, CMAP, a[0], 0, a[1], 0), (ch, a)
    store.shutdown()
