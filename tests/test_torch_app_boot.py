"""The port's viewer (thesia_tpu_torch/viewer/index.html and js/*.js) boots
and runs headlessly against the port's engine on the CPU: tests/jsinterp.py
executes the real modules, tests/torch_fakedom.py bridges their fetches into
thesia_tpu_torch.engine.service (Commands.call) on an
EngineSession(device="cpu"), in the synchronous and in the deferred mode, as
tests/test_app_boot.py does for the JAX service.  Beside the boot flows (add a
track, tiles fetched and painted, a Linear switch that settles, the settle
watcher re-reading metadata), the port's repairs of the viewer (ROADMAP.md,
Queue 3) each have a test that fails on the JAX package's files: app.js's
settle watcher stops after a bounded run of failed rounds, refreshAll's
colorbar refresh is awaited, and viewport.js's computing watch stops after a
bounded run of failed polls."""

import os
import pathlib

import numpy as np
import pytest

VIEWER = pathlib.Path(__file__).resolve().parent.parent / "thesia_tpu_torch" / "viewer"
MODULES = ("api.js", "freqscale.js", "caches.js", "axes.js", "viewport.js", "applogic.js",
           "audioplayer.js", "overview.js", "app.js")


@pytest.fixture(scope="module", params=["sync", "deferred"])
def booted(request, tmp_path_factory):
    from torch_fakedom import AsyncInterp, PortBrowser

    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_f32

    prev = os.environ.get("THESIA_DEFER_SETTINGS")
    os.environ["THESIA_DEFER_SETTINGS"] = "1" if request.param == "deferred" else "0"
    request.addfinalizer(
        lambda: os.environ.update({"THESIA_DEFER_SETTINGS": prev})
        if prev is not None else os.environ.pop("THESIA_DEFER_SETTINGS", None)
    )
    td = tmp_path_factory.mktemp(f"torch_app_boot_{request.param}")
    rng = np.random.default_rng(5)
    media = td / "boot_track.wav"
    media.write_bytes(encode_wav_f32(rng.uniform(-0.7, 0.7, (2, 16000)).astype(np.float32), 8000))
    session = EngineSession(device="cpu", settings_dir=td / "cfg")
    browser = PortBrowser(session, (VIEWER / "index.html").read_text(), media_paths=[media])
    interp = AsyncInterp()
    browser.install(interp)
    for name in MODULES:
        interp.load((VIEWER / "js" / name).read_text())
    yield interp, browser, session, str(media)
    session.tm.images.shutdown()


def g(interp):
    return interp.global_env.vars


def settle(session):
    assert session.settings_settled(timeout=180)
    session.tm.images.drain()


def clean(interp):
    """No rejection went unhandled (what a browser console would show)."""
    assert interp.unhandled() == []


def metadata_reads(browser) -> int:
    return browser.fetch_log.count("/api/get_audio_render_metadata")


def test_boot_initialized_the_ports_engine(booted):
    interp, browser, session, _media = booted
    state = g(interp)["state"]
    assert state["freqScale"] in ("Mel", "Linear")
    sel = browser.doc["querySelector"]("#media-list")
    assert len(sel["children"]) == 2  # placeholder + the server media file
    assert session.tile_cache.colormap_rgba is not None
    assert type(session).__module__ == "thesia_tpu_torch.engine.session"
    clean(interp)


def test_add_track_via_media_select(booted):
    interp, browser, session, media = booted
    sel = browser.doc["querySelector"]("#media-list")
    sel["value"] = media
    browser.dispatch_event(sel, "change")
    settle(session)
    rows = browser.doc["querySelector"]("#rows")["children"]
    assert [r["dataset"]["idCh"] for r in rows] == ["0_0", "0_1"]
    assert "boot_track.wav" in rows[0]["querySelector"](".track-name")["textContent"]
    assert "8 kHz" in rows[0]["querySelector"](".track-meta")["textContent"]
    assert "LUFS" in rows[0]["querySelector"](".track-stats")["textContent"]
    state = g(interp)["state"]
    assert state["selected"] == [0.0]
    vp = interp._call_method(state["viewports"], "get", ["0_0"])
    assert vp["metadata"]["spectrogramWidth"] == session.tm.images.geometry(0)[1] > 0
    assert state["maxSec"] == pytest.approx(2.0)
    clean(interp)


def test_tiles_are_fetched_and_painted(booted):
    interp, browser, _session, _media = booted
    g(interp)["state"]["needsRedraw"] = True
    browser.step_frames(2)  # frame 1 fetches (through the bridge), frame 2 draws
    cached = interp._call_method(g(interp)["specTileCache"]["map"], "keys", [])
    assert cached, "no spectrogram tiles were fetched and cached"
    assert "/api/get_spectrogram_tile" in browser.fetch_log
    assert "/api/get_waveform_tile" in browser.fetch_log
    ops = [name for name, _ in browser.doc["querySelector"]("#compositor")["_ctx"]["_ops"]]
    assert "clearRect" in ops and "clip" in ops and "drawImage" in ops
    clean(interp)


def test_a_linear_switch_settles_and_the_viewer_adopts_it(booted):
    interp, browser, session, _media = booted
    rev0 = session.tile_cache.spectrogram_revision
    fs = browser.doc["querySelector"]("#freq-scale")
    fs["value"] = "Linear"
    browser.dispatch_event(fs, "change")
    settle(session)
    assert session.tm.setting.freq_scale.value == "Linear"
    assert session.tile_cache.spectrogram_revision > rev0
    state = g(interp)["state"]
    assert state["freqScale"] == "Linear"
    height = session.tm.images.geometry(0)[0]
    md = None
    for _ in range(12):  # deferred: the computing watchdog adopts it on the clock
        md = interp._call_method(state["viewports"], "get", ["0_0"])["metadata"]
        if md["spectrogramHeight"] == height and not md["isComputing"]:
            break
        browser.advance(500)
    assert md["spectrogramHeight"] == height and not md["isComputing"]
    state["needsRedraw"] = True
    browser.step_frames(2)
    clean(interp)


def test_the_settle_watcher_rereads_metadata(booted):
    interp, browser, session, _media = booted
    settle(session)
    for _ in range(10):
        browser.advance(500)  # earlier polls run out
    before = len(browser.fetch_log)
    g(interp)["refreshAppliedWhenSettled"]()
    browser.advance(250)
    new = browser.fetch_log[before:]
    # one read per row, then, every row settled, the applied-state readers
    # (the rows' info, the colorbar's range) run once
    assert new[:2] == ["/api/get_audio_render_metadata"] * 2
    assert "/api/get_min_dB" in new and "/api/get_max_dB" in new
    after = len(browser.fetch_log)
    browser.advance(30_000)
    assert metadata_reads(browser) == browser.fetch_log[:after].count(
        "/api/get_audio_render_metadata")  # and stops polling
    clean(interp)


def test_the_settle_watcher_stops_after_a_run_of_failed_rounds(booted):
    """app.js:268-288 of the JAX package retried forever when every fetch
    failed; the port's watcher stops after SETTLE_MAX_FAILED_ROUNDS rounds."""
    interp, browser, session, _media = booted
    settle(session)
    for _ in range(10):
        browser.advance(500)
    poll_player = g(interp)["pollPlayer"]
    browser.failing.add("get_audio_render_metadata")
    try:
        reads0 = metadata_reads(browser)
        g(interp)["refreshAppliedWhenSettled"]()
        for _ in range(40):
            browser.advance(30_000)
        reads = metadata_reads(browser) - reads0
        rows = len(interp._call_method(g(interp)["state"]["viewports"], "keys", []))
        assert reads == 30 * rows  # every failed round read every row, then it stopped
        browser.advance(600_000)
        assert metadata_reads(browser) - reads0 == reads
        # the timer queue holds nothing but the player's own poll
        assert all(fn is poll_player for _due, _h, fn, _a in browser.timers), browser.timers
    finally:
        browser.failing.discard("get_audio_render_metadata")
    clean(interp)


def test_a_success_resets_the_failed_run(booted):
    interp, browser, session, _media = booted
    settle(session)
    for _ in range(10):
        browser.advance(500)
    rows = len(interp._call_method(g(interp)["state"]["viewports"], "keys", []))
    browser.failing.add("get_audio_render_metadata")
    reads0 = metadata_reads(browser)
    g(interp)["refreshAppliedWhenSettled"]()
    while metadata_reads(browser) - reads0 < 20 * rows:
        browser.advance(100)
    # one round that reads every row, reporting a row still computing
    md = session.get_audio_render_metadata("0_0")
    browser.failing.discard("get_audio_render_metadata")
    orig = session.get_audio_render_metadata
    session.get_audio_render_metadata = lambda k: {**orig(k), "isComputing": True}
    try:
        target = metadata_reads(browser) + rows
        while metadata_reads(browser) < target:
            browser.advance(100)
    finally:
        del session.get_audio_render_metadata
    browser.failing.add("get_audio_render_metadata")
    try:
        for _ in range(40):
            browser.advance(30_000)
        # 20 failed rounds, one good one, then a fresh run of 30
        assert metadata_reads(browser) - reads0 == (20 + 1 + 30) * rows
    finally:
        browser.failing.discard("get_audio_render_metadata")
    assert md["spectrogramWidth"] > 0
    clean(interp)


def test_the_viewport_watch_stops_after_a_run_of_failed_polls(booted):
    """viewport.js:110-145 of the JAX package (Viewport._watchComputing)
    retried forever when every metadata fetch failed; the port's stops
    after WATCH_MAX_FAILED_POLLS polls, and a poll that reads the metadata
    starts the run again."""
    interp, browser, session, media = booted
    viewports = g(interp)["state"]["viewports"]
    if "0_0" not in interp._call_method(viewports, "keys", []):  # the track, added
        sel = browser.doc["querySelector"]("#media-list")
        sel["value"] = media
        browser.dispatch_event(sel, "change")
    settle(session)
    for _ in range(10):
        browser.advance(500)
    vp = interp._call_method(viewports, "get", ["0_0"])
    reads0 = metadata_reads(browser)
    browser.failing.add("get_audio_render_metadata")
    try:
        interp._call_method(vp, "_watchComputing", [])
        while metadata_reads(browser) - reads0 < 20:
            browser.advance(100)
        # one poll that reads the metadata of a row still computing
        browser.failing.discard("get_audio_render_metadata")
        orig = session.get_audio_render_metadata
        session.get_audio_render_metadata = lambda k: {**orig(k), "isComputing": True}
        try:
            while metadata_reads(browser) - reads0 < 21:
                browser.advance(100)
        finally:
            del session.get_audio_render_metadata
        browser.failing.add("get_audio_render_metadata")
        for _ in range(40):
            browser.advance(30_000)
        assert metadata_reads(browser) - reads0 == 20 + 1 + 30
        browser.advance(600_000)
        assert metadata_reads(browser) - reads0 == 20 + 1 + 30  # and it stopped
    finally:
        browser.failing.discard("get_audio_render_metadata")
    # a watch that reads the settled metadata adopts it and stops
    interp._call_method(vp, "_watchComputing", [])
    for _ in range(10):
        browser.advance(1_000)
    assert vp["metadata"]["isComputing"] is False
    clean(interp)


def test_refresh_all_awaits_the_colorbar(booted):
    """app.js:250 of the JAX package called updateColorbar() without await:
    a failing colorbar fetch became an unhandled rejection and refreshAll
    went on as if it had succeeded.  The port's refreshAll rejects to its
    caller."""
    from torch_fakedom import RejectedPromise

    interp, browser, session, _media = booted
    settle(session)
    browser.failing.add("get_min_dB")
    try:
        got = g(interp)["refreshAll"]()
    finally:
        browser.failing.discard("get_min_dB")
    assert isinstance(got, RejectedPromise), got
    got.handled = True
    assert "get_min_dB" in got.error.value["message"]
    clean(interp)
    assert not isinstance(g(interp)["refreshAll"](), RejectedPromise)  # and succeeds again
    clean(interp)
