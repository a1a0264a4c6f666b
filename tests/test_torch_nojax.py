"""thesia_tpu_torch imports neither jax, nor the JAX package thesia_tpu, nor
aiohttp, and chip_smoke.py refuses to run without a card.  A subprocess
imports every module of the port and runs the whole CPU slice with shadow
``jax``, ``thesia_tpu`` and ``aiohttp`` packages on PYTHONPATH whose import
raises, deferred commands, image streaming, the big-WAV prefetch with K4 and
the player included (the repository's way of simulating an absent package);
another serves requests through the port's service and transport; another
runs the cold-start modules (the shape warmer, the device warmup, the header
probe, the viewer twins); another runs the device mesh (``parallel/``: a
virtual CPU mesh through the analyzer, the warm jobs and the dry run);
another imports chip_smoke.py's modules under the same shadows."""

import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent

SHADOWED = ("jax", "thesia_tpu", "aiohttp")
# no module of jax, of the JAX package or of aiohttp is loaded
NOT_LOADED = (
    f'bad = [k for k in sys.modules if k.split(".")[0] in {SHADOWED!r}]; '
    'assert not bad, bad'
)

SLICE = textwrap.dedent(
    f"""
    import importlib, pkgutil, sys, tempfile
    from pathlib import Path
    import numpy as np
    import thesia_tpu_torch
    for m in pkgutil.walk_packages(thesia_tpu_torch.__path__, "thesia_tpu_torch."):
        importlib.import_module(m.name)
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_s16
    from thesia_tpu_torch.render.colormap import default_colormap_rgba8
    from thesia_tpu_torch.render.tiles import decode_spectrogram_tile
    d = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    paths = []
    for name, sr, ch in (("a.wav", 8000, 2), ("b.wav", 16000, 1)):
        w = (0.3 * rng.standard_normal((ch, sr))).astype(np.float32)
        (d / name).write_bytes(encode_wav_s16(np.clip(w, -1, 1), sr))
        paths.append(str(d / name))
    s = EngineSession(device="cpu", settings_dir=d / "config")
    s.init(default_colormap_rgba8().reshape(-1).tolist())
    assert s.add_tracks([0, 1], paths) == [0, 1]
    assert s.apply_track_list_changes() == ["0_0", "0_1", "1_0"]
    assert s.get_audio_render_metadata("1_0")["spectrogramWidth"] > 0
    assert decode_spectrogram_tile(s.get_spectrogram_tile("0_0", 0, 0, 0, 0))["width"] > 0
    s.set_spec_setting({{"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}})
    assert decode_spectrogram_tile(s.get_spectrogram_tile("1_0", 0, 0, 0, 0))["height"] > 0
    assert len(s.get_waveform_tile("0_1", 0, 0)) > 24
    lufs = s.get_global_lufs(0)["value"]
    s.set_common_guard_clipping("Limiter")
    s.set_common_normalize({{"type": "LUFS", "target": lufs + 12.0}})
    assert s.get_guard_clip_stats(0) and min(s.get_limiter_gain(0)) < 1.0
    s.set_common_guard_clipping("Clip")
    assert s.get_audio_render_metadata("0_0")["isClipped"]
    from thesia_tpu_torch.dynamics import stats_device
    assert stats_device.lufs_stats_batched.launches and stats_device.limiter_gain_seqs_batched.launches
    # the deferred engine: background streaming, the switch worker, the
    # deferred apply's reconcile and the store's region fetches
    s.set_spec_setting({{"winMillisec": 20.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}, defer=True)
    s.set_common_normalize({{"type": "LUFS", "target": lufs - 6.0}}, defer=True)
    s.set_common_guard_clipping("ReduceGlobalLevel", defer=True)
    assert s.settings_settled(timeout=120)
    assert decode_spectrogram_tile(s.get_spectrogram_tile("0_1", 3, 0, 0, 0))["width"] > 0
    s.remove_tracks([1])
    (d / "c.wav").write_bytes(encode_wav_s16(np.full((1, 8000), 0.9, np.float32), 8000))
    s.add_tracks([2], [str(d / "c.wav")])
    assert "2_0" in s.apply_track_list_changes(defer=True)
    assert s.settings_settled(timeout=120) and s.tm.images.drain(timeout=120)
    assert not s.get_audio_render_metadata("0_0")["isComputing"]
    assert s.tm.images.stream_failures == 0
    # the big-WAV prefetch (K4 on the payload) and the player
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer
    from thesia_tpu_torch.kernels import pcm
    EngineSession._PREFETCH_MIN_FILE_BYTES = 0
    SpectrogramAnalyzer._PREFETCH_MIN_BYTES = 0
    pcm.reset_launches()
    assert s.add_tracks([3], [paths[0]]) == [3]
    assert s.tm.spec_analyzer.prefetch_adopted == 1 and pcm.deinterleave_flat.launches == 1
    s.apply_track_list_changes(defer=False)
    assert s.player.requested_sr == 8000
    s.set_track_player(3, 0.5)
    s.resume_player()
    s.seek_player(0.25)
    s.pause_player()
    s.set_volume_db(-6.0)
    assert s.player.state()["trackId"] == 3
    {NOT_LOADED}
    print("SLICE-OK")
    """
)
SERVICE = textwrap.dedent(
    f"""
    import asyncio, http.client, json, sys, tempfile, threading
    from pathlib import Path
    import numpy as np
    import thesia_tpu_torch.__main__
    from thesia_tpu_torch.engine import http as _transport
    from thesia_tpu_torch.engine.service import EngineService
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_s16
    from thesia_tpu_torch.render.colormap import default_colormap_rgba8
    from thesia_tpu_torch.render.tiles import decode_waveform_tile
    d = Path(tempfile.mkdtemp())
    (d / "a.wav").write_bytes(encode_wav_s16(np.zeros((1, 8000), np.float32) + 0.25, 8000))
    svc = EngineService(EngineSession(device="cpu", settings_dir=d / "config"))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever)
    thread.start()
    port = asyncio.run_coroutine_threadsafe(svc.start("127.0.0.1", 0), loop).result(10)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    def post(name, body):
        conn.request("POST", "/api/" + name, json.dumps(body), {{"Content-Type": "application/json"}})
        r = conn.getresponse()
        return r.status, r.read()
    assert post("is_dev", {{}}) == (200, b'{{"result": false}}')
    post("init", {{"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()}})
    post("add_tracks", {{"trackIds": [0], "paths": [str(d / "a.wav")]}})
    post("apply_track_list_changes", {{}})
    status, tile = post("get_waveform_tile", {{"idChStr": "0_0", "level": 0, "tileIndex": 0}})
    assert status == 200 and decode_waveform_tile(tile)["binCount"] == 1024
    conn.close()
    asyncio.run_coroutine_threadsafe(svc.stop(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    {NOT_LOADED}
    print("SERVICE-OK")
    """
)
COLDSTART = textwrap.dedent(
    f"""
    import os, sys, tempfile
    from pathlib import Path
    import numpy as np
    os.environ["THESIA_PRECOMPILE"] = "1"
    from thesia_tpu_torch import runtime
    from thesia_tpu_torch.dsp import precompile
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.probe import probe_shape
    from thesia_tpu_torch.io.wav import encode_wav_s16
    from thesia_tpu_torch.render.colormap import default_colormap_rgba8
    from thesia_tpu_torch.viewer import twin, twin_app
    runtime.device_warmup(device="cpu")
    runtime.device_warmup(background=True, device="cpu")
    assert runtime.warmup_done("cpu")
    assert len(precompile.neighbor_settings(precompile.SpecSetting())) == 9
    assert twin.tick_scale(twin.AMP_TICK_NUM, 80) == (5, 5) and "MAX_PX_PER_SEC" in twin_app.TWINNED
    d = Path(tempfile.mkdtemp())
    (d / "a.wav").write_bytes(encode_wav_s16(np.full((2, 24000), 0.25, np.float32), 8000))
    assert probe_shape(d / "a.wav") == (2, 24000, 8000)
    s = EngineSession(device="cpu", settings_dir=d / "config")
    s.init(default_colormap_rgba8().reshape(-1).tolist())
    s.add_tracks([0], [str(d / "a.wav")])
    s.apply_track_list_changes(defer=True)
    s.set_spec_setting({{"winMillisec": 20.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}, defer=True)
    assert s.settings_settled(timeout=120) and s.tm.shape_warmer.drain(timeout=120)
    w = s.tm.shape_warmer
    assert w.compiled_count > 0 and w.failed_count == 0, (w.compiled_count, w.failed_count)
    {NOT_LOADED}
    print("COLDSTART-OK")
    """
)
MESH = textwrap.dedent(
    f"""
    import sys
    import numpy as np
    import torch
    from thesia_tpu_torch.dsp import precompile
    from thesia_tpu_torch.dsp.framing import SpecSetting
    from thesia_tpu_torch.dsp.spectrogram import SpectrogramAnalyzer
    from thesia_tpu_torch.parallel import sharding
    from thesia_tpu_torch.tools import dryrun_mesh
    rng = np.random.default_rng(0)
    items = [(0, rng.uniform(-1, 1, (2, 6000)).astype(np.float32), 8000, 1)]
    single = SpectrogramAnalyzer("cpu").calc_specs_batched(items, SpecSetting())
    sharding.set_active_mesh(sharding.make_mesh(devices=["cpu"] * 8, time_parallel=4))
    an = SpectrogramAnalyzer("cpu")
    assert torch.equal(an.calc_specs_batched(items, SpecSetting())[0].db, single[0].db)
    make = precompile.spec_jobs_for(an, [(0, (2, 6000), 8000)], SpecSetting(),
                                    sharding.active_spec_sharding())[0]
    make()[1]()
    sharding.set_active_mesh(None)
    assert dryrun_mesh.main(["4", "--device", "cpu"]) == 0
    {NOT_LOADED}
    print("MESH-OK")
    """
)
SMOKE_IMPORTS = textwrap.dedent(
    f"""
    import sys
    import chip_smoke
    m = chip_smoke.port_modules()
    assert m.spec_db.spec_db.launches == {{"mel": 0, "linear": 0}}
    assert m.stats_device.lufs_stats_batched.launches == 0
    assert m.pcm.deinterleave_flat.launches == m.pcm.deinterleave_s24.launches == 0
    {NOT_LOADED}
    print("IMPORTS-OK")
    """
)


def _shadowed_env(tmp_path):
    """PYTHONPATH with shadow jax, thesia_tpu and aiohttp packages ahead of
    the repo."""
    root = tmp_path / "shadow"
    for name in SHADOWED:
        (root / name).mkdir(parents=True)
        (root / name / "__init__.py").write_text(
            f'raise ImportError("{name} is shadowed in this test")\n')
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))


def test_the_port_runs_the_slice_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SLICE], env=_shadowed_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SLICE-OK" in proc.stdout


def test_the_port_serves_without_jax_or_aiohttp(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SERVICE], env=_shadowed_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVICE-OK" in proc.stdout


def test_the_cold_start_modules_run_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", COLDSTART], env=_shadowed_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "COLDSTART-OK" in proc.stdout


def test_the_mesh_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", MESH], env=_shadowed_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MESH-OK" in proc.stdout


def test_chip_smoke_imports_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SMOKE_IMPORTS], env=_shadowed_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTS-OK" in proc.stdout


def test_no_source_of_the_port_imports_the_jax_package():
    pattern = re.compile(r"^\s*(from|import) (jax|thesia_tpu|aiohttp)([. ]|$)", re.M)
    files = sorted((REPO / "thesia_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def _run_smoke(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
