"""The port's host copies (thesia_tpu_torch/common, io, native, obs,
dynamics, viewer) against their originals in the JAX package, imported side
by side: filterbanks, windows and frequency-scale math bit for bit, WAV
decode of every sample format bit for bit, the native library's encoders
byte for byte, the dynamics, player, header probe, viewer twin and shape
warmer host code statement for statement (their behaviour is pinned in
tests/test_torch_dynamics.py, tests/test_torch_player.py,
tests/test_torch_precompile.py and tests/test_torch_viewer_consistency.py),
and the viewer's static files byte for byte, app.js with its two logged
repairs."""

import ast
import importlib
import inspect
import struct
import textwrap

import numpy as np
import pytest

import thesia_tpu.native as jax_native
import thesia_tpu_torch.native as port_native
from thesia_tpu import obs as jax_obs
from thesia_tpu.engine import images as jax_images
from thesia_tpu.common import freqscale as jax_freqscale
from thesia_tpu.common import melscale as jax_melscale
from thesia_tpu.common import windows as jax_windows
from thesia_tpu.io import decode as jax_decode
from thesia_tpu.io import wav as jax_wav
from thesia_tpu_torch import obs as port_obs
from thesia_tpu_torch.common import freqscale as port_freqscale
from thesia_tpu_torch.common import melscale as port_melscale
from thesia_tpu_torch.common import windows as port_windows
from thesia_tpu_torch.engine import images as port_images
from thesia_tpu_torch.io import decode as port_decode
from thesia_tpu_torch.io import wav as port_wav

RATES = (8000, 11025, 16000, 22050, 44100, 48000, 96000)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("sr", RATES)
def test_mel_filterbanks_are_bit_exact(sr):
    for n_fft in (64, 256, 1024, 2048, 4096):
        _same(port_melscale.calc_mel_fb_default(sr, n_fft), jax_melscale.calc_mel_fb_default(sr, n_fft))
    for args in ((sr, 512, 40, 20.0, sr / 3.0, True), (sr, 1024, 128, 0.0, None, False)):
        _same(port_melscale.calc_mel_fb(*args), jax_melscale.calc_mel_fb(*args))
        _same(port_melscale.calc_mel_fb(*args, np.float64), jax_melscale.calc_mel_fb(*args, np.float64))


def test_mel_scale_conversions_are_bit_exact():
    hz = np.linspace(0.0, 48000.0, 9601)
    for dtype in (np.float32, np.float64):
        _same(port_melscale.hz_to_mel(hz, dtype), jax_melscale.hz_to_mel(hz, dtype))
        mel = jax_melscale.hz_to_mel(hz, dtype)
        _same(port_melscale.mel_to_hz(mel, dtype), jax_melscale.mel_to_hz(mel, dtype))
    assert port_melscale.MEL_DIFF_2K_1K == jax_melscale.MEL_DIFF_2K_1K
    assert port_melscale.MIN_LOG_MEL == jax_melscale.MIN_LOG_MEL


@pytest.mark.parametrize("kind", ["Hann", "Blackman", "BoxCar"])
def test_windows_are_bit_exact(kind):
    pk, jk = port_windows.WindowType[kind], jax_windows.WindowType[kind]
    assert pk.value == jk.value
    for size in (2, 3, 7, 320, 640, 1920, 4096):
        for norm in (1.0, 512.0, 2048.0):
            _same(port_windows.calc_normalized_win(pk, size, norm),
                  jax_windows.calc_normalized_win(jk, size, norm))
    for size in (2, 5, 1920):
        for sym in (False, True):
            for dt in (np.float32, np.float64):
                _same(port_windows.hann(size, sym, dt), jax_windows.hann(size, sym, dt))
                _same(port_windows.blackman(size, sym, dt), jax_windows.blackman(size, sym, dt))


@pytest.mark.parametrize("scale", ["Linear", "Mel"])
def test_freq_scale_is_bit_exact(scale):
    ps, js = port_freqscale.FreqScale(scale), jax_freqscale.FreqScale(scale)
    assert ps.value == js.value == scale
    for lo, hi in ((0.0, 24000.0), (20.0, 8000.0), (440.0, 441.0), (500.0, 100.0)):
        for rel in (0.0, 0.1, 0.5, 0.999, 1.0):
            assert ps.relative_freq_to_hz(rel, (lo, hi)) == js.relative_freq_to_hz(rel, (lo, hi))
        for hz in (0.0, 20.0, 999.0, 1000.0, 12345.6):
            a, b = ps.hz_to_relative_freq(hz, (lo, hi)), js.hz_to_relative_freq(hz, (lo, hi))
            assert a == b or (np.isnan(a) and np.isnan(b))
        for sr in (16000, 48000):
            for n in (257, 347, 1025):
                assert ps.hz_range_to_idx((lo, hi), sr, n) == js.hz_range_to_idx((lo, hi), sr, n)


def _wav_bytes(fmt_tag: int, bits: int, n_ch: int, sr: int, payload: bytes) -> bytes:
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, n_ch, sr, sr * block, block, bits)
    chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        chunks += b"\0"
    return b"RIFF" + struct.pack("<I", len(chunks)) + chunks


def _payloads(n_ch: int, n: int):
    """(format tag, bits, interleaved payload) of every PCM layout, from
    random samples that include the extremes."""
    rng = np.random.default_rng(n_ch * 1000 + n)
    x = np.clip(rng.standard_normal((n, n_ch)) * 0.4, -1.0, 1.0)
    x[0] = -1.0
    s16 = np.clip(np.round(x * 32768), -32768, 32767).astype("<i2")
    s24 = np.clip(np.round(x * 8388608), -8388608, 8388607).astype("<i4")
    s24_bytes = s24.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    s32 = np.clip(np.round(x * 2147483648.0), -2147483648, 2147483647).astype("<i4")
    u8 = np.clip(np.round(x * 128 + 128), 0, 255).astype(np.uint8)
    return [
        (1, 16, s16.tobytes()), (1, 24, s24_bytes), (3, 32, x.astype("<f4").tobytes()),
        (3, 64, x.astype("<f8").tobytes()), (1, 32, s32.tobytes()), (1, 8, u8.tobytes()),
    ]


@pytest.mark.parametrize("n_ch", [1, 2, 3])
def test_wav_decode_is_bit_exact(n_ch):
    for fmt_tag, bits, payload in _payloads(n_ch, 4001):
        data = _wav_bytes(fmt_tag, bits, n_ch, 44100, payload)
        pw, psr, pcodec = port_wav.decode_wav(data)
        jw, jsr, jcodec = jax_wav.decode_wav(data)
        _same(pw, jw)
        assert (psr, pcodec) == (jsr, jcodec) and pw.shape == (n_ch, 4001)
        pa, pinfo = port_decode.open_audio_file("unused.wav", data=data)
        ja, jinfo = jax_decode.open_audio_file("unused.wav", data=data)
        _same(pa, ja)
        assert pinfo.to_json() == jinfo.to_json()


def test_wav_encoders_and_errors_are_the_same():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 999)).astype(np.float32)
    assert port_wav.encode_wav_s16(x, 48000) == jax_wav.encode_wav_s16(x, 48000)
    assert port_wav.encode_wav_f32(x, 48000) == jax_wav.encode_wav_f32(x, 48000)
    for bad in (b"RIFF....WAVE", b"not audio at all", _wav_bytes(1, 12, 1, 8000, b"\0" * 30)):
        with pytest.raises(port_decode.DecodeError) as pe:
            port_decode.open_audio_file("x", data=bad)
        with pytest.raises(jax_decode.DecodeError) as je:
            jax_decode.open_audio_file("x", data=bad)
        assert str(pe.value) == str(je.value)
    for head in (b"ID3\x03", b"\xff\xfb\x90\x00", b"OggS", b"\0\0\0\x20ftyp", b"fLaC"):
        assert port_decode.sniff_format(head + b"\0" * 8) == jax_decode.sniff_format(head + b"\0" * 8)


def test_the_native_library_builds_without_march_native():
    assert port_native.available() and jax_native.available()
    assert not any(f.startswith("-march") for f in port_native.GXX_FLAGS)
    so = port_native.build_shared(port_native._SRC, "thesia_native")
    assert so is not None and so.startswith(port_native.BUILD_DIR)


def test_native_halve_x_and_rgba_rows_are_byte_equal():
    rng = np.random.default_rng(2)
    for h, w in ((1, 1), (3, 7), (347, 1001), (64, 4096)):
        img = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        _same(port_native.halve_x_u16(img), jax_native.halve_x_u16(img))
        lut = rng.integers(0, 256, (65536, 4), dtype=np.uint8)
        _same(port_native.u16_rgba_rows_bottom_up(img, lut), jax_native.u16_rgba_rows_bottom_up(img, lut))


def test_native_spectrogram_tiles_are_byte_equal():
    rng = np.random.default_rng(3)
    spec = rng.integers(0, 65536, (347, 3000), dtype=np.uint16)
    cmap = rng.integers(0, 256, (258, 4), dtype=np.uint8)
    for crop, width, height in (
        ((0.0, 0.0, 3000.0, 347.0), 512, 347), ((10.5, 3.25, 522.5, 300.75), 520, 520),
        ((2900.0, 0.0, 3000.0, 347.0), 400, 64), ((0.0, 0.0, 3000.0, 347.0), 47, 13),
    ):
        _same(port_native.spectrogram_tile_rgba(spec, crop, width, height, cmap),
              jax_native.spectrogram_tile_rgba(spec, crop, width, height, cmap))
        _same(port_native.lanczos3_crop_resize_u16(spec, crop, width, height),
              jax_native.lanczos3_crop_resize_u16(spec, crop, width, height))


def test_native_waveform_bin_stats_are_byte_equal():
    wav = np.random.default_rng(4).standard_normal(100_003).astype(np.float32)
    for start, end, spb in ((0, 100_003, 1), (0, 100_003, 97), (5000, 9000, 3), (99_000, 100_003, 1024)):
        bins = -(-(end - start) // spb)
        _same(port_native.waveform_bin_stats(wav, start, end, spb, bins),
              jax_native.waveform_bin_stats(wav, start, end, spb, bins))


@pytest.mark.parametrize("fmt", ["f32", "f64", "u8", "s16", "s24", "s32"])
def test_native_pcm_to_f32_planar_is_byte_equal(fmt):
    raw = np.random.default_rng(5).integers(0, 256, 3 * 8 * 1000, dtype=np.uint8)
    if fmt in ("f32", "f64"):  # finite samples only: NaN payloads need not match bitwise
        x = np.random.default_rng(6).standard_normal(len(raw) // 8)
        raw = np.frombuffer(x.astype("<f8" if fmt == "f64" else "<f4").tobytes(), np.uint8)
    for n_ch in (1, 2, 3):
        _same(port_native.pcm_to_f32_planar(raw.tobytes(), n_ch, fmt),
              jax_native.pcm_to_f32_planar(raw.tobytes(), n_ch, fmt))


def test_non_wav_audio_decodes_as_the_original_or_raises_decode_error(tmp_path):
    """The ffmpeg copy builds only where the ffmpeg headers are installed;
    without it the port raises DecodeError, as the original does without
    ffmpeg."""
    path = tmp_path / "clip.ogg"
    path.write_bytes(b"OggS" + bytes(200))
    from thesia_tpu_torch.native import ffmpeg as port_ffmpeg

    if port_ffmpeg.available():
        with pytest.raises(port_decode.DecodeError):
            port_decode.open_audio_file(path)
    else:
        with pytest.raises(port_decode.DecodeError, match="ffmpeg decoder unavailable"):
            port_decode.open_audio_file(path)


def test_obs_spans_are_recorded_as_in_the_original():
    for mod in (port_obs, jax_obs):
        mod.reset()
        for _ in range(3):
            with mod.span("stage.x"):
                pass
        mod.record("stage.y", 0.25)
    port_sum, jax_sum = port_obs.summary(), jax_obs.summary()
    assert set(port_sum) == set(jax_sum) == {"stage.x", "stage.y"}
    assert port_sum["stage.x"]["count"] == jax_sum["stage.x"]["count"] == 3
    assert port_sum["stage.y"] == jax_sum["stage.y"]
    port_obs.reset()
    assert port_obs.summary() == {}


# host copies of the dynamics slice: (port module, original module, whether
# the code is the original's statement for statement)
DYNAMICS_COPIES = [
    ("thesia_tpu_torch.dynamics.envelope", "thesia_tpu.dynamics.envelope", True),
    ("thesia_tpu_torch.dynamics.limiter", "thesia_tpu.dynamics.limiter", True),
    ("thesia_tpu_torch.dynamics.loudness", "thesia_tpu.dynamics.loudness", True),
    ("thesia_tpu_torch.dynamics.stats", "thesia_tpu.dynamics.stats", True),
    ("thesia_tpu_torch.dynamics.normalize", "thesia_tpu.dynamics.normalize", True),
    ("thesia_tpu_torch.dynamics.guard", "thesia_tpu.dynamics.guard", True),
    ("thesia_tpu_torch.dsp.decibel", "thesia_tpu.dsp.decibel", False),
    ("thesia_tpu_torch.engine.audio", "thesia_tpu.engine.audio", False),
    ("thesia_tpu_torch.engine.track", "thesia_tpu.engine.track", False),
    ("thesia_tpu_torch.dynamics.stats_device", "thesia_tpu.dynamics.stats_device", False),
]


def _tree_without_docstrings(obj) -> ast.AST:
    """ast of a module's, class's or function's code, docstrings left out."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _code_without_docstrings(obj) -> str:
    return ast.dump(_tree_without_docstrings(obj))


@pytest.mark.parametrize("port_name,orig_name,verbatim", DYNAMICS_COPIES)
def test_dynamics_copies_name_and_match_their_originals(port_name, orig_name, verbatim):
    """Each module names its original; the host copies are the original's
    code (docstrings and comments aside), the ports keep its names."""
    port, orig = importlib.import_module(port_name), importlib.import_module(orig_name)
    assert orig_name.replace(".", "/") + ".py" in port.__doc__
    if verbatim:
        assert _code_without_docstrings(port) == _code_without_docstrings(orig)
    public = {n for n, v in vars(orig).items()
              if not n.startswith("_") and callable(v) and getattr(v, "__module__", None) == orig_name}
    missing = {n for n in public if not hasattr(port, n)}
    assert not missing, missing


def test_rwlock_is_the_originals_code_and_excludes_writers():
    """thesia_tpu/obs.py:97-150, statement for statement; a writer waits for
    the readers, and a waiting writer holds new readers back."""
    assert "thesia_tpu/obs.py:97-150" in port_obs.__doc__
    assert _code_without_docstrings(port_obs.RwLock) == _code_without_docstrings(jax_obs.RwLock)
    import threading

    lock, order = port_obs.RwLock(), []
    reading, writer_waiting = threading.Event(), threading.Event()

    def writer():
        writer_waiting.set()
        with lock.write():
            order.append("write")

    with lock.read():
        reading.set()
        w = threading.Thread(target=writer)
        w.start()
        assert writer_waiting.wait(10)
        while not lock._writers_waiting:
            pass
        order.append("read")
    w.join(timeout=10)
    assert not w.is_alive() and order == ["read", "write"]


@pytest.mark.parametrize("name", ["_merge_landed", "covers", "next_gap", "reset_host",
                                  "host_bytes", "host_image"])
def test_track_images_bookkeeping_is_the_originals_code(name):
    """thesia_tpu/engine/images.py:180-227, statement for statement."""
    assert "thesia_tpu/engine/images.py" in port_images.__doc__
    assert _code_without_docstrings(getattr(port_images.TrackImages, name)) == \
        _code_without_docstrings(getattr(jax_images.TrackImages, name))


# host copies of the player: (port module, original module)
PLAYER_COPIES = [
    ("thesia_tpu_torch.player.mixing", "thesia_tpu.player.mixing"),
    ("thesia_tpu_torch.player.resampler", "thesia_tpu.player.resampler"),
    ("thesia_tpu_torch.player.stream", "thesia_tpu.player.stream"),
    ("thesia_tpu_torch.player.player", "thesia_tpu.player.player"),
]


def _player_code(mod) -> str:
    """The module's code without docstrings and imports; in player.py,
    Player.set_volume_db is left out too (the port writes the JAX package's
    jnp amp_from_db in torch; tests/test_torch_player.py holds the gains bit
    for bit)."""
    tree = _tree_without_docstrings(mod)
    tree.body = [n for n in tree.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Player":
            node.body = [n for n in node.body
                         if not (isinstance(n, ast.FunctionDef) and n.name == "set_volume_db")]
    return ast.dump(tree)


@pytest.mark.parametrize("port_name,orig_name", PLAYER_COPIES)
def test_player_copies_name_and_match_their_originals(port_name, orig_name):
    port, orig = importlib.import_module(port_name), importlib.import_module(orig_name)
    assert orig_name.replace(".", "/") + ".py" in port.__doc__
    assert _player_code(port) == _player_code(orig)
    if not port_name.endswith(".player"):  # the same imports, docstrings aside
        assert _code_without_docstrings(port) == _code_without_docstrings(orig)


VIEWER_FILES = ["index.html", "style.css", "js/api.js", "js/app.js", "js/applogic.js",
                "js/audioplayer.js", "js/axes.js", "js/caches.js", "js/freqscale.js",
                "js/overview.js", "js/viewport.js"]

# the port's repairs of thesia_tpu/viewer/js/app.js (ROADMAP.md, Queue 3):
# (the original's text, the port's); each original text occurs once
APP_JS_REPAIRS = [
    # refreshAll awaits the colorbar's refresh, so its rejection reaches
    # refreshAll's caller
    ("""  updateColorbar();
  // deferred switches return at dispatch""",
     """  await updateColorbar();
  // deferred switches return at dispatch"""),
    # refreshAppliedWhenSettled stops after a bounded run of failed rounds
    ("""// isComputing until they do).  Latest-wins: a newer schedule supersedes.
let appliedSettleGen = 0;
function refreshAppliedWhenSettled() {
  const gen = ++appliedSettleGen;
  const FAILED = Symbol("fetch-failed");
  const poll = async (delay) => {""",
     """// isComputing until they do).  Latest-wins: a newer schedule supersedes.
// A run of SETTLE_MAX_FAILED_ROUNDS rounds whose fetches all failed ends the
// chain (the engine is gone); a round that reads every row resets the run.
let appliedSettleGen = 0;
const SETTLE_MAX_FAILED_ROUNDS = 30;
function refreshAppliedWhenSettled() {
  const gen = ++appliedSettleGen;
  const FAILED = Symbol("fetch-failed");
  let failedRounds = 0;
  const poll = async (delay) => {"""),
    ("""    if (mds.some((md) => md === FAILED)) {
      next(); // transient failure: retry with backoff
      return;
    }
    // null = row removed""",
     """    if (mds.some((md) => md === FAILED)) {
      failedRounds += 1;
      if (failedRounds >= SETTLE_MAX_FAILED_ROUNDS) return; // stop polling
      next(); // transient failure: retry with backoff
      return;
    }
    failedRounds = 0;
    // null = row removed"""),
]


# the port's repair of thesia_tpu/viewer/js/viewport.js (ROADMAP.md, Queue
# 3): Viewport._watchComputing stops after a bounded run of failed polls
VIEWPORT_JS_REPAIRS = [
    ("""const CROSSFADE_MS = 200; // reference: AudioTrackViewport.tsx:30-35
""",
     """const CROSSFADE_MS = 200; // reference: AudioTrackViewport.tsx:30-35
// a run of this many polls whose fetch failed ends _watchComputing (the
// engine is gone); a poll that reads the metadata resets the run
const WATCH_MAX_FAILED_POLLS = 30;
"""),
    ("""    const FAILED = Symbol("fetch-failed");
    const poll = async (delay) => {
      if (gen !== this._computingGen) return; // a newer refresh took over""",
     """    const FAILED = Symbol("fetch-failed");
    let failedPolls = 0;
    const poll = async (delay) => {
      if (gen !== this._computingGen) return; // a newer refresh took over"""),
    ("""      if (md === FAILED) {
        setTimeout(() => poll(Math.min(delay * 1.25, 2000)), delay);
        return;
      }
      if (!md) return; // track gone: stop""",
     """      if (md === FAILED) {
        failedPolls += 1;
        if (failedPolls >= WATCH_MAX_FAILED_POLLS) return; // stop polling
        setTimeout(() => poll(Math.min(delay * 1.25, 2000)), delay);
        return;
      }
      failedPolls = 0;
      if (!md) return; // track gone: stop"""),
]

REPAIRS = {"js/app.js": APP_JS_REPAIRS, "js/viewport.js": VIEWPORT_JS_REPAIRS}


def repaired(original: str, repairs) -> str:
    for old, new in repairs:
        assert original.count(old) == 1, old
        original = original.replace(old, new)
    return original


def repaired_app_js(original: str) -> str:
    return repaired(original, APP_JS_REPAIRS)


@pytest.mark.parametrize("name", VIEWER_FILES)
def test_viewer_files_are_byte_equal_to_the_originals(name):
    """thesia_tpu_torch/viewer/ is thesia_tpu/viewer/'s static app, byte for
    byte, but for app.js and viewport.js, each the original with exactly the
    repairs of APP_JS_REPAIRS and VIEWPORT_JS_REPAIRS; beside it the two
    Python twins (pinned below)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    port, orig = root / "thesia_tpu_torch" / "viewer", root / "thesia_tpu" / "viewer"
    if name in REPAIRS:
        assert (port / name).read_text() == repaired((orig / name).read_text(), REPAIRS[name])
        assert (port / name).read_bytes() != (orig / name).read_bytes()
    else:
        assert (port / name).read_bytes() == (orig / name).read_bytes()
    shipped = sorted(str(p.relative_to(port)) for p in port.rglob("*")
                     if p.is_file() and "__pycache__" not in p.parts)
    assert shipped == sorted(VIEWER_FILES + ["twin.py", "twin_app.py"])
    assert sorted(p.name for p in (orig / "js").glob("*.js")) == sorted(
        n[3:] for n in VIEWER_FILES if n.startswith("js/"))


# host copies that are their original's code statement for statement,
# docstrings aside: (port module, original module)
STATEMENT_COPIES = [
    ("thesia_tpu_torch.io.probe", "thesia_tpu.io.probe"),
    ("thesia_tpu_torch.viewer.twin", "thesia_tpu.viewer.twin"),
    ("thesia_tpu_torch.viewer.twin_app", "thesia_tpu.viewer.twin_app"),
]


@pytest.mark.parametrize("port_name,orig_name", STATEMENT_COPIES)
def test_probe_and_viewer_twins_are_the_originals_code(port_name, orig_name):
    port, orig = importlib.import_module(port_name), importlib.import_module(orig_name)
    assert orig_name.replace(".", "/") + ".py" in port.__doc__
    assert _code_without_docstrings(port) == _code_without_docstrings(orig)


def test_the_shape_warmers_control_logic_is_the_originals():
    """enabled, neighbor_settings and _detent_index statement for statement;
    ShapeWarmer's interactive, submit and drain too, and in _run the idle
    exit, the interactive wait with the supersede check, and the pending
    clear (the port's gate and job body differ: dsp/precompile.py)."""
    from thesia_tpu.dsp import precompile as jax_pc
    from thesia_tpu_torch.dsp import precompile as port_pc

    assert "thesia_tpu/dsp/precompile.py" in port_pc.__doc__
    assert port_pc.T_OVERLAP_VALUES == jax_pc.T_OVERLAP_VALUES
    assert port_pc.WIN_MS_PRESETS == jax_pc.WIN_MS_PRESETS
    for name in ("enabled", "neighbor_settings", "_detent_index"):
        assert _code_without_docstrings(getattr(port_pc, name)) == \
            _code_without_docstrings(getattr(jax_pc, name)), name
    for name in ("interactive", "submit", "drain"):
        assert _code_without_docstrings(getattr(port_pc.ShapeWarmer, name)) == \
            _code_without_docstrings(getattr(jax_pc.ShapeWarmer, name)), name

    def run_parts(cls):
        loop = _tree_without_docstrings(cls._run).body[0].body[0]  # while True
        inner = loop.body[2]  # while i < len(jobs)
        return [ast.dump(n) for n in (loop.body[0], loop.body[1], inner.test, inner.body[0],
                                      loop.body[-1])]

    assert run_parts(port_pc.ShapeWarmer) == run_parts(jax_pc.ShapeWarmer)
