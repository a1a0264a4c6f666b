"""The port's engine service (thesia_tpu_torch/engine/service.py on the
standard-library transport engine/http.py) against the JAX service
(thesia_tpu/engine/service.py on aiohttp), on the CPU.

The JAX service runs under aiohttp's TestServer and the port's on a loopback
socket, each on an event loop of its own thread; one standard-library client
sends both the same bytes.  WAVs are written from numpy seeds.  Covered: the
tables, a parity round trip (metadata equal but for the revisions, waveform
tiles bit-equal, spectrogram tiles within tests/torch_parity.py, axis answers
equal, every malformed request the same status), keep-alive, a WebSocket
client written here, static files, uploads, the body limits, concurrent
clients in both settings modes, the debug and player routes, and
``python -m thesia_tpu_torch`` as a process.  Mirrors tests/test_service.py,
tests/test_service_concurrent.py and tests/test_remote_audio.py:234."""

import asyncio
import base64
import contextlib
import hashlib
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

# the JAX service needs aiohttp, which the machine with the card lacks: there
# this CPU-only file skips (it has no gpu case)
jax_service = pytest.importorskip("thesia_tpu.engine.service")

from aiohttp.test_utils import TestServer  # noqa: E402
from torch_http import TIMEOUT, Client, LoopThread, port_server  # noqa: E402
from torch_parity import db_limit  # noqa: E402
from thesia_tpu.engine.session import EngineSession as JaxSession  # noqa: E402
from thesia_tpu_torch.engine import http as port_http  # noqa: E402
from thesia_tpu_torch.engine import service as port_service  # noqa: E402
from thesia_tpu_torch.engine.session import EngineSession as PortSession  # noqa: E402
from thesia_tpu_torch.io.wav import encode_wav_s16  # noqa: E402
from thesia_tpu_torch.player.player import MAX_PULL_FRAMES  # noqa: E402
from thesia_tpu_torch.render.colormap import default_colormap_rgba8  # noqa: E402
from thesia_tpu_torch.render.tiles import decode_spectrogram_tile, decode_waveform_tile  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CMAP = default_colormap_rgba8().reshape(-1).tolist()
LINEAR = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}


# -- servers and clients -----------------------------------------------------


@contextlib.contextmanager
def jax_server(session, **kw):
    svc = jax_service.EngineService(session, **kw)
    lt = LoopThread()
    server = TestServer(svc.make_app(), host="127.0.0.1")
    try:
        lt.run(server.start_server())
        yield svc, server.port
    finally:
        lt.run(server.close())
        lt.close()


def _wav(path, sr, sec, freqs, seed):
    """Sines plus white noise at -60 dBFS as a 16-bit WAV."""
    rng = np.random.default_rng(seed)
    n = int(sr * sec)
    t = np.arange(n) / sr
    rows = [0.5 * np.sin(2 * np.pi * f * t) + 1e-3 * rng.standard_normal(n) for f in freqs]
    path.write_bytes(encode_wav_s16(np.clip(np.stack(rows), -1, 1).astype(np.float32), sr))
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_service_wavs")
    return [
        _wav(d / "stereo_8k.wav", 8000, 2.0, (440.0, 550.0), 1),
        _wav(d / "mono_16k.wav", 16000, 1.5, (1000.0,), 2),
        _wav(d / "mono_22k.wav", 22050, 1.0, (300.0,), 3),
    ]


@pytest.fixture(scope="module")
def jax_warm(wavs, tmp_path_factory):
    """The JAX session's programs compiled for these shapes before any
    request is timed by a socket wait."""
    s = JaxSession(settings_dir=tmp_path_factory.mktemp("jax_warm"))
    s.init(CMAP)
    s.add_tracks([0, 1], wavs[:2])
    s.apply_track_list_changes(defer=False)
    s.get_spectrogram_tile("0_0", 0, 0, 0, 0)
    s.set_spec_setting(LINEAR, defer=False)
    s.tm.images.drain()


# -- (a) the tables ----------------------------------------------------------


def test_tables_are_the_jax_services():
    for name in ("BINARY_COMMANDS", "WRITE_COMMANDS", "COMMANDS", "OPTIONAL_ARGS", "MISC_COMMANDS"):
        assert getattr(port_service, name) == getattr(jax_service, name), name
    assert len(port_service.COMMANDS) == 41
    assert port_service.AXIS_COMMANDS == jax_service.AXIS_COMMANDS
    session_methods = {n for n in dir(PortSession) if not n.startswith("_")}
    for method, _args in port_service.COMMANDS.values():
        assert method in session_methods, method
    cmds = port_service.Commands.__new__(port_service.Commands)
    cmds.axis, cmds.misc = port_service.AxisApi(), port_service.MiscApi()
    for table, target in ((port_service.AXIS_COMMANDS, cmds.axis), (port_service.MISC_COMMANDS, cmds.misc)):
        for method, _args in table.values():
            assert callable(getattr(target, method)), method
    assert port_service.MiscApi().get_default_colormap() == jax_service.MiscApi().get_default_colormap()
    for x in (np.arange(3), np.int64(4), np.float32(0.5), {"a": (np.float64(1.0), [np.int8(2)])}):
        assert port_service._jsonable(x) == jax_service._jsonable(x)


def test_command_call_maps_errors_like_handle_command(tmp_path, caplog):
    """The transport-free table: lookup order, 404, non-object bodies,
    missing and optional arguments, the 400 mapping (TypeError logged with
    its traceback), binary results."""
    cmds = port_service.Commands(PortSession(device="cpu", settings_dir=tmp_path))
    assert cmds.call("nope", {}) == (404, {"error": "unknown command nope"})
    assert cmds.call("is_dev", [1]) == (400, {"error": "request body must be a JSON object"})
    assert cmds.call("get_sample_rate", {}) == (400, {"error": "missing argument trackId for get_sample_rate"})
    assert cmds.call("is_dev", {}) == (200, {"result": False})
    assert cmds.call("seconds_to_label", {"sec": 61.5}) == (200, {"result": "00:01:01.500"})
    assert cmds.call("get_default_colormap", {})[1]["result"] == CMAP
    status, body = cmds.call("set_dB_range", {"dBRange": "abc"})
    assert status == 400 and "error" in body
    with caplog.at_level("WARNING"):
        status, body = cmds.call("get_waveform_tile", {"idChStr": "0_0", "level": [], "tileIndex": 0})
    assert status == 400
    # OPTIONAL_ARGS become None: set_track_player without "sec" reaches the
    # session (which ignores an unknown track)
    assert cmds.call("set_track_player", {"trackId": 5}) == (200, {"result": None})
    assert cmds.call("set_track_player", {}) == (400, {"error": "missing argument trackId for set_track_player"})


# -- (b) parity round trip ------------------------------------------------------


AXIS_BODIES = [
    ("calc_time_axis_markers", {"startSec": 0.0, "endSec": 2.0, "tickUnit": 0.5, "labelInterval": 2, "maxSec": 2.0}),
    ("calc_freq_axis_markers", {"hzRangeMin": 0.0, "hzRangeMax": 8000.0, "freqScale": "Mel",
                                "maxNumTicks": 12, "maxNumLabels": 6, "maxTrackHz": 8000.0}),
    ("calc_dB_axis_markers", {"maxNumTicks": 8, "maxNumLabels": 4, "dBRangeMin": -100.0, "dBRangeMax": 0.0}),
    ("calc_amp_axis_markers", {"maxNumTicks": 5, "maxNumLabels": 3, "ampRangeMin": -1.0, "ampRangeMax": 1.0}),
    ("freq_pos_to_hz", {"freqScale": "Linear", "y": 100.0, "height": 400, "hzRangeMin": 0.0,
                        "hzRangeMax": 8000.0, "maxTrackHz": 8000.0}),
    ("format_linear_axis_tooltip", {"value": 0.25, "resolution": 0.01, "tickUnit": None, "maxFractionDigits": 3}),
    ("time_label_to_seconds", {"label": "inf"}),
    ("seconds_to_label", {"sec": 3725.5}),
]
MALFORMED = [
    ("nope", {}),
    ("get_sample_rate", {}),
    ("get_waveform_tile", {"idChStr": 3, "level": 0, "tileIndex": 0}),
    ("get_waveform_tile", {"idChStr": "0_-1", "level": 0, "tileIndex": 0}),
    ("get_spectrogram_tile", {"idChStr": "1_2_3", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0}),
    ("set_dB_range", {"dBRange": "abc"}),
    ("set_dB_range", {"dBRange": -5}),
    ("set_dB_range", {"dBRange": float("inf")}),
    ("set_dB_range", {"dBRange": float("nan")}),
    ("set_user_settings", {"userSettings": {"dBRange": float("inf")}}),
    ("set_user_settings", {"userSettings": 5}),
    ("set_track_player", {"trackId": [1], "sec": 0}),
    ("add_tracks", {"trackIds": [0, 1], "paths": ["/x"]}),
    ("remove_tracks", {"trackIds": []}),
    ("set_spec_setting", {"specSetting": {"winMillisec": -1, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}),
    ("set_spec_setting", {"specSetting": {"winMillisec": 1e9, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}),
    ("get_waveform_tile", {"idChStr": "0_0", "level": 63, "tileIndex": 0}),
    ("get_waveform_tile", {"idChStr": "0_0", "level": 2, "tileIndex": 2**40}),
    ("get_spectrogram_tile", {"idChStr": "0_0", "levelX": 10**9, "levelY": 0, "tileX": 0, "tileY": 0}),
    ("set_common_normalize", {"target": {"type": "Wat", "target": -3}}),
    ("set_common_normalize", {"target": {"type": "LUFS", "target": "nan"}}),
    ("set_common_guard_clipping", {"mode": "Bogus"}),
    ("calc_time_axis_markers", {"startSec": 0.0, "endSec": 1e15, "tickUnit": 1e-6, "labelInterval": 2, "maxSec": 10.0}),
    ("calc_dB_axis_markers", {"maxNumTicks": 3, "maxNumLabels": 0, "dBRangeMin": -100.0, "dBRangeMax": 0.0}),
    ("freq_pos_to_hz", {"freqScale": "Bogus", "y": 1.0, "height": 10, "hzRangeMin": 0.0,
                        "hzRangeMax": 1.0, "maxTrackHz": 1.0}),
]
RAW_BODIES = [b"[1,2]", b"5", b"\xff\xfe\x00bad", b"{not json", b""]
SPEC_TILES = [("0_0", 0, 0, 0, 0), ("0_1", 1, 0, 0, 0), ("1_0", 0, 0, 0, 0), ("1_0", 2, 1, 0, 0)]
WAVE_TILES = [("0_0", 0, 0), ("0_1", 3, 0), ("1_0", 0, 1), ("1_0", 8, 0)]
GETTERS = ["get_sample_rate", "get_length_sec", "get_channel_counts", "get_format_info",
           "get_file_name", "get_max_peak_dB"]


def _drive(client: Client, session, wavs) -> dict:
    """One request sequence; replies by step."""
    out = {"init": client.call("init", colormapRgba=CMAP),
           "add": client.call("add_tracks", trackIds=[0, 1], paths=wavs[:2]),
           "apply": client.call("apply_track_list_changes")}
    for stage in ("Mel", "Linear"):
        if stage == "Linear":
            out["set"] = client.call("set_spec_setting", specSetting=LINEAR)
        session.tm.images.drain()
        out[stage] = {
            "metadata": {k: client.call("get_audio_render_metadata", idChStr=k) for k in ("0_0", "0_1", "1_0")},
            "spec": {a: client.call("get_spectrogram_tile", **dict(zip(
                ("idChStr", "levelX", "levelY", "tileX", "tileY"), a))) for a in SPEC_TILES},
            "wave": {a: client.call("get_waveform_tile", idChStr=a[0], level=a[1], tileIndex=a[2])
                     for a in WAVE_TILES},
            "range": (client.call("get_max_dB"), client.call("get_min_dB")),
        }
    out["getters"] = {(g, t): client.call(g, trackId=t) for g in GETTERS for t in (0, 1)}
    out["lufs"] = [client.call("get_global_lufs", trackId=t) for t in (0, 1)]
    out["state"] = {n: client.call(n) for n in ("get_spec_setting", "get_dB_range", "get_max_track_hz",
                                                "get_longest_track_length_sec", "get_common_normalize",
                                                "get_common_guard_clipping")}
    out["find"] = client.call("find_id_by_path", path=wavs[1])
    out["axis"] = [client.call(name, **body) for name, body in AXIS_BODIES]
    out["malformed"] = [client.post(f"/api/{name}", body).status for name, body in MALFORMED]
    out["raw"] = [client.post("/api/find_id_by_path", raw=raw).status for raw in RAW_BODIES]
    out["routes"] = [client.request(m, p).status for m, p in
                     (("GET", "/api/is_dev"), ("POST", "/player/state"), ("GET", "/nowhere"),
                      ("POST", "/api/"), ("GET", "/pending_open_paths"))]
    return out


def _without_revisions(md):
    return {k: v for k, v in md.items() if k not in ("waveformRevision", "spectrogramRevision")}


def _color_index(rgba: np.ndarray) -> np.ndarray:
    """Each pixel's entry in the default colormap (all 258 are distinct)."""
    table = default_colormap_rgba8().reshape(-1, 4)
    keys = table.astype(np.uint32) @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    assert len(set(keys.tolist())) == len(keys)
    pix = rgba.reshape(-1, 4).astype(np.uint32) @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    order = np.argsort(keys)
    idx = np.searchsorted(keys[order], pix)
    assert (keys[order][idx] == pix).all()
    return order[idx].reshape(rgba.shape[:2]).astype(np.int64)


@pytest.fixture(scope="module")
def parity(wavs, jax_warm, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_service_parity")
    runs = {}
    for name, serve, session in (
        ("jax", jax_server, JaxSession(settings_dir=d / "jax")),
        ("port", port_server, PortSession(device="cpu", settings_dir=d / "port")),
    ):
        with serve(session) as (_svc, port):
            client = Client(port)
            try:
                runs[name] = _drive(client, session, wavs)
            finally:
                client.close()
    return runs["jax"], runs["port"]


def test_parity_results_and_metadata(parity):
    j, p = parity
    for key in ("init", "add", "apply", "set", "state", "find", "getters"):
        assert p[key] == j[key], key
    for stage in ("Mel", "Linear"):
        for k, md in j[stage]["metadata"].items():
            assert _without_revisions(p[stage]["metadata"][k]) == _without_revisions(md), (stage, k)
    for a, b in zip(p["lufs"], j["lufs"]):
        assert a["type"] == b["type"] == "Finite" and abs(a["value"] - b["value"]) <= 1e-9


def test_parity_waveform_tiles_are_bit_equal(parity):
    j, p = parity
    for stage in ("Mel", "Linear"):
        assert p[stage]["wave"] == j[stage]["wave"]
        for tile in p[stage]["wave"].values():
            assert decode_waveform_tile(tile)["binCount"] > 0


@pytest.mark.parametrize("stage", ["Mel", "Linear"])
def test_parity_spectrogram_tiles_within_the_contract(parity, stage):
    """Headers equal but for the revision; the dB range within db_limit; each
    pixel's colormap entry at most one apart (the contract's u16 steps, at
    most 63 down to 100 dB below the max, are under the 255 u16 values of
    one colormap entry)."""
    j, p = parity
    (jmax, jmin), (pmax, pmin) = j[stage]["range"], p[stage]["range"]
    assert abs(pmax["value"] - jmax["value"]) <= db_limit(jmax["value"], jmax["value"])
    assert abs(pmin["value"] - jmin["value"]) <= db_limit(jmin["value"], jmax["value"])
    for args, want in j[stage]["spec"].items():
        got = p[stage]["spec"][args]
        assert len(got) == len(want) and got[8:40] == want[8:40], args
        dg, dw = decode_spectrogram_tile(got), decode_spectrogram_tile(want)
        step = np.abs(_color_index(dg["rgba"]) - _color_index(dw["rgba"]))
        assert step.max() <= 1, (args, int(step.max()))


def test_parity_axis_answers_are_equal(parity):
    j, p = parity
    assert p["axis"] == j["axis"]


def test_parity_malformed_requests_get_the_same_status(parity):
    j, p = parity
    assert p["malformed"] == j["malformed"]
    assert p["malformed"][0] == 404 and set(p["malformed"][1:]) == {400}
    assert p["raw"] == j["raw"] == [400] * len(RAW_BODIES)
    assert p["routes"] == j["routes"] == [405, 405, 404, 404, 200]


# -- (c) keep-alive, (e) static files, transport limits ----------------------------


@pytest.fixture(scope="module")
def idle_port_service(tmp_path_factory):
    viewer = REPO / "thesia_tpu_torch" / "viewer"
    session = PortSession(device="cpu", settings_dir=tmp_path_factory.mktemp("idle_cfg"))
    with port_server(session, viewer_dir=str(viewer), open_paths=["/a.wav", "/b.wav"]) as (svc, port):
        yield svc, port


def test_keep_alive_serves_many_requests_on_one_connection(idle_port_service):
    _svc, port = idle_port_service
    client = Client(port)
    try:
        client.call("is_dev")
        sock = client.conn.sock
        for i in range(20):
            assert client.call("seconds_to_label", sec=float(i)) == f"00:00:{i:02d}.000"
            assert client.get("/style.css").status == 200
            assert client.conn.sock is sock  # http.client reconnects on a closed socket
    finally:
        client.close()
    # HTTP/1.0 closes unless asked; Connection: close closes
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(b"POST /api/is_dev HTTP/1.0\r\nContent-Length: 2\r\n\r\n{}")
        data = _recv_all(s)
        assert data.startswith(b"HTTP/1.1 200") and data.endswith(b'{"result": false}')
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(b"GET /media HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert b"Connection: close" in _recv_all(s)


def _recv_all(s) -> bytes:
    chunks = []
    while chunk := s.recv(65536):
        chunks.append(chunk)
    return b"".join(chunks)


def _raw(port, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(request)
        return _recv_all(s)


def test_static_files_types_and_refusals(idle_port_service):
    _svc, port = idle_port_service
    client = Client(port)
    viewer = REPO / "thesia_tpu_torch" / "viewer"
    try:
        for path, ctype, file in (("/", "text/html", "index.html"), ("/index.html", "text/html", "index.html"),
                                  ("/js/app.js", "text/javascript", "js/app.js"),
                                  ("/js/api.js", "text/javascript", "js/api.js"),
                                  ("/style.css", "text/css", "style.css")):
            r = client.get(path)
            assert (r.status, r.content_type) == (200, ctype), path
            assert r.body == (viewer / file).read_bytes()
        r = client.request("HEAD", "/js/app.js")
        assert r.status == 200 and r.body == b""
        assert client.get("/js/").status == 200 and b"app.js" in client.get("/js/").body
        assert client.get("/nope.js").status == 404
    finally:
        client.close()
    for target in (b"/js/../../engine/service.py", b"/..%2f..%2fengine/service.py", b"/../README.md",
                   b"/%2e%2e/%2e%2e/README.md", b"/js/..%5c..%5cservice.py"):
        data = _raw(port, b"GET " + target + b" HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 404"), (target, data[:40])


def test_transport_limits_and_bad_requests(idle_port_service):
    _svc, port = idle_port_service
    big = 256 * 1024 * 1024 + 1
    data = _raw(port, f"POST /api/is_dev HTTP/1.1\r\nContent-Length: {big}\r\n\r\n{{}}".encode())
    assert data.startswith(b"HTTP/1.1 413") and b"Connection: close" in data
    data = _raw(port, b"POST /api/is_dev HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n2\r\n{}\r\n0\r\n\r\n")
    assert data.startswith(b"HTTP/1.1 411")
    for junk in (b"HELLO\r\n\r\n", b"GET / HTTP/2.0\r\n\r\n", b"GET / HTTP/1.1\r\nno colon\r\n\r\n",
                 b"POST /api/is_dev HTTP/1.1\r\nContent-Length: x\r\n\r\n"):
        assert _raw(port, junk).startswith(b"HTTP/1.1 400"), junk
    # the same connection keeps serving after an unread body of a 404
    client = Client(port)
    try:
        assert client.post("/no/such/route", {"x": 1}).status == 404
        assert client.call("is_dev") is False
    finally:
        client.close()


# -- (d) WebSocket -----------------------------------------------------------


def ws_connect(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /events HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rb")
    assert f.readline().startswith(b"HTTP/1.1 101")
    headers = {}
    while (line := f.readline()) != b"\r\n":
        name, _, value = line.decode().partition(":")
        headers[name.strip().lower()] = value.strip()
    want = base64.b64encode(hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
    assert headers["sec-websocket-accept"] == want.decode()
    return sock, f


def ws_send(sock, opcode, payload: bytes):
    mask = os.urandom(4)
    n = len(payload)
    head = bytes([0x80 | opcode]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack("!H", n))
    sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))


def ws_recv(f):
    """(opcode, payload) of one unmasked server frame."""
    b0, b1 = f.read(2)
    assert not b1 & 0x80, "server frames are unmasked"
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", f.read(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", f.read(8))
    return b0 & 0x0F, f.read(n)


def test_websocket_client_receives_player_state_changed(wavs, tmp_path):
    session = PortSession(device="cpu", settings_dir=tmp_path)
    with port_server(session) as (svc, port):
        sock, f = ws_connect(port)
        client = Client(port)
        try:
            ws_send(sock, 0x9, b"ping!")
            assert ws_recv(f) == (0xA, b"ping!")  # registered: the reader loop answers
            client.call("init", colormapRgba=CMAP)
            client.call("add_tracks", trackIds=[0], paths=wavs[:1])
            client.call("apply_track_list_changes")
            client.call("set_track_player", trackId=0, sec=0.0)
            client.call("resume_player")
            events = []
            while not any(e["event"] == "player-state-changed" and e["payload"]["isPlaying"] for e in events):
                op, payload = ws_recv(f)
                assert op == 0x1
                events.append(json.loads(payload))
            client.call("pause_player")
            ws_send(sock, 0x8, struct.pack("!H", 1000))
            while (frame := ws_recv(f))[0] != 0x8:
                pass
            assert frame == (0x8, struct.pack("!H", 1000))
            deadline = time.monotonic() + TIMEOUT
            while svc._ws_clients and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not svc._ws_clients
        finally:
            client.close()
            f.close()
            sock.close()
        # a plain GET of /events is no upgrade: 400
        data = _raw(port, b"GET /events HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 400")


class _Writer:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


@pytest.mark.parametrize("n", [0, 125, 126, 65535, 65536, 200_000])
def test_websocket_server_frame_lengths(n):
    """7-, 16- and 64-bit payload lengths, unmasked, FIN set."""
    w = _Writer()
    ws = port_http.WebSocket(None, w)
    text = "x" * n
    asyncio.run(ws.send_str(text))
    import io

    op, payload = ws_recv(io.BytesIO(bytes(w.data)))
    assert w.data[0] == 0x81 and op == 0x1 and payload == text.encode()
    assert len(w.data) == n + (2 if n < 126 else 4 if n < 65536 else 10)


# -- uploads ------------------------------------------------------------------


def _multipart(payload: bytes, filename="song.wav", name="file", boundary="----thesiaBoundary7MA4YWxk"):
    head = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; filename=\"{filename}\"\r\n"
            "Content-Type: application/octet-stream\r\n\r\n").encode()
    return head + payload + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def test_uploads_stream_to_disk_like_the_jax_service(tmp_path, monkeypatch):
    """Same-named uploads land on distinct paths; a 3 MB body holding
    boundary-like bytes arrives byte for byte; both services store the same
    files; a body without the file field or not multipart is a 400 (the JAX
    service: 400 and 500)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    rng = np.random.default_rng(7)
    big = bytearray(rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes())
    for at in range(1000, len(big) - 100, 65536 + 7):
        big[at : at + 8] = b"\r\n------"
    payloads = [b"first-bytes", b"second-bytes", bytes(big)]
    stored = {}
    for name, serve, session in (("jax", jax_server, JaxSession(settings_dir=tmp_path / "jax")),
                                 ("port", port_server, PortSession(device="cpu", settings_dir=tmp_path / "port"))):
        with serve(session) as (_svc, port):
            client = Client(port)
            try:
                paths = []
                for payload in payloads:
                    body, ctype = _multipart(payload)
                    r = client.request("POST", "/upload", body, {"Content-Type": ctype})
                    assert r.status == 200
                    paths.append(r.json()["result"])
                assert len(set(paths)) == 3 and all(Path(p).name == "song.wav" for p in paths)
                stored[name] = [Path(p).read_bytes() for p in paths]
                body, ctype = _multipart(b"x", name="other")
                assert client.request("POST", "/upload", body, {"Content-Type": ctype}).status == 400
                if name == "port":
                    r = client.request("POST", "/upload", b"{}", {"Content-Type": "application/json"})
                    assert r.status == 400
                    assert client.call("is_dev") is False  # the connection survives
            finally:
                client.close()
    assert stored["port"] == stored["jax"] == payloads


def test_prune_stale_uploads_spares_live_tracks(tmp_path, wavs):
    session = PortSession(device="cpu", settings_dir=tmp_path / "cfg")
    session.init(CMAP)
    svc = port_service.EngineService(session)
    updir = tmp_path / "uploads"
    updir.mkdir()
    old = time.time() - 2 * 24 * 3600
    stale = updir / "tmp_stale"
    stale.mkdir()
    (stale / "old.wav").write_bytes(b"x")
    os.utime(stale, (old, old))
    live = updir / "tmp_live"
    live.mkdir()
    shutil.copyfile(wavs[0], live / "song.wav")
    os.utime(live, (old, old))
    session.add_tracks([0], [str(live / "song.wav")])
    session.apply_track_list_changes()
    fresh = updir / "tmp_fresh"
    fresh.mkdir()
    svc._prune_stale_uploads(updir)
    assert not stale.exists() and (live / "song.wav").exists() and fresh.exists()
    assert 0 in session.tracklist.reload_tracks([0])[1]
    session.tm.images.shutdown()


# -- debug, player, settings ---------------------------------------------------


def test_debug_and_player_endpoints(idle_port_service, wavs):
    svc, port = idle_port_service
    client = Client(port)
    try:
        client.call("init", colormapRgba=CMAP)
        assert client.call("add_tracks", trackIds=[0], paths=wavs[:1]) == [0]
        client.call("apply_track_list_changes")
        m = client.get("/debug/metrics").json()["result"]
        assert m["spec.recompute"]["count"] >= 1
        assert {"count", "total_ms", "p50_ms", "p95_ms", "last_ms"} <= set(m["spec.recompute"])
        # the JAX service's shape_warmer keys, and the port's failed count
        assert m["shape_warmer"] == {"compiled": 0, "idle": True, "failed": 0}
        assert m["kernel_launches"] == {"spec_fft_mel": 0, "spec_fft_linear": 0,
                                        "deinterleave_flat": 0, "deinterleave_s24": 0,
                                        "lufs_stats": 0, "limiter_gain": 0, "guard_peak": 0,
                                        "guard_apply": 0, "quantize_mips": 0}
        assert m["warm_kernel_launches"] == m["kernel_launches"]
        # the lone track's K9 rows came from its device wav (the plain
        # version runs them here, so no launch counts above)
        rows_keys = {"device_wav", "upload", "scaled"}
        assert set(m["stats_rows"]) == set(m["warm_stats_rows"]) == rows_keys
        assert m["stats_rows"]["device_wav"] >= 1
        # ... as a K9 group of one: {tracks in a group: its launches}
        assert m["stats_group_tracks"].get("1", 0) >= 1
        assert isinstance(m["warm_stats_group_tracks"], dict)
        # tracks gained by K10 or by numpy's guard, since the process started
        assert set(m["guard_routes"]) == set(m["warm_guard_routes"]) == {"device", "host"}
        assert client.get("/pending_open_paths").json()["result"] == ["/a.wav", "/b.wav"]
        assert client.get("/pending_open_paths").json()["result"] == []
        assert client.call("set_track_player", trackId=0, sec=0.0) is None
        client.call("resume_player")
        time.sleep(0.15)
        st = client.get("/player/state").json()["result"]
        assert st["isPlaying"] and st["positionSec"] > 0.0
        client.call("seek_player", sec=1e9)
        assert client.get("/player/state").json()["result"]["positionSec"] <= 2.0
        client.call("pause_player")
        r = client.post("/debug/profile", {"durationMs": 10})
        assert r.status == 200
        trace = Path(r.json()["result"]) / "trace.json"
        assert "traceEvents" in json.loads(trace.read_text())
        shutil.rmtree(trace.parent)
        assert client.post("/debug/profile", [1]).status == 400
        assert client.post("/debug/profile", {"durationMs": "x"}).status == 400
        assert client.get("/media").json()["result"] == []
    finally:
        client.call("remove_tracks", trackIds=[0])
        client.call("apply_track_list_changes")
        client.close()


def test_profile_traces_in_one_second_keep_their_own_directories():
    """Two captures started within one second never share a directory, as
    jax.profiler writes each run into a directory of its own."""
    from thesia_tpu_torch import obs

    dirs = [Path(obs.profile_trace(1.0)) for _ in range(2)]
    try:
        assert dirs[0] != dirs[1]
        for d in dirs:
            assert "traceEvents" in json.loads((d / "trace.json").read_text())
    finally:
        for d in dirs:
            shutil.rmtree(d)


def test_service_pcm_endpoints(wavs, tmp_path):
    """tests/test_remote_audio.py:234 over the port's service."""
    session = PortSession(device="cpu", settings_dir=tmp_path)
    with port_server(session) as (_svc, port):
        client = Client(port)
        try:
            client.call("init", colormapRgba=CMAP)
            client.call("add_tracks", trackIds=[0], paths=wavs[2:3])
            client.call("apply_track_list_changes")
            assert client.post("/player/pcm", {"frames": 480}).status == 400
            r = client.post("/player/attach_pcm", {"sampleRate": 44100, "channels": 2})
            assert r.status == 200
            cfg = r.json()["result"]
            assert cfg["sampleRate"] == 44100 and cfg["channels"] == 2
            client.call("set_track_player", trackId=0, sec=0.0)
            client.call("resume_player")
            r = client.post("/player/pcm", {"frames": 480})
            assert r.status == 200 and r.content_type == "application/octet-stream"
            n, ch, _sr, flags = struct.unpack_from("<IIII", r.body)
            assert (n, ch, flags & 1) == (480, 2, 1)
            assert np.frombuffer(r.body, np.float32, offset=32).any()
            for bad in (0, -3, MAX_PULL_FRAMES + 1, "x"):
                assert client.post("/player/pcm", {"frames": bad}).status == 400, bad
            assert client.post("/player/attach_pcm", {"sampleRate": "x"}).status == 400
            assert client.post("/player/detach_pcm", {}).status == 200
            assert client.post("/player/pcm", {"frames": 480}).status == 400
        finally:
            client.close()


def test_poisoned_settings_store_degrades_to_defaults(tmp_path):
    (tmp_path / "settings.json").write_text(json.dumps(
        {"specSetting": 5, "dBRange": "junk", "blend": None,
         "commonGuardClipping": "NoSuchMode", "commonNormalize": [1]}))
    with port_server(PortSession(device="cpu", settings_dir=tmp_path)) as (_svc, port):
        client = Client(port)
        try:
            us = client.call("init", colormapRgba=CMAP)["userSettings"]
            assert us["specSetting"]["winMillisec"] == 40.0
            assert us["dBRange"] == 100.0 and us["blend"] == 0.5
            client.call("init", colormapRgba=CMAP)
        finally:
            client.close()


def test_reads_are_consistent_during_writes(wavs, tmp_path):
    session = PortSession(device="cpu", settings_dir=tmp_path)
    with port_server(session) as (_svc, port):
        setup = Client(port)
        setup.call("init", colormapRgba=CMAP)
        setup.call("add_tracks", trackIds=[0], paths=wavs[:1])
        setup.call("apply_track_list_changes")
        setup.close()
        errors = []

        def writer():
            c = Client(port)
            for win in (20, 40, 20):
                r = c.post("/api/set_spec_setting", {"specSetting": {
                    "winMillisec": win, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}})
                if r.status != 200:
                    errors.append(("write", r.status))
            c.close()

        def reader():
            c = Client(port)
            for _ in range(15):
                md = c.call("get_audio_render_metadata", idChStr="0_0")
                if not (md["spectrogramWidth"] > 0 and md["spectrogramHeight"] > 0):
                    errors.append(md)
                time.sleep(0.005)
            c.close()

        threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert not errors


def test_deferred_settings_switch_over_http(wavs, tmp_path, monkeypatch):
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")
    session = PortSession(device="cpu", settings_dir=tmp_path)
    with port_server(session) as (_svc, port):
        client = Client(port)
        try:
            client.call("init", colormapRgba=CMAP)
            client.call("add_tracks", trackIds=[0], paths=wavs[1:2])
            client.call("apply_track_list_changes")
            assert session.settings_settled(timeout=60) and session.tm.images.drain(timeout=60)
            before = client.call("get_audio_render_metadata", idChStr="0_0")
            client.call("set_spec_setting", specSetting={"winMillisec": 20, "tOverlap": 4,
                                                          "fOverlap": 1, "freqScale": "Mel"})
            assert client.call("get_spec_setting")["winMillisec"] == 20
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                md = client.call("get_audio_render_metadata", idChStr="0_0")
                if not md["isComputing"] and md["spectrogramRevision"] > before["spectrogramRevision"]:
                    break
                time.sleep(0.02)
            assert md["spectrogramRevision"] > before["spectrogramRevision"]
            assert md["spectrogramWidth"] != before["spectrogramWidth"]
            assert len(client.call("get_spectrogram_tile", idChStr="0_0", levelX=0, levelY=0,
                                   tileX=0, tileY=0)) > 40
        finally:
            client.close()
            session.tm.images.shutdown()


# -- (f) concurrent clients -----------------------------------------------------


def _fuzz_worker(port, seed, bad):
    rng = np.random.default_rng(seed)
    c = Client(port)
    try:
        for _ in range(25):
            op = int(rng.integers(0, 12))
            if op == 8:
                r = c.post("/player/attach_pcm", {"sampleRate": int(rng.choice([44100, 48000])), "channels": 2})
            elif op == 9:
                r = c.post("/player/pcm", {"frames": int(rng.choice([512, 4096]))})
            elif op == 10:
                r = c.post("/player/detach_pcm", {})
            else:
                if op == 11:
                    name, body = (("resume_player", {}) if rng.random() < 0.4 else ("pause_player", {})
                                  if rng.random() < 0.5 else ("seek_player", {"sec": float(rng.uniform(0, 2))}))
                elif op == 0:
                    name, body = "set_spec_setting", {"specSetting": {
                        "winMillisec": float(rng.choice([20.0, 40.0])), "tOverlap": int(rng.choice([2, 4])),
                        "fOverlap": 1, "freqScale": str(rng.choice(["Mel", "Linear"]))}}
                elif op == 1:
                    name, body = "set_dB_range", {"dBRange": float(rng.choice([80.0, 100.0]))}
                elif op == 2:
                    name, body = "get_spectrogram_tile", {
                        "idChStr": f"{int(rng.integers(0, 4))}_{int(rng.integers(0, 2))}",
                        "levelX": int(rng.integers(0, 4)), "levelY": 0, "tileX": int(rng.integers(0, 4)), "tileY": 0}
                elif op == 3:
                    name, body = "get_waveform_tile", {"idChStr": f"{int(rng.integers(0, 3))}_0",
                                                       "level": int(rng.integers(0, 10)),
                                                       "tileIndex": int(rng.integers(0, 4))}
                elif op == 4:
                    name, body = "get_audio_render_metadata", {"idChStr": f"{int(rng.integers(0, 4))}_0"}
                elif op == 5:
                    name, body = "set_common_normalize", {"target": {"type": "LUFS", "target": -20.0}
                                                          if rng.random() < 0.5 else {"type": "Off"}}
                elif op == 6:
                    name, body = "set_track_player", {"trackId": int(rng.integers(0, 3)),
                                                      "sec": float(rng.uniform(0, 2))}
                else:
                    name, body = "calc_dB_axis_markers", {"maxNumTicks": 5, "maxNumLabels": 3,
                                                          "dBRangeMin": -100.0, "dBRangeMax": 0.0}
                r = c.post(f"/api/{name}", body)
                op = (name, body)
            if r.status >= 500:
                bad.append((op, r.status, r.body[:200]))
    finally:
        c.close()


@pytest.mark.parametrize("deferred", [False, True], ids=["sync", "deferred"])
def test_concurrent_clients_never_500(wavs, tmp_path, monkeypatch, deferred):
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1" if deferred else "0")
    session = PortSession(device="cpu", settings_dir=tmp_path)
    with port_server(session) as (_svc, port):
        setup = Client(port)
        setup.call("init", colormapRgba=CMAP)
        setup.call("add_tracks", trackIds=[0, 1, 2], paths=wavs)
        setup.call("apply_track_list_changes")
        bad = []
        threads = [threading.Thread(target=_fuzz_worker, args=(port, 1000 + i, bad)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert not bad, bad[:3]
        if deferred:
            assert session.settings_settled(timeout=60)
            assert session.tm.setting.to_json() == session.get_spec_setting()
        assert session.tm.images.drain(timeout=60)
        for tid in (0, 1, 2):
            md = setup.call("get_audio_render_metadata", idChStr=f"{tid}_0")
            assert md["spectrogramWidth"] > 0 and md["isComputing"] is False
            assert len(setup.call("get_spectrogram_tile", idChStr=f"{tid}_0", levelX=0, levelY=0,
                                  tileX=0, tileY=0)) >= 40
        setup.close()


# -- (g) the entry point as a process ----------------------------------------------


def _start(args, env):
    return subprocess.Popen([sys.executable, "-m", "thesia_tpu_torch", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_python_m_serves_on_the_cpu_and_stops(tmp_path):
    env = dict(os.environ, THESIA_TPU_CONFIG=str(tmp_path / "cfg"), THESIA_LOG_LEVEL="WARNING")
    proc = _start(["--device", "cpu", "--port", "0"], env)
    try:
        lines = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if "listening on" in line or not line:
                break
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", lines[-1])
        assert m, "".join(lines)
        client = Client(int(m.group(1)))
        assert client.call("is_dev") is False
        assert client.get("/js/app.js").content_type == "text/javascript"
        client.close()
        proc.terminate()
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        proc.stdout.close()


def test_python_m_without_a_card_raises(tmp_path):
    env = dict(os.environ, THESIA_TPU_CONFIG=str(tmp_path / "cfg"), CUDA_VISIBLE_DEVICES="")
    proc = _start(["--port", "0"], env)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "CUDA is not available" in out and "listening" not in out
