"""The port's service held to the committed goldens of the synth48k track
(tests/goldens/goldens.json, tests/synth.py), the anchors that need no
reference file.  The port's EngineService serves a session with the synth
track alone, whose dB range is the goldens' (synth48k's max sets it alone),
and every anchor is read over HTTP or from that session:

- the waveform tiles synth48k_wave_t0.bin and t1.bin, bit-exact;
- spec shape [4404, 347], min and max dB and the db crop, within
  tests/torch_parity.py;
- the u16 image within the contract's u16 steps of the JAX image, whose
  sha256 is the golden one (a test of its own: on another machine's jax
  build the JAX image differs);
- the spectrogram tiles (t0, t1, and the 20 ms Linear tile) with equal
  headers but for the revision and every pixel's colormap entry at most one
  apart;
- the metadata, and after the 20 ms Linear switch, apart from the revisions.

The ``gpu`` case runs the same checks with the session on the card."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from synth import SYNTH48K_SR, synth48k_wavs
from torch_http import Client, port_server
from torch_parity import DB_DEPTH, db_limit, u16_limit
from thesia_tpu.engine.session import EngineSession as JaxSession
from thesia_tpu_torch.engine.session import EngineSession as PortSession
from thesia_tpu_torch.io.wav import encode_wav_s16
from thesia_tpu_torch.render.colormap import default_colormap_rgba8, quantize_min_value
from thesia_tpu_torch.render.tiles import decode_spectrogram_tile

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
G = json.loads((GOLDENS / "goldens.json").read_text())
CMAP = default_colormap_rgba8().reshape(-1).tolist()
LINEAR_20MS = {"winMillisec": 20, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}
SPEC_TILES = {"synth48k_spec_t0.bin": ("0_0", 0, 0, 1, 0), "synth48k_spec_t1.bin": ("0_0", 2, 1, 0, 0)}
WAVE_TILES = {"synth48k_wave_t0.bin": ("0_0", 0, 3), "synth48k_wave_t1.bin": ("0_0", 11, 0)}
REVISIONS = ("waveformRevision", "spectrogramRevision")


def _tile(client, args):
    return client.call("get_spectrogram_tile", **dict(zip(
        ("idChStr", "levelX", "levelY", "tileX", "tileY"), args)))


@pytest.fixture(scope="module")
def synth_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("synth48k") / "synth48k.wav"
    path.write_bytes(encode_wav_s16(synth48k_wavs(), SYNTH48K_SR))
    assert hashlib.sha256(path.read_bytes()).hexdigest() == G["synth48k"]["sha_file"]
    return str(path)


@pytest.fixture(scope="module")
def jax_image(synth_wav, tmp_path_factory):
    """The JAX session's u16 image of the synth track alone and its range."""
    s = JaxSession(settings_dir=tmp_path_factory.mktemp("jax_synth"))
    s.init(default_colormap_rgba8())
    s.add_tracks([0], [synth_wav])
    s.apply_track_list_changes(defer=False)
    img = np.array(s.tm.spec_imgs[(0, 0)])
    rng = [s.tm.min_db, s.tm.max_db]
    s.tm.images.shutdown()
    return img, rng


def test_the_jax_image_of_the_synth_track_alone_is_the_golden(jax_image):
    """So the u16 check below holds the port to the golden image (here; a
    machine with another jax build computes another JAX image)."""
    img, rng = jax_image
    assert hashlib.sha256(img.tobytes()).hexdigest() == G["synth48k"]["img"]["sha"]
    assert rng == G["db_range"]


def _serve_synth(device, synth_wav, settings_dir) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    session = PortSession(device=device, settings_dir=settings_dir)
    out = {}
    with port_server(session) as (_svc, port):
        client = Client(port)
        try:
            client.call("init", colormapRgba=CMAP)
            assert client.call("add_tracks", trackIds=[0], paths=[synth_wav]) == [0]
            assert client.call("apply_track_list_changes") == ["0_0"]
            assert session.settings_settled(timeout=120) and session.tm.images.drain(timeout=120)
            res = session.tm.specs[0]
            out["db"] = res.db[0, : res.n_frames].cpu().numpy()
            out["image"] = np.array(session.tm.spec_imgs[(0, 0)])
            out["range"] = [session.tm.min_db, session.tm.max_db]
            out["metadata"] = client.call("get_audio_render_metadata", idChStr="0_0")
            out["wave"] = {f: client.call("get_waveform_tile", idChStr=a[0], level=a[1], tileIndex=a[2])
                           for f, a in WAVE_TILES.items()}
            out["spec"] = {f: _tile(client, a) for f, a in SPEC_TILES.items()}
            client.call("set_spec_setting", specSetting=LINEAR_20MS)
            assert session.settings_settled(timeout=120) and session.tm.images.drain(timeout=120)
            out["metadata_linear"] = client.call("get_audio_render_metadata", idChStr="0_0")
            out["spec"]["synth48k_spec_20ms_linear.bin"] = _tile(client, ("0_0", 1, 1, 1, 0))
        finally:
            client.close()
            session.tm.images.shutdown()
    return out


@pytest.fixture(scope="module", params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def served(request, synth_wav, tmp_path_factory):
    return _serve_synth(request.param, synth_wav, tmp_path_factory.mktemp(f"port_{request.param}"))


def test_waveform_tiles_are_the_goldens(served):
    for fname, data in served["wave"].items():
        assert len(data) == G["tiles"][fname]["len"]
        assert data == (GOLDENS / fname).read_bytes(), fname


def test_spec_db_anchors_within_the_contract(served):
    g = G["synth48k"]["spec"]
    db = served["db"]
    assert list(db.shape) == g["shape"]
    gmax = g["max_db"]
    assert abs(float(db.max()) - gmax) <= db_limit(gmax, gmax)
    assert abs(float(db.min()) - g["min_db"]) <= db_limit(g["min_db"], gmax)
    crop = np.load(GOLDENS / "synth48k_db_crop.npy").astype(np.float64)
    got = db[1000:1032].astype(np.float64)
    assert (np.isneginf(crop) == np.isneginf(got)).all()
    mask = np.isfinite(crop) & (crop >= gmax - DB_DEPTH)
    assert mask.sum() > 2000
    assert (np.abs(got - crop)[mask] <= db_limit(crop, gmax)[mask]).all()
    assert served["range"] == pytest.approx(G["db_range"], abs=db_limit(gmax, gmax))


def test_u16_image_within_the_contract(served, jax_image):
    """Every pixel within u16_limit of the JAX image (one rounding step
    plus the dB contract in u16 steps), and within one u16 step wherever its
    dB lies within 60 dB of the max (where the contract's dB limit is under
    5e-3 dB).  Deeper pixels differ by up to 24 steps (0.04 dB)."""
    img = served["image"]
    assert list(img.shape) == G["synth48k"]["img"]["shape"] and img.dtype == np.uint16
    gmin, gmax = G["db_range"]
    ref_rows = served["db"].T.astype(np.float64)  # (F, T), the image's rows bottom-up
    limit = u16_limit(ref_rows, gmax, gmax - gmin, quantize_min_value(258))
    step = np.abs(img.astype(np.int64) - jax_image[0])
    assert (step <= limit).all()
    loud = ref_rows >= gmax - 60.0
    assert loud.sum() > 50_000 and step[loud].max() <= 1


def _color_index(rgba):
    table = default_colormap_rgba8().reshape(-1, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    pix = rgba.reshape(-1, 4).astype(np.uint32) @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    order = np.argsort(table)
    idx = np.searchsorted(table[order], pix)
    assert (table[order][idx] == pix).all()
    return order[idx].astype(np.int64)


@pytest.mark.parametrize("fname", [*SPEC_TILES, "synth48k_spec_20ms_linear.bin"])
def test_spectrogram_tiles_within_one_colormap_entry(served, fname):
    got, want = served["spec"][fname], (GOLDENS / fname).read_bytes()
    assert len(got) == len(want) == G["tiles"][fname]["len"]
    assert got[8:40] == want[8:40]
    step = np.abs(_color_index(decode_spectrogram_tile(got)["rgba"])
                  - _color_index(decode_spectrogram_tile(want)["rgba"]))
    assert step.max() <= 1


@pytest.mark.parametrize("key,golden", [("metadata", "synth48k"), ("metadata_linear", "synth48k_metadata_20ms_linear")])
def test_metadata_anchors(served, key, golden):
    want = G[golden]["metadata"] if golden == "synth48k" else G[golden]
    got = served[key]
    assert {k: v for k, v in got.items() if k not in REVISIONS} == \
        {k: v for k, v in want.items() if k not in REVISIONS}
