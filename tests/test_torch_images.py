"""The port's image and render modules against the JAX package's, bit for
bit: u16 quantization and the device mip chain (kernels/images.py on the
CPU, its plain version), the transfer, the store's landed mip chain and tiles, and the host render copies (colormap, Lanczos3 resize, mip
chains, tile encoders, tile cache metadata)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import thesia_tpu.native
from thesia_tpu.dsp.spectrogram import frame_cap
from thesia_tpu.engine import images as jax_images
from thesia_tpu.render import colormap as jax_colormap
from thesia_tpu.render import mips as jax_mips
from thesia_tpu.render import resize as jax_resize
from thesia_tpu.render import tiles as jax_tiles
from thesia_tpu.render.visualize import quantize_min_value as jax_min_value
from thesia_tpu_torch.engine import images as port_images
from thesia_tpu_torch.kernels import images as kimages
from thesia_tpu_torch.render import colormap as port_colormap
from thesia_tpu_torch.render import mips as port_mips
from thesia_tpu_torch.render import resize as port_resize
from thesia_tpu_torch.render import tiles as port_tiles

C, F, N_FRAMES = 2, 40, 9001  # 9001 frames -> device mip levels 3 and 4


def _db(seed: int, t: int) -> np.ndarray:
    """(C, t, F) dB in [-130, 0] with -inf and NaN entries."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-130.0, 0.0, (C, t, F)).astype(np.float32)
    db[rng.random(db.shape) < 0.01] = -np.inf
    db[rng.random(db.shape) < 0.001] = np.nan
    return db


def _range(kind: str):
    """(lo, span) as the JAX manager forms them: on the device (f32
    subtraction) or on the host (f64 difference cast to f32)."""
    gmax, gmin = np.float32(-3.25), np.float32(-103.25)
    if kind == "device":
        return gmin, np.float32(gmax - gmin)
    return np.float32(float(gmin)), np.float32(float(gmax) - float(gmin))


def _jax_quantize(db, lo, span, n_frames, **kw):
    outs = jax_images._quantize_and_mips(
        jnp.asarray(db), jnp.float32(lo), jnp.float32(span), jnp.int32(n_frames),
        t_valid_static=frame_cap(n_frames), **kw,
    )
    return [np.asarray(o) for o in outs]


def _port_quantize(db, lo, span, n_frames, **kw):
    img, mips = kimages.quantize_mips(
        torch.from_numpy(db), torch.tensor(lo), torch.tensor(span), n_frames, **kw
    )
    return port_images.land_u16([img, *mips])


@pytest.mark.parametrize("range_kind", ["device", "host"])
@pytest.mark.parametrize(
    "i_start,n_rows,height", [(0, F, F), (0, F, F + 12), (3, F - 3, F - 3), (0, 0, 7)],
    ids=["full", "taller-than-spec", "offset", "no-rows"],
)
def test_quantize_and_mips_bit_exact(range_kind, i_start, n_rows, height):
    db = _db(1, N_FRAMES)
    lo, span = _range(range_kind)
    kw = dict(i_start=i_start, n_rows=n_rows, height=height, min_value=254,
              mip_levels=tuple(port_images.mip_plan(N_FRAMES)))
    assert kw["mip_levels"] == tuple(jax_images.mip_plan(N_FRAMES)) == (3, 4)
    want = _jax_quantize(db, lo, span, N_FRAMES, **kw)
    got = _port_quantize(db, lo, span, N_FRAMES, **kw)
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        assert w.dtype == g.dtype == np.uint16
        np.testing.assert_array_equal(g, w)


def test_exact_width_needs_no_tail_clamp():
    """The JAX program sees frame-cap padded dB (garbage columns past
    n_frames) and clamps the tail before each halving; the port quantizes
    exactly n_frames columns.  Valid columns of every level agree."""
    padded = _db(2, frame_cap(N_FRAMES))
    lo, span = _range("device")
    kw = dict(i_start=0, n_rows=F, height=F, min_value=254, mip_levels=(3, 4))
    want = _jax_quantize(padded, lo, span, N_FRAMES, **kw)
    got = _port_quantize(np.ascontiguousarray(padded[:, :N_FRAMES]), lo, span, N_FRAMES, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w[..., : g.shape[-1]])


@pytest.mark.parametrize("width", [1, 2, 7, 8, 1025])
def test_halve_t_matches(width):
    x = np.random.default_rng(width).integers(0, 65536, (3, 5, width)).astype(np.uint16)
    want = np.asarray(jax_images._halve_t(jnp.asarray(x)))
    got = kimages._halve_t(torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(port_images.land_u16([got.to(kimages.IMAGE_DTYPE)])[0], want)


def test_land_u16_is_one_exact_transfer():
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 65536, s).astype(np.uint16) for s in ((2, 3, 5), (2, 3, 3), (7,))]
    arrays[0].flat[:4] = [0, 32767, 32768, 65535]
    out = port_images.land_u16([torch.from_numpy(a) for a in arrays])
    for a, o in zip(arrays, out):
        assert o.dtype == np.uint16
        np.testing.assert_array_equal(o, a)


def test_device_mips_equal_the_host_chain():
    db = _db(4, N_FRAMES)
    lo, span = _range("device")
    levels = tuple(port_images.mip_plan(N_FRAMES))
    img, mips = kimages.quantize_mips(
        torch.from_numpy(db), torch.tensor(lo), torch.tensor(span), N_FRAMES,
        i_start=0, n_rows=F, height=F, min_value=254, mip_levels=levels)
    device_mips = dict(zip(levels, port_images.land_u16(mips)))
    store = port_images.SpecImageStore()
    store.set_images(0, port_images.TrackImages(0, C, N_FRAMES, F, img, dict(zip(levels, mips))))
    assert store.drain(timeout=30)
    for ch in range(C):
        chain = store.host_image(0, ch).mips()
        jchain = jax_mips.build_mip_chain(port_images.land_u16([img])[0][ch])
        assert len(chain) == len(jchain) == 4
        for level in levels:
            np.testing.assert_array_equal(device_mips[level][ch], chain[level - 1])
        for a, b in zip(chain, jchain):
            np.testing.assert_array_equal(a, b)
    store.shutdown()


def test_colormap_and_min_value_are_the_same():
    np.testing.assert_array_equal(port_colormap.default_colormap_rgba8(), jax_colormap.default_colormap_rgba8())
    for n in (None, 1, 2, 6, 255, 258, 1000, 70000):
        assert port_colormap.quantize_min_value(n) == jax_min_value(n)


def _image(seed=5, h=300, w=3000):
    return np.random.default_rng(seed).integers(0, 65536, (h, w)).astype(np.uint16)


def test_resize_and_halving_are_the_same():
    img = _image()
    for crop, dw, dh in (((0.0, 0.0, 3000.0, 300.0), 512, 300), ((10.5, 3.25, 600.75, 250.5), 300, 128),
                         ((100.0, 0.0, 140.0, 300.0), 512, 516)):
        np.testing.assert_array_equal(
            port_resize.lanczos3_crop_resize_u16(img, crop, dw, dh),
            jax_resize.lanczos3_crop_resize_u16(img, crop, dw, dh),
        )
    np.testing.assert_array_equal(port_mips.halve_x_u16(img), jax_mips.halve_x_u16(img))
    assert port_mips.chain_len(3000) == jax_mips.chain_len(3000)


TILES = [(0, 0, 0, 0), (0, 0, 5, 0), (1, 0, 1, 0), (2, 1, 0, 0), (3, 0, 0, 0), (6, 2, 0, 0), (0, 0, 99, 0)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tile_bytes_from_the_same_image_are_the_same(native, monkeypatch):
    if not native:
        monkeypatch.setattr(thesia_tpu.native, "available", lambda: False)
    img = _image()
    cmap = port_colormap.default_colormap_rgba8()
    for args in TILES:
        want = jax_tiles.encode_spectrogram_tile(jax_mips.SpecImage(img), cmap, 7, *args)
        got = port_tiles.encode_spectrogram_tile(port_mips.SpecImage(img), cmap, 7, *args)
        assert got == want, args
    wav = np.random.default_rng(6).standard_normal(50_000).astype(np.float32)
    wav[100:110] = np.nan
    for level, index in ((0, 0), (0, 48), (3, 1), (10, 0), (4, 9)):
        assert port_tiles.encode_waveform_tile(wav, 3, level, index) == \
            jax_tiles.encode_waveform_tile(wav, 3, level, index)


def test_store_tile_body_is_the_encoded_tile_body():
    img = _image(7, 120, 2600)
    cmap = port_colormap.default_colormap_rgba8()
    dev = torch.from_numpy(img)[None]
    store = port_images.SpecImageStore()
    store.set_images(4, port_images.TrackImages(4, 1, 2600, 120, dev, {}))
    assert store.geometry(4) == (120, 2600)
    for settled in (False, True):  # while streaming, then from the landed image
        if settled:
            assert store.drain(timeout=30)
        for args in TILES:
            body = store.tile_body(4, 0, cmap, *args)
            want = jax_tiles.encode_spectrogram_tile(jax_mips.SpecImage(img), cmap, 1, *args)
            assert port_tiles.spectrogram_tile_header(1, 120, 2600, *args) + body == want, args
    assert store.tile_body(4, 1, cmap, 0, 0, 0, 0) is None
    assert store.tile_body(5, 0, cmap, 0, 0, 0, 0) is None
    store.shutdown()


def test_tile_geometry_header_and_metadata_are_the_same():
    for h, w in ((347, 30001), (1, 1), (516, 512), (1025, 6001)):
        for lx in (0, 1, 4, 9):
            for ly in (0, 1, 3):
                for tx, ty in ((0, 0), (1, 0), (3, 2)):
                    a = (h, w, lx, ly, tx, ty)
                    assert port_tiles.spectrogram_tile_geometry(*a) == jax_tiles.spectrogram_tile_geometry(*a)
                    assert port_tiles.spectrogram_tile_header(9, *a) == jax_tiles.spectrogram_tile_header(9, *a)
                    for m in (0, 1, 3):
                        assert port_tiles.spectrogram_tile_source_cols(w, lx, tx, m, h, ly, ty) == \
                            jax_tiles.spectrogram_tile_source_cols(w, lx, tx, m, h, ly, ty)
    pc, jc = port_tiles.RenderTileCache(), jax_tiles.RenderTileCache()
    for c in (pc, jc):
        c.invalidate_all()
        c.set_colormap(port_colormap.default_colormap_rgba8().reshape(-1))
        c.invalidate_spectrogram()
    for shape in (None, (347, 30001)):
        assert pc.metadata(14_400_000, 48000, 300.0, False, shape) == \
            jc.metadata(14_400_000, 48000, 300.0, False, shape)
    tile = port_tiles.encode_spectrogram_tile(_image(8, 40, 600), pc.colormap_rgba, 2, 0, 0, 0, 0)
    a, b = port_tiles.decode_spectrogram_tile(tile), jax_tiles.decode_spectrogram_tile(tile)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
