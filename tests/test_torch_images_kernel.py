"""K6, the quantize + mips kernel (thesia_tpu_torch/kernels/images.py and
csrc/images.cu), against the JAX package's ``_quantize_and_mips``.

On the CPU: the plain version ``quantize_mips_reference`` bit for bit equal
to the JAX program (run on the CPU as the JAX package's tests run it) over a
grid of row offsets, images taller than the spectrogram, min_value 0, 1 and
254, widths odd at every level, width 1, NaN, +-inf, values on x.5 ties and
values outside the range; a numpy model of the kernel's tiled schedule
(aligned tiles of 2^TILE_LEVELS columns halved locally with the image's
widths, then launches from every TILE_LEVELS-th level) against the JAX chain
at the lecture's nine levels; the 2-byte storage (dtype, and the host bytes
through ``land_u16``, the store's region copies and the streamer equal to
the int32 images' narrowed bits of the parent design); the wrapper's routing
and its errors, which propagate through the manager.  Cases marked gpu launch
the kernel on the card against its plain version on the same grid and at the
main path's four images, and skip without a card."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from thesia_tpu.engine import images as jax_images
from thesia_tpu_torch.engine import images as port_images
from thesia_tpu_torch.kernels import build
from thesia_tpu_torch.kernels import images as kimages
from thesia_tpu_torch.render.mips import chain_len


def _db(kind: str, seed: int, c: int, t: int, f: int, min_value: int):
    """(db (c, t, f) f32, lo, span).  "random": dB in [-140, 10] (outside the
    range on both sides) with NaN and +-inf; "ties": lo 0 and a span of
    65535 - min_value, values k + 0.5 that quantize onto exact x.5 ties."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        k = rng.integers(-70000, 70000, (c, t, f)).astype(np.float64)
        return (k + 0.5).astype(np.float32), np.float32(0.0), np.float32(65535 - min_value)
    db = rng.uniform(-140.0, 10.0, (c, t, f)).astype(np.float32)
    u = rng.random(db.shape)
    db[u < 0.01] = -np.inf
    db[(u >= 0.01) & (u < 0.015)] = np.inf
    db[u > 0.995] = np.nan
    return db, np.float32(-103.25), np.float32(100.0)


def _jax(db, lo, span, n, **kw):
    outs = jax_images._quantize_and_mips(
        jnp.asarray(db), jnp.float32(lo), jnp.float32(span), jnp.int32(n),
        t_valid_static=n, **kw)
    return [np.asarray(o) for o in outs]


def _levels(n: int, deepest: int = 10) -> tuple[int, ...]:
    return tuple(range(1, min(deepest, max(chain_len(n, 1), 1)) + 1))


# (channels, frames, dB columns, i_start, rows, height, min_value, data)
GRID = [
    (1, 1, 3, 0, 3, 3, 254, "random"),
    (2, 1, 5, 1, 3, 6, 0, "random"),
    (1, 2, 4, 0, 4, 4, 1, "ties"),
    (1, 255, 9, 2, 7, 12, 254, "random"),
    (2, 256, 33, 0, 33, 33, 0, "ties"),
    (1, 257, 40, 3, 33, 40, 1, "random"),
    (3, 1023, 17, 0, 17, 40, 254, "random"),
    (1, 1025, 35, 5, 30, 30, 0, "random"),
    (2, 4097, 12, 0, 12, 12, 1, "ties"),
    (1, 6001, 11, 0, 11, 16, 254, "random"),
    (1, 700, 8, 2, 0, 5, 254, "random"),
]
IDS = [f"C{c}-n{n}-F{f}-i{i}-r{r}-h{h}-m{m}-{k}" for c, n, f, i, r, h, m, k in GRID]


@pytest.mark.parametrize("case", GRID, ids=IDS)
def test_reference_equals_the_jax_program(case):
    c, n, f, i_start, rows, height, min_value, kind = case
    db, lo, span = _db(kind, n + f, c, n, f, min_value)
    kw = dict(i_start=i_start, n_rows=rows, height=height, min_value=min_value,
              mip_levels=_levels(n))
    want = _jax(db, lo, span, n, **kw)
    img, mips = kimages.quantize_mips_reference(
        torch.from_numpy(db), torch.tensor(lo), torch.tensor(span), n, **kw)
    got = [img, *mips]
    assert len(got) == len(want) == 1 + len(kw["mip_levels"])
    for w, g in zip(want, got):
        assert g.dtype == kimages.IMAGE_DTYPE and w.dtype == np.uint16
        np.testing.assert_array_equal(g.numpy(), w)


def test_the_ties_grid_lands_on_ties():
    """The "ties" data quantize onto v = k + 0.5 exactly for most values (so
    the grid tests half away from zero, not torch.round's half to even)."""
    for min_value in (0, 1):
        db, lo, span = _db("ties", 5, 1, 2000, 4, min_value)
        q = ((db - lo) / span).astype(np.float32)
        v = (q.astype(np.float64) * (65535 - min_value) + min_value).astype(np.float32)
        assert np.mean(v == np.floor(v) + 0.5) > 0.9


def _halve_tile(prev: np.ndarray, j0: int, w_prev: int, w: int, lw: int) -> np.ndarray:
    """One level of a tile: prev's local columns start at 2 j0 of a level
    w_prev wide; local columns j0 .. of the next level, w wide, at most lw."""
    nloc = min(lw, w - j0)
    out = np.empty(prev.shape[:-1] + (nloc,), np.uint32)
    for j in range(nloc):
        a = prev[..., 2 * j].astype(np.uint32)
        out[..., j] = (a + prev[..., 2 * j + 1] + 1) >> 1 if 2 * (j0 + j) + 1 < w_prev else a
    return out


def tiled_schedule(img: np.ndarray, mip_levels: tuple[int, ...]) -> dict[int, np.ndarray]:
    """The kernel's schedule in numpy: k6_quantize's tiles of 2^D columns of
    level 0 halve levels 1..D in their own buffer; then k6_halve from every
    D-th level written (``launch_levels``) in tiles of 2^D of its columns.
    Returns every level it writes."""
    d = kimages.TILE_LEVELS
    tt = 1 << d
    deepest = max(mip_levels, default=0)
    written = set(kimages.launch_levels(mip_levels))
    out = {}
    base, src = 0, img
    while base < deepest:
        nlev = min(d, deepest - base)
        w0 = src.shape[-1]
        widths = [w0]
        for _ in range(nlev):
            widths.append((widths[-1] + 1) >> 1)
        levels = {k: np.zeros(src.shape[:-1] + (widths[k],), np.uint16)
                  for k in range(1, nlev + 1)}
        for c0 in range(0, w0, tt):
            cur = src[..., c0 : c0 + tt]
            for k in range(1, nlev + 1):
                j0 = c0 >> k
                cur = _halve_tile(cur, j0, widths[k - 1], widths[k], tt >> k)
                levels[k][..., j0 : j0 + cur.shape[-1]] = cur
        for k, a in levels.items():
            if base + k in written:
                out[base + k] = a
        base += nlev
        src = out[base]
    return out


@pytest.mark.parametrize("n,deepest", [(360001, 9), (5000, 12), (200, 3), (1, 2)],
                         ids=["lecture", "two-halve-launches", "under-one-tile", "width-1"])
def test_tiled_schedule_equals_the_jax_chain(n, deepest):
    db, lo, span = _db("random", n, 1, n, 3, 254)
    levels = tuple(range(3 if deepest >= 3 else 1, deepest + 1))
    if n == 360001:
        assert levels == tuple(port_images.mip_plan(n))
    want = _jax(db, lo, span, n, i_start=0, n_rows=3, height=3, min_value=254, mip_levels=levels)
    got = tiled_schedule(want[0], levels)
    assert set(kimages.launch_levels(levels)) == set(got)
    for level, w in zip(levels, want[1:]):
        np.testing.assert_array_equal(got[level], w)


def test_launch_levels_and_work():
    assert kimages.launch_levels(()) == []
    assert kimages.launch_levels((3, 4, 5)) == [3, 4, 5]
    assert kimages.launch_levels((3, 4, 5, 6, 7, 8, 9)) == [3, 4, 5, 6, 7, 8, 9]
    assert kimages.launch_levels((10, 11)) == [8, 10, 11]
    assert kimages.launch_levels(tuple(range(3, 18))) == list(range(3, 18))
    assert kimages.launch_levels((20,)) == [8, 16, 20]
    assert [kimages.level_width(30001, l) for l in (0, 1, 5)] == [30001, 15001, 938]
    w = kimages.images_work(2, 347, 347, 30001, (3, 4, 5))
    mip_px = 2 * 347 * (3751 + 1876 + 938)
    assert w["bytes"] == 4 * 2 * 347 * 30001 + 8 + 2 * 2 * 347 * 30001 + 2 * mip_px
    assert w["flop"] == kimages.FLOP_PER_PIXEL * 2 * 347 * 30001 + kimages.OPS_PER_MIP_PIXEL * mip_px
    # rows above the spectrogram are written, not read
    tall = kimages.images_work(1, 385, 521, 6001, (3,))
    assert tall["bytes"] == 4 * 385 * 6001 + 8 + 2 * 521 * 6001 + 2 * 521 * 751


def _narrowed_bits(values: np.ndarray) -> np.ndarray:
    """The parent design's landing: int32 images narrowed to int16 on the
    device (``torch.where(x > 32767, x - 65536, x)``), read as u16."""
    x = torch.from_numpy(values.astype(np.int32))
    return torch.where(x > 32767, x - 65536, x).to(torch.int16).numpy().view(np.uint16)


def test_images_are_two_bytes_a_pixel_with_the_same_host_bytes():
    assert kimages.IMAGE_DTYPE == torch.uint16
    rng = np.random.default_rng(9)
    values = rng.integers(0, 65536, (2, 6, 3001)).astype(np.uint16)
    values[0, 0, :4] = [0, 32767, 32768, 65535]
    want = _narrowed_bits(values)
    dev = torch.from_numpy(values)
    assert dev.element_size() == 2
    np.testing.assert_array_equal(port_images.land_u16([dev])[0], want)
    store = port_images.SpecImageStore()
    t = port_images.TrackImages(0, 2, 3001, 6, dev, {3: dev[..., ::8].contiguous()})
    region = store._to_host(t, dev[1, :, 100:900])
    assert region.dtype == np.uint16
    np.testing.assert_array_equal(region, want[1, :, 100:900])
    store.set_images(0, t)
    assert store.drain(timeout=30)
    for ch in range(2):
        np.testing.assert_array_equal(np.asarray(store.host_image(0, ch)), want[ch])
    store.shutdown()


def test_the_manager_quantizes_into_two_byte_images(tmp_path):
    from thesia_tpu_torch.engine.manager import TrackManager
    from thesia_tpu_torch.engine.track import TrackList
    from thesia_tpu_torch.io.wav import encode_wav_f32

    rng = np.random.default_rng(4)
    paths = []
    for i, (sr, c, sec) in enumerate([(8000, 2, 3.0), (16000, 1, 2.0)]):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.8, 0.8, (c, int(sr * sec))).astype(np.float32), sr))
        paths.append(str(p))
    tl, tm = TrackList("cpu"), TrackManager("cpu")
    tm.add_tracks(tl, tl.add_tracks([0, 1], paths))
    seen = []
    orig = tm.images.set_images
    tm.images.set_images = lambda tid, t: (seen.append((t.dev_img, dict(t.dev_mips))),
                                           orig(tid, t))
    tm.apply_track_list_changes(tl)
    assert tm.images.drain(timeout=30) and len(seen) == 2
    for img, mips in seen:
        assert img.dtype == kimages.IMAGE_DTYPE and img.element_size() == 2
        assert all(m.dtype == kimages.IMAGE_DTYPE for m in mips.values())
    tm.images.shutdown()


def test_the_wrapper_routes_by_device_and_checks_its_arguments():
    db, lo, span = _db("random", 3, 1, 50, 8, 254)
    args = (torch.from_numpy(db), torch.tensor(lo), torch.tensor(span), 50)
    kw = dict(i_start=0, n_rows=8, height=8, min_value=254, mip_levels=(1, 2))
    kimages.reset_launches()
    img, mips = kimages.quantize_mips(*args, **kw)
    ref, ref_mips = kimages.quantize_mips_reference(*args, **kw)
    assert torch.equal(img.view(torch.int16), ref.view(torch.int16)) and len(mips) == 2
    assert kimages.quantize_mips.launches == 0  # the CPU takes the plain version
    with pytest.raises(ValueError, match="no kernel for device"):
        kimages.quantize_mips(args[0].to("meta"), *args[1:], **kw)
    bad = [dict(kw, mip_levels=(2, 1)), dict(kw, mip_levels=(0,)), dict(kw, n_rows=9, height=9),
           dict(kw, height=7), dict(kw, min_value=70000), dict(kw, i_start=1)]
    for b in bad:
        with pytest.raises(ValueError):
            kimages.quantize_mips(*args, **b)
    # the CPU's plain version takes a strided dB, as the torch chain before the kernel did
    strided = torch.from_numpy(np.ascontiguousarray(db.transpose(0, 2, 1))).transpose(1, 2)
    got, got_mips = kimages.quantize_mips(strided, *args[1:], **kw)
    for g, w in zip([got, *got_mips], [ref, *ref_mips]):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    with pytest.raises(ValueError, match="lo must be"):
        kimages.quantize_mips(args[0], args[1].double(), *args[2:], **kw)


def test_a_failing_kernel_propagates_through_the_manager(tmp_path, monkeypatch):
    """No fallback around the wrapper: a failing K6 fails the apply."""
    from thesia_tpu_torch.engine.manager import TrackManager
    from thesia_tpu_torch.engine.track import TrackList
    from thesia_tpu_torch.io.wav import encode_wav_f32

    p = tmp_path / "t.wav"
    p.write_bytes(encode_wav_f32(np.random.default_rng(2).uniform(-0.5, 0.5, (1, 8000))
                                 .astype(np.float32), 8000))
    tl, tm = TrackList("cpu"), TrackManager("cpu")
    tm.add_tracks(tl, tl.add_tracks([0], [str(p)]))

    def failed(*a, **k):
        raise RuntimeError("quantize_mips kernel launch failed: CUDA error 700")

    monkeypatch.setattr(kimages, "quantize_mips", failed)
    with pytest.raises(RuntimeError, match="quantize_mips kernel launch failed"):
        tm.apply_track_list_changes(tl)
    tm.images.shutdown()


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card_equal(cuda, db, lo, span, n, **kw):
    args = (torch.from_numpy(db).to(cuda), torch.tensor(lo, device=cuda),
            torch.tensor(span, device=cuda), n)
    before = kimages.quantize_mips.launches
    img, mips = kimages.quantize_mips(*args, **kw)
    assert kimages.quantize_mips.launches == before + 1
    ref, ref_mips = kimages.quantize_mips_reference(*args, **kw)
    torch.cuda.synchronize()
    assert img.dtype == kimages.IMAGE_DTYPE and img.shape == ref.shape
    for g, w in zip([img, *mips], [ref, *ref_mips]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRID, ids=IDS)
def test_kernel_equals_plain_on_the_card(cuda, case):
    c, n, f, i_start, rows, height, min_value, kind = case
    db, lo, span = _db(kind, n + f, c, n, f, min_value)
    _on_card_equal(cuda, db, lo, span, n, i_start=i_start, n_rows=rows, height=height,
                   min_value=min_value, mip_levels=_levels(n, 12))


# the main path's images (tools/bench_images.py SHAPES)
MAIN_SHAPES = [(2, 30001, 347, 0, 347, 347, (3, 4, 5)), (2, 30001, 1025, 0, 1025, 1025, (3, 4, 5)),
               (1, 6001, 385, 0, 385, 521, (3,)),
               (1, 360001, 385, 0, 385, 385, (3, 4, 5, 6, 7, 8, 9))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=["song-mel", "song-linear", "memo-mel", "lecture-mel"])
def test_kernel_equals_plain_at_the_main_path_shapes(cuda, shape):
    c, n, f, i_start, rows, height, levels = shape
    db, lo, span = _db("random", n, c, n, f, 254)
    _on_card_equal(cuda, db, lo, span, n, i_start=i_start, n_rows=rows, height=height,
                   min_value=254, mip_levels=levels)


@pytest.mark.gpu
def test_a_card_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(kimages, "quantize_mips_reference", plain)
    db, lo, span = _db("random", 1, 1, 3000, 20, 254)
    img, _ = kimages.quantize_mips(torch.from_numpy(db).to(cuda), torch.tensor(lo, device=cuda),
                                   torch.tensor(span, device=cuda), 3000, i_start=0, n_rows=20,
                                   height=20, min_value=254, mip_levels=(3,))
    assert img.is_cuda


@pytest.mark.gpu
def test_the_card_refuses_a_strided_db(cuda):
    db, lo, span = _db("random", 3, 1, 50, 8, 254)
    strided = torch.from_numpy(np.ascontiguousarray(db.transpose(0, 2, 1))).to(cuda).transpose(1, 2)
    before = kimages.quantize_mips.launches
    with pytest.raises(ValueError, match="contiguous"):
        kimages.quantize_mips(strided, torch.tensor(lo, device=cuda), torch.tensor(span, device=cuda),
                              50, i_start=0, n_rows=8, height=8, min_value=254, mip_levels=(1, 2))
    assert kimages.quantize_mips.launches == before


@pytest.mark.gpu
def test_a_failing_launch_raises_through_the_session(cuda, monkeypatch, tmp_path):
    from thesia_tpu_torch.engine.session import EngineSession
    from thesia_tpu_torch.io.wav import encode_wav_f32
    from thesia_tpu_torch.render.colormap import default_colormap_rgba8

    p = tmp_path / "t.wav"
    p.write_bytes(encode_wav_f32(np.random.default_rng(2).uniform(-0.5, 0.5, (2, 48000))
                                 .astype(np.float32), 48000))
    sess = EngineSession(device=cuda, settings_dir=tmp_path / "config")
    sess.init(default_colormap_rgba8().reshape(-1).tolist())
    assert sess.add_tracks([0], [str(p)]) == [0]
    lib = build.library()

    class Failing:
        def __getattr__(self, name):
            if name == "thesia_quantize_mips":
                return lambda *a: 700
            return getattr(lib, name)

    monkeypatch.setattr(build, "library", lambda: Failing())
    with pytest.raises(RuntimeError, match="quantize_mips kernel launch failed: CUDA error 700"):
        sess.apply_track_list_changes(defer=False)
    monkeypatch.undo()
    sess.tm.images.shutdown()


@pytest.mark.gpu
def test_the_card_lands_the_same_bytes(cuda):
    rng = np.random.default_rng(9)
    values = rng.integers(0, 65536, (2, 6, 3001)).astype(np.uint16)
    want = _narrowed_bits(values)
    dev = torch.from_numpy(values).to(cuda)
    np.testing.assert_array_equal(port_images.land_u16([dev])[0], want)
    store = port_images.SpecImageStore()
    t = port_images.TrackImages(0, 2, 3001, 6, dev, {})
    store.set_images(0, t)
    np.testing.assert_array_equal(store._to_host(t, dev[1, :, 100:900]), want[1, :, 100:900])
    assert store.drain(timeout=60)
    for ch in range(2):
        np.testing.assert_array_equal(np.asarray(store.host_image(0, ch)), want[ch])
    store.shutdown()


def test_ptxas_report_names_the_k6_kernels():
    """chip_smoke.py's [build] gate finds csrc/images.cu's two kernels by
    name in the build log."""
    log = """ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__x_9_images_cu_y11k6_quantizeEPKflllliiS2_S2_fPtiNS_6LevelsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__x_9_images_cu_y11k6_quantizeEPKflllliiS2_S2_fPtiNS_6LevelsE
    72 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__x_9_images_cu_y8k6_halveEPKtliiNS_6LevelsE' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__x_9_images_cu_y8k6_halveEPKtliiNS_6LevelsE
    72 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers
"""
    assert build.ptxas_report(log) == [
        {"kernel": "k6_quantize", "stack": 72, "spill_stores": 0, "spill_loads": 0, "registers": 47},
        {"kernel": "k6_halve", "stack": 72, "spill_stores": 0, "spill_loads": 0, "registers": 47},
    ]
