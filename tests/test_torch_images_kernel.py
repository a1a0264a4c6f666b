"""K6, the quantize + mips kernel (thesia_tpu_torch/kernels/images.py and
csrc/images.cu), against the JAX package's ``_quantize_and_mips``.

On the CPU: the plain version ``quantize_mips_reference`` bit for bit equal
to the JAX program (run on the CPU as the JAX package's tests run it) over a
grid of row offsets, images taller than the spectrogram, min_value 0, 1 and
254, widths odd at every level, width 1, NaN, +-inf, values on x.5 ties and
values outside the range; a numpy model of the kernel's schedule (fewer
blocks than tiles, each a run of consecutive tiles of 2^TILE_LEVELS columns
along one band of rows, each row of a tile halved by one warp in its lanes
and by shuffles, every level stored as 16-byte words at the row's alignment
with each run's end word carried to the next tile, 2-byte stores only at a
run's ends, then launches from every TILE_LEVELS-th level) against the JAX
chain at the lecture's nine levels and at edge widths, heights and channel
counts; the 2-byte storage (dtype, and the host bytes
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


TT = 1 << kimages.TILE_LEVELS  # csrc/images.cu: frames a tile
TR = 32  # rows a tile


class Flat:
    """A level array as the kernel sees it, flat, with a log of its stores:
    every 16-byte store must start at a 16-byte address, and every element
    must be written exactly once."""

    def __init__(self, shape):
        self.shape = shape
        self.v = np.zeros(int(np.prod(shape)), np.uint32)
        self.count = np.zeros(self.v.size, np.int32)
        self.words = self.scalars = self.batch = 0
        self.word_at: list[tuple[int, int]] = []  # (element, batch: the tile that stored it)

    def store16(self, e: np.ndarray, vals: np.ndarray) -> None:
        assert np.all(e % 8 == 0)
        idx = e[:, None] + np.arange(8)
        self.v[idx] = vals
        np.add.at(self.count, idx.reshape(-1), 1)
        self.words += len(e)
        self.word_at += [(int(x), self.batch) for x in e]

    def store2(self, e: int, val) -> None:
        self.v[e] = val
        self.count[e] += 1
        self.scalars += 1

    def array(self) -> np.ndarray:
        assert np.all(self.count == 1), "an element written twice or never"
        return self.v.reshape(self.shape).astype(np.uint16)


def _halve(x, y, both):
    return np.where(both, (x + y + 1) >> 1, x)  # the odd-width tail copies its only column


def _grain(k: int) -> int:
    """Columns a level's stores complete at once: a 16-byte word at levels
    0..2, a 32-byte sector deeper."""
    return 16 if k >= 3 else 8


def _row_words(k: int) -> int:
    """16-byte words of the image a row of level k's tile and its carry can touch."""
    return (_grain(k) - 1 + (TT >> k) + 7) // 8


def _store_level(out: Flat, cat: np.ndarray, e: int, length: int, k: int, since: int,
                 last: bool) -> None:
    """store_word over one row: ``cat`` is the row's G carry slots and its
    run (``length`` columns), the run starting at flat element ``e``, p = e
    mod G columns past a grain boundary (G = _grain(k)); the carry holds the
    last min(p, since) of those p columns.  Word m (columns 8m - p .. 8m - p
    + 7 of the run) is one 16-byte store when its grain is whole (carry and
    run); the first grain when the carry does not fill it, and the run's
    last grain at the end of the block's run (``last``), go out as far as
    they hold values; the grain the run ends in is otherwise carried."""
    g = _grain(k)
    p = e % g
    c = min(p, since)
    for m in range(_row_words(k)):
        L = 8 * m - p
        g0 = (8 * m // g) * g - p
        whole = g0 >= -c and g0 + g <= length
        if L >= length or (not whole and not last and g0 + g > length):
            continue
        lo, hi = max(L, -c), min(L + 8, length)
        if whole or (lo == L and hi == L + 8):
            out.store16(np.array([e + L]), cat[None, g + L:g + L + 8])
        else:
            for i in range(lo, hi):
                out.store2(e + i, cat[g + i])


def _halve_rows(lvl0: np.ndarray, c0: int, w0: int, nlev: int) -> dict[int, np.ndarray]:
    """chunk_levels and halve_deep: the thread that holds chunk l of a row
    (the tile's columns 8l .. 8l + 7) halves it to levels 1..3; level k >= 4
    by lane l of a warp holding column l of level 3, with lane l ^ 2^(k-4)
    (a shuffle).  Returns each level's tile, (rows, TT >> k)."""
    lanes = np.arange(32)
    edge = c0 + TT > w0

    def ok(j, k):  # column j of level k pairs two columns: its source level k-1 holds 2j+1
        left = -(-w0 // (1 << (k - 1))) - (c0 >> (k - 1))
        return np.logical_or(not edge, 2 * j + 1 < min(left, TT))

    tiles = {}
    for row in lvl0:
        a = row.reshape(32, 8)
        v1 = _halve(a[:, 0::2], a[:, 1::2], ok(4 * lanes[:, None] + np.arange(4), 1))
        v2 = _halve(v1[:, 0::2], v1[:, 1::2], ok(2 * lanes[:, None] + np.arange(2), 2))
        v = _halve(v2[:, 0], v2[:, 1], ok(lanes, 3))
        runs = {1: v1.reshape(-1), 2: v2.reshape(-1), 3: v}
        for k in range(4, nlev + 1):
            d = 1 << (k - 4)
            p, odd = v[lanes ^ d], (lanes & d) != 0
            v = _halve(np.where(odd, p, v), np.where(odd, v, p), ok(lanes >> (k - 3), k))
            runs[k] = v[:: 1 << (k - 3)]
        for k in range(1, nlev + 1):
            tiles.setdefault(k, []).append(runs[k])
    return {k: np.stack(v) for k, v in tiles.items()}


class Run:
    """A block's run of tiles along one band of rows: each level's carry
    slots, random until the run writes them."""

    def __init__(self, rows: int, first: int, rng: np.random.Generator):
        self.first, self.rng, self.rows = first, rng, rows
        self.lead: dict[int, np.ndarray] = {}

    def tile(self, out: Flat, k: int, tile: np.ndarray, c0: int, w0: int, row: int,
             last: bool) -> None:
        """Store level k of a tile (its base level w0 wide, first column
        c0): each row's run behind its carry, then the new carry."""
        g = _grain(k)
        lead = self.lead.setdefault(k, self.rng.integers(0, 65536, (self.rows, g)))
        out.batch += 1
        wk = -(-w0 // (1 << k))
        length = min(wk - (c0 >> k), TT >> k)
        for r in range(len(tile)):
            e = (row + r) * wk + (c0 >> k)
            cat = np.concatenate([lead[r], tile[r, :length]])
            _store_level(out, cat, e, length, k, (c0 >> k) - (self.first >> k), last)
            q = (e % g + length) % g
            lead[r, g - q:] = cat[g + length - q:g + length]


def kernel_schedule(img: np.ndarray, mip_levels: tuple[int, ...], grid: int,
                    rng: np.random.Generator) -> tuple[Flat, dict[int, Flat]]:
    """The kernel's schedule in numpy.  k6_quantize: a block a run of
    consecutive time tiles of one band (TR rows of one channel), ``grid //
    bands`` runs a band (at least 1, at most a run a tile); a tile: the
    level-0 tile, its levels 1..D (_halve_rows), then every level's 16-byte
    words (Run.tile, _store_level).  Then k6_halve from every D-th level
    written (``launch_levels``): a block a tile of TR of the C * H level rows
    by TT columns, its own run.  Columns past a level's width and carry slots
    not yet written hold random values, which must not reach any output.
    Returns level 0 and every level written."""
    d = kimages.TILE_LEVELS
    c, height, n = img.shape
    written = kimages.launch_levels(mip_levels)
    outs = {l: Flat((c, height, kimages.level_width(n, l))) for l in written}
    out0 = Flat(img.shape)
    first = min(max(written, default=0), d)
    row_tiles, time_tiles = -(-height // TR), -(-n // TT)
    bands = c * row_tiles
    runs = min(max(grid // bands, 1), time_tiles)
    for block in range(bands * runs):
        band, run = block % bands, block // bands
        ch, rt = divmod(band, row_tiles)
        tt0, tt1 = run * time_tiles // runs, (run + 1) * time_tiles // runs
        row0, rows = rt * TR, min(TR, height - rt * TR)
        row = ch * height + row0
        state = Run(rows, tt0 * TT, rng)
        for tt in range(tt0, tt1):
            t0 = tt * TT
            fn = min(TT, n - t0)
            lvl0 = rng.integers(0, 65536, (rows, TT))
            lvl0[:, :fn] = img[ch, row0:row0 + rows, t0:t0 + fn]
            last = tt + 1 == tt1
            state.tile(out0, 0, lvl0, t0, n, row, last)
            if first:
                for k, tile in _halve_rows(lvl0, t0, n, first).items():
                    if k in outs:
                        state.tile(outs[k], k, tile, t0, n, row, last)
    for base in range(d, max(written, default=0), d):
        nlev = min(d, max(written) - base)
        src = outs[base].array().reshape(c * height, -1)
        w0 = src.shape[-1]
        for row in range(0, c * height, TR):
            for c0 in range(0, w0, TT):
                seg = src[row:row + TR, c0:c0 + TT]
                lvl0 = rng.integers(0, 65536, (len(seg), TT))
                lvl0[:, :seg.shape[1]] = seg
                state = Run(len(seg), c0, rng)
                for k, tile in _halve_rows(lvl0, c0, w0, nlev).items():
                    if base + k in outs:
                        state.tile(outs[base + k], k, tile, c0, w0, row, True)
    return out0, outs


# (frames, deepest level, channels, rows, height, grid)
SCHEDULES = [(360001, 9, 1, 3, 3, 5), (5000, 12, 1, 3, 3, 3), (200, 3, 1, 3, 3, 1),
             (1, 2, 1, 3, 3, 1), (1000, 10, 2, 3, 5, 3), (777, 9, 1, 35, 40, 2),
             (4096, 9, 2, 2, 2, 5)]


@pytest.mark.parametrize("n,deepest,c,rows,height,grid", SCHEDULES,
                         ids=["lecture", "two-halve-launches", "under-one-tile", "width-1",
                              "C2-even-taller", "odd-two-row-tiles", "whole-tiles"])
def test_tiled_schedule_equals_the_jax_chain(n, deepest, c, rows, height, grid):
    db, lo, span = _db("random", n, c, n, rows, 254)
    levels = tuple(range(3 if deepest >= 3 else 1, deepest + 1))
    if n == 360001:
        assert levels == tuple(port_images.mip_plan(n))
    want = _jax(db, lo, span, n, i_start=0, n_rows=rows, height=height, min_value=254,
                mip_levels=levels)
    out0, outs = kernel_schedule(want[0], levels, grid, np.random.default_rng(n))
    assert set(kimages.launch_levels(levels)) == set(outs)
    np.testing.assert_array_equal(out0.array(), want[0])
    for level, w in zip(levels, want[1:]):
        np.testing.assert_array_equal(outs[level].array(), w)
    # whole words: 2-byte stores only at the two ends of a block's run along a row (at
    # most 7 columns each), at every level the block writes
    runs = min(max(grid // (c * -(-height // TR)), 1), -(-n // TT))
    for level, flat in [(0, out0)] + [(l, outs[l]) for l in levels if l <= kimages.TILE_LEVELS]:
        assert flat.scalars <= 14 * c * height * runs, level
        if level >= 3:  # whole 32-byte sectors: a tile stores a word without its partner
            words = set(flat.word_at)  # only at the ends of a block's run
            alone = [(w, b) for w, b in words if (w ^ 8, b) not in words]
            assert len(alone) <= 2 * c * height * runs, level
    if n >= 4096:
        assert 8 * out0.words > 0.99 * out0.v.size


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
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_reads_a_db_at_any_4_byte_offset(cuda, offset):
    """The kernel copies each frame's rows as the 16-byte chunks that hold
    them: a contiguous dB that starts 4, 8 or 12 bytes past a 16-byte
    address (a view into a larger buffer) gives the same image."""
    c, n, f = 2, 3001, 37
    db, lo, span = _db("random", offset, c, n, f, 254)
    flat = torch.zeros(db.size + 8, dtype=torch.float32, device=cuda)
    view = flat[offset:offset + db.size].view(db.shape)
    view.copy_(torch.from_numpy(db))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    lo_t, span_t = torch.tensor(lo, device=cuda), torch.tensor(span, device=cuda)
    kw = dict(i_start=2, n_rows=33, height=40, min_value=254, mip_levels=(3, 4, 5))
    got = kimages.quantize_mips(view, lo_t, span_t, n, **kw)
    want = kimages.quantize_mips_reference(view, lo_t, span_t, n, **kw)
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


# (lo, span): the fast quotient's range and both sides of it, a denormal
# span, 0, inf and NaN
EXTREME_RANGES = [(-103.25, 100.0), (0.0, 1e-12), (-5.0, 3e20), (1.0, 1e-40), (0.0, 0.0),
                  (0.0, float("inf")), (0.0, float("nan")), (-1e30, 1e-30)]


def _extreme_db(seed: int, c: int, t: int, f: int) -> np.ndarray:
    """dB over the whole f32 range: magnitudes from 1e-45 to 3e38 of both
    signs, 0 and -0, +-inf and NaN."""
    rng = np.random.default_rng(seed)
    db = (rng.choice([-1.0, 1.0], (c, t, f)) * 10.0 ** rng.uniform(-45, 38.5, (c, t, f)))
    db = db.astype(np.float32)
    u = rng.random(db.shape)
    db[u < 0.02] = 0.0
    db[(u >= 0.02) & (u < 0.04)] = -0.0
    db[(u >= 0.04) & (u < 0.05)] = np.inf
    db[(u >= 0.05) & (u < 0.06)] = -np.inf
    db[u > 0.99] = np.nan
    return db


@pytest.mark.gpu
@pytest.mark.parametrize("lo,span", EXTREME_RANGES)
def test_kernel_divides_as_ieee_over_the_whole_range(cuda, lo, span):
    """The kernel's quotient (the fast path's three operations from one
    reciprocal a block, __fdiv_rn outside [2^-32, 2^32], d * (1 / span) for
    a non-finite d) equals the plain version's IEEE division everywhere."""
    db = _extreme_db(3, 2, 700, 40)
    _on_card_equal(cuda, db, np.float32(lo), np.float32(span), 700, i_start=1, n_rows=37,
                   height=40, min_value=254, mip_levels=(3, 4))


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
    name in the build log and reads their stack frames: 0 bytes, since the
    level pointers are a __grid_constant__ parameter indexed only with
    unrolled levels."""
    q = "_ZN41_GLOBAL__N__3aa4998c_9_images_cu_93a73a2c11k6_quantizeEPKflllliiS1_S1_fPtiiiiNS_6LevelsE"
    h = "_ZN41_GLOBAL__N__3aa4998c_9_images_cu_93a73a2c8k6_halveEPKtllliNS_6LevelsE"
    log = f"""ptxas info    : Compiling entry function '{h}' for 'sm_90a'
ptxas info    : Function properties for {h}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 40992 bytes smem
ptxas info    : Compiling entry function '{q}' for 'sm_90a'
ptxas info    : Function properties for {q}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""
    report = build.ptxas_report(log)
    assert report == [
        {"kernel": "k6_halve", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 32},
        {"kernel": "k6_quantize", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 64},
    ]
    assert not any(k["stack"] or k["spill_stores"] or k["spill_loads"] for k in report)


def test_phase_profile_reads_the_kernels_marks():
    """tools/profile_images_phases.py counts cycles at csrc/images.cu's own
    PHASE marks, each naming its kernel and phase: every counter is marked
    once, each kernel starts its clock and flushes it, and a source without
    marks or with an unnamed mark is refused."""
    from thesia_tpu_torch.tools import profile_images_phases as phases

    src = (build.CSRC_DIR / "images.cu").read_text()
    names = phases.phase_names(src)
    kernels = {kernel for kernel, _phase in names.values()}
    assert kernels == {"k6_quantize", "k6_halve"}
    for i in names:
        assert src.count(f"PHASE({i})") == 1, i
    assert src.count("PHASE_BEGIN\n") == len(kernels) + 1  # and the empty macro's definition
    assert src.count("PHASE_END\n") == len(kernels) + 1
    text = phases.instrumented_source(src)
    assert "g_phase_cycles" in text and "thesia_phase_cycles" in text
    with pytest.raises(ValueError, match="marks no phases"):
        phases.instrumented_source("#include <stdint.h>\nnamespace {\n")
    with pytest.raises(ValueError, match="names"):
        phases.phase_names(src.replace("PHASE(0)  // k6_quantize issue", "PHASE(0)"))
