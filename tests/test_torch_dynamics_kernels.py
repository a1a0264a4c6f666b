"""K9 (LUFS + stats) and K8 (limiter gains) as CUDA kernels
(thesia_tpu_torch/kernels/dynamics.py, csrc/dynamics.cu).

On the CPU:

* the host tables the kernels read: the biquads' coefficients against the
  plain version's ``_affine_from_biquad``, the cascade's matrix against the
  two biquads run one after the other, the weights W[k] = M^k g and the
  powers of M (made in extended precision), the schedules, the work counts;
* the pieces of the new design on their own: run and block end states from
  the weights and one scan against the recurrence, the hold as the gain of
  an f32 sliding max against the plain version's sliding min of f64 gains
  (bitwise), the histogram bin's log2 estimate against searchsorted;
* numpy models of the kernels' decomposition (K9: runs of a block by the
  weights, one scan a block with the powers of M^run, the carry K blocks a
  thread with the powers of M^(chunk K), each run re-run from P^j R plus its
  start from zero; K8: chunks with their hold and box halos, the hold by van
  Herk over the threads' segments, centred (A, E, C) release maps carried
  across chunks, the box stack as differences of prefix sums), built from
  those tables with small chunks so that every carry crosses many of them,
  held against the JAX package's ``_lufs_kernel`` and ``_limiter_gain_kernel``
  at 1e-9 (run on the CPU as tests/test_torch_dynamics.py runs them);
* the routing: CPU tensors take the plain versions (the float64 torch
  programs of dynamics/stats_device.py) and count no launch; a CUDA tensor
  never does, so a library that fails to build raises, and a failing kernel
  propagates through the session's add and Limiter.

Tests marked gpu launch the kernels and skip without a card: every rate and
channel count the viewer meets, mixed and edge lengths, silence, levels
below the gates, NaN and a spike, against the plain versions on the card
(LUFS and gains within 1e-9, peaks equal, sums of squares within 1e-12
relative), two calls bitwise equal, a constant number of launches."""

import math
import types

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from thesia_tpu.dynamics import stats_device as jax_dev
from thesia_tpu_torch.dynamics import stats_device as port_dev
from thesia_tpu_torch.dynamics.envelope import optimal_ratios, stack_layer_lengths
from thesia_tpu_torch.dynamics.loudness import (
    _RELATIVE_GATE_FACTOR, _SURROUND_WEIGHT, HIST_BOUNDARIES, HIST_ENERGIES, k_weighting_coeffs,
)
from thesia_tpu_torch.kernels import build
from thesia_tpu_torch.kernels import dynamics as kdyn

RATES = [8000, 16000, 44100, 48000, 96000]


# -- host tables -----------------------------------------------------------------

@pytest.mark.parametrize("sr", RATES + [22050, 11025])
def test_coefficients_are_the_plain_versions_recurrences(sr):
    b1, a1, b2, a2 = k_weighting_coeffs(sr)
    coef = kdyn.k9_coefficients(sr)
    for (b, a), part in zip(((b1, a1), (b2, a2)), (coef[:5], coef[5:])):
        A, c, b0 = port_dev._affine_from_biquad(b, a)
        assert part.tolist() == [A[0, 0], A[1, 0], c[0], c[1], b0]


@pytest.mark.parametrize("sr", [16000, 48000])
def test_cascade_matrix_runs_the_two_biquads(sr):
    """S_t = M S_{t-1} + g x_t with output z_t = b02 (b01 x_t + s0) + u0 is
    the two DF2T biquads in a row (scipy's lfilter)."""
    rng = np.random.default_rng(sr)
    x = rng.standard_normal(3000)
    coef = kdyn.k9_coefficients(sr)
    m, g = kdyn.k9_matrix(coef)
    b0, e0 = coef[4], coef[9]
    s = np.zeros(4)
    z = np.empty_like(x)
    for t, v in enumerate(x):
        z[t] = e0 * (b0 * v + s[0]) + s[2]
        s = m @ s + g * v
    b1, a1, b2, a2 = k_weighting_coeffs(sr)
    np.testing.assert_allclose(z, lfilter(b2, a2, lfilter(b1, a1, x)), rtol=0, atol=1e-12)


def _powers(table, at):
    """(ladder (10, 4, 4), lane (32, 4, 4), warp (33, 4, 4)) of a power table
    at ``at``."""
    pw = table[at:at + kdyn.POW_TABLE]
    lane_at = 16 * kdyn.POW_STEPS
    lane = pw[lane_at:lane_at + 16 * 32].reshape(16, 32).T.reshape(32, 4, 4)  # element-major
    return (pw[:lane_at].reshape(-1, 4, 4), lane, pw[lane_at + 16 * 32:].reshape(-1, 4, 4))


@pytest.mark.parametrize("sr", RATES)
def test_power_ladders(sr):
    plan = kdyn.k9_plan(sr)
    coef, table = kdyn.k9_tables(sr)
    run, ch = plan["run"], plan["chunk"]
    assert table.shape == (4 * run + kdyn.POW_TABLE + 16 * (run + 1),) and not table.flags.writeable
    advance = table[4 * run + kdyn.POW_TABLE:].reshape(run + 1, 4, 4)  # M^k, k <= run
    m, g = kdyn.k9_matrix(coef)
    wide = m.astype(np.longdouble)
    weights = table[:4 * run].reshape(run, 4)
    w = g.astype(np.longdouble)
    for k in range(run):  # W[k] = M^k g, step by step here in extended precision
        np.testing.assert_allclose(weights[k], w.astype(np.float64), rtol=0,
                                   atol=1e-14 * np.abs(g).max())
        w = wide @ w
    tables = [(table, 4 * run, run)]
    for k in (1, 4):
        carry = kdyn.k9_carry_table(sr, k)
        assert carry.shape == (kdyn.POW_TABLE + 16,) and not carry.flags.writeable
        assert np.abs(carry[-16:].reshape(4, 4) - np.linalg.matrix_power(wide, ch).astype(np.float64)
                      ).max() <= 1e-15
        tables.append((carry, 0, ch * k))
    for tab, at, base in tables:
        ladder, lane, warp = _powers(tab, at)
        for pw, exps in ((ladder, [base << i for i in range(kdyn.POW_STEPS)]),
                         (lane, [base * i for i in range(32)]),
                         (warp, [32 * base * i for i in range(33)])):
            for p, e in zip(pw, exps):
                # f64 squarings lose up to about 1e-9 of these powers (M is
                # far from normal); the table's are made in extended precision
                want = np.linalg.matrix_power(wide, e)
                assert np.abs(p - want.astype(np.float64)).max() <= 1e-15 + 1e-13 * np.abs(want).max()
                assert not p[:2, 2:].any()  # block lower triangular, as csrc's mat_acc reads it
        assert np.array_equal(lane[0], np.eye(4)) and np.array_equal(warp[0], np.eye(4))
    for k in range(run + 1):
        want = np.linalg.matrix_power(wide, k)
        assert np.abs(advance[k] - want.astype(np.float64)).max() <= 1e-15 + 1e-13 * np.abs(want).max()
    p = np.eye(4, dtype=np.longdouble)
    for i in range(32 * run):  # the run's lane powers, one step at a time
        if i % run == 0:
            want = p.astype(np.float64)
            lane_i = _powers(table, 4 * run)[1][i // run]
            assert np.abs(lane_i - want).max() <= 1e-12 * np.abs(want).max()
        p = wide @ p
    # the high-pass pole near 1 decays slowly: M^run is far from zero
    assert np.abs(_powers(table, 4 * run)[0][0]).max() > 0.5


def test_warm_tables_builds_every_table_a_rate_needs(monkeypatch):
    """``warm_tables`` leaves K9's table and every carry table of a rate in
    the caches, so an add at a common rate builds none of them."""
    built = []
    for name in ("k9_tables", "k9_carry_table"):
        real = getattr(kdyn, name)
        monkeypatch.setattr(kdyn, name,
                            lambda *a, _r=real, _n=name: built.append((_n, a)) or _r(*a))
    kdyn.warm_tables(44100)
    assert built == ([("k9_tables", (44100,))]
                     + [("k9_carry_table", (44100, k)) for k in (1, 2, 4, 8)])
    assert {kdyn.carry_blocks(nb) for nb in (1, 600, 1500, 3000, 10**6)} == {1, 2, 4, 8}
    assert 16000 in kdyn.COMMON_RATES and 48000 in kdyn.COMMON_RATES


@pytest.mark.parametrize("sr", [100, 150, 160, 8000, 11025, 44100, 48000, 96000, 192000])
def test_k9_plan(sr):
    plan = kdyn.k9_plan(sr)
    s100 = (sr + 5) // 10
    assert plan["s100"] == s100 and plan["win"] == 4 * s100
    assert plan["chunk"] == plan["segments"] * s100 and plan["segments"] >= 1
    run, threads = plan["run"], plan["threads"]
    # every sample of a block has a thread, whose run touches at most two segments
    assert threads * run >= plan["chunk"] > threads * (run - 2)
    assert 1 <= run <= s100 and (run % 2 == 1 or run == s100)  # odd: no bank conflicts
    assert plan["chunk"] <= max(threads * kdyn.K9_RUN_TARGET, s100)
    assert plan["carry_threads"] == kdyn.CARRY_THREADS
    assert 4 * (plan["chunk"] + 4) <= 220 * 1024  # the staged samples fit shared memory
    with pytest.raises(ValueError, match="no 100 ms segment"):
        kdyn.k9_plan(4)
    with pytest.raises(ValueError, match="longer than a segment"):
        kdyn.k9_plan(8000, threads=4, segments=8)


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000, 96000, 192000, 384000])
def test_k8_plan_fits_shared_memory(sr):
    attack = int(np.floor(5.0 * sr / 1000.0 + 0.5))
    hold = int(np.floor(20.0 * sr / 1000.0 + 0.5))
    boxes = [max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3))]
    plan = kdyn.k8_plan(hold, boxes)
    assert plan["hbox"] == attack - 1  # the box stack's delay
    assert plan["chunk"] % kdyn.K8_THREADS == 0 and plan["chunk"] >= 1024
    assert plan["buf"] == plan["chunk"] + plan["hbox"] + hold - 1
    assert plan["m"] == plan["chunk"] + plan["hbox"]
    bufp = -(-plan["buf"] // 4) * 4
    assert plan["smem_bytes"] == 8 * bufp + 16 + 8 * plan["m"] <= kdyn.K8_SMEM_LIMIT
    assert plan["spans_smem_bytes"] == 12 * bufp + 32 <= kdyn.K8_SMEM_LIMIT
    if sr <= 48000:  # two blocks an SM
        assert 2 * plan["smem_bytes"] <= 227 * 1024
    assert kdyn.k8_plan(0, [])["hold"] == 1 and kdyn.k8_plan(5, [1, 1, 4])["boxes"] == (4,)
    with pytest.raises(ValueError, match="at most"):
        kdyn.k8_plan(5, [2] * 5)


def test_work_counts():
    w = kdyn.lufs_work([48000 * 300], 2, 48000)
    assert w["bytes"] == 4 * 2 * 48000 * 300 + 8 * 2001 + 24
    assert w["flop"] > kdyn.K9_FLOP_PER_SAMPLE * 2 * 48000 * 300
    w = kdyn.limiter_work(1, 2, 1000)
    assert w["bytes"] == 4 * 2 * 1000 + 8 * 1000 and w["flop"] == (4 + 19) * 1000


# -- numpy models of the decomposition ------------------------------------------

def _k_run(coef, x, cnt, s):
    """Every thread's samples x (T, S) through both biquads from states s (T, 4),
    the first cnt (T,) of them: (outputs (T, S), end states)."""
    na1, na2, c0, c1, b0, nb1, nb2, d0, d1, e0 = coef
    s = s.copy()
    z = np.zeros(x.shape)
    for i in range(x.shape[1]):
        on = i < cnt
        v = x[:, i]
        y = b0 * v + s[:, 0]
        nxt = np.stack([c0 * v + (na1 * s[:, 0] + s[:, 1]), c1 * v + na2 * s[:, 0],
                        d0 * y + (nb1 * s[:, 2] + s[:, 3]), d1 * y + nb2 * s[:, 2]], 1)
        z[:, i] = np.where(on, e0 * y + s[:, 2], 0.0)
        s = np.where(on[:, None], nxt, s)
    return z, s


def _scan_states(e, c, pw):
    """csrc/dynamics.cu scan_states: the runs' end states e (T, 4) from zero
    and the state c entering the block -> (each run's start state, the
    block's end state), by a scan in each warp (T lanes where T < 32) with
    the ladder, a scan of the warp totals with P^(32 2^l), then the warps'
    and the lanes' powers."""
    ladder, lane, warp = pw
    t = len(e)
    width = min(t, 32)
    nw = t // width
    v = e.reshape(nw, width, 4).copy()
    l = 0
    while (1 << l) < width:
        d = 1 << l
        v[:, d:] = v[:, :-d] @ ladder[l].T + v[:, d:]
        l += 1
    u = v[:, -1].copy()
    l = 0
    while (1 << l) < nw:
        d = 1 << l
        u[d:] = u[:-d] @ ladder[5 + l].T + u[d:]
        l += 1
    tot = (warp[nw] if width == 32 else lane[width]) @ c + u[-1]
    x = np.einsum("wij,j->wi", warp[:nw], c) + np.concatenate([np.zeros((1, 4)), u[:-1]])
    ex = np.concatenate([np.zeros((nw, 1, 4)), v[:, :-1]], axis=1)
    starts = np.einsum("lij,wj->wli", lane[:width], x) + ex
    return starts.reshape(t, 4), tot


def _weighted_ends(weights, xr, cnt):
    """End states from zero of each thread's first cnt samples of xr (T, run)
    by the weights: sum_i W[cnt - 1 - i] x_i."""
    i = np.arange(xr.shape[1])
    idx = np.clip(cnt[:, None] - 1 - i, 0, len(weights) - 1)
    return np.einsum("tik,ti->tk", weights[idx], np.where(i < cnt[:, None], xr, 0.0))


def _runs(x, p0, run):
    """(T, run) samples of x at p0[t] + i, zeros outside x."""
    pos = p0[:, None] + np.arange(run)
    return np.where((pos >= 0) & (pos < len(x)), x[np.clip(pos, 0, max(len(x) - 1, 0))], 0.0)


def _block_starts(table, run, threads, xb):
    """k9_sums on one block's samples xb: (each run's start from a zero block
    start, the block's end state), runs of `run` samples from the block's
    start, the last one short."""
    j = np.arange(threads)
    weights = table[:4 * run].reshape(run, 4)
    cnt = np.clip(len(xb) - j * run, 0, run)
    e = _weighted_ends(weights, _runs(xb, j * run, run), cnt)
    st, _tot = _scan_states(e, np.zeros(4), _powers(table, 4 * run))
    last = (len(xb) - 1) // run
    advance = table[4 * run + kdyn.POW_TABLE:].reshape(run + 1, 4, 4)
    return st, advance[cnt[last]] @ st[last] + e[last]


def _block_end(table, run, threads, xb):
    return _block_starts(table, run, threads, xb)[1]


def model_lufs(wavs, ns, sr, threads, carry, segments):
    """K9 as csrc/dynamics.cu runs it, from kdyn's tables: (lufs, sum_sq, peak)."""
    plan = kdyn.k9_plan(sr, threads, segments, carry)
    coef, table = kdyn.k9_tables(sr, threads, segments)
    s100, run, ch = plan["s100"], plan["run"], plan["chunk"]
    weights = table[:4 * run].reshape(run, 4)
    prun = _powers(table, 4 * run)
    n_items, n_ch, _length = wavs.shape
    j = np.arange(threads)
    out = []
    for b in range(n_items):
        n = int(ns[b])
        nb = -(-n // ch)
        segs, sq, pk = [], 0.0, np.float32(0.0)
        for c in range(n_ch):
            x = wavs[b, c, :n].astype(np.float64)
            sq += float(np.sum(x * x))
            pk = max(pk, np.abs(wavs[b, c, :n]).max(initial=np.float32(0.0)))
            blocks = [x[k * ch:(k + 1) * ch] for k in range(nb)]
            # k9_sums: the runs' starts from a zero block start, the block's end
            sums = [_block_starts(table, run, threads, xb) for xb in blocks]
            ends = [end for _st, end in sums]
            # k9_carry, K blocks a thread, in tiles of `carry` threads
            k = kdyn.carry_blocks(nb, carry)
            ctab = kdyn.k9_carry_table(sr, k, threads, segments)
            pkw, p1 = _powers(ctab, 0), ctab[kdyn.POW_TABLE:].reshape(4, 4)
            end_of = lambda kk: ends[kk] if kk < nb else np.zeros(4)  # noqa: E731
            starts, cin = [], np.zeros(4)
            for k0 in range(0, nb, carry * k):
                agg = np.zeros((carry, 4))
                for j2 in range(carry):
                    for i in range(k):
                        agg[j2] = p1 @ agg[j2] + end_of(k0 + j2 * k + i)
                st, cin = _scan_states(agg, cin, pkw)
                for j2 in range(carry):
                    sj = st[j2]
                    for i in range(k):
                        if k0 + j2 * k + i < nb:
                            starts.append(sj)
                            sj = p1 @ sj + end_of(k0 + j2 * k + i)
            # k9_energy: each run's start P^j R + its start from zero, re-run
            ladder, lane, warp = prun
            width = min(threads, 32)
            acc = np.zeros(nb * segments)
            for k, xb in enumerate(blocks):
                cnt = np.clip(len(xb) - j * run, 0, run)
                xr = _runs(xb, j * run, run)
                lift = np.einsum("wij,j->wi", warp[:-(-threads // width)], starts[k])
                st = sums[k][0] + np.einsum("tij,tj->ti", lane[j % width], lift[j // width])
                z, _ = _k_run(coef, xr, cnt, st)
                pos = (j * run)[:, None] + np.arange(run)
                on = np.arange(run) < cnt[:, None]
                np.add.at(acc, k * segments + pos[on] // s100, z[on] ** 2)
            segs.append(acc[: n // s100])
        n_blocks = max((n - 4 * s100) // s100 + 1, 0)
        z = sum((_SURROUND_WEIGHT if c >= 3 else 1.0)
                * (segs[c][:n_blocks] + segs[c][1:n_blocks + 1] + segs[c][2:n_blocks + 2]
                   + segs[c][3:n_blocks + 3]) for c in range(n_ch)) / (4 * s100)
        q = HIST_ENERGIES[[hist_bin(v) for v in z]] if len(z) else np.zeros(0)
        m_abs = z >= HIST_BOUNDARIES[0]
        gate = q[m_abs].sum() / max(m_abs.sum(), 1) * _RELATIVE_GATE_FACTOR
        m_rel = m_abs & (q > gate)
        lufs = -0.691 + 10.0 * np.log10(max(q[m_rel].sum() / m_rel.sum(), 1e-300)) \
            if m_rel.any() else -np.inf
        out.append((lufs, sq, float(pk)))
    return out


def hist_bin(z: float) -> int:
    """csrc/dynamics.cu hist_bin: an f32 estimate of the histogram bin from
    log2, moved to the exact bin against the f64 bounds."""
    with np.errstate(over="ignore", divide="ignore"):
        f = np.float32(30.1029995664) * np.log2(np.float32(z)) + np.float32(693.09)
    i = int(min(max(f, np.float32(0.0)), np.float32(1000.0)))
    while i < 1000 and HIST_BOUNDARIES[i + 1] <= z:
        i += 1
    while i > 0 and HIST_BOUNDARIES[i] > z:
        i -= 1
    return min(i, 999)


def _compose(l, e):
    """Maps of centred values eta = y - 1, eta -> min(C, A eta + E), as (A, E,
    C) arrays, later o earlier; C = inf is the identity's cap."""
    (A2, E2, C2), (A1, E1, C1) = l, e
    with np.errstate(invalid="ignore"):
        cc = np.where(np.isinf(C1), np.inf, A2 * C1 + E2)
    return A2 * A1, A2 * E1 + E2, np.minimum(C2, cc)


def _apply(f, eta):
    return np.minimum(f[2], f[0] * eta + f[1])


def hold_max(lv, hold, threads):
    """csrc/dynamics.cu hold_max: for i >= hold - 1 the max of lv over [i -
    hold + 1, i] (f32), by van Herk/Gil-Werman over the threads' segments of
    q = ceil(n / threads) positions (each segment's suffix maxima and
    maximum, then the suffix at the window's start, the whole segments
    between and the running prefix), or directly for a hold no longer than
    a segment.  Entries before hold - 1 are NaN."""
    n = len(lv)
    q = -(-n // threads)
    out = np.full(n, np.nan, np.float32)
    if hold <= q:
        for i in range(hold - 1, n):
            out[i] = lv[i - hold + 1:i + 1].max()
        return out
    seg = np.full(threads * q, -np.inf, np.float32)
    seg[:n] = lv
    seg = seg.reshape(threads, q)
    sfx = np.maximum.accumulate(seg[:, ::-1], axis=1)[:, ::-1]
    pre = np.maximum.accumulate(seg, axis=1).reshape(-1)
    segmax = sfx[:, 0]
    sfx = sfx.reshape(-1)
    for i in range(hold - 1, n):
        s0 = i - hold + 1
        mid = segmax[s0 // q + 1:i // q].max(initial=-np.inf)
        out[i] = max(sfx[s0], mid, pre[i])
    return out


def _gain(m, threshold):
    d = m.astype(np.float64)
    with np.errstate(invalid="ignore"):
        return np.where(d > threshold, threshold / (d + np.finfo(np.float64).eps), 1.0)


def _shares(m, threads):
    q = -(-m // threads)
    lo = np.minimum(np.arange(threads) * q, m)
    return lo, np.minimum(lo + q, m), q


def _thread_maps(h, t0, m, threads, slew):
    """Each thread's composed release steps over its share of m positions
    t0 + i at holds h (positions before t = 0 the identity), on centred
    values: eta -> min(h - 1, (1 - slew) eta + slew (h - 1))."""
    lo, hi, q = _shares(m, threads)
    f = (np.ones(threads), np.zeros(threads), np.full(threads, np.inf))
    for i in range(q):
        idx = lo + i
        on = (idx < hi) & (t0 + idx >= 0)
        hv = h[np.minimum(idx, m - 1)]
        g = _compose((np.full(threads, 1.0 - slew), slew * (hv - 1.0), hv - 1.0), f)
        f = tuple(np.where(on, gv, fv) for gv, fv in zip(g, f))
    return f


def model_limiter(wavs, threshold, slew, hold_length, box_lengths, threads, chunk):
    """K8 as csrc/dynamics.cu runs it (kdyn.k8_plan's schedule at ``chunk``):
    gain (B, L) f64."""
    plan = kdyn.k8_plan(hold_length, box_lengths, chunk, threads)
    hold, hbox, ch = plan["hold"], plan["hbox"], plan["chunk"]
    n_items, _c, length = wavs.shape
    a = np.abs(wavs)
    v_all = np.where(np.isnan(a), np.float32(-np.inf), a).max(axis=1)
    nb = -(-length // ch)

    def holds(b, t0, m):
        """The gains after the hold at positions t0 .. t0 + m - 1."""
        t = t0 - (hold - 1) + np.arange(m + hold - 1)
        lv = np.where(t < 0, np.float32(-np.inf), v_all[b, np.clip(t, 0, length - 1)])
        return _gain(hold_max(lv, hold, threads)[hold - 1:], threshold)

    out = np.zeros((n_items, length))
    for b in range(n_items):
        # k8_spans: each span's map, the threads' maps composed in order
        tri = []
        for k in range(nb - 1):
            p0 = k * ch - hbox
            f = _thread_maps(holds(b, p0, ch), p0, ch, threads, slew)
            t = (1.0, 0.0, np.inf)
            for i in range(threads):
                t = _compose(tuple(v[i] for v in f), t)
            tri.append(t)
        # k8_carry: every chunk's start value, centred
        starts = [0.0]
        for t in tri:
            starts.append(float(_apply(t, starts[-1])))
        # k8_gain
        for k in range(nb):
            t0, t1 = k * ch, min(k * ch + ch, length)
            q0 = t0 - hbox
            m = t1 - q0
            h = holds(b, q0, m)
            f = _thread_maps(h, q0, m, threads, slew)
            lo, hi, q = _shares(m, threads)
            y_all = np.zeros(m)  # centred release values, 0 before t = 0
            p = (1.0, 0.0, np.inf)
            for j in range(threads):
                y = starts[k] if j == 0 else float(_apply(p, starts[k]))
                for i in range(lo[j], hi[j]):
                    if q0 + i >= 0:
                        y = min(h[i] - 1.0, (1.0 - slew) * y + slew * (h[i] - 1.0))
                        y_all[i] = y
                p = _compose(tuple(v[j] for v in f), p)
            first = 0
            for l in plan["boxes"]:  # each thread's share of m fixed for every layer
                start = first
                first += l - 1
                local = np.zeros(m)
                tots = np.zeros(threads)
                for j in range(threads):
                    u0 = max(lo[j], start)
                    if hi[j] > u0:
                        local[u0:hi[j]] = np.cumsum(y_all[u0:hi[j]])
                        tots[j] = local[hi[j] - 1]
                offs = np.concatenate([[0.0], np.cumsum(tots)[:-1]])
                pre = lambda u: offs[u // q] + local[u]  # noqa: E731
                new = y_all.copy()
                for u in range(first, m):
                    back = 0.0 if u - l < start else pre(u - l)
                    new[u] = (pre(u) - back) / l
                y_all = new
            out[b, t0:t1] = np.minimum(y_all[hbox:m] + 1.0, 1.0)
    return out


def _lufs_items(rng, sr, shapes):
    """[(key, wavs (C, n) f32, sr)]: noise and a tone, with a quiet stretch."""
    items = []
    for k, (c, n, amp) in enumerate(shapes):
        t = np.arange(n) / sr
        w = amp * (0.3 * rng.standard_normal((c, n)) + np.sin(2 * np.pi * 997.0 * t))
        w[:, n // 3: n // 2] *= 1e-3
        items.append((k, w.astype(np.float32), sr))
    return items


def _padded(items):
    n_ch = max(w.shape[0] for _k, w, _sr in items)
    length = max(w.shape[1] for _k, w, _sr in items)
    rows = np.zeros((len(items), n_ch, length), np.float32)
    for i, (_k, w, _sr) in enumerate(items):
        rows[i, : w.shape[0], : w.shape[1]] = w
    return rows, np.array([w.shape[1] for _k, w, _sr in items], np.int64)


@pytest.mark.parametrize("sr,threads,carry,segments,shapes", [
    (8000, 4, 4, 1, [(2, 9000, 0.5), (2, 6400, 0.2)]),  # one-segment blocks
    (16000, 8, 16, 2, [(1, 17599, 0.7), (1, 6400, 0.1)]),  # a row one gating block long
    (44100, 8, 16, 1, [(6, 26000, 0.3)]),  # surround channels
    (48000, 4, 8, 3, [(2, 21000, 0.4), (2, 19201, 0.9)]),
])
def test_lufs_model_matches_jax(sr, threads, carry, segments, shapes):
    items = _lufs_items(np.random.default_rng(sr), sr, shapes)
    rows, ns = _padded(items)
    got = model_lufs(rows, ns, sr, threads, carry, segments)
    want = jax_dev.lufs_stats_batched(items)
    for (k, _w, _sr), (lufs, sq, pk) in zip(items, got):
        w_lufs, w_sq, w_pk = want[k]
        assert (np.isinf(lufs) and np.isinf(w_lufs)) or abs(lufs - w_lufs) < 1e-9
        assert abs(sq - w_sq) <= 1e-12 * w_sq
        assert pk == w_pk


@pytest.mark.parametrize("sr,chunk,threads,n_ch,amps", [
    (8000, 37, 8, 2, (2.5, 0.7)),  # halos (199 samples) span several chunks
    (8000, 256, 4, 1, (4.0,)),
    (16000, 1024, 16, 3, (1.5, 3.0, 0.2)),
])
def test_limiter_model_matches_jax(sr, chunk, threads, n_ch, amps):
    rng = np.random.default_rng(chunk)
    n = 5000
    wavs = (rng.uniform(-1, 1, (n_ch, n)) * np.array(amps)[:, None]).astype(np.float32)
    wavs[0, 1200:1300] = 0.0
    if n_ch > 1:
        wavs[1, 2000] = np.nan  # ignored by the channel max
    want = jax_dev.limiter_gain_seqs_batched([(0, wavs, sr)])[0]
    attack = int(np.floor(5.0 * sr / 1000.0 + 0.5))
    hold = int(np.floor(20.0 * sr / 1000.0 + 0.5))
    boxes = tuple(max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3)))
    length = n + attack + 1
    rows = np.zeros((1, n_ch, length), np.float32)
    rows[0, :, :n] = wavs
    got = model_limiter(rows, 1.0, 1.0 / (40.0 * sr / 1000.0 + 1.0), hold, boxes, threads, chunk)
    assert got.shape == (1, length)
    np.testing.assert_allclose(got[0, attack:attack + n], want, rtol=0, atol=1e-9)
    assert want.min() < 0.5


@pytest.mark.parametrize("sr", [16000, 48000])
def test_weight_table_ends_runs_as_the_recurrence(sr):
    """k9_sums' decomposition: a run's end state from zero by the weights
    W[k] = M^k g, and a block's end state by the runs aligned to its end
    scanned with the powers of M^run, against the 4-state recurrence, for
    runs up to the block (the 48 kHz block is 9600 samples), within 1e-12 of
    the state's size."""
    plan = kdyn.k9_plan(sr)
    coef, table = kdyn.k9_tables(sr)
    run, ch = plan["run"], plan["chunk"]
    weights = table[:4 * run].reshape(run, 4)
    m, g = kdyn.k9_matrix(coef)
    x = np.random.default_rng(sr).standard_normal(ch)
    states = np.zeros((ch + 1, 4))
    for t in range(ch):
        states[t + 1] = m @ states[t] + g * x[t]
    for n in (1, 2, run // 2, run):  # a run from zero, the short last one's offset
        end = _weighted_ends(weights, x[None, :run], np.array([n]))[0]
        np.testing.assert_allclose(end, states[n], rtol=0, atol=1e-12 * np.abs(states[n]).max())
    for nb in (run, 5 * run + 3, ch // 2 + 1, ch):  # blocks up to the whole chunk
        # a block's samples from zero: its own recurrence
        ref = np.zeros(4)
        for v in x[:nb]:
            ref = m @ ref + g * v
        end = _block_end(table, run, plan["threads"], x[:nb])
        np.testing.assert_allclose(end, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("hold", [1, 2, 960])
def test_gain_of_the_sliding_max_is_the_sliding_min_of_gains(hold):
    """K8's hold: the gain of the max level over the window (hold_max over
    f32 channel maxima, -inf before t = 0) is bitwise today's sliding min of
    the f64 gains (+inf before t = 0), on rows with NaN channels, a silent
    stretch and levels at the threshold."""
    rng = np.random.default_rng(hold)
    thr = 1.0
    n = 20000
    wavs = (rng.uniform(-1, 1, (2, 3, n)) * np.array([2.5, 0.8, 1.2])[None, :, None]) \
        .astype(np.float32)
    wavs[:, :, 3000:7000] = 0.0  # silence
    wavs[0, 1, ::97] = np.nan  # ignored by the channel max
    wavs[1, :, 11000:11050] = np.nan  # every channel NaN: level -inf, gain 1
    wavs[0, 0, 15000:15020] = np.float32(thr)  # at the threshold: gain 1
    wavs[0, 0, 15020:15040] = np.nextafter(np.float32(thr), np.float32(2))
    wavs[1, 2, 16000:16040] = np.nextafter(np.float32(thr), np.float32(0))
    rows = torch.from_numpy(wavs)
    a = rows.abs()
    v = torch.where(torch.isnan(a), -torch.inf, a).amax(dim=1).to(torch.float64)
    raw = torch.where(v > thr, thr / (v + np.finfo(np.float64).eps), torch.ones((), dtype=torch.float64))
    want = port_dev._sliding_min(raw, hold).numpy()
    lv = np.where(np.isnan(wavs), np.float32(-np.inf), np.abs(wavs)).max(axis=1)
    for b in range(2):
        padded = np.concatenate([np.full(hold - 1, -np.inf, np.float32), lv[b]])
        got = _gain(hold_max(padded, hold, kdyn.THREADS)[hold - 1:], thr)
        assert got.tobytes() == want[b].tobytes()
    assert (want < 1.0).any() and (want == 1.0).any()


def test_hist_bin_is_searchsorted():
    """k9_tail's histogram bin (an f32 log2 estimate moved to the exact bin)
    equals searchsorted(bounds, z, right) - 1 clipped to [0, 999], at and
    around every boundary and over the whole range."""
    b = HIST_BOUNDARIES
    z = np.concatenate([b, np.nextafter(b, 0), np.nextafter(b, np.inf), b * 1.01, b * 0.99,
                        np.geomspace(b[0], 1e6, 5000), [1e300, np.inf]])
    z = z[z >= b[0]]
    want = np.clip(np.searchsorted(b, z, side="right") - 1, 0, 999)
    assert [hist_bin(v) for v in z] == want.tolist()


def test_phase_profile_marks_every_phase_of_the_kernels():
    """tools/profile_dynamics_phases.py counts cycles at csrc/dynamics.cu's
    own PHASE marks: each phase it names is marked once, each kernel that
    marks phases starts its clock, and a source without marks is refused."""
    from thesia_tpu_torch.tools import profile_dynamics_phases as phases

    src = (build.CSRC_DIR / "dynamics.cu").read_text()
    text = phases.instrumented_source(src)
    assert "g_phase_cycles" in text and "thesia_phase_cycles" in text
    for i in phases.PHASES:
        assert src.count(f"PHASE({i})") == 1, i
    kernels = {kernel for kernel, _phase in phases.PHASES.values()}
    assert src.count("PHASE_BEGIN\n") == len(kernels) + 1  # and the empty macro's definition
    with pytest.raises(ValueError, match="marks no phases"):
        phases.instrumented_source("#include <stdint.h>\nnamespace {\n")


# -- routing ---------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    rng = np.random.default_rng(1)
    rows = torch.from_numpy((0.3 * rng.standard_normal((2, 2, 8000))).astype(np.float32))
    ns = torch.tensor([8000, 6000])
    kdyn.reset_launches()
    got = kdyn.lufs_stats(rows, ns, 16000)
    want = port_dev.lufs_program(rows, ns, 16000)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gain = kdyn.limiter_gain(rows * 4, 1.0, 0.02, hold_length=320, box_lengths=(30, 26, 25))
    assert torch.equal(gain, port_dev.limiter_gain_program(rows * 4, 1.0, 0.02, hold_length=320,
                                                           box_lengths=(30, 26, 25)))
    assert kdyn.lufs_stats.launches == kdyn.limiter_gain.launches == 0  # nothing launched
    calls = []
    monkeypatch.setattr(port_dev, "lufs_program", lambda *a: calls.append(a) or "plain")
    assert kdyn.lufs_stats(rows, ns, 16000) == "plain" and len(calls) == 1


@pytest.mark.parametrize("change,error", [
    ("f64", "float32"), ("2d", "float32"), ("strided", "contiguous"), ("meta", "no kernel"),
])
def test_wrappers_raise_on_what_the_kernels_do_not_take(change, error):
    rows = torch.zeros((1, 2, 100))
    rows = {"f64": rows.double(), "2d": rows[0], "strided": rows[:, :, ::2],
            "meta": rows.to("meta")}[change]
    for call in (lambda: kdyn.lufs_stats(rows, torch.tensor([100]), 8000),
                 lambda: kdyn.limiter_gain(rows, 1.0, 0.1, hold_length=3, box_lengths=())):
        with pytest.raises(ValueError, match=error):
            call()


def _fake_cuda_rows(shape):
    dev = torch.device("cuda", 0)
    return types.SimpleNamespace(device=dev, dtype=torch.float32, shape=torch.Size(shape),
                                 dim=lambda: len(shape), is_contiguous=lambda: True)


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrappers launch the kernel for a CUDA tensor or raise: with no
    library, the build's error comes out and the plain versions never run."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def no_library():
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(port_dev, "lufs_program", boom)
    monkeypatch.setattr(port_dev, "limiter_gain_program", boom)
    monkeypatch.setattr(build, "library", no_library)
    rows = _fake_cuda_rows((1, 2, 4000))
    ns = types.SimpleNamespace(device=rows.device, dtype=torch.int64, shape=(1,),
                               is_contiguous=lambda: True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kdyn.lufs_stats(rows, ns, 8000)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kdyn.limiter_gain(rows, 1.0, 0.1, hold_length=160, box_lengths=(14, 13, 13))


def test_limiter_kernel_takes_no_negative_threshold(monkeypatch):
    """Its hold takes the gain of the max level, which holds for thresholds
    >= 0 (gains fall as the level rises): a CUDA tensor with another
    threshold raises before any launch."""
    monkeypatch.setattr(build, "library", lambda: pytest.fail("no launch expected"))
    rows = _fake_cuda_rows((1, 2, 4000))
    for thr in (-1.0, float("nan")):
        with pytest.raises(ValueError, match="threshold >= 0"):
            kdyn.limiter_gain(rows, thr, 0.1, hold_length=160, box_lengths=(14, 13, 13))


def test_a_failing_kernel_propagates_through_the_session(monkeypatch, tmp_path):
    """stats_device has no fallback around the wrappers: a failing K9 fails
    the add, a failing K8 the Limiter switch (which rolls back)."""
    from thesia_tpu_torch.dynamics.guard import GuardClippingMode
    from thesia_tpu_torch.dynamics.normalize import NormalizeTarget
    from thesia_tpu_torch.engine.track import TrackList
    from thesia_tpu_torch.io.wav import encode_wav_f32

    rng = np.random.default_rng(3)
    paths = []
    for i, (c, n) in enumerate([(2, 12000), (1, 9000)]):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(rng.uniform(-0.5, 0.5, (c, n)).astype(np.float32), 8000))
        paths.append(str(p))

    def failed(name):
        def launch(*a, **k):
            raise RuntimeError(f"{name} kernel launch failed: CUDA error 700")
        return launch

    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    monkeypatch.setattr(kdyn, "lufs_stats", failed("lufs_stats"))
    with pytest.raises(RuntimeError, match="lufs_stats kernel launch failed"):
        TrackList("cpu").add_tracks([0, 1], paths)
    monkeypatch.undo()
    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    tl = TrackList("cpu")
    assert tl.add_tracks([0, 1], paths) == [0, 1]
    tl.common_guard_clipping = GuardClippingMode.Limiter
    monkeypatch.setattr(kdyn, "limiter_gain", failed("limiter_gain"))
    with pytest.raises(RuntimeError, match="limiter_gain kernel launch failed"):
        tl.set_common_normalize(NormalizeTarget("LUFS", 3.0))


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lufs_close(a, b):
    return (math.isinf(a) and math.isinf(b) and a == b) or abs(a - b) <= 1e-9


def _check_lufs(cuda, items, sr):
    rows, ns = _padded(items)
    rows_t = torch.from_numpy(rows).to(cuda)
    ns_t = torch.from_numpy(ns).to(cuda)
    got = [t.cpu().numpy() for t in kdyn.lufs_stats(rows_t, ns_t, sr)]
    again = [t.cpu().numpy() for t in kdyn.lufs_stats(rows_t, ns_t, sr)]
    want = [t.cpu().numpy() for t in port_dev.lufs_program(rows_t, ns_t, sr)]
    for g, a in zip(got, again):
        assert g.tobytes() == a.tobytes()  # deterministic
    for i in range(len(items)):
        assert _lufs_close(got[0][i], want[0][i]), (i, got[0][i], want[0][i])
        sq_ok = (np.isnan(got[1][i]) and np.isnan(want[1][i])) or \
            abs(got[1][i] - want[1][i]) <= 1e-12 * abs(want[1][i])
        assert sq_ok, (i, got[1][i], want[1][i])
        assert got[2][i] == want[2][i] or (np.isnan(got[2][i]) and np.isnan(want[2][i]))


@pytest.mark.gpu
@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("n_ch", [1, 2, 3, 4, 5, 6])
def test_lufs_kernel_matches_plain_on_the_card(cuda, sr, n_ch):
    plan = kdyn.k9_plan(sr)
    ch, s100 = plan["chunk"], plan["s100"]
    lengths = [4 * s100, ch - 1, ch, ch + 1, 3 * ch + 7, int(2.5 * sr)]
    rng = np.random.default_rng(sr + n_ch)
    items = _lufs_items(rng, sr, [(n_ch, n, a) for n, a in zip(lengths, (0.5, 0.2, 0.9, 0.01,
                                                                         0.3, 0.6))])
    _check_lufs(cuda, items, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("sr", [16000, 48000])
def test_lufs_kernel_edge_signals_on_the_card(cuda, sr):
    n = 3 * sr
    silence = np.zeros((2, n), np.float32)
    quiet = np.full((2, n), 1e-5, np.float32)  # below the absolute gate
    spike = np.zeros((2, n), np.float32)
    spike[1, n // 2] = 1.0
    nan = (0.2 * np.random.default_rng(0).standard_normal((2, n))).astype(np.float32)
    nan[0, n // 3] = np.nan
    items = [(k, w, sr) for k, w in enumerate((silence, quiet, spike, nan))]
    _check_lufs(cuda, items, sr)
    got = kdyn.lufs_stats(torch.from_numpy(_padded(items)[0]).to(cuda),
                          torch.tensor([n] * 4, device=cuda), sr)
    lufs, sq, pk = (t.cpu().numpy() for t in got)
    assert np.isneginf(lufs[:2]).all() and sq[0] == 0.0 and pk[2] == 1.0
    assert np.isnan(sq[3]) and np.isnan(pk[3])  # NaN propagates, as the plain version's


@pytest.mark.gpu
@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("n_ch", [1, 2, 6])
def test_limiter_kernel_matches_plain_on_the_card(cuda, sr, n_ch):
    attack = int(np.floor(5.0 * sr / 1000.0 + 0.5))
    hold = int(np.floor(20.0 * sr / 1000.0 + 0.5))
    boxes = tuple(max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3)))
    ch = kdyn.k8_plan(hold, boxes)["chunk"]
    rng = np.random.default_rng(sr * n_ch)
    for n in (hold // 2, ch - attack - 2, ch - attack - 1, ch - attack, 3 * ch + 11, 2 * sr):
        w = (rng.uniform(-1, 1, (1, n_ch, n + attack + 1)) * 2.5).astype(np.float32)
        w[..., n:] = 0.0
        w[0, 0, n // 4: n // 3] = 0.0
        if n_ch > 1:
            w[0, 1, n // 2] = np.nan
        w[0, -1, n // 5] = 40.0  # a spike
        rows = torch.from_numpy(w).to(cuda)
        args = (1.0, 1.0 / (40.0 * sr / 1000.0 + 1.0))
        got = kdyn.limiter_gain(rows, *args, hold_length=hold, box_lengths=boxes)
        again = kdyn.limiter_gain(rows, *args, hold_length=hold, box_lengths=boxes)
        want = port_dev.limiter_gain_program(rows, *args, hold_length=hold, box_lengths=boxes)
        assert torch.equal(got, again)
        err = float((got - want).abs().max())
        assert err <= 1e-9, (n, err)
        assert not torch.isnan(got).any()


@pytest.mark.gpu
def test_limiter_kernel_silence_and_quiet_on_the_card(cuda):
    rows = torch.zeros((2, 2, 20000), device=cuda)
    rows[1] = 0.5
    got = kdyn.limiter_gain(rows, 1.0, 0.01, hold_length=480, box_lengths=(60, 50, 50))
    assert (got == 1.0).all()


@pytest.mark.gpu
def test_batched_calls_launch_the_kernels_a_constant_number_of_times(cuda):
    """Each K9 group and each K8 group: one wrapper launch, at most six device
    kernels (csrc/dynamics.cu: five and three), whatever the length."""
    from thesia_tpu_torch.tools.profile_dynamics import device_kernels, dynamics_kernels

    rng = np.random.default_rng(2)
    for n in (48000, 480000):
        items = [(0, (0.3 * rng.standard_normal((2, n))).astype(np.float32), 48000),
                 (1, (0.3 * rng.standard_normal((2, n // 2))).astype(np.float32), 48000)]
        rows = torch.from_numpy(_padded(items)[0]).to(cuda)
        ns = torch.tensor([n, n // 2], device=cuda)
        for fn in (lambda: kdyn.lufs_stats(rows, ns, 48000),
                   lambda: kdyn.limiter_gain(rows * 4, 1.0, 0.005, hold_length=960,
                                             box_lengths=(80, 80, 80))):
            fn()
            kernels = dynamics_kernels(device_kernels(fn))
            assert 3 <= len(kernels) <= 6, kernels
    kdyn.reset_launches()
    port_dev.calc_stats_batched(items, cuda)
    assert kdyn.lufs_stats.launches == 1


@pytest.mark.gpu
def test_a_failing_launch_raises_on_the_card(cuda, monkeypatch):
    """A launch the library refuses (more segments a block than its shared
    sums hold) and an error the library reports both raise."""
    rows, ns = torch.zeros((1, 1, 4000), device=cuda), torch.tensor([4000], device=cuda)
    plan, tables = kdyn.k9_plan, kdyn.k9_tables(8000)
    monkeypatch.setattr(kdyn, "k9_plan", lambda sr: {**plan(sr), "segments": 10 ** 6})
    monkeypatch.setattr(kdyn, "k9_tables", lambda sr: tables)
    with pytest.raises(RuntimeError, match="lufs_stats kernel launch failed: CUDA error 1"):
        kdyn.lufs_stats(rows, ns, 8000)
    monkeypatch.undo()
    lib = types.SimpleNamespace(thesia_limiter_gain=lambda *a: 700)
    monkeypatch.setattr(build, "library", lambda: lib)
    with pytest.raises(RuntimeError, match="limiter_gain kernel launch failed: CUDA error 700"):
        kdyn.limiter_gain(rows, 1.0, 0.1, hold_length=160, box_lengths=(14, 13, 13))
