"""K9 (LUFS + stats) and K8 (limiter gains) as CUDA kernels
(thesia_tpu_torch/kernels/dynamics.py, csrc/dynamics.cu).

On the CPU:

* the host tables the kernels read: the biquads' coefficients against the
  plain version's ``_affine_from_biquad``, the cascade's matrix against the
  two biquads run one after the other, the powers of M, the schedules;
* numpy models of the kernels' chunk-and-carry decomposition (threads of S
  samples scanned with the powers M^(S 2^i), blocks carried with M^(ch 2^i);
  K8's chunks with their hold and box halos, (A, B, C) maps carried across
  chunks), built from those tables with small chunks so that every carry
  crosses many of them, held against the JAX package's ``_lufs_kernel`` and
  ``_limiter_gain_kernel`` at 1e-9 (run on the CPU as
  tests/test_torch_dynamics.py runs them);
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


@pytest.mark.parametrize("sr", RATES)
def test_power_ladders(sr):
    plan = kdyn.k9_plan(sr)
    tables = kdyn.k9_tables(sr)
    steps = kdyn.THREADS.bit_length() - 1
    assert tables.shape == (10 + 2 * steps * 16,) and not tables.flags.writeable
    m, _g = kdyn.k9_matrix(tables[:10])
    tpow = tables[10:10 + 16 * steps].reshape(steps, 4, 4)
    bpow = tables[10 + 16 * steps:].reshape(steps, 4, 4)
    for ladder, base in ((tpow, plan["sub"]), (bpow, plan["chunk"])):
        for i in range(steps):
            # another order of products; as maps of states of size 1 (a
            # carry's) the two agree to a few ulp, whatever the power's size
            want = np.linalg.matrix_power(m, base << i)
            assert np.abs(ladder[i] - want).max() <= 1e-15 + 1e-12 * np.abs(want).max()
        for i in range(steps - 1):
            assert np.array_equal(ladder[i + 1], ladder[i] @ ladder[i])
    # the high-pass pole near 1 decays slowly: M^S is far from zero
    assert np.abs(tpow[0]).max() > 0.5


@pytest.mark.parametrize("sr", [100, 150, 160, 8000, 11025, 44100, 48000, 96000, 192000])
def test_k9_plan(sr):
    plan = kdyn.k9_plan(sr)
    s100 = (sr + 5) // 10
    assert plan["s100"] == s100 and plan["win"] == 4 * s100
    assert plan["sub"] in kdyn.K9_SUBS and plan["sub"] <= s100
    assert plan["sub"] == 16 or 2 * plan["sub"] > s100  # the largest that fits
    assert 1 <= plan["segments"] <= kdyn.K9_MAX_SEGMENTS
    assert plan["chunk"] == plan["segments"] * s100
    with pytest.raises(ValueError, match="no 100 ms segment"):
        kdyn.k9_plan(4)


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000, 96000, 192000, 384000])
def test_k8_plan_fits_shared_memory(sr):
    attack = int(np.floor(5.0 * sr / 1000.0 + 0.5))
    hold = int(np.floor(20.0 * sr / 1000.0 + 0.5))
    boxes = [max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3))]
    plan = kdyn.k8_plan(hold, boxes)
    assert plan["hbox"] == attack - 1  # the box stack's delay
    assert plan["chunk"] % kdyn.THREADS == 0 and plan["chunk"] >= 1024
    assert plan["span"] == plan["chunk"] + plan["hbox"] + hold - 1
    assert plan["smem_bytes"] == 16 * plan["span"] <= kdyn.K8_SMEM_LIMIT
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


def _scan4(e, pw):
    """Hillis-Steele inclusive scan of (T, 4) with pw[l] = P^(2^l)."""
    for l in range(pw.shape[0]):
        d = 1 << l
        e = np.concatenate([e[:d], e[d:] + e[:-d] @ pw[l].T])
    return e


def model_lufs(wavs, ns, sr, threads, sub, segments):
    """K9 as csrc/dynamics.cu runs it, from kdyn's tables: (lufs, sum_sq, peak)."""
    plan = kdyn.k9_plan(sr, threads, sub, segments)
    tables = kdyn.k9_tables(sr, threads, sub, segments)
    steps = threads.bit_length() - 1
    coef = tables[:10]
    tpow = tables[10:10 + 16 * steps].reshape(steps, 4, 4)
    bpow = tables[10 + 16 * steps:].reshape(steps, 4, 4)
    s100, S, ch = plan["s100"], plan["sub"], plan["chunk"]
    n_items, n_ch, _length = wavs.shape
    out = []
    for b in range(n_items):
        n = int(ns[b])
        nb = -(-n // ch)
        segs, sq, pk = [], 0.0, np.float32(0.0)
        for c in range(n_ch):
            x = wavs[b, c, :n].astype(np.float64)
            sq += float(np.sum(x * x))
            pk = max(pk, np.abs(wavs[b, c, :n]).max(initial=np.float32(0.0)))

            def block(k, start, pass2):
                b0, b1 = k * ch, min(k * ch + ch, n)
                R = start.copy()
                acc = np.zeros(plan["segments"])
                for q0 in range(b0, b1, threads * S):
                    ln = min(threads * S, b1 - q0)
                    xs = np.zeros(threads * S)
                    xs[:ln] = x[q0:q0 + ln]
                    xs = xs.reshape(threads, S)
                    cnt = np.clip(ln - np.arange(threads) * S, 0, S)
                    _z, e = _k_run(coef, xs, cnt, np.zeros((threads, 4)))
                    e[0] += tpow[0] @ R
                    e = _scan4(e, tpow)
                    st = np.concatenate([R[None], e[:-1]])
                    z, ends = _k_run(coef, xs, cnt, st)
                    R = ends[(ln - 1) // S]
                    if pass2:
                        pos = q0 - b0 + np.arange(ln)
                        np.add.at(acc, pos // s100, (z.reshape(-1)[:ln]) ** 2)
                return R, acc

            ends = [block(k, np.zeros(4), False)[0] for k in range(nb)]
            starts = [np.zeros(4)]
            carry = np.zeros(4)
            for k0 in range(0, nb - 1, threads):
                e = np.zeros((threads, 4))
                for j in range(min(threads, nb - 1 - k0)):
                    e[j] = ends[k0 + j]
                e[0] += bpow[0] @ carry
                e = _scan4(e, bpow)
                starts += list(e[:min(threads, nb - 1 - k0)])
                carry = e[-1]
            seg = np.concatenate([block(k, starts[k], True)[1] for k in range(nb)] or [[]])
            segs.append(seg[: n // s100])
        n_blocks = max((n - 4 * s100) // s100 + 1, 0)
        z = sum((_SURROUND_WEIGHT if c >= 3 else 1.0)
                * (segs[c][:n_blocks] + segs[c][1:n_blocks + 1] + segs[c][2:n_blocks + 2]
                   + segs[c][3:n_blocks + 3]) for c in range(n_ch)) / (4 * s100)
        q = HIST_ENERGIES[np.clip(np.searchsorted(HIST_BOUNDARIES, z, side="right") - 1, 0, 999)]
        m_abs = z >= HIST_BOUNDARIES[0]
        gate = q[m_abs].sum() / max(m_abs.sum(), 1) * _RELATIVE_GATE_FACTOR
        m_rel = m_abs & (q > gate)
        lufs = -0.691 + 10.0 * np.log10(max(q[m_rel].sum() / m_rel.sum(), 1e-300)) \
            if m_rel.any() else -np.inf
        out.append((lufs, sq, float(pk)))
    return out


def _compose(l, e):
    """Maps y -> min(C, A (y - 1) + E) as (A, E, C) arrays, later o earlier;
    C = inf is the identity's cap."""
    (A2, E2, C2), (A1, E1, C1) = l, e
    with np.errstate(invalid="ignore"):
        cc = np.where(np.isinf(C1), np.inf, A2 * (C1 - 1.0) + E2)
    return A2 * A1, A2 * (E1 - 1.0) + E2, np.minimum(C2, cc)


def _scan_tri(f):
    f = tuple(np.asarray(v, np.float64) for v in f)
    d = 1
    while d < f[0].size:
        shifted = tuple(v[:-d] for v in f)
        new = _compose(tuple(v[d:] for v in f), shifted)
        f = tuple(np.concatenate([v[:d], w]) for v, w in zip(f, new))
        d *= 2
    return f


def model_limiter(wavs, threshold, slew, hold_length, box_lengths, threads, chunk):
    """K8 as csrc/dynamics.cu runs it (kdyn.k8_plan's schedule at ``chunk``):
    gain (B, L) f64."""
    plan = kdyn.k8_plan(hold_length, box_lengths, chunk)
    hold, hbox, ch = plan["hold"], plan["hbox"], plan["chunk"]
    n_items, _c, length = wavs.shape
    a = np.abs(wavs)
    v = np.where(np.isnan(a), -np.inf, a).max(axis=1).astype(np.float64)
    raw_all = np.where(v > threshold, threshold / (v + np.finfo(np.float64).eps), 1.0)
    nb = -(-length // ch)
    ra = 1.0 - slew

    def held(b, r0, n):
        t = r0 + np.arange(n)
        src = np.where(t < 0, np.inf, raw_all[b, np.clip(t, 0, length - 1)])
        w = 1
        while 2 * w <= hold:
            dst = src.copy()
            dst[2 * w - 1:] = np.minimum(src[2 * w - 1:], src[w - 1:n - w])
            src, w = dst, 2 * w
        if hold > w:
            rest = hold - w
            dst = src.copy()
            dst[hold - 1:] = np.minimum(src[hold - 1:], src[hold - 1 - rest:n - rest])
            src = dst
        return src[hold - 1:]

    def shares(m):
        q = -(-m // threads)
        lo = np.minimum(np.arange(threads) * q, m)
        return lo, np.minimum(lo + q, m), q

    def thread_maps(hv, q0, m):
        lo, hi, q = shares(m)
        f = (np.ones(threads), np.ones(threads), np.full(threads, np.inf))
        for i in range(q):
            idx = lo + i
            on = (idx < hi) & (q0 + idx >= 0)
            h = hv[np.minimum(idx, m - 1)]
            g = _compose((np.full(threads, ra), slew * (h - 1.0) + 1.0, h), f)
            f = tuple(np.where(on, gv, fv) for gv, fv in zip(g, f))
        return f

    out = np.zeros((n_items, length))
    for b in range(n_items):
        tri = []
        for k in range(nb - 1):
            p0 = k * ch - hbox
            hv = held(b, p0 - (hold - 1), ch + hold - 1)
            f = _scan_tri(thread_maps(hv, p0, ch))
            tri.append(tuple(v[-1] for v in f))
        starts = [1.0]
        carry = 1.0
        for k0 in range(0, nb - 1, threads):
            part = tri[k0:k0 + threads]
            part += [(1.0, 1.0, np.inf)] * (threads - len(part))
            f = _scan_tri(tuple(np.array(v) for v in zip(*part)))
            ys = np.minimum(f[2], f[0] * (carry - 1.0) + f[1])
            starts += list(ys[:min(threads, nb - 1 - k0)])
            carry = ys[-1]
        for k in range(nb):
            t0, t1 = k * ch, min(k * ch + ch, length)
            q0 = t0 - hbox
            m = t1 - q0
            hv = held(b, q0 - (hold - 1), t1 - q0 + hold - 1).copy()
            f = _scan_tri(thread_maps(hv, q0, m))
            y0 = starts[k]
            lo, hi, q = shares(m)
            y = np.concatenate([[y0], np.minimum(f[2][:-1], f[0][:-1] * (y0 - 1.0) + f[1][:-1])])
            for i in range(q):
                idx = lo + i
                on = idx < hi
                ii = np.minimum(idx, m - 1)
                h = hv[ii]
                y = np.where(on & (q0 + idx >= 0), np.minimum(h, y + slew * (h - y)), y)
                hv[ii[on]] = np.where(q0 + idx >= 0, y, 1.0)[on]
            src = hv
            first = 0
            for l in plan["boxes"]:
                first += l - 1
                dst = np.zeros(m)
                i0, i1, q = shares(m - first)
                i0, i1 = i0 + first, i1 + first
                s = np.array([src[i - l + 1:i + 1].sum() if i < j else 0.0
                              for i, j in zip(i0, i1)])
                for i in range(q):
                    idx = i0 + i
                    on = idx < i1
                    ii = np.minimum(idx, m - 1)
                    if i:
                        s = np.where(on, s + (src[ii] - src[ii - l]), s)
                    dst[ii[on]] = (s / l)[on]
                src = dst
            out[b, t0:t1] = np.minimum(src[hbox:m], 1.0)
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


@pytest.mark.parametrize("sr,threads,sub,segments,shapes", [
    (8000, 4, 4, 1, [(2, 9000, 0.5), (2, 6400, 0.2)]),  # one-segment blocks
    (16000, 8, 16, 2, [(1, 17599, 0.7), (1, 6400, 0.1)]),  # a row one gating block long
    (44100, 8, 16, 1, [(6, 26000, 0.3)]),  # surround channels
    (48000, 4, 8, 3, [(2, 21000, 0.4), (2, 19201, 0.9)]),
])
def test_lufs_model_matches_jax(sr, threads, sub, segments, shapes):
    items = _lufs_items(np.random.default_rng(sr), sr, shapes)
    rows, ns = _padded(items)
    got = model_lufs(rows, ns, sr, threads, sub, segments)
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
    kernels (csrc/dynamics.cu: four and three), whatever the length."""
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
