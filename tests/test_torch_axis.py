"""The port's axis copies (thesia_tpu_torch/axis, engine/axis_api.py) against
their originals: statement for statement, the goldens of tests/test_axis.py
(reference: src-wasm/src/axis.rs:656-845) on the port's functions, the
hostile-input contract (ValueError, never a crash), and a seeded sweep of
every axis command through both AxisApi classes with equal answers."""

import ast
import importlib
import inspect
import math
import textwrap

import numpy as np
import pytest

from thesia_tpu.engine import axis_api as jax_axis_api
from thesia_tpu_torch.axis import (
    calc_amp_axis_markers,
    calc_db_axis_markers,
    calc_freq_axis_markers,
    calc_time_axis_markers,
    format_frequency_axis_tooltip,
    format_linear_axis_tooltip,
    format_number_label,
    format_time_axis_tooltip,
    freq_hz_to_pos,
    freq_label_to_hz,
    freq_pos_to_hz,
    hz_to_label,
    sec_to_label,
    time_label_to_sec,
)
from thesia_tpu_torch.axis.markers import _rust_exp_format
from thesia_tpu_torch.common.freqscale import FreqScale
from thesia_tpu_torch.common.melscale import MIN_LOG_MEL, hz_to_mel
from thesia_tpu_torch.engine import axis_api as port_axis_api

I32_MIN = -2147483648

COPIES = [
    ("thesia_tpu_torch.axis", "thesia_tpu.axis"),
    ("thesia_tpu_torch.axis.markers", "thesia_tpu.axis.markers"),
    ("thesia_tpu_torch.engine.axis_api", "thesia_tpu.engine.axis_api"),
]


def _code_without_docstrings(mod) -> str:
    tree = ast.parse(textwrap.dedent(inspect.getsource(mod)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("port_name,orig_name", COPIES)
def test_axis_copies_are_the_originals_statement_for_statement(port_name, orig_name):
    port, orig = importlib.import_module(port_name), importlib.import_module(orig_name)
    assert orig_name.replace(".", "/") in port.__doc__
    assert _code_without_docstrings(port) == _code_without_docstrings(orig)


def test_axis_command_table_is_the_originals():
    assert port_axis_api.AXIS_COMMANDS == jax_axis_api.AXIS_COMMANDS
    for method, _args in port_axis_api.AXIS_COMMANDS.values():
        assert callable(getattr(port_axis_api.AxisApi(), method))


def assert_axis_eq(got, expected):
    assert len(got) == len(expected), f"{got} vs {expected}"
    for (y0, s0), (y1, s1) in zip(got, expected):
        assert abs(y0 - y1) < 2e-7, f"{got} vs {expected}"
        assert s0 == s1, f"{got} vs {expected}"


def mel(hz):
    return float(hz_to_mel(np.float32(hz)))


def test_sec_to_label_floor():
    for sec, label in ((1.999, "00:00:01.999"), (1.9991, "00:00:01.999"), (1.9999, "00:00:01.999"),
                       (2.0 - 2.220446049250313e-16, "00:00:01.999"), (2.0, "00:00:02.000")):
        assert sec_to_label(sec) == label


TIME_GOLDENS = [
    ((1.999, 2.0015, 0.0005, 1, 59.0),
     [(-0.2, "1.998"), (0.0, "1.999"), (0.2, "1.999"), (0.4, "2"), (0.6, "2"), (0.8, "2.001"),
      (I32_MIN, "ss.xxx")]),
    ((1.999, 2.001, 0.001, 1, 60.0),
     [(-0.5, "00:01.998"), (0.0, "00:01.999"), (0.5, "00:02"), (I32_MIN, "mm:ss.xxx")]),
]


@pytest.mark.parametrize("args,expected", TIME_GOLDENS)
def test_time_axis(args, expected):
    assert_axis_eq(calc_time_axis_markers(*args), expected)


def _freq_goldens():
    lin, m = FreqScale.Linear, FreqScale.Mel
    return [
        (((0.0, 12000.0), lin, 2, 2), None, [(1.0, "0"), (0.0, "12k")]),
        (((0.0, 12000.0), lin, 8, 8), None,
         [(1.0, "0"), (5 / 6, "2k"), (4 / 6, "4k"), (3 / 6, "6k"), (2 / 6, "8k"), (1 / 6, "10k"),
          (0.0, "12k")]),
        (((0.0, 12000.0), lin, 24, 24), slice(None, 3), [(1.0, "0"), (11 / 12, "1k"), (10 / 12, "2k")]),
        (((0.0, 12000.0), lin, 25, 25), slice(None, 3), [(1.0, "0"), (23 / 24, "500"), (22 / 24, "1k")]),
        (((0.0, 11025.0), lin, 24, 24), slice(20, None),
         [(1.0 - 10000.0 / 11025.0, "10k"), (1.0 - 10500.0 / 11025.0, "10.5k"), (0.0, "11.025k")]),
        (((0.0, 12000.0), m, 2, 2), None, [(1.0, "0"), (0.0, "12k")]),
        (((0.0, 12000.0), m, 3, 3), None, [(1.0, "0"), (1.0 - MIN_LOG_MEL / mel(12000), "1k"), (0.0, "12k")]),
        (((0.0, 1500.0), m, 4, 4), None,
         [(1.0, "0"), (1.0 - mel(500) / mel(1500), "500"), (1.0 - MIN_LOG_MEL / mel(1500), "1k"),
          (0.0, "1.5k")]),
        (((0.0, 12000.0), m, 8, 8), None,
         [(1.0, "0"), (1.0 - mel(500) / mel(12000), "500"), (1.0 - MIN_LOG_MEL / mel(12000), "1k"),
          (1.0 - mel(2000) / mel(12000), "2k"), (1.0 - mel(4000) / mel(12000), "4k"),
          (1.0 - mel(8000) / mel(12000), "8k"), (0.0, "12k")]),
        (((0.0, 48000.0), m, 6, 6), None,
         [(1.0, "0"), (1.0 - MIN_LOG_MEL / mel(48000), "1k"), (1.0 - mel(4000) / mel(48000), "4k"),
          (1.0 - mel(16000) / mel(48000), "16k"), (0.0, "48k")]),
    ]


@pytest.mark.parametrize("case", range(10))
def test_freq_axis(case):
    args, part, expected = _freq_goldens()[case]
    got = calc_freq_axis_markers(*args)
    assert_axis_eq(got if part is None else got[part], expected)


def test_db_axis():
    assert_axis_eq(calc_db_axis_markers(2, 2, (-100.0, 0.0)), [(0.0, "0"), (1.0, "-100")])
    assert_axis_eq(calc_db_axis_markers(3, 3, (-12.0, 0.0)),
                   [(0.0, "0"), (-5.0 / -12.0, "-5"), (-10.0 / -12.0, "-10")])
    assert_axis_eq(calc_db_axis_markers(3, 3, (-2.0, -1.1)),
                   [((-1.5 + 1.1) / (-2.0 + 1.1), "-1.5"), (1.0, "-2.0")])
    assert_axis_eq(calc_db_axis_markers(2, 2, (-math.inf, -math.inf)), [(1.0, "-∞")])
    assert_axis_eq(calc_db_axis_markers(2, 2, (-360.0, -360.0)), [(1.0, "-360")])


def test_amp_axis():
    assert_axis_eq(calc_amp_axis_markers(5, 3, (-1.0, 1.0)),
                   [(0.0, "1.0"), (0.25, "0.5"), (0.5, "0"), (0.75, "-0.5"), (1.0, "-1.0")])


def test_label_parsing():
    assert abs(time_label_to_sec("2.125") - 2.125) < 1e-12
    assert abs(time_label_to_sec("1:02.5") - 62.5) < 1e-12
    assert abs(time_label_to_sec("01:02:03.25") - 3723.25) < 1e-12
    with pytest.raises(ValueError):
        time_label_to_sec("1:2:3:4")
    assert freq_label_to_hz("500") == 500.0
    assert freq_label_to_hz("1k") == 1000.0
    assert freq_label_to_hz("1K5") == 1500.0
    assert freq_label_to_hz("10.5k") == 10500.0
    for bad in ("k1", "-1", "1kK"):
        with pytest.raises(ValueError):
            freq_label_to_hz(bad)


def test_tooltips():
    assert format_time_axis_tooltip(62.125, "mm:ss.xxx") == "01:02.125"
    assert format_time_axis_tooltip(2.0, "ss.xxx") == "2.000"
    assert format_time_axis_tooltip(2.1, "ss.xx") == "2.10"
    assert format_frequency_axis_tooltip(12345.0, 10.0) == "12.35k"
    assert format_frequency_axis_tooltip(440.25, 0.1) == "440.2"
    assert format_linear_axis_tooltip(0.0012, 0.0001, 0.001, 9) == "1.2e-3"
    assert format_linear_axis_tooltip(1.234, 0.01, 0.1, 9) == "1.23"
    assert format_linear_axis_tooltip(-math.inf, 1.0, math.nan, 9) == "-∞"
    assert format_number_label(-12.345, 2) == "-12.35"
    assert format_number_label(0.0, 2) == "0.00"
    assert format_number_label(-math.inf, 2) == "-∞"


def test_axis_inputs_from_http_never_crash():
    """HTTP-reachable hostile inputs raise ValueError (-> 400) or return
    quickly, as in tests/test_axis.py::test_axis_inputs_from_http_never_crash."""
    raising = [
        lambda: calc_time_axis_markers(0.0, 1e15, 1e-6, 2, 10.0),
        lambda: calc_time_axis_markers(1.0, 0.999, 0.5, 2, 10.0),
        lambda: calc_time_axis_markers(0.0, 1.0, 0.0, 2, 10.0),
        lambda: freq_pos_to_hz(FreqScale.Mel, 10.0, 0, (0.0, 8000.0), 8000.0),
        lambda: freq_pos_to_hz(FreqScale.Mel, float("nan"), 100, (0.0, 8000.0), 8000.0),
        lambda: calc_freq_axis_markers((0.0, 1e13), FreqScale.Mel, 10**10, 5, 24000.0),
        lambda: calc_amp_axis_markers(5, 3, (-1.0, 2.0)),
        lambda: calc_amp_axis_markers(4, 3, (-1.0, 1.0)),
        lambda: calc_db_axis_markers(3, 0, (-100.0, 0.0)),
        lambda: calc_db_axis_markers(3, 2, (0.0, -100.0)),
        lambda: calc_db_axis_markers(3, 2, (-1e308, 1e308)),
        lambda: format_time_axis_tooltip(math.inf, "mm:ss.xxx"),
        lambda: format_frequency_axis_tooltip(math.inf, 1.0),
    ] + [lambda bad=bad: time_label_to_sec(bad)
         for bad in ("-1:30", "1: 30", "1_0:30", "+-1:30", "1:30:00:00")]
    for fn in raising:
        with pytest.raises(ValueError):
            fn()
    assert calc_time_axis_markers(1.0, 1.0, 0.5, 2, 10.0)[-1][1] == "ss"
    assert sec_to_label(-0.5) == "00:00:00.000"
    assert sec_to_label(float("nan")) == "00:00:00.000"
    assert ":" in sec_to_label(float("inf"))
    assert time_label_to_sec("-30") == -30.0
    api = port_axis_api.AxisApi()
    assert api.time_label_to_seconds("inf") is None
    assert api.freq_label_to_hz("inf") is None
    assert api.time_label_to_seconds("90") == 90.0
    assert hz_to_label(math.inf) == "+∞"
    assert len(calc_db_axis_markers(5, 3, (0.0, 1e-46))) == 2
    out = calc_freq_axis_markers((5000.0, 20000.0), FreqScale.Mel, 8, 4, 4000.0)
    assert out[0][1] == "5k" and len(out) == 2
    assert freq_hz_to_pos(FreqScale.Linear, 0.0, 100, (0.0, 8000.0), 8000.0) == 100.0


def test_rust_exp_format_renormalizes_carry():
    assert _rust_exp_format(9.9999e-5, 2) == "1.00e-4"
    assert _rust_exp_format(-9.9999e-5, 2) == "-1.00e-4"
    assert _rust_exp_format(9.49e-5, 2) == "9.49e-5"


def _sweep_bodies(seed: int):
    """Axis command bodies from a seed: ordinary viewer inputs and edges."""
    rng = np.random.default_rng(seed)
    scale = lambda: str(rng.choice(["Linear", "Mel"]))  # noqa: E731
    for _ in range(40):
        start = float(rng.uniform(0, 600))
        end = start + float(10 ** rng.uniform(-3, 3))
        yield "calc_time_axis_markers", {"startSec": start, "endSec": end,
                                         "tickUnit": 10.0 ** int(rng.integers(-3, 2)),
                                         "labelInterval": int(rng.integers(1, 6)),
                                         "maxSec": float(rng.choice([59.0, 3600.0, 7200.0]))}
        lo = float(rng.uniform(0, 4000))
        hi = lo + float(rng.uniform(1, 20000))
        track_hz = float(rng.choice([4000.0, 8000.0, 24000.0]))
        yield "calc_freq_axis_markers", {"hzRangeMin": lo, "hzRangeMax": hi, "freqScale": scale(),
                                         "maxNumTicks": int(rng.integers(2, 30)),
                                         "maxNumLabels": int(rng.integers(2, 30)), "maxTrackHz": track_hz}
        yield "calc_dB_axis_markers", {"maxNumTicks": int(rng.integers(2, 12)),
                                       "maxNumLabels": int(rng.integers(1, 12)),
                                       "dBRangeMin": float(rng.uniform(-150, -1)), "dBRangeMax": 0.0}
        yield "calc_amp_axis_markers", {"maxNumTicks": int(rng.choice([3, 5, 7, 9])),
                                        "maxNumLabels": int(rng.integers(2, 6)),
                                        "ampRangeMin": -1.0, "ampRangeMax": 1.0}
        sec = float(rng.uniform(0, 4000))
        yield "seconds_to_label", {"sec": sec}
        yield "time_label_to_seconds", {"label": str(rng.choice(["1:02.5", "90", "x", "inf", "1:2:3"]))}
        yield "hz_to_label", {"freq": float(rng.uniform(0, 30000))}
        yield "freq_label_to_hz", {"label": str(rng.choice(["1k", "10.5k", "500", "k", "inf"]))}
        args = {"freqScale": scale(), "height": int(rng.integers(0, 800)), "hzRangeMin": lo,
                "hzRangeMax": hi, "maxTrackHz": track_hz}
        yield "freq_pos_to_hz", {**args, "y": float(rng.uniform(-10, 800))}
        yield "freq_hz_to_pos", {**args, "hz": float(rng.uniform(0, 24000))}
        yield "format_linear_axis_tooltip", {"value": float(rng.uniform(-2, 2)),
                                             "resolution": 10.0 ** int(rng.integers(-4, 0)),
                                             "tickUnit": None if rng.random() < 0.2 else 0.1,
                                             "maxFractionDigits": int(rng.integers(0, 10))}
        yield "format_frequency_axis_tooltip", {"hz": float(rng.uniform(0, 24000)),
                                                "resolutionHz": float(10 ** rng.uniform(-2, 2))}
        yield "format_time_axis_tooltip", {"sec": sec, "formatDisplay": str(
            rng.choice(["ss.xxx", "mm:ss.xxx", "hh:mm:ss.x", "ss"]))}
        yield "format_number_label", {"value": float(rng.uniform(-100, 100)),
                                      "fractionDigits": int(rng.integers(0, 5))}


def _answer(api, name, body):
    method, arg_names = jax_axis_api.AXIS_COMMANDS[name]
    try:
        return "ok", getattr(api, method)(*[body[a] for a in arg_names])
    except Exception as e:  # noqa: BLE001 -- compared, not handled
        return type(e).__name__, str(e)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_axis_command_answers_as_the_original(seed):
    port, orig = port_axis_api.AxisApi(), jax_axis_api.AxisApi()
    kinds = set()
    for name, body in _sweep_bodies(seed):
        got, want = _answer(port, name, body), _answer(orig, name, body)
        assert got == want, (name, body, got, want)
        kinds.add((name, got[0]))
    assert {n for n, _ in kinds} == set(jax_axis_api.AXIS_COMMANDS)
