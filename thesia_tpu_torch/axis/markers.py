"""Axis tick/label computation for time, frequency, amplitude and dB axes.

Host copy of ``thesia_tpu/axis/markers.py`` (statement for statement; the
port imports nothing of the JAX package).  ``tests/test_torch_axis.py`` pins
the two against each other.

Port of the reference's WASM axis module semantics (reference:
src-wasm/src/axis.rs) — the viewer calls these over the service API instead
of a WASM module.  Markers are (position, label) pairs; position is a 0..1
fraction along the axis (time axis: fraction of the visible range; the final
element is a sentinel (i32::MIN, format_display)).
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..common.freqscale import FreqScale
from ..common.melscale import MEL_DIFF_2K_1K, MIN_LOG_MEL, hz_to_mel, mel_to_hz

POSSIBLE_TEN_UNITS = [10, 20, 50, 100]
I32_MIN = -2147483648


# ---------------------------------------------------------------------------
# Rust-compatible float formatting helpers


def _rust_display_f32(value: float) -> str:
    """Rust's `{}` for f32: shortest decimal that round-trips f32;
    integer-valued floats print without a decimal point."""
    v32 = np.float32(value)
    if np.isnan(v32):
        return "NaN"
    if np.isinf(v32):
        return "inf" if v32 > 0 else "-inf"
    # shortest positional decimal that round-trips f32 (Rust Display never
    # switches to scientific notation)
    s = np.format_float_positional(v32, unique=True, trim="-")
    if s.endswith("."):
        s = s[:-1]
    return s


_MAX_TICKS = 10_000  # far beyond any viewport; bounds loops and payloads


def _require(cond: bool, msg: str) -> None:
    """Axis inputs come straight from HTTP bodies: ValueError -> clean 400."""
    if not cond:
        raise ValueError(msg)


def _rust_exp_format(value: float, precision: int | None) -> str:
    """Rust `{:e}` / `{:.*e}`: mantissa 'e' exponent, exponent unpadded and
    unsigned when positive."""
    if value == 0.0:
        mant, exp = 0.0, 0
    else:
        exp = math.floor(math.log10(abs(value)))
        mant = value / 10.0**exp
        # correct boundary drift
        if abs(mant) >= 10.0:
            mant /= 10.0
            exp += 1
        elif abs(mant) < 1.0:
            mant *= 10.0
            exp -= 1
    if precision is None:
        m = _rust_display_f32(mant)
    else:
        m = f"{mant:.{precision}f}"
        # fixed-precision rounding can carry the mantissa to 10.xx
        # (9.9999 @ .2 -> "10.00"); Rust's {:.2e} renormalizes to 1.00e+1
        if m.lstrip("-").split(".")[0] == "10":
            mant /= 10.0
            exp += 1
            m = f"{mant:.{precision}f}"
    return f"{m}e{exp}"


def _format_non_finite(value: float) -> str:
    if value == math.inf:
        return "+∞"
    if value == -math.inf:
        return "-∞"
    return "nan"


def _uses_scientific(exponent: int, unit_exponent: int | None) -> bool:
    return exponent <= -3 or (
        exponent > 3 and (unit_exponent is None or unit_exponent > 0)
    )


def format_ticklabel(value: float, unit_exponent: int | None = None) -> str:
    """reference: axis.rs:497-523."""
    if value == 0.0:
        return "0"
    if not math.isfinite(value):
        return _format_non_finite(value)
    exponent = math.floor(math.log10(abs(value)))
    if unit_exponent is not None:
        rounded = (
            _round_half_away(value * 10.0 ** (-unit_exponent)) * 10.0**unit_exponent
        )
        n_effs = max(exponent - unit_exponent, 0)
        if _uses_scientific(exponent, unit_exponent):
            return _rust_exp_format(rounded, n_effs)
        return f"{rounded:.{max(-unit_exponent, 0)}f}"
    if _uses_scientific(exponent, None):
        return _rust_exp_format(float(np.float32(value)), None)
    return _rust_display_f32(value)


def _round_half_away(x: float) -> float:
    if not math.isfinite(x):
        return x  # math.floor(inf) raises; propagate like Rust's round()
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


# ---------------------------------------------------------------------------
# Time axis


def _format_hms(sec_u32: int, milli: int, hms_format: str, milli_format: str) -> str:
    h = sec_u32 // 3600
    m = sec_u32 // 60 % 60
    s = sec_u32 % 60
    if hms_format == "%H:%M:%S":
        out = f"{h:02}:{m:02}:{s:02}"
    elif hms_format == "%M:%S":
        out = f"{m:02}:{s:02}"
    else:
        out = f"{s:02}"
    if milli_format:
        out += f".{milli:03}"
    return out


def calc_time_axis_markers(
    start_sec: float, end_sec: float, tick_unit: float, label_interval: int, max_sec: float
) -> list[tuple[float, str]]:
    """reference: axis.rs:36-107.  Inputs come straight from the HTTP
    body, so validate with ValueErrors (-> 400) and bound the tick loop —
    an absurd (range, tickUnit) pair could otherwise iterate ~1e21 times
    on an executor thread."""
    _require(
        all(math.isfinite(v) for v in (start_sec, end_sec, tick_unit, max_sec)),
        "non-finite time axis parameters",
    )
    _require(tick_unit > 0.0, "tickUnit must be positive")
    # reference asserts start <= end (axis.rs:23): equality arises naturally
    # from a zero-width canvas (pre-layout boot frame) and must not 400
    _require(start_sec <= end_sec, "startSec must be <= endSec")
    _require(label_interval > 0, "labelInterval must be positive")
    first_unit = max(math.ceil(start_sec / tick_unit) - label_interval, 0)
    last_unit = math.ceil(end_sec / tick_unit)
    _require(last_unit - first_unit <= _MAX_TICKS, "tick count out of range")
    label_unit = tick_unit * label_interval
    if max_sec > 3599.0:
        hms_format, hms_display = "%H:%M:%S", "hh:mm:ss"
    elif max_sec > 59.0:
        hms_format, hms_display = "%M:%S", "mm:ss"
    else:
        hms_format, hms_display = "%S", "ss"
    if label_unit > 0.999:
        milli_format, milli_display, n_mod = "", "", 1
    else:
        milli_format = "%.3f"
        if label_unit > 0.099:
            n_mod, milli_display = 100, ".x"
        elif label_unit > 0.009:
            n_mod, milli_display = 10, ".xx"
        else:
            n_mod, milli_display = 1, ".xxx"

    out: list[tuple[float, str]] = []
    if end_sec == start_sec:
        # zero span: there is no position axis to project onto — return
        # just the format sentinel (the Rust f64 division would yield inf
        # positions; nothing can be drawn on a zero-width canvas anyway)
        first_unit = last_unit = 0
    for unit in range(first_unit, last_unit):
        sec = unit * tick_unit
        x = float(np.float32((sec - start_sec) / (end_sec - start_sec)))
        if unit % label_interval > 0:
            out.append((x, ""))
            continue
        sec_floor = int(math.floor(sec))
        milli = int(math.floor(sec * 1000.0)) - sec_floor * 1000
        sec_u32 = sec_floor + milli // 1000
        milli = milli - milli // 1000 * 1000
        milli_q = 0 if not milli_format else milli // n_mod * n_mod
        s = _format_hms(sec_u32, milli_q, hms_format, milli_format)
        if hms_format == "%S" and sec_u32 < 10:
            s = s.replace("0", "", 1)
        if milli_format:
            s = s.rstrip("0").rstrip(".")
        out.append((x, s))
    out.append((float(np.float32(I32_MIN)), hms_display + milli_display))
    return out


# ---------------------------------------------------------------------------
# Frequency axis


def hz_to_label(freq: float) -> str:
    """reference: axis.rs:362-379."""
    if not math.isfinite(freq):
        return _format_non_finite(float(freq))
    freq = max(_round_half_away(float(freq)), 0.0)
    freq_int = int(freq)
    if freq >= 1000.0:
        if freq_int % 1000 == 0:
            return f"{freq_int // 1000}k"
        if freq_int % 100 == 0:
            return f"{freq / 1000.0:.1f}k"
        if freq_int % 10 == 0:
            return f"{freq / 1000.0:.2f}k"
        return f"{freq / 1000.0:.3f}k"
    return f"{freq_int}"


def freq_label_to_hz(label: str) -> float:
    """Accepts '500', '1k', '1K5', '10.5k'. reference: axis.rs:390-413."""
    label = label.strip()
    low_up = label.lower()
    if (
        label.startswith(("k", "-k", "K", "-K", "."))
        or ("k" in label and "K" in label)
    ):
        raise ValueError(f"invalid frequency label: {label}")
    if label.endswith(("k", "K")):
        value = float(label[:-1]) * 1000.0
    elif ("k" in label or "K" in label) and "." not in label:
        value = float(label.replace("k", ".").replace("K", ".")) * 1000.0
    else:
        value = float(label)
    if not value >= 0.0:
        raise ValueError(f"negative frequency: {label}")
    return value


def _coarse_band(fine_band: float) -> float:
    """Snap a raw tick spacing up to a human band: 100/200/500, then whole
    kHz (the tick values the goldens pin: …, 500, 1k, 2k …)."""
    if fine_band <= 100.0:
        return 100.0
    if fine_band <= 200.0:
        return 200.0
    if fine_band <= 500.0:
        return 500.0
    return math.ceil(fine_band / 1000.0) * 1000.0


def _arithmetic_candidates(band: float, above: float, below: float) -> list[float]:
    """Multiples of `band` strictly inside (above, below) — the open
    interval left once the endpoint labels' collision margins are carved
    out.  band is always a float-exact integer (see _coarse_band), so
    k*band carries no accumulation error."""
    out = []
    k = 1
    while band * k < below:
        if band * k > above:
            out.append(band * k)
        k += 1
    return out


def _mel_octave_candidates(
    ratio_step: int, min_mel: float, max_mel: float, margin_mel: float
) -> list[tuple[float, float]]:
    """Geometric candidate series 1000*r^k Hz (k >= 1) with its mel
    coordinate, kept strictly inside the margin-carved mel interval.  The
    series is bounded above by the top margin, then filtered against the
    bottom one (candidates below 1 kHz don't exist: the sub-1k region is
    arithmetic)."""
    out = []
    freq = 1000.0
    while True:
        freq *= ratio_step
        mel = float(hz_to_mel(np.float32(freq)))
        if mel >= max_mel - margin_mel:
            return [(f, m) for f, m in out if m > min_mel + margin_mel]
        out.append((freq, mel))


def calc_freq_axis_markers(
    hz_range: tuple[float, float],
    freq_scale: FreqScale,
    max_num_ticks: int,
    max_num_labels: int,
    max_track_hz: float | None = None,
) -> list[tuple[float, str]]:
    """Frequency-axis markers: endpoint labels plus tick candidates kept
    clear of them by a 0.66-fine-band collision margin.

    Behavioral spec (pinned by the golden tick tables in
    tests/test_axis.py; reference behavior: src-wasm/src/axis.rs:132-218):

    * the endpoints of the (possibly max_track_hz-clamped) range are always
      labeled, low at position 1.0 (bottom), high at 0.0 (top);
    * linear scale — or a mel view that never reaches above 1 kHz — places
      arithmetic ticks at multiples of a human band (100/200/500/N·1000 Hz)
      snapped up from the raw spacing range/(max_ticks-1);
    * mel scale above 1 kHz splits at the 1 kHz scale knee: below it,
      arithmetic ticks in Hz (only when they'd be readable: >= 4 ticks and
      a fine band no wider than half the 0..1k mel span); above it, octave
      ticks 1k·r^k where r doubles until consecutive ticks are at least a
      fine band apart in mel;
    * the 1 kHz knee itself is always labeled when visible — and when the
      low endpoint sits within 0.66 fine bands below 1 kHz the knee label
      REPLACES the endpoint label (two labels that close would collide; the
      margin also guarantees no sub-1k tick survives in that case);
    * every candidate must clear both endpoint labels by 0.66 fine bands
      (in Hz for arithmetic ticks, in mel for octave ticks).

    The RAW range is validated first, THEN the upper bound clamps to
    max_track_hz (the reverse order turned a low-sample-rate track with a
    retained high zoom into an assertion failure instead of markers)."""
    _require(
        all(math.isfinite(v) for v in (*hz_range, max_track_hz or 0.0)),
        "non-finite frequency axis parameters",
    )
    _require(hz_range[0] < hz_range[1], "hzRangeMin must be < hzRangeMax")
    _require(0 < max_num_ticks <= _MAX_TICKS, "maxNumTicks out of range")
    _require(0 < max_num_labels <= _MAX_TICKS, "maxNumLabels out of range")
    if max_track_hz is not None:
        hz_range = (hz_range[0], min(hz_range[1], max_track_hz))
    if not hz_range[0] < hz_range[1]:
        # the clamp closed the range: serve the endpoint labels instead of
        # running the band loops on an inverted interval
        return [(1.0, hz_to_label(hz_range[0])), (0.0, hz_to_label(hz_range[1]))]
    lo, hi = hz_range
    result: list[tuple[float, str]] = [(1.0, hz_to_label(lo))]

    if max_num_ticks >= 3:
        if freq_scale is FreqScale.Mel and hi > 1000.0:
            min_mel = float(hz_to_mel(np.float32(lo)))
            max_mel = float(hz_to_mel(np.float32(hi)))
            mel_interval = max_mel - min_mel
            mel_1k = float(MIN_LOG_MEL)  # the scale knee's exact mel coord
            fine_band_mel = mel_interval / (max_num_ticks - 1.0)

            def pos_of(mel: float) -> float:
                return float(np.float32((max_mel - mel) / mel_interval))

            # -- below the knee: arithmetic ticks in Hz + the 1 kHz anchor
            if lo < 1000.0:
                fine_band_hz = float(mel_to_hz(np.float32(fine_band_mel)))
                margin_hz = fine_band_hz * 0.66
                sub_1k: list[float] = []
                if max_num_ticks >= 4 and fine_band_mel <= mel_1k / 2.0:
                    sub_1k = _arithmetic_candidates(
                        _coarse_band(fine_band_hz), lo + margin_hz, 1000.0 - margin_hz
                    )
                # knee-vs-endpoint collision: lo within the margin below
                # 1 kHz (and not at the axis origin) -> the 1 kHz label
                # replaces the low-endpoint label.  No sub-1k candidate can
                # exist then (the interval (lo+margin, 1k-margin) is empty).
                if lo > fine_band_hz * 0.33 and 1000.0 <= lo + margin_hz:
                    assert not sub_1k
                    result.pop()
                result.extend(
                    (pos_of(float(hz_to_mel(np.float32(f)))), hz_to_label(f))
                    for f in sub_1k
                )
                result.append((pos_of(mel_1k), hz_to_label(1000.0)))

            # -- above the knee: octave ticks, only if tick budget remains
            if max_num_ticks - len(result) > 1:
                # the smallest power of two whose consecutive ticks sit at
                # least a fine band apart in mel (mel(2k)-mel(1k) is the
                # per-doubling mel step near the knee)
                ratio_step = 2 ** int(max(math.ceil(fine_band_mel / MEL_DIFF_2K_1K), 1.0))
                result.extend(
                    (pos_of(mel), hz_to_label(f))
                    for f, mel in _mel_octave_candidates(
                        ratio_step, min_mel, max_mel, fine_band_mel * 0.66
                    )
                )
        else:
            hz_interval = hi - lo
            fine_band = hz_interval / (max_num_ticks - 1.0)
            margin = fine_band * 0.66
            result.extend(
                (float(np.float32((hi - f) / hz_interval)), hz_to_label(f))
                for f in _arithmetic_candidates(
                    _coarse_band(fine_band), lo + margin, hi - margin
                )
            )

    result.append((0.0, hz_to_label(hi)))
    return result


# ---------------------------------------------------------------------------
# Linear / amp / dB axes


def _calc_linear_axis(lo: float, hi: float, max_num_ticks: int) -> list[tuple[float, str]]:
    """reference: axis.rs:451-480."""
    if max_num_ticks == 2 or lo == -math.inf or hi == math.inf:
        return [(0.0, format_ticklabel(hi)), (1.0, format_ticklabel(lo))]
    if np.float32(hi) == np.float32(lo):
        # span underflows float32 (sub-denormal request): the unit search
        # below would divide by a zero unit — serve the endpoints only
        return [(0.0, format_ticklabel(hi)), (1.0, format_ticklabel(lo))]
    raw_unit = (hi - lo) / (max_num_ticks - 1)
    unit_exponent = math.floor(math.log10(raw_unit))
    chosen = None
    for x in POSSIBLE_TEN_UNITS:
        unit = float(np.float32(x * 10.0 ** (unit_exponent - 1)))
        if unit == 0.0:
            continue  # underflowed candidate
        min_i = math.ceil(np.float32(lo) / np.float32(unit))
        max_i = math.floor(np.float32(hi) / np.float32(unit))
        if max_i + 1 - min_i <= max_num_ticks:
            chosen = (x, unit, min_i, max_i)
            break
    if chosen is None:
        return [(0.0, format_ticklabel(hi)), (1.0, format_ticklabel(lo))]
    ten_unit, unit, min_i, max_i = chosen
    if ten_unit == 100:
        unit_exponent += 1
    out = []
    for i in range(max_i, min_i - 1, -1):
        value = float(np.float32(i * np.float32(unit)))
        y_ratio = float(np.float32((hi - value) / (hi - lo)))
        out.append((y_ratio, format_ticklabel(value, unit_exponent)))
    return out


def _omit_labels(markers, max_num_labels: int):
    """reference: axis.rs:482-495."""
    n = len(markers)
    n_mod = -(-n // max_num_labels)
    out = []
    for i, (y, s) in enumerate(markers):
        if (i % n_mod == 0 and (n - 1 - i) >= n_mod) or i == n - 1:
            out.append((y, s))
        else:
            out.append((y, ""))
    return out


def calc_amp_axis_markers(
    max_num_ticks: int, max_num_labels: int, amp_range: tuple[float, float]
) -> list[tuple[float, str]]:
    """Symmetric around 0. reference: axis.rs:239-284.  ValueErrors, not
    NotImplementedError/bare asserts: these reach the HTTP boundary and
    must map to 400."""
    _require(all(math.isfinite(v) for v in amp_range), "non-finite amp range")
    _require(amp_range[1] > amp_range[0], "ampRange must be increasing")
    _require(3 <= max_num_ticks <= _MAX_TICKS, "maxNumTicks out of range")
    _require(0 < max_num_labels <= _MAX_TICKS, "maxNumLabels out of range")
    _require(
        math.isclose(amp_range[0], -amp_range[1], abs_tol=1.2e-7),
        "amp axis must be symmetric",
    )
    _require(max_num_ticks % 2 == 1, "amp axis needs an odd tick count")
    n_ticks_half = (max_num_ticks - 1) // 2
    half_to_amp0 = _calc_linear_axis(0.0, amp_range[1], n_ticks_half + 1)
    half_from_amp0 = _omit_labels(list(reversed(half_to_amp0)), max_num_labels)
    positive = [(y / 2.0, s) for y, s in reversed(half_from_amp0)]
    negative = [
        (1.0 - y / 2.0, f"-{s}" if s else "") for y, s in half_from_amp0[1:]
    ]
    return positive + negative


def calc_db_axis_markers(
    max_num_ticks: int, max_num_labels: int, db_range: tuple[float, float]
) -> list[tuple[float, str]]:
    """reference: axis.rs:307-322 (its wrapper asserts ordering via
    assert_axis_params; a reversed range otherwise leaks a 'math domain
    error' from log10)."""
    if math.isnan(db_range[0]) or math.isnan(db_range[1]):
        return []
    if db_range[0] == db_range[1]:
        return [(1.0, format_ticklabel(db_range[1]))]
    _require(2 <= max_num_ticks <= _MAX_TICKS, "maxNumTicks out of range")
    _require(0 < max_num_labels <= _MAX_TICKS, "maxNumLabels out of range")
    _require(db_range[0] < db_range[1], "dB range must be increasing")
    # bounds check in plain python (np.float32(1e308) emits a RuntimeWarning)
    _f32_max = 3.4028235e38
    _require(
        abs(db_range[0]) <= _f32_max and abs(db_range[1]) <= _f32_max,
        "dB range exceeds float32",
    )
    axis = _calc_linear_axis(db_range[0], db_range[1], max_num_ticks)
    return _omit_labels(axis, max_num_labels)


# ---------------------------------------------------------------------------
# Label/position converters & tooltips


_U32_MAX = 2**32 - 1


def _sat_u32(x: float) -> int:
    """Rust `as u32` float cast: saturating, NaN -> 0."""
    if math.isnan(x):
        return 0
    return int(min(max(x, 0.0), float(_U32_MAX)))


def sec_to_label(sec: float) -> str:
    """Floor-to-ms HH:MM:SS.mmm. reference: axis.rs:325-335.  The Rust
    float->u32 casts SATURATE (negative -> 0, inf -> u32::MAX, NaN -> 0);
    math.floor(inf) would 500 and a negative produced nonsense labels
    (review finding)."""
    sec_floor = _sat_u32(math.floor(sec) if math.isfinite(sec) else sec)
    milli = _sat_u32(
        math.floor(sec * 1000.0 - sec_floor * 1000.0)
        if math.isfinite(sec) else sec
    )
    sec_u32 = min(sec_floor + milli // 1000, _U32_MAX)
    milli = milli - milli // 1000 * 1000
    h, m, s = sec_u32 // 3600, sec_u32 // 60 % 60, sec_u32 % 60
    return f"{h:02}:{m:02}:{s:02}.{milli:03}"


_U32_FIELD_RE = re.compile(r"^\+?\d+$")
_F64_FIELD_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$|^[+-]?(inf|infinity|nan)$",
    re.IGNORECASE,
)


def time_label_to_sec(label: str) -> float:
    """[hh:][mm:]ss.fff. reference: axis.rs:342-360.  Field parsing mirrors
    Rust: hour/minute via u32 (digits only — '-1', ' 30' and '1_0' are
    rejected, Python's int() accepted all three; review finding), the
    seconds field via f64 FromStr (no interior whitespace/underscores)."""
    parts = label.strip().split(":")[::-1]
    if len(parts) > 3:
        raise ValueError(f"invalid time label: {label}")
    if not _F64_FIELD_RE.match(parts[0]):
        raise ValueError(f"invalid time label: {label}")
    total = float(parts[0])
    for i, p in enumerate(parts[1:], start=1):
        if not _U32_FIELD_RE.match(p):
            raise ValueError(f"invalid time label: {label}")
        field = int(p)
        if field > _U32_MAX:  # Rust u32 parse overflows -> Err
            raise ValueError(f"invalid time label: {label}")
        total += field * 60.0**i
    return total


def freq_pos_to_hz(
    freq_scale: FreqScale, y: float, height: int, hz_range: tuple[float, float],
    max_track_hz: float,
) -> float:
    # ValueErrors, not bare asserts: HTTP-reachable and stripped under -O
    _require(height >= 1, "height must be >= 1")
    _require(
        all(math.isfinite(v) for v in (y, hz_range[0], hz_range[1], max_track_hz)),
        "non-finite freq position parameters",
    )
    hz_range = (hz_range[0], min(hz_range[1], max_track_hz))
    rel = 1.0 - y / height
    return freq_scale.relative_freq_to_hz(rel, hz_range)


def freq_hz_to_pos(
    freq_scale: FreqScale, hz: float, height: int, hz_range: tuple[float, float],
    max_track_hz: float,
) -> float:
    _require(height >= 1, "height must be >= 1")
    _require(
        all(math.isfinite(v) for v in (hz, hz_range[0], hz_range[1], max_track_hz)),
        "non-finite freq position parameters",
    )
    hz_range = (hz_range[0], min(hz_range[1], max_track_hz))
    rel = freq_scale.hz_to_relative_freq(hz, hz_range)
    return (1.0 - rel) * height


def _fraction_digits_for_resolution(resolution: float, max_fraction_digits: int) -> int:
    if not math.isfinite(resolution) or resolution <= 0.0:
        return 0
    return min(max(math.ceil(-math.log10(resolution)), 0), max_fraction_digits)


def _normalize_tooltip_zero(value: float, fraction_digits: int) -> float:
    return 0.0 if abs(value) < 0.5 * 10.0 ** (-fraction_digits) else value


def format_linear_axis_tooltip(
    value: float, resolution: float, tick_unit: float, max_fraction_digits: int
) -> str:
    """reference: axis.rs:563-592."""
    fraction_digits = _fraction_digits_for_resolution(resolution, max_fraction_digits)
    value = _normalize_tooltip_zero(value, fraction_digits)
    if value == 0.0 or not math.isfinite(value):
        return format_ticklabel(value)
    value_exponent = math.floor(math.log10(abs(value)))
    tick_unit_exponent = (
        math.floor(math.log10(tick_unit))
        if math.isfinite(tick_unit) and tick_unit > 0.0
        else None
    )
    if _uses_scientific(value_exponent, tick_unit_exponent):
        if math.isfinite(resolution) and resolution > 0.0:
            resolution_exponent = math.floor(math.log10(resolution))
        else:
            resolution_exponent = value_exponent
        sig = min(max(value_exponent - resolution_exponent, 0), max_fraction_digits)
        return _rust_exp_format(value, sig)
    return f"{value:.{fraction_digits}f}"


def format_frequency_axis_tooltip(hz: float, resolution_hz: float) -> str:
    """reference: axis.rs:594-606."""
    _require(math.isfinite(hz) and math.isfinite(resolution_hz), "non-finite tooltip input")
    use_kilo = _round_half_away(hz) >= 1000.0
    scale = 1000.0 if use_kilo else 1.0
    fraction_digits = _fraction_digits_for_resolution(resolution_hz / scale, 6)
    value = _normalize_tooltip_zero(hz / scale, fraction_digits)
    return f"{value:.{fraction_digits}f}" + ("k" if use_kilo else "")


def format_time_axis_tooltip(sec: float, format_display: str) -> str:
    """reference: axis.rs:608-634."""
    _require(math.isfinite(sec), "non-finite tooltip input")
    fraction_digits = (
        len(format_display.split(".", 1)[1]) if "." in format_display else 0
    )
    scale = 10**fraction_digits
    rounded_units = int(_round_half_away(max(sec, 0.0) * scale))
    whole_sec = rounded_units // scale
    fraction = rounded_units - whole_sec * scale
    seconds = whole_sec % 60
    minutes = whole_sec // 60 % 60
    hours = whole_sec // 3600
    fraction_label = f".{fraction:0{fraction_digits}}" if fraction_digits else ""
    if format_display.startswith("hh:"):
        return f"{hours:02}:{minutes:02}:{seconds:02}{fraction_label}"
    if format_display.startswith("mm:"):
        total_minutes = whole_sec // 60
        return f"{total_minutes:02}:{seconds:02}{fraction_label}"
    return f"{seconds}{fraction_label}"


def format_number_label(value: float, fraction_digits: int) -> str:
    if math.isfinite(value):
        return f"{value:.{fraction_digits}f}"
    return _format_non_finite(value)
