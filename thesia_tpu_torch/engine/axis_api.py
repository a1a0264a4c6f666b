"""Axis-math command wrappers for the service.

Host copy of ``thesia_tpu/engine/axis_api.py`` (statement for statement), on
the port's ``axis`` and ``common.freqscale`` copies;
``tests/test_torch_axis.py`` pins the two against each other.

The reference runs axis computation client-side in a WASM module
(reference: src-wasm/src/axis.rs via src/api/wasm-wrapper.ts); here the same
functions are served over the command API so the viewer stays a no-build
static app.
"""

from __future__ import annotations

import math

from ..axis import markers as ax
from ..common.freqscale import FreqScale


class AxisApi:
    def calc_time_axis_markers(self, start_sec, end_sec, tick_unit, label_interval, max_sec):
        return ax.calc_time_axis_markers(start_sec, end_sec, tick_unit, label_interval, max_sec)

    def calc_freq_axis_markers(
        self, hz_range_min, hz_range_max, freq_scale, max_num_ticks, max_num_labels, max_track_hz
    ):
        return ax.calc_freq_axis_markers(
            (hz_range_min, hz_range_max),
            FreqScale(freq_scale),
            max_num_ticks,
            max_num_labels,
            max_track_hz,
        )

    def calc_amp_axis_markers(self, max_num_ticks, max_num_labels, amp_range_min, amp_range_max):
        return ax.calc_amp_axis_markers(max_num_ticks, max_num_labels, (amp_range_min, amp_range_max))

    def calc_db_axis_markers(self, max_num_ticks, max_num_labels, db_range_min, db_range_max):
        return ax.calc_db_axis_markers(max_num_ticks, max_num_labels, (db_range_min, db_range_max))

    def seconds_to_label(self, sec):
        return ax.sec_to_label(sec)

    def time_label_to_seconds(self, label):
        try:
            out = ax.time_label_to_sec(label)
        except ValueError:
            return None
        # Rust f64 parse accepts 'inf'/'nan' — but a non-finite float is not
        # valid JSON (json.dumps emits the bare Infinity literal, which the
        # browser's response.json() rejects); null already means
        # "unparseable" to the viewer (review finding)
        return out if math.isfinite(out) else None

    def hz_to_label(self, freq):
        return ax.hz_to_label(freq)

    def freq_label_to_hz(self, label):
        try:
            out = ax.freq_label_to_hz(label)
        except ValueError:
            return None
        return out if math.isfinite(out) else None

    def freq_pos_to_hz(self, freq_scale, y, height, hz_range_min, hz_range_max, max_track_hz):
        return ax.freq_pos_to_hz(
            FreqScale(freq_scale), y, height, (hz_range_min, hz_range_max), max_track_hz
        )

    def freq_hz_to_pos(self, freq_scale, hz, height, hz_range_min, hz_range_max, max_track_hz):
        return ax.freq_hz_to_pos(
            FreqScale(freq_scale), hz, height, (hz_range_min, hz_range_max), max_track_hz
        )

    def format_linear_axis_tooltip(self, value, resolution, tick_unit, max_fraction_digits):
        # NaN has no JSON encoding: the viewer sends null when the drawn
        # markers had no positive tick gap (wasm-wrapper.ts:147's ?? NaN)
        if tick_unit is None:
            tick_unit = float("nan")
        return ax.format_linear_axis_tooltip(value, resolution, tick_unit, max_fraction_digits)

    def format_frequency_axis_tooltip(self, hz, resolution_hz):
        return ax.format_frequency_axis_tooltip(hz, resolution_hz)

    def format_time_axis_tooltip(self, sec, format_display):
        return ax.format_time_axis_tooltip(sec, format_display)

    def format_number_label(self, value, fraction_digits):
        return ax.format_number_label(value, fraction_digits)


AXIS_COMMANDS = {
    "calc_time_axis_markers": (
        "calc_time_axis_markers",
        ["startSec", "endSec", "tickUnit", "labelInterval", "maxSec"],
    ),
    "calc_freq_axis_markers": (
        "calc_freq_axis_markers",
        ["hzRangeMin", "hzRangeMax", "freqScale", "maxNumTicks", "maxNumLabels", "maxTrackHz"],
    ),
    "calc_amp_axis_markers": (
        "calc_amp_axis_markers",
        ["maxNumTicks", "maxNumLabels", "ampRangeMin", "ampRangeMax"],
    ),
    "calc_dB_axis_markers": (
        "calc_db_axis_markers",
        ["maxNumTicks", "maxNumLabels", "dBRangeMin", "dBRangeMax"],
    ),
    "seconds_to_label": ("seconds_to_label", ["sec"]),
    "time_label_to_seconds": ("time_label_to_seconds", ["label"]),
    "hz_to_label": ("hz_to_label", ["freq"]),
    "freq_label_to_hz": ("freq_label_to_hz", ["label"]),
    "freq_pos_to_hz": (
        "freq_pos_to_hz",
        ["freqScale", "y", "height", "hzRangeMin", "hzRangeMax", "maxTrackHz"],
    ),
    "freq_hz_to_pos": (
        "freq_hz_to_pos",
        ["freqScale", "hz", "height", "hzRangeMin", "hzRangeMax", "maxTrackHz"],
    ),
    "format_linear_axis_tooltip": (
        "format_linear_axis_tooltip",
        ["value", "resolution", "tickUnit", "maxFractionDigits"],
    ),
    "format_frequency_axis_tooltip": (
        "format_frequency_axis_tooltip",
        ["hz", "resolutionHz"],
    ),
    "format_time_axis_tooltip": ("format_time_axis_tooltip", ["sec", "formatDisplay"]),
    "format_number_label": ("format_number_label", ["value", "fractionDigits"]),
}
