"""Axis markers and labels: host copy of ``thesia_tpu/axis/__init__.py``."""

from .markers import (
    calc_amp_axis_markers,
    calc_db_axis_markers,
    calc_freq_axis_markers,
    calc_time_axis_markers,
    format_frequency_axis_tooltip,
    format_linear_axis_tooltip,
    format_number_label,
    format_ticklabel,
    format_time_axis_tooltip,
    freq_hz_to_pos,
    freq_label_to_hz,
    freq_pos_to_hz,
    hz_to_label,
    sec_to_label,
    time_label_to_sec,
)

__all__ = [
    "calc_amp_axis_markers",
    "calc_db_axis_markers",
    "calc_freq_axis_markers",
    "calc_time_axis_markers",
    "format_frequency_axis_tooltip",
    "format_linear_axis_tooltip",
    "format_number_label",
    "format_ticklabel",
    "format_time_axis_tooltip",
    "freq_hz_to_pos",
    "freq_label_to_hz",
    "freq_pos_to_hz",
    "hz_to_label",
    "sec_to_label",
    "time_label_to_sec",
]
