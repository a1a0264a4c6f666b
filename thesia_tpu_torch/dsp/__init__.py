"""Spectrogram analysis: framing, STFT helpers and the analyzer.

``__all__`` is the JAX package's (``thesia_tpu/dsp/__init__.py``).
``SpectrogramAnalyzer`` loads on first access: ``spectrogram.py`` imports the
kernel modules, which import ``dsp.stft``, so an eager import here would
make that a cycle."""

from .decibel import amp_from_db, db_from_amp, db_from_power, power_from_db
from .framing import SpecSetting, SrWinNfft
from .stft import perform_stft, reflect_pad_1d, stft_frame_count

__all__ = [
    "SpecSetting",
    "SrWinNfft",
    "db_from_amp",
    "db_from_power",
    "amp_from_db",
    "power_from_db",
    "stft_frame_count",
    "perform_stft",
    "reflect_pad_1d",
    "SpectrogramAnalyzer",
]


def __getattr__(name: str):
    if name == "SpectrogramAnalyzer":
        from .spectrogram import SpectrogramAnalyzer

        return SpectrogramAnalyzer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
