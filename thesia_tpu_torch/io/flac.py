"""FLAC decode via the native extension.

Host copy of ``thesia_tpu/io/flac.py`` (verbatim apart from this note): the port
imports nothing of the JAX package.  ``tests/test_torch_hostcopies.py``
pins the two against each other.
"""

from __future__ import annotations

import numpy as np


class FlacError(ValueError):
    pass


def decode_flac(data: bytes) -> tuple[np.ndarray, int, int]:
    """-> (planar f32 (n_ch, n_samples), sample_rate, bits_per_sample)."""
    from .. import native

    if not native.available():
        raise FlacError("native extension unavailable (flac decode requires it)")
    try:
        wavs, sr, bps = native.flac_decode(data)
    except ValueError as e:
        raise FlacError(str(e)) from e
    return wavs, sr, bps
