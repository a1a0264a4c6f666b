"""tile_ms_p95: the 95th percentile of every tile request of the window
(spectrogram and waveform tiles, landed or mid-stream)."""

from benchmark.harness.readers import percentile

UNIT = "ms"


def read(run):
    return percentile(run.tile_ms, 95) if run.tile_ms else None
