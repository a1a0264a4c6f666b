"""tile_span_p95_ms.waveform: render + engine.images -- 95th percentile of
the ms of the window's ``command.get_waveform_tile`` spans that encoded a
tile (a ``tile.waveform_encode`` under them; cache hits left out)."""

from benchmark.harness import spantree
from benchmark.harness.readers import percentile

UNIT = "ms"
spantree.arm()


def read(run):
    ms = spantree.tile_ms(run, "waveform")
    return percentile(ms, 95) if ms else None
