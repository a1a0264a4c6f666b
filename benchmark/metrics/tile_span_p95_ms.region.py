"""tile_span_p95_ms.region: render + engine.images -- 95th percentile of the
ms of the window's ``command.get_spectrogram_tile`` spans whose source region
was fetched from the card mid-stream (a ``tile.region_d2h`` under them)."""

from benchmark.harness import spantree
from benchmark.harness.readers import percentile

UNIT = "ms"
spantree.arm()


def read(run):
    ms = spantree.tile_ms(run, "region")
    return percentile(ms, 95) if ms else None
