"""tile_span_p95_ms.image: render + engine.images -- 95th percentile of the
ms of the window's ``command.get_spectrogram_tile`` spans encoded from the
landed host image (no ``tile.region_d2h`` under them)."""

from benchmark.harness import spantree
from benchmark.harness.readers import percentile

UNIT = "ms"
spantree.arm()


def read(run):
    ms = spantree.tile_ms(run, "image")
    return percentile(ms, 95) if ms else None
