"""region_fetches: engine.images -- region fetches a turn of the window: the
``tile.region_d2h`` spans, one at each count of the port's counter
``engine.images.region_fetches`` (a tile served from the card while its
image streams)."""

from benchmark.harness import spantree

UNIT = "fetches"
spantree.arm()


def read(run):
    win = spantree.window(run)
    return None if win is None else len(win.named("tile.region_d2h")) / len(run.turns)
