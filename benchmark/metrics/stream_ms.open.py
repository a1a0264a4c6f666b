"""stream_ms.open: engine.images (the landing) -- the ``spec.stream`` span's
total a turn of the window (the open cells)."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "spec.stream")
