"""stream_ms.switch: engine.images (the landing) -- the ``spec.stream`` span's
total a turn of the window (the switch cell)."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "spec.stream")
