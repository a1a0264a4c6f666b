"""decode_ms: engine.track + io + native -- the ``decode`` span's total a
turn of the window (the open cells)."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "decode")
