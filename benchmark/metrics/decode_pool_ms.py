"""decode_pool_ms: engine.track + io + native -- the ``decode.pool`` span (the
wall time of an add's pool of decodes, the parent of each thread's
``decode``) a turn of the window (the open cells); None where the program
logs no such span."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "decode.pool")
