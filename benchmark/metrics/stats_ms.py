"""stats_ms: dynamics + dynamics.stats_device + kernels.dynamics (K9) -- the
``stats`` and ``stats.batched`` spans' total an open."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "stats", "stats.batched")
