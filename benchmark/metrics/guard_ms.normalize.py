"""guard_ms.normalize: dynamics + dynamics.stats_device + kernels.dynamics (the
host guard and K8) -- the ``normalize``, ``gain_apply`` and
``guard_clipping`` spans' total a normalize turn."""

from benchmark.harness.readers import kind_span_ms

UNIT = "ms"


def read(run):
    return kind_span_ms(run, "normalize", "normalize", "gain_apply", "guard_clipping")
