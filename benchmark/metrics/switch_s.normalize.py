"""switch_s.normalize: the mean time of the window's normalize turns -- a
normalize target: gain and guard on the host (K8 under the Limiter), the
recompute, K6 and the landing -- from the command to its viewport repainted,
settled and the summary read. Each kind is timed on its own, so the deck's
mix of kinds weights nothing."""

from benchmark.harness.readers import mean_turn_s

UNIT = "s"


def read(run):
    return mean_turn_s(run, "normalize")
