"""idle_unspanned_pct.open: device + host -- 100 x the window's device-idle
time in which no span of the program was open on any thread (the shape
warmer's left out) over all of it, the open cells; none where the span
clock check fails."""

from benchmark.harness import spantree

UNIT = "%"
spantree.arm()


def read(run):
    return spantree.idle_unspanned_pct(run)
