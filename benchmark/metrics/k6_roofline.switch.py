"""k6_roofline.switch: engine.manager + kernels.images (K6) -- the least time of
the window's quantize + mips launches over their device time by kernel name
(``k6_quantize``, ``k6_halve``), over the window (the switch cell)."""

from benchmark.harness.readers import roofline_pct

UNIT = "%"


def read(run):
    return roofline_pct(run, "k6")
