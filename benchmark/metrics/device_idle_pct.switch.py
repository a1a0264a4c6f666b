"""device_idle_pct.switch: the device -- 100 x (1 - the union of every kernel,
copy and memset interval on every stream / the traced window) of the window
(the cells of the switch mix)."""

from benchmark.harness.readers import idle_pct

UNIT = "%"


def read(run):
    return idle_pct(run)
