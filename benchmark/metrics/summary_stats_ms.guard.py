"""summary_stats_ms.guard: dynamics + dynamics.stats_device + kernels.dynamics
-- the ``stats`` spans whose root is a reader command (``command.get_*``:
the summary's LUFS, RMS and peak after the turn's gain), total ms a guard
turn."""

from benchmark.harness import spantree

UNIT = "ms"
spantree.arm()


def _lazy_stats(win, r):
    root = win.root_of(r)
    return r[spantree.NAME] == "stats" and root is not None and \
        root[spantree.NAME].startswith("command.get_")


def read(run):
    return spantree.kind_ms(run, "guard", _lazy_stats)
