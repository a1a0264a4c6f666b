"""limiter_ms.normalize: dynamics + dynamics.stats_device + kernels.dynamics --
the ``guard.limiter`` span's total a normalize turn (K8 and the gains' copy
to the host, or the native limiter's pool, for every track the Limiter
engages on), 0 in a turn that engages none."""

from benchmark.harness import spantree

UNIT = "ms"
spantree.arm()


def read(run):
    return spantree.kind_ms(run, "normalize", lambda win, r: r[spantree.NAME] == "guard.limiter")
