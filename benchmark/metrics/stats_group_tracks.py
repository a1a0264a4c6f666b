"""stats_group_tracks: dynamics + dynamics.stats_device + kernels.dynamics --
the mean number of tracks an engine K9 launch took in the window's opens: the
port's per-launch record ``stats_device.group_log`` (kept while the span log
is on), the launches made under the warmers left out.  None where the program
keeps no such record or launched no K9 in an open."""

from benchmark.harness import spantree

UNIT = "tracks"
spantree.arm()


def read(run):
    from thesia_tpu_torch.dynamics import stats_device

    log = getattr(stats_device, "group_log", None)
    if log is None:
        return None
    opens = [spantree.turn_bounds(t) for t in run.of("open")]
    sizes = [n for t_ns, n, warm in list(log)
             if not warm and any(a <= t_ns <= b for a, b in opens)]
    return sum(sizes) / len(sizes) if sizes else None
