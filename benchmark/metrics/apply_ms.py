"""apply_ms: engine.service + engine.session -- the span
``command.apply_track_list_changes`` of each open (the turn's first), mean
ms: the deferred apply inside ``Commands.call``, the inside twin of
``dispatch_ms``."""

from benchmark.harness import spantree

UNIT = "ms"
spantree.arm()


def read(run):
    spans = spantree.first_in_turns(run, "command.apply_track_list_changes")
    return sum(r[spantree.END] - r[spantree.START] for r in spans) / 1e6 / len(spans) \
        if spans else None
