"""dispatch_ms: engine.service / engine.session -- the mean host time of a
deferred command's ``Commands.call`` (the apply of an open, a knob turn's
command) until it returns, by the harness's clock."""

UNIT = "ms"


def read(run):
    ms = [t.dispatch_ms for t in run.turns]
    return sum(ms) / len(ms) if ms else None
