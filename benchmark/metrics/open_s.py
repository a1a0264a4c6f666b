"""open_s: the window's length over the opens it completed (add, deferred
apply, viewport painted, settled, summary read, removed and applied)."""

UNIT = "s"


def read(run):
    n = len(run.of("open"))
    return run.window_s / n if n else None
