"""paint_ms: the mean over the window's commands of the time from the
command's call until every tile of its viewport, fetched as the viewer
fetches them (mid-stream region fetches included), carries its result."""

UNIT = "ms"


def read(run):
    paints = [t.paint_ms for t in run.turns]
    return sum(paints) / len(paints) if paints else None
