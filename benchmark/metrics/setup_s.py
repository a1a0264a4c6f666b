"""setup_s: process start to window start -- imports, the card's context,
the tracks made from the seed and written, the session's ``init``, and one
pass of the cell's own loop (every shape the window uses)."""

UNIT = "s"


def read(run):
    return run.setup_s
