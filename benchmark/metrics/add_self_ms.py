"""add_self_ms: engine.session + engine.track -- the self time of each open's
``command.add_tracks`` (its interval less the union of every span it caused,
on every thread), mean ms: the add's host work outside decode, stats, the
upload, normalize and the spectrogram."""

from benchmark.harness import spantree

UNIT = "ms"
spantree.arm()


def read(run):
    spans = spantree.first_in_turns(run, "command.add_tracks")
    if not spans:
        return None
    win = spantree.window(run)
    return sum(win.self_ns(r) for r in spans) / 1e6 / len(spans)
