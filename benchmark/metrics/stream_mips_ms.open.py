"""stream_mips_ms.open: engine.images -- the ``spec.stream.mips`` span's
total a turn of the window (the host images and mip chains the landing
builds once its copies are in), the open cells."""

from benchmark.harness import spantree

UNIT = "ms"
spantree.arm()


def read(run):
    return spantree.window_ms_a_turn(run, "spec.stream.mips")
