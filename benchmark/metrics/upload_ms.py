"""upload_ms: dsp.upload -- the ``spec.h2d_upload`` span's total an open."""

from benchmark.harness.readers import per_turn_ms

UNIT = "ms"


def read(run):
    return per_turn_ms(run, "spec.h2d_upload")
