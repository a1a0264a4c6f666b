"""spec_fft_roofline.open: dsp.spectrogram + kernels.spec_db (K1/K2) -- the
least time of the window's K1/K2 launches (bytes at 3.35 TB/s or f32 FLOP at
67 TFLOP/s, from shapes: benchmark/harness/work.py) over their device time by
kernel name, over the window (the open cells)."""

from benchmark.harness.readers import roofline_pct

UNIT = "%"


def read(run):
    return roofline_pct(run, "spec_fft")
