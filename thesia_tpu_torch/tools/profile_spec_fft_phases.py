"""Where the register schedule of the spectrogram kernel spends its time, by
phase, on one CUDA card (the card's machine has no ncu or nsys).

    python -m thesia_tpu_torch.tools.profile_spec_fft_phases

It builds an instrumented copy of ``csrc/spec_fft.cu`` into ``_build/``: at
each phase boundary of ``spec_fft_kernel_regs`` every warp reads
``clock64()`` and lane 0 adds the cycles since the last boundary to a device
counter of that phase.  The phases: ``load`` (the frame's samples, windowed),
``fft32`` (the 32-point DFTs in registers and the stage twiddle),
``exchange`` (the transpose through the warp's buffer), ``fftL`` (the
L-point DFTs and Z back to the buffer), ``split`` (mel only: the bin pairs'
powers and the magnitudes), ``epilogue`` (linear: the split and the dB
stores; mel: the filterbank sums and the dB stores).  A warp's cycles in a
phase include the time the SM gave to other warps meanwhile, so the shares,
not the cycles, say where a warp waits.  For the main path's shapes (a 5-min
48 kHz stereo song, a 60-s 16 kHz memo, random samples from seed 0) and both
variants it prints one JSON line: the shares, the cycles per frame, and the
instrumented launch's device ms beside the plain build's (``runtime.launch_ms``),
after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from .. import runtime
from ..dsp.framing import SpecSetting
from ..dsp.spectrogram import SpectrogramAnalyzer
from ..dsp.stft import stft_frame_count
from ..kernels import build
from ..kernels import spec_db as kern

PHASES = ("load", "fft32", "exchange", "fftL", "epilogue", "split")
SHAPES = ((48000, 2, 300.0), (16000, 1, 60.0))

# (phase index, source text after which the boundary goes) in
# spec_fft_kernel_regs; the epilogue's boundary closes the frame group's loop
MARKS = (
    (0, "            v[q] = load_pair(f, s, a.win, w.x, w.y);\n          }\n        }\n      }\n    }\n"),
    (1, "    for (int r = 1; r < 32; ++r) v[r] = cmul(v[r], st[rev_bits(r, 5) * L + j]);\n"),
    (2, "      for (int b = 0; b < L; ++b) v[i * L + b] = xb[R::x_at(g, j + L * i, b)];\n"
        "    }\n    __syncwarp();\n"),
    (3, "      for (int r = 0; r < L; ++r) xb[R::z_at(g, j + L * i + 32 * rev_bits(r, LOG2L))]"
        " = v[i * L + r];\n    }\n    __syncwarp();\n"),
    (5, "          if (H - k != k) mag[R::m_at(g, H - k)] = sqrt_approx(pw[q].y);\n"
        "        }\n      }\n      __syncwarp();\n"),
)
START = "    const bool counted = valid && a.t0 + t < nf;\n"
END = "    __syncwarp();\n  }\n  bounds.flush(a, row);"


def _mark(i: int) -> str:
    return ("    { const long long now = clock64(); if ((threadIdx.x & 31) == 0) "
            f"atomicAdd(&g_phase_cycles[{i}], (unsigned long long)(now - phase_t)); "
            "phase_t = now; }\n")


def instrumented_source(src: str) -> str:
    """csrc/spec_fft.cu with the phase counters; raises if an anchor moved."""
    def place(text, after, add):
        if text.count(after) != 1:
            raise ValueError(f"anchor not found once in csrc/spec_fft.cu: {after!r}")
        return text.replace(after, after + add)

    src = place(src, "namespace {\n", "__device__ unsigned long long g_phase_cycles[8];\n")
    src = place(src, START, "    long long phase_t = clock64();\n")
    for i, anchor in MARKS:
        src = place(src, anchor, _mark(i))
    if src.count(END) != 1:
        raise ValueError("the frame-group loop's end moved in csrc/spec_fft.cu")
    src = src.replace(END, "    __syncwarp();\n" + _mark(4) + "  }\n  bounds.flush(a, row);")
    return src + """
extern "C" int thesia_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
"""


def main() -> int:
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    plain = build.library()
    phased = build.instrumented_library(
        "spec_fft.cu", instrumented_source((build.CSRC_DIR / "spec_fft.cu").read_text()))
    cycles = (ctypes.c_ulonglong * 8)()
    analyzer = SpectrogramAnalyzer(dev)
    rng = np.random.default_rng(0)
    for sr, rows, sec in SHAPES:
        hop, win, n_fft = SpecSetting().calc_framing_params(sr)
        raw = torch.from_numpy((0.1 * rng.standard_normal((rows, int(sr * sec))))
                               .astype(np.float32)).to(dev)
        n_frames = stft_frame_count(raw.shape[1], win, hop)
        window = analyzer.window(win, n_fft)
        for variant, mel in (("mel", analyzer.mel_fb(sr, n_fft)), ("linear", None)):
            def launch():
                return kern.spec_db(raw, hop, win, n_frames, window, n_fft, mel, pad=win // 2,
                                    bounds=True)

            build._lib = phased
            try:
                launch()
                if phased.thesia_phase_cycles(cycles):  # clears the warm-up's counts
                    raise RuntimeError("reading the phase counters failed")
                launch()
                if phased.thesia_phase_cycles(cycles):
                    raise RuntimeError("reading the phase counters failed")
                counts = dict(zip(PHASES, (cycles[i] for i in range(len(PHASES)))))
                phased_ms = runtime.launch_ms(launch, n=20).ms
            finally:
                build._lib = plain
            plain_ms = runtime.launch_ms(launch, n=20).ms
            total = sum(counts.values())
            frames = rows * n_frames
            print(json.dumps({
                "sr": sr, "variant": variant, "n_fft": n_fft,
                "share": {k: round(v / total, 4) for k, v in counts.items()},
                "cycles_per_frame": {k: round(v / frames, 1) for k, v in counts.items()},
                "instrumented_ms": phased_ms, "plain_ms": plain_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
