"""Time the spectrogram kernel (csrc/spec_fft.cu) over launch plans at the
main path's shapes, on one CUDA card.

    python -m thesia_tpu_torch.tools.bench_spec_fft [CTA_COMPLEX:THREADS ...]

For each plan (complex values of frames per CTA, threads per CTA; default:
the wrapper's own plan) and each shape (a 5-min 48 kHz stereo song and a
60-s 16 kHz mono memo at the default settings, random samples from seed 0),
it prints the median of 20 CUDA-event timings of the mel and the linear
variant, after checking the output against the first plan's bit for bit,
and the first 16 hex digits of the SHA-256 of each output (equal across two
builds of the kernel that compute the same bits).
One JSON line per plan; the card's name and power limit first, then for
each shape and variant the work of one launch (kernels/spec_db.py:
kernel_work) and its times at the card's peaks (runtime.py): HBM bytes, the
FFT's f32 operations, and the f32 operations of the DFT GEMM the kernel
replaced.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

from .. import runtime
from ..dsp.framing import SpecSetting
from ..dsp.spectrogram import SpectrogramAnalyzer, reflect_pad_rows
from ..dsp.stft import stft_frame_count
from ..kernels import spec_db as kern

SHAPES = (("48k", 48000, 2, 300.0), ("16k", 16000, 1, 60.0))


def main(argv: list[str]) -> int:
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    plans = [tuple(int(x) for x in a.split(":")) for a in argv] or [(kern.CTA_COMPLEX, kern.THREADS)]
    analyzer = SpectrogramAnalyzer(dev)
    rng = np.random.default_rng(0)
    cases = []
    for label, sr, rows, sec in SHAPES:
        hop, win, n_fft = SpecSetting().calc_framing_params(sr)
        wavs = (0.1 * rng.standard_normal((rows, int(sr * sec)))).astype(np.float32)
        padded = reflect_pad_rows(torch.from_numpy(wavs).to(dev), win // 2)
        n_frames = stft_frame_count(wavs.shape[1], win, hop)
        args = (padded, hop, win, n_frames, analyzer.window(win, n_fft), n_fft)
        mel = analyzer.mel_fb(sr, n_fft)
        cases.append((label, args, mel))
        for variant, m in (("mel", mel), ("linear", None)):
            work = kern.kernel_work(rows, padded.shape[1], n_frames, win, n_fft, m)
            print(json.dumps({"shape": label, "variant": variant, **work,
                              "bytes_ms": work["bytes"] / runtime.HBM_BYTES_PER_S * 1e3,
                              "flop_ms": work["flop"] / runtime.F32_FLOP_PER_S * 1e3,
                              "dft_gemm_ms": work["dft_gemm_flop"] / runtime.F32_FLOP_PER_S * 1e3}),
                  flush=True)
    first = {}
    for cta_complex, threads in plans:
        result = {"cta_complex": cta_complex, "threads": threads}
        plan = {"cta_complex": cta_complex, "threads": threads}
        for label, args, mel in cases:
            for variant, m in (("mel", mel), ("linear", None)):
                out = kern.spec_db(*args, m, **plan)
                key = (label, variant)
                if key in first and not torch.equal(first[key], out):
                    raise AssertionError(f"{result} changed the output of {key}")
                first.setdefault(key, out)
                result[f"{variant}_{label}_sha256"] = hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()[:16]
                result[f"{variant}_{label}_ms"] = runtime.median_ms(
                    lambda: kern.spec_db(*args, m, **plan), reps=20, warmup=1)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
