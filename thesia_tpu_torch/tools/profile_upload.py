"""Host-to-device upload routes for a track's samples on one CUDA card.

    python -m thesia_tpu_torch.tools.profile_upload    # from the repository root

For the 5-minute 48 kHz stereo song and the 1-hour 16 kHz mono lecture of
``signals`` (decoded from their 16-bit WAVs, so every sample lies on the
int16 grid), times three routes, each the median host wall of 5 warm calls
that end in a synchronize, with the copy stream's CUDA-event ms where it has
one:

  * ``pageable``: ``torch.from_numpy(wavs).to(card)``, the route before the
    pinned upload;
  * ``pinned``: ``dsp/upload.py`` (pinned ring on the copy stream), the
    port's route;
  * ``int16``: the JAX package's ``_as_s16_grid`` route: the native
    ``f32_to_s16_grid`` host pass, the int16 bytes through ``dsp/upload.py``,
    then ``x * 2**-15`` on the card (the grid pass timed alone beside it).

Before them, the process's first upload (16 MB) and its second: the first
creates the copy stream and the pinned ring and starts torch's host thread
pool.  Prints the card's name and power limit, then one JSON line for the
first uploads and one per track.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import native, runtime
from ..dsp import upload
from ..io.wav import decode_wav, encode_wav_s16
from . import signals


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``reps`` calls of an already warm ``fn``."""
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def routes(wavs: np.ndarray, dev: torch.device) -> dict:
    out = {"bytes_f32": wavs.nbytes}
    pageable = torch.from_numpy(wavs).to(dev)
    out["pageable_ms"] = _wall_ms(lambda: torch.from_numpy(wavs).to(dev))

    pinned = upload.upload(wavs, dev).tensor_for()
    upload.reset_counters()
    out["pinned_ms"] = _wall_ms(lambda: upload.upload(wavs, dev).tensor_for())
    out["pinned_copy_stream_ms"] = upload.copy_stream_ms() / 5

    def int16_route():
        ints = native.f32_to_s16_grid(wavs)
        dev_ints = upload.upload(ints.reshape(-1).view(np.uint8), dev).tensor_for()
        return torch.mul(dev_ints.view(torch.int16).view(wavs.shape), 1.0 / 32768.0)

    via_int16 = int16_route()
    upload.reset_counters()
    out["int16_ms"] = _wall_ms(int16_route)
    out["int16_copy_stream_ms"] = upload.copy_stream_ms() / 5
    out["int16_grid_pass_ms"] = _wall_ms(lambda: native.f32_to_s16_grid(wavs))
    out["all_equal"] = bool(torch.equal(pageable, pinned) and torch.equal(pinned, via_int16))
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in out.items()}


def main() -> int:
    dev = runtime.resolve_device("cuda")
    print(runtime.card_description(), flush=True)
    if not native.available():
        raise RuntimeError("the port's native host library did not build")
    torch.zeros(1, device=dev)
    first = np.ones(16 << 20, np.uint8)
    once = lambda: round(_wall_ms(lambda: upload.upload(first, dev).tensor_for(), 1), 3)  # noqa: E731
    print(json.dumps({"first_upload_16mb_ms": once(), "second_upload_16mb_ms": once()}), flush=True)
    rng = np.random.default_rng(0)
    for name, wavs, sr in (("song_48k_stereo_5min", signals.song(rng), signals.SONG_SR),
                           ("lecture_16k_mono_1h", signals.lecture(rng), signals.LECTURE_SR)):
        decoded = decode_wav(encode_wav_s16(wavs, sr))[0]
        print(json.dumps({"track": name, "shape": decoded.shape, **routes(decoded, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
