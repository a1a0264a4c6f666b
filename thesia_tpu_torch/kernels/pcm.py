"""K4: interleaved PCM payloads -> planar float32 on the device.

Port of ``_deinterleave_flat`` and ``_deinterleave_s24``
(``thesia_tpu/dsp/spectrogram.py:76-114``), the programs of the big-WAV
prefetch.  These are XLA programs in the JAX package, not Pallas kernels, so
they come over as torch operations (a hand kernel follows only if the card's
profile shows that they matter end to end; ROADMAP.md, Queue 2 K4).
``_s16_to_f32`` (``:68-73``) is the int16 conversion inside
``deinterleave_flat``; its own route, ``_as_s16_grid``, is not ported (on the
H100 the host grid pass costs more than the halved upload saves; PERF.md).
Each output equals the host decode (``io/wav.py``) bit for bit:

  * s16: ``x * 2**-15`` (int16 is exact in f32 and the scale is an exponent
    shift, so this is the host's ``x / 32768``);
  * s24: three little-endian bytes combined to a sign-extended int32, then
    ``* 2**-23``;
  * f32: the samples as they are.

The port has no wav-size buckets: the output has exactly ``n`` columns, where
``n`` is the number of whole frames in the payload (a trailing partial frame
is dropped, as the host decode drops it).

Each wrapper is one fused pass on the device: ``torch.mul`` reads the
interleaved input through a transposed view and writes the contiguous planar
output, converting and scaling on the way.  ``*_reference`` are the JAX
package's formulation (one strided slice per channel, stacked, then
converted), the plain versions that ``chip_smoke.py`` holds the wrappers
against.  Launches count per wrapper (plain integers), those made under
``runtime.warming()`` apart in ``warm_launches``; the plain versions do not
count.
"""

from __future__ import annotations

import torch

from ..runtime import count_launch

S16_SCALE = 1.0 / 32768.0
S24_SCALE = 1.0 / 8388608.0


def _frames(flat: torch.Tensor, c: int, width: int = 1) -> torch.Tensor:
    """The whole frames of a flat interleaved payload as an (n, c[, width]) view."""
    if flat.dim() != 1 or c <= 0:
        raise ValueError(f"need a flat payload and a positive channel count, got {tuple(flat.shape)}, {c}")
    n = flat.numel() // (c * width)
    shape = (n, c) if width == 1 else (n, c, width)
    return flat[: n * c * width].view(shape)


def deinterleave_flat(flat: torch.Tensor, c: int) -> torch.Tensor:
    """(n*c [+ tail],) interleaved int16 or float32 -> (c, n) float32 planar."""
    if flat.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"deinterleave_flat takes int16 or float32, not {flat.dtype}")
    frames = _frames(flat, c)
    out = torch.empty((c, frames.shape[0]), dtype=torch.float32, device=flat.device)
    if flat.dtype == torch.int16:
        torch.mul(frames.t(), S16_SCALE, out=out)
    else:
        out.copy_(frames.t())
    count_launch(deinterleave_flat)
    return out


def deinterleave_s24(flat: torch.Tensor, c: int) -> torch.Tensor:
    """(n*3*c [+ tail],) packed little-endian 24-bit bytes (uint8) -> (c, n)
    float32 planar.  The top byte read as int8 carries the sign, so
    ``hi * 65536 + mid * 256 + lo`` is the sign-extended sample in int32."""
    if flat.dtype != torch.uint8:
        raise TypeError(f"deinterleave_s24 takes uint8 bytes, not {flat.dtype}")
    b = _frames(flat, c, 3)
    v = b[..., 2].view(torch.int8).to(torch.int32) * 65536
    v += b[..., 1].to(torch.int32) * 256
    v += b[..., 0]
    out = torch.empty((c, b.shape[0]), dtype=torch.float32, device=flat.device)
    torch.mul(v.t(), S24_SCALE, out=out)
    count_launch(deinterleave_s24)
    return out


# -- plain versions: the JAX package's formulation, as torch ops


def deinterleave_flat_reference(flat: torch.Tensor, c: int) -> torch.Tensor:
    n = flat.numel() // c
    rows = torch.stack([flat[ch : n * c : c] for ch in range(c)])
    return rows if rows.dtype == torch.float32 else rows.to(torch.float32) * S16_SCALE


def deinterleave_s24_reference(flat: torch.Tensor, c: int) -> torch.Tensor:
    n = flat.numel() // (3 * c)
    rows = []
    for ch in range(c):
        def byte(k, _base=3 * ch):
            return flat[_base + k : n * 3 * c : 3 * c].to(torch.int32)

        v = byte(0) | (byte(1) << 8) | (byte(2) << 16)
        rows.append((v << 8) >> 8)  # sign-extend 24 -> 32
    return torch.stack(rows).to(torch.float32) * S24_SCALE


def reset_launches() -> None:
    for fn in (deinterleave_flat, deinterleave_s24):
        fn.launches = fn.warm_launches = 0


reset_launches()
