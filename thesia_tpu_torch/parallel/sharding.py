"""Device mesh of the batched spectrogram recompute: rows, time and freq.

Port of ``thesia_tpu/parallel/sharding.py``, with its public names
(``make_mesh``, ``set_active_mesh``, ``active_mesh``, ``auto_mesh``,
``SpecSharding``, ``spec_sharding``, ``active_spec_sharding``,
``pad_rows_for``).  The JAX package lets GSPMD partition one jitted program
over a ``jax.sharding.Mesh``; the port has no partitioner, so the mesh here is
a plain ``(tracks, time, freq)`` array of ``torch.device`` and
``shard_plan`` says which rows, frames and columns each shard computes.  One
process drives every device (the JAX mesh is single-controller too): no
``torch.distributed``, no process group.  ``set_active_mesh`` installs a
process-wide mesh that ``SpectrogramAnalyzer.calc_specs_batched`` reads on
its next recompute.

  * "tracks": (track x channel) rows of a batch, data parallel.  The batch
    pads to ``pad_rows_for`` rows and row r goes to shard r // (padded rows
    / n_rows), the JAX placement; padding rows are never computed.
  * "time": contiguous blocks of STFT frames, sequence parallel.  A shard
    reads the rows from its first frame's start to its last frame's end, so
    the ``win - hop`` samples past its last frame are the halo.
  * "freq": blocks of output columns (mel filterbank columns, or linear
    bins).  In the JAX package this axis splits the DFT GEMM's columns and
    the mel contraction (a psum, tolerance-only).  No kernel of the port
    contracts over the bins that way: on the card every freq shard computes
    the whole FFT of its frames and writes only its columns, each summed in
    the same order as unsharded, so the axis splits output bytes and the mel
    sums, not the FFT, and is bit-exact there.

Every axis is bit-exact on the card, where each frame and column is computed
the same way in any launch.  On the CPU the plain version multiplies row
blocks and column slices of its matrices, which torch's CPU matmul keeps
bitwise only at small sizes (tolerance, ``tests/torch_parity.py``).

A device may repeat in a mesh: ``make_mesh(devices=["cpu"] * 8)`` or
``[cuda:0] * 4`` is a virtual mesh, the counterpart of the JAX package's
virtual XLA CPU devices, whose shards run in turn on one device.  Peer
copies to a shard on another device count in ``counters`` (the upload
counters of ``dsp/upload.py`` keep counting host-to-device bytes only).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..runtime import resolve_device

class Mesh:
    """A (tracks, time, freq) numpy object array of torch devices."""

    axis_names = ("tracks", "time", "freq")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"mesh of shape {devices.shape} for axes {self.axis_names}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)


_active_mesh: Mesh | None = None


def make_mesh(
    n_devices: int | None = None, freq_parallel: int = 1, time_parallel: int = 1,
    devices=None,
) -> Mesh:
    """Mesh over the visible CUDA devices, or over ``devices`` (in which a
    device may repeat: a virtual mesh), the first ``n_devices`` of them."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    devices = devices[: n_devices or len(devices)]
    n = len(devices)
    assert n and n % (freq_parallel * time_parallel) == 0
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // (freq_parallel * time_parallel), time_parallel, freq_parallel))


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install the mesh the engine's batched recompute shards over (None to
    return to single-device execution)."""
    global _active_mesh
    _active_mesh = mesh


def active_mesh() -> Mesh | None:
    return _active_mesh


def auto_mesh(min_devices: int = 2) -> Mesh | None:
    """All-card "tracks" mesh when more than one card is visible."""
    n = torch.cuda.device_count()
    return make_mesh(n) if n >= min_devices else None


class SpecSharding(NamedTuple):
    """What the batched recompute shards over: the mesh's axis sizes, which
    of time and freq are opted in, and the shard -> device map
    ``devices[r][t][f]`` (nested tuples, so the bundle is hashable)."""

    n_rows: int  # size of the "tracks" axis (row batches pad to a multiple)
    n_freq: int  # size of the "freq" axis
    n_time: int  # size of the "time" axis
    freq_parallel: bool
    time_parallel: bool
    devices: tuple

    def device(self, r: int, t: int, f: int) -> torch.device:
        return self.devices[r][t][f]

    def first_device(self) -> torch.device:
        return self.devices[0][0][0]


def spec_sharding(
    mesh: Mesh, freq_parallel: bool = False, time_parallel: bool = False
) -> SpecSharding:
    n_rows = mesh.shape["tracks"]
    n_freq = mesh.shape["freq"]
    n_time = mesh.shape["time"]
    return SpecSharding(
        n_rows=n_rows,
        n_freq=n_freq,
        n_time=n_time,
        freq_parallel=freq_parallel and n_freq > 1,
        time_parallel=time_parallel and n_time > 1,
        devices=tuple(tuple(tuple(row) for row in plane) for plane in mesh.devices),
    )


def active_spec_sharding() -> SpecSharding | None:
    """The sharding the engine applies to batched recomputes, or None when
    no mesh of two or more shards is active.  A mesh built with
    make_mesh(freq_parallel=k>1) or make_mesh(time_parallel=m>1) opts those
    axes in here, as in the JAX package."""
    mesh = _active_mesh
    if mesh is None or mesh.size < 2:
        return None
    return spec_sharding(
        mesh,
        freq_parallel=mesh.shape["freq"] > 1,
        time_parallel=mesh.shape["time"] > 1,
    )


def pad_rows_for(shardings: SpecSharding | None, rows: int) -> int:
    """Row-batch size: next power of two (executable reuse), rounded up to a
    multiple of the mesh "tracks" axis so every shard is equal."""
    c = 1
    while c < rows:
        c *= 2
    if shardings is not None:
        m = shardings.n_rows
        c = max(c, m)
        if c % m:
            c = ((c + m - 1) // m) * m
    return c


class Shard(NamedTuple):
    """One launch of a sharded batch: rows [r0, r1), frames [t0, t1) and
    output columns [c0, c1) on ``device``."""

    device: torch.device
    r0: int
    r1: int
    t0: int
    t1: int
    c0: int
    c1: int


def blocks(n: int, k: int) -> list[tuple[int, int]]:
    """[start, end) of k equal blocks of n (the last may be short; empty
    blocks left out)."""
    size = -(-n // k)
    return [(i * size, min((i + 1) * size, n)) for i in range(k) if i * size < n]


def shard_plan(sh: SpecSharding, rows: int, n_frames: int, n_cols: int,
               use_freq: bool = True) -> list[Shard]:
    """The shards of a batch of ``rows`` rows, ``n_frames`` frames and
    ``n_cols`` output columns, in (tracks, time, freq) order; a shard with
    no real row, frame or column is left out.  ``use_freq`` False keeps the
    columns whole (the rfft route, as in the JAX package)."""
    per = pad_rows_for(sh, rows) // sh.n_rows
    n_time = sh.n_time if sh.time_parallel else 1
    n_freq = sh.n_freq if sh.freq_parallel and use_freq else 1
    out = []
    for r in range(sh.n_rows):
        r0, r1 = r * per, min((r + 1) * per, rows)
        if r0 >= r1:
            continue
        for t, (t0, t1) in enumerate(blocks(n_frames, n_time)):
            for f, (c0, c1) in enumerate(blocks(n_cols, n_freq)):
                out.append(Shard(sh.device(r, t, f), r0, r1, t0, t1, c0, c1))
    return out


# peer copies to shards on another device than the analyzer's, per target
# device: {"cuda:1": {"copies": n, "bytes": b}}
counters: dict[str, dict[str, int]] = {}
_counters_lock = threading.Lock()


def count_peer_copy(device: torch.device, n_bytes: int) -> None:
    with _counters_lock:
        c = counters.setdefault(str(device), {"copies": 0, "bytes": 0})
        c["copies"] += 1
        c["bytes"] += int(n_bytes)


def reset_counters() -> None:
    with _counters_lock:
        counters.clear()


def peer_bytes() -> int:
    with _counters_lock:
        return sum(c["bytes"] for c in counters.values())
