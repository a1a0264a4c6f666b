"""Header-only audio shape probing: (n_ch, n_samples, sr) without decoding.

Host copy of ``thesia_tpu/io/probe.py`` (the port imports nothing of the JAX
package; ``tests/test_torch_hostcopies.py`` pins it statement for
statement).  The session's shape warmer reads a track's framing-relevant
quantities from the container header while the add decodes, so it can
prepay the current and neighbouring settings' tables; the probe reads a few
KB, never the payload.

Covers WAV (RIFF fmt + data chunk sizes, incl. extensible), FLAC
(STREAMINFO), MP3 (Xing/Info frame count, else CBR estimate), M4A (the
audio track's mdhd timescale/duration + stsd channels; tail-reads moov for
non-faststart files), and Ogg vorbis/opus (id header + last-page granule
position from the file tail).  Channel count and sample rate are exact;
the length is an estimate for the compressed containers.
"""

from __future__ import annotations

import os
import struct

_HEAD_BYTES = 1 << 18


def probe_shape(path: str | os.PathLike) -> tuple[int, int, int] | None:
    """(n_ch, n_samples, sr) or None when the container can't be probed
    cheaply.  Never raises on malformed input."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(_HEAD_BYTES)
    except OSError:
        return None
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return _probe_wav(head, size)
    if len(head) >= 42 and head[:4] == b"fLaC":
        return _probe_flac(head)
    if head[:4] == b"OggS":
        return _probe_ogg(head, path)
    if len(head) > 8 and head[4:8] == b"ftyp":
        # moov is frequently at the END of non-faststart files
        data = head
        if b"moov" not in head:
            try:
                with open(path, "rb") as f:
                    f.seek(max(size - (1 << 20), 0))
                    data = f.read()
            except OSError:
                return None
        return _probe_m4a(data)
    if head[:3] == b"ID3" or (len(head) > 1 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return _probe_mp3(head, size)
    return None


def _probe_wav(head: bytes, file_size: int) -> tuple[int, int, int] | None:
    pos = 12
    fmt = None  # (n_ch, sr, block_align)
    data_size = None
    while pos + 8 <= len(head):
        cid = head[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", head, pos + 4)
        if cid == b"fmt " and pos + 8 + 16 <= len(head):
            _tag, n_ch, sr, _br, block_align, _bits = struct.unpack_from(
                "<HHIIHH", head, pos + 8
            )
            if n_ch and sr and block_align:
                fmt = (n_ch, sr, block_align)
        elif cid == b"data":
            # size 0xFFFFFFFF / 0 streams: fall back to the file tail
            data_size = csize
            if csize in (0, 0xFFFFFFFF) or pos + 8 + csize > file_size:
                data_size = max(file_size - (pos + 8), 0)
            # fmt almost always precedes data; if both seen we are done
            if fmt is not None:
                break
        pos += 8 + csize + (csize & 1)
    if fmt is None or data_size is None:
        return None
    n_ch, sr, block_align = fmt
    return (n_ch, data_size // block_align, sr)


def _probe_flac(head: bytes) -> tuple[int, int, int] | None:
    # METADATA_BLOCK_HEADER at byte 4; STREAMINFO is always first
    if (head[4] & 0x7F) != 0:
        return None
    # STREAMINFO layout (bytes 8..): min/max blocksize (4), min/max frame
    # size (6), then 8 bytes packing sr(20) ch(3) bps(5) total_samples(36)
    packed = int.from_bytes(head[18:26], "big")
    sr = packed >> 44
    n_ch = ((packed >> 41) & 0x7) + 1
    total = packed & ((1 << 36) - 1)
    if not sr or not total:
        return None
    return (n_ch, total, sr)


# ---------------------------------------------------------------------------
# compressed containers: header-only shape estimates good to the warm
# bucket (wav_size_bucket pow2 classes tolerate small duration error)

_MP3_BITRATES = (  # MPEG1 Layer III kbps table
    0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0
)
_MP3_SRS = {0: 44100, 1: 48000, 2: 32000}


def _probe_mp3(head: bytes, file_size: int) -> tuple[int, int, int] | None:
    pos = 0
    if head[:3] == b"ID3" and len(head) >= 10:
        size = ((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14) \
            | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F)
        pos = 10 + size
    # find the first MPEG1 Layer III frame sync
    while pos + 4 <= len(head):
        if head[pos] == 0xFF and (head[pos + 1] & 0xE0) == 0xE0:
            b1, b2, b3 = head[pos + 1], head[pos + 2], head[pos + 3]
            if (b1 >> 3) & 0x3 == 0x3 and (b1 >> 1) & 0x3 == 0x1:  # MPEG1 L3
                sr = _MP3_SRS.get((b2 >> 2) & 0x3)
                kbps = _MP3_BITRATES[(b2 >> 4) & 0xF]
                mode = (b3 >> 6) & 0x3
                n_ch = 1 if mode == 3 else 2
                if sr:
                    # Xing/Info VBR header: exact frame count when present
                    side = 17 if n_ch == 1 else 32
                    tag_off = pos + 4 + side
                    tag = head[tag_off : tag_off + 4]
                    if tag in (b"Xing", b"Info") and len(head) >= tag_off + 12:
                        flags = int.from_bytes(head[tag_off + 4 : tag_off + 8], "big")
                        if flags & 1:
                            frames = int.from_bytes(
                                head[tag_off + 8 : tag_off + 12], "big"
                            )
                            return (n_ch, frames * 1152, sr)
                    if kbps:  # CBR estimate from the payload size
                        n = (file_size - pos) * 8 * sr // (kbps * 1000)
                        return (n_ch, n, sr)
            pos += 1
        else:
            pos += 1
    return None


def _walk_mp4_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos : pos + 4], "big")
        name = data[pos + 4 : pos + 8]
        if size < 8:
            return
        yield name, pos + 8, min(pos + size, end)
        pos += size


def _probe_m4a(data: bytes) -> tuple[int, int, int] | None:
    """Shape from the moov box: the audio track's mdhd timescale (= sr) and
    duration (= samples), channels from the stsd audio sample entry."""

    def find(name: bytes, start: int, end: int):
        for n, s, e in _walk_mp4_boxes(data, start, end):
            if n == name:
                return s, e
        return None

    moov = find(b"moov", 0, len(data))
    if moov is None:
        return None
    for tname, ts, te in _walk_mp4_boxes(data, *moov):
        if tname != b"trak":
            continue
        mdia = find(b"mdia", ts, te)
        if mdia is None:
            continue
        # only SOUND tracks: a leading video trak's 90 kHz timescale passes
        # the plausibility floor below and would warm never-used 90 kHz
        # spectrogram shapes — the hdlr handler_type at
        # offset +8 (after ver/flags + pre_defined) says what the trak is
        hdlr = find(b"hdlr", *mdia)
        if hdlr is not None and data[hdlr[0] + 8 : hdlr[0] + 12] != b"soun":
            continue
        mdhd = find(b"mdhd", *mdia)
        if mdhd is None:
            continue
        ver = data[mdhd[0]]
        if ver == 1:
            timescale = int.from_bytes(data[mdhd[0] + 20 : mdhd[0] + 24], "big")
            duration = int.from_bytes(data[mdhd[0] + 24 : mdhd[0] + 32], "big")
        else:
            timescale = int.from_bytes(data[mdhd[0] + 12 : mdhd[0] + 16], "big")
            duration = int.from_bytes(data[mdhd[0] + 16 : mdhd[0] + 20], "big")
        if timescale < 8000:  # movie/hint track, not audio
            continue
        n_ch = 2
        minf = find(b"minf", *mdia)
        if minf is not None:
            stbl = find(b"stbl", *minf)
            if stbl is not None:
                stsd = find(b"stsd", *stbl)
                if stsd is not None and stsd[0] + 34 <= len(data):
                    entry = stsd[0] + 8  # ver/flags + entry_count
                    n_ch = int.from_bytes(data[entry + 24 : entry + 26], "big") or 2
                    n_ch = _m4a_real_channels(data, entry, stsd[1]) or n_ch
        return (n_ch, duration, timescale)
    return None


def _m4a_real_channels(data: bytes, entry: int, end: int) -> int | None:
    """The stsd channelcount lies for AAC (it often says 2 for mono); the
    truth lives in the esds AudioSpecificConfig's channel configuration —
    or, for ALAC, in the alac magic cookie."""
    esds = data.find(b"esds", entry, end)
    if esds != -1:
        pos = esds + 8  # skip name + ver/flags
        # descriptor walk: tag byte + 7-bit varint length
        def desc(pos, want):
            while pos < end:
                tag = data[pos]
                pos += 1
                length = 0
                while pos < end:
                    b = data[pos]
                    pos += 1
                    length = (length << 7) | (b & 0x7F)
                    if not b & 0x80:
                        break
                if tag == want:
                    return pos, length
                if tag == 0x03:  # descend into the ES descriptor
                    pos += 3
                    continue
                pos += length
            return None, 0

        pos, _l = desc(pos, 0x04)
        if pos is not None:
            pos += 13  # objectType(1) + streamType/buffer(4) + rates(8)
            pos, length = desc(pos, 0x05)
            if pos is not None and length >= 2:
                b0, b1 = data[pos], data[pos + 1]
                if (b0 >> 3) != 31 and ((b0 & 0x7) << 1 | (b1 >> 7)) != 15:
                    ch_cfg = (b1 >> 3) & 0xF
                    if 1 <= ch_cfg <= 7:
                        return 8 if ch_cfg == 7 else ch_cfg
        return None
    alac = data.find(b"alac", entry + 8, end)
    if alac != -1:
        cookie = alac + 8  # name + ver/flags
        if cookie + 14 <= len(data):
            ch = data[cookie + 9]  # frameLength(4) compat(1) bits(1) pb/mb/kb(3)
            if 1 <= ch <= 8:
                return ch
    return None


def _probe_ogg(head: bytes, path) -> tuple[int, int, int] | None:
    """sr/channels from the vorbis/opus id header; total samples from the
    LAST page's granule position (read from the file tail)."""
    if b"\x01vorbis" in head[:256]:
        i = head.index(b"\x01vorbis")
        n_ch = head[i + 11]
        sr = int.from_bytes(head[i + 12 : i + 16], "little")
        pre_skip = 0
    elif b"OpusHead" in head[:256]:
        i = head.index(b"OpusHead")
        n_ch = head[i + 9]
        pre_skip = int.from_bytes(head[i + 10 : i + 12], "little")
        sr = 48000  # opus always decodes at 48 kHz
    else:
        return None
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - (1 << 16), 0))
            tail = f.read()
    except OSError:
        return None
    best = 0
    pos = tail.find(b"OggS")
    while pos != -1:
        if pos + 14 <= len(tail):
            gp = int.from_bytes(tail[pos + 6 : pos + 14], "little")
            if gp != 0xFFFFFFFFFFFFFFFF:
                best = max(best, gp)
        pos = tail.find(b"OggS", pos + 4)
    if not best or not sr or not n_ch:
        return None
    return (n_ch, max(best - pre_skip, 0), sr)
