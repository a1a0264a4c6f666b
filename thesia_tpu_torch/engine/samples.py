"""DeviceSamples: where a track's samples live on the device, and who may ask
for them.

The port's own (the JAX package keeps this rule in its manager).  A
TrackManager builds one over its spectrogram analyzer's wav cache
(``tm.samples``), so a re-``init`` that makes a new manager makes a new store;
the session's TrackList takes it (``TrackList(device, samples=tm.samples)``).
It alone knows the cache keys, a track's original samples under the track id
and the post-guard samples the device route of the gain and guard (K10) made
under ``(track id, "guarded")``, their tokens (``Audio.version``) and the rule
of what a spectrogram and K9 read: the original times float32(g) while the
guard was a no-op (``AudioTrack.device_scalar_gain``), so a normalize change
never re-uploads; else the post-guard samples.  The two keys live side by
side, so a turn back to a no-op guard finds the original still there.

An add's big-WAV prefetch hands its pending uploads here (``expect``): the
first ask for a track's samples adopts that track's upload, and
``adopt_pending`` decides the rest once the add has decoded.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def _guarded(track_id: int) -> tuple:
    """The wav cache's key of a track's post-guard samples."""
    return (track_id, "guarded")


class DeviceSamples:
    def __init__(self, analyzer):
        self.analyzer = analyzer
        self._pending: dict = {}  # {track id: Future of a prefetched upload}

    def spec_item(self, track_id: int, track):
        """(wavs, cache key, token, gain) as the analyzer takes them: the
        original samples and the scalar gain the kernel applies while the
        guard was a no-op, else the post-guard samples and 1."""
        g = track.device_scalar_gain()
        if g is not None:
            return track.original.wavs, track_id, track.original.version, g
        return track.audio.wavs, _guarded(track_id), track.audio.version, 1.0

    def current(self, track_id: int, track):
        """(samples, gain): the (C, n) f32 device tensor the spectrogram and
        K9 read, whose float32(gain) multiple is ``track.audio``'s samples,
        uploaded once under (cache key, token)."""
        self._adopt_one(track_id, track)
        wavs, key, token, gain = self.spec_item(track_id, track)
        return self.analyzer.device_wav(wavs, key, token), gain

    def original(self, track_id: int, track):
        """The track's original samples on the device (uploaded once a
        version)."""
        self._adopt_one(track_id, track)
        return self.analyzer.device_wav(track.original.wavs, track_id, track.original.version)

    def keep_guarded(self, track_id: int, track, samples) -> None:
        """Keep the post-guard device samples of ``track.audio`` where
        ``current`` looks for them, unless they are the original times the
        gain (the guard changed nothing)."""
        if track.device_scalar_gain() is None:
            self.analyzer.install_wav(_guarded(track_id), samples, track.audio.version)

    def drop(self, track_id: int) -> None:
        self.analyzer.drop_wav(track_id)
        self.analyzer.drop_wav(_guarded(track_id))

    # -- the big-WAV prefetch ---------------------------------------------
    def expect(self, uploads: dict) -> None:
        """An add's pending uploads ({track id: Future of (device payload,
        n, probe) or None}); any an earlier add left undecided are dropped."""
        self._pending = dict(uploads)

    def adopt_pending(self, tracks: dict) -> None:
        """Adopt the pending upload of each track of ``tracks`` ({track id:
        track}, the add's decoded tracks) and cancel the rest: a track that
        failed to decode must not wait for a doomed transfer."""
        for tid in list(self._pending):
            if tid in tracks:
                self._adopt_one(tid, tracks[tid])
            else:
                self._pending.pop(tid).cancel()

    def _adopt_one(self, track_id: int, track) -> None:
        """Install the track's pending upload, if any, once the decoded
        samples vouch for the uploaded bytes (shape and strided probe); the
        entry is popped, so each is decided once."""
        fut = self._pending.pop(track_id, None)
        if fut is None:
            return
        an = self.analyzer
        try:
            res = fut.result()
        except Exception:
            an.prefetch_failed += 1
            log.warning("wav prefetch for track %s failed; decode path will upload",
                        track_id, exc_info=True)
            return
        if res is None:
            return
        dev, n, probe = res
        w = track.original.wavs
        if w.shape != (dev.shape[0], n) or not an.prefetch_matches(probe, w):
            an.prefetch_failed += 1
            log.warning("wav prefetch for track %s does not match its decode", track_id)
            return
        an.adopt_wav(track_id, dev, n, track.original.version)
