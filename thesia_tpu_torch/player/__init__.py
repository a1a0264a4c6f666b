"""Playback: host copies of ``thesia_tpu/player/`` (see each module)."""
