"""Host copies of ``thesia_tpu/io``: WAV, FLAC and ffmpeg decoding."""
