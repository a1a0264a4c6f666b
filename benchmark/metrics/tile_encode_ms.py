"""tile_encode_ms: render + engine.images.tile_body -- the
``tile.spectrogram_encode`` span's mean a tile."""

UNIT = "ms"


def read(run):
    n = run.span_count("tile.spectrogram_encode")
    return run.span_ms("tile.spectrogram_encode") / n if n else None
