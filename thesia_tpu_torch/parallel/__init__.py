"""Device mesh of the batched spectrogram recompute (``sharding.py``)."""
