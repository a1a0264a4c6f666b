"""Host copies of ``thesia_tpu/common``: mel scale, frequency scale, windows."""
