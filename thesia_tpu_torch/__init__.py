"""thesia_tpu_torch: the PyTorch/CUDA port of thesia_tpu.

The JAX package ``thesia_tpu`` is the reference; this package computes the
same spectrograms, images and tiles with PyTorch tensor code and hand-written
CUDA kernels (``csrc/``).  It imports torch and never jax, and nothing of the
JAX package: the host modules it needs (``common``, ``io``, ``native``,
``obs`` and parts of ``dsp``, ``render`` and ``engine``) are copies, each
naming its original and pinned against it by a test.
"""
