"""Bitset, container and BSI ops of the PyTorch port (the JAX package's
``ops/``), plus the hand-written CUDA container kernels (``kernels``)."""

from . import bitset, bsi  # noqa: F401
