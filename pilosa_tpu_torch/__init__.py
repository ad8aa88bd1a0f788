"""pilosa_tpu_torch — the PyTorch / CUDA port of pilosa-tpu for NVIDIA
Hopper GPUs.

It answers PQL read requests over the same data model (index / field /
view / 2^20-column shard / fragment), the same on-disk formats and the
same results as the JAX package beside it, which stays the reference.
The port imports ``torch`` and ``numpy`` only, never ``jax`` and nothing
of the JAX package.  Its two container kernels are hand-written CUDA for
``sm_90a`` (``csrc/container_kernels.cu``, bound in ``ops/kernels.py``).

Entry points take an explicit device: ``Executor(holder, device=None)``
runs on every visible card (``cuda``; ``cuda:k`` one card, a list
exactly those devices) and raises without a card; pass ``device="cpu"``
for the plain PyTorch paths.  ``convert.holder_from_arrays`` builds a holder from
plain arrays.  ``python -m pilosa_tpu_torch server`` serves the HTTP API
on the card (``--device cpu`` for the plain paths).
"""

__version__ = "0.1.0"
