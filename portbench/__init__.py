"""The benchmark of the PyTorch / CUDA port (``pilosa_tpu_torch``).

One run serves one cell of ``BENCHMARK.json`` (a deployment under a
traffic mix) through ``pilosa_tpu_torch.api.API.query`` for a fixed
window and prints one JSON line; ``python3 portbench/run.py --help``.
Everything that measures lives here: the generators, the traffic decks,
the closed loop, the readers of the per-layer metrics, the bytes a call
needs, the table of peaks and the plain reference that decides
``correct``.  Nothing here imports ``jax`` or ``pilosa_tpu``; the
reference imports nothing of the port either.
"""
