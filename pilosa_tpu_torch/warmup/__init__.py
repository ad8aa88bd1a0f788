"""Warm-start subsystem: durable signature corpus and warmup to READY —
the port of the JAX package's ``warmup/`` package.

* ``corpus`` — a CRC-framed durable log of what this process runs
  (signature, shape fingerprint, params template, traffic), in the JAX
  package's format;
* ``replayer`` — the boot-time coordinator that replays the top-N corpus
  queries through the real executor before READY, twice each, so that
  their CUDA graphs are captured before the first client request.

The JAX package's ``compile_cache.py`` has no counterpart: it only points
JAX's persistent XLA compilation cache at the data dir, and CUDA graphs
do not outlive their process.  The ``compile-cache-dir`` and
``compile-cache-mb`` keys are accepted and unused, and the coordinator's
``cacheEnabled`` reads false.
"""

from .corpus import CorpusRecorder, SignatureCorpus, top_n
from .replayer import (PHASE_COLD, PHASE_READY, PHASE_WARMING,
                       WarmupCoordinator)

__all__ = [
    "CorpusRecorder", "SignatureCorpus", "top_n",
    "PHASE_COLD", "PHASE_READY", "PHASE_WARMING", "WarmupCoordinator",
]
