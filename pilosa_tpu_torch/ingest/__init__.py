"""Streaming ingest subsystem — the port of the JAX package's
``ingest/`` package.

The production write path: length-prefixed binary frames off the socket
(``wire``), per-fragment group commit — one WAL frame, one generation
bump, one rank-cache touch per flush, not per request (``committer``) —
and device delta overlays so freshly ingested bits reach queries without
re-staging whole fragments (``delta``, the overlay branch of
storage/fragment.py ``Fragment.device`` and parallel/stacked.py).

``IngestBackpressure`` lives in the JAX package's
``parallel/cluster.py``, which the port does not have yet; it moved here,
with the cluster error base class it derives from there replaced by
``RuntimeError``.  Only the cluster's ingest forward raises it.
"""

from .committer import GroupCommitter
from .wire import (FrameError, FrameReader, MAGIC, REC_BITS, REC_BITS_TS,
                   REC_VALS, encode_frame, encode_records, pack_bits,
                   pack_values)


class IngestBackpressure(RuntimeError):
    """A forwarded ingest batch was refused 503 by the shard owner (its
    group-commit backlog is over high-water).  The coordinator maps this
    back to its own 503 + Retry-After so the producer backs off the
    whole (idempotent) stream — backpressure propagates end-to-end
    instead of queueing invisibly."""


__all__ = [
    "GroupCommitter", "FrameError", "FrameReader", "IngestBackpressure",
    "MAGIC", "REC_BITS", "REC_BITS_TS", "REC_VALS",
    "encode_frame", "encode_records", "pack_bits", "pack_values",
]
