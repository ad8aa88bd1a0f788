"""``batch_occupancy``: tickets a device launch of the dispatch batcher
(``parallel/batcher.py``) carried over the window, from the batch-size
histogram's sum and count (a launch of one ticket counts as one)."""

from __future__ import annotations


def snapshot(run):
    b = run.api.executor.batcher
    if b is None:
        return None
    s = b.batch_size_hist.snapshot()
    return s["count"], s["sum"]


def read(run, before, after):
    if before is None or after is None or after[0] == before[0]:
        return None
    return (after[1] - before[1]) / (after[0] - before[0])
