"""``batcher_queue_ms``: the median over the window's requests of the
time their tickets waited in the dispatch batcher's queue
(``parallel/batcher.py``): each request's ``batcher.queue`` spans, from
enqueue to the start of the launch that carried the ticket.  That
includes the time the one dispatcher spent on earlier launches, blocked
in their enqueue while the stream's queue was full."""

from __future__ import annotations

from portbench import spans


def snapshot(run):
    return spans.window(run, "batcher_queue_ms")


def read(run, before, after):
    return spans.median_ms(after,
                           lambda r: spans.total_ms(r, "batcher.queue"))
