"""``device_wait_ms``: the median over the window's requests of the time
their threads waited on the device's stream: the launch that carried
each of their tickets (its ``batcher.submit`` less its ``batcher.queue``:
the dispatcher's enqueue, which blocks while the stream's queue is
full) and each ``executor.fetch`` (``executor/executor.py``
``_resolve_pendings``: the wait behind every launch on the stream
before its own, then the copy to the host)."""

from __future__ import annotations

from portbench import spans


def snapshot(run):
    return spans.window(run, "device_wait_ms")


def _wait(req):
    return (spans.total_ms(req, "batcher.submit")
            - spans.total_ms(req, "batcher.queue")
            + spans.total_ms(req, "executor.fetch"))


def read(run, before, after):
    return spans.median_ms(after, _wait)
