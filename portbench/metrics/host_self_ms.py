"""``host_self_ms``: the median over the window's requests of the
executor front's own time (``api.py``, ``executor/``, ``pql/``): the
request's ``api.Query`` span less the part of it that its
``batcher.submit`` spans (queue and launch) and ``executor.fetch`` spans
(the device wait) cover."""

from __future__ import annotations

from portbench import spans


def snapshot(run):
    return spans.window(run, "host_self_ms")


def _self(req):
    return spans.total_ms(req, "api.Query") - spans.covered_ms(
        req, ("batcher.submit", "executor.fetch"))


def read(run, before, after):
    return spans.median_ms(after, _self)
