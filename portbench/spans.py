"""The port's spans of the traced window, for the span readers.

Every reader's ``snapshot`` calls ``window(run, name)``.  Before the
window the first call registers one sink for the run on the port's
tracer (``GLOBAL_TRACER.add_sink``), and every call returns None; after
the window the first call takes the sink off, and every call returns the
span dicts the window finished.  A port whose tracer has no sinks gives
None both times, and its readers read nothing.  ``requests`` groups
those spans by request: one trace a served query, whose id is its
``api.Query`` span's.
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def window(run, name: str):
    from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER
    if not hasattr(GLOBAL_TRACER, "add_sink"):
        return None
    w = getattr(run, "span_window", None)
    if w is None:
        w = run.span_window = {"sink": [], "before": set()}
        GLOBAL_TRACER.add_sink(w["sink"])
    if name not in w["before"]:
        w["before"].add(name)
        return None
    GLOBAL_TRACER.remove_sink(w["sink"])
    return w["sink"]


def requests(spans) -> list[dict]:
    """One ``{span name: [span dicts]}`` a trace that holds an
    ``api.Query`` span."""
    by_trace: dict = defaultdict(lambda: defaultdict(list))
    for s in spans:
        by_trace[s["traceID"]][s["name"]].append(s)
    return [t for t in by_trace.values() if "api.Query" in t]


def total_ms(req: dict, name: str) -> float:
    """The summed duration of a request's spans of one name."""
    return sum(s["durationMS"] for s in req.get(name, ()))


def covered_ms(req: dict, names) -> float:
    """How much of the time line a request's spans of ``names`` cover
    (their intervals' union)."""
    iv = sorted((s["start"], s["start"] + s["durationMS"] / 1e3)
                for n in names for s in req.get(n, ()))
    out, end = 0.0, None
    for lo, hi in iv:
        if end is None or lo > end:
            out += hi - lo
            end = hi
        elif hi > end:
            out += hi - end
            end = hi
    return out * 1e3


def median_ms(spans, per_request) -> float | None:
    """The median over the window's requests of ``per_request(req)``."""
    if spans is None:
        return None
    vals = [per_request(r) for r in requests(spans)]
    return statistics.median(vals) if vals else None
