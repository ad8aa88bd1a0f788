"""The closed loop and its latency arithmetic.

``latency_record`` and the client loop are copied from the port's bench
(``pilosa_tpu_torch/bench.py`` ``latency_record`` and ``closed_loop``);
the loop here runs for a fixed window instead of a fixed count: every
client sends its next request when its previous one returns, until the
window's end, and the window closes when the last request returns.  A
rate is over every request and the whole window; a percentile is over
every request.
"""

from __future__ import annotations

import math
import statistics
import threading
import time

TAIL_SAMPLES = 10


def latency_record(lat_s: list) -> dict:
    """The request median and the highest percentile with at least
    TAIL_SAMPLES samples beyond it, with the sample count; the tail is
    null until it lies above the median (more than 2 x TAIL_SAMPLES
    samples)."""
    lat = sorted(lat_s)
    n = len(lat)
    rec = {"samples": n, "p50_ms": statistics.median(lat) * 1e3,
           "tail_pct": None, "tail_ms": None}
    if n > 2 * TAIL_SAMPLES:
        rec["tail_pct"] = 100.0 * (n - TAIL_SAMPLES) / n
        rec["tail_ms"] = lat[n - TAIL_SAMPLES - 1] * 1e3
    return rec


def percentile(lat_s: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    lat = sorted(lat_s)
    return lat[max(0, math.ceil(q / 100.0 * len(lat)) - 1)]


class Request:
    __slots__ = ("name", "pql", "t0", "t1", "result", "error")

    def __init__(self, name, pql):
        self.name, self.pql = name, pql
        self.t0 = self.t1 = None
        self.result = self.error = None


def closed_loop(send, cards, offsets, seconds: float):
    """Each client ``k`` sends ``cards[(offsets[k] + i) % len(cards)]``
    for i = 0, 1, ... through ``send(pql)`` until ``seconds`` have passed
    since the start, each when its previous request returned.  Returns
    (window start, window end, requests): the end is when the last
    request returned."""
    reqs: list[list[Request]] = [[] for _ in offsets]
    start = threading.Barrier(len(offsets) + 1)
    t_start = [0.0]

    def client(k):
        i = offsets[k]
        start.wait()
        t_end = t_start[0] + seconds
        while time.perf_counter() < t_end:
            name, pql = cards[i % len(cards)]
            i += 1
            r = Request(name, pql)
            r.t0 = time.perf_counter()
            try:
                r.result = send(pql)
            except Exception as e:   # a failed request counts in `failed`
                r.error = f"{type(e).__name__}: {e}"
            r.t1 = time.perf_counter()
            reqs[k].append(r)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(len(offsets))]
    for t in threads:
        t.start()
    t_start[0] = time.perf_counter()
    start.wait()
    for t in threads:
        t.join()
    done = [r for rs in reqs for r in rs]
    t_stop = max((r.t1 for r in done), default=t_start[0])
    return t_start[0], t_stop, done
