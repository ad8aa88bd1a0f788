"""Slow-query log: a bounded ring of queries that ran past
``slow-query-threshold``, each entry carrying the query text, index,
shard count, trace id, final status, and the per-query profile tree —
exposed at ``GET /debug/slow`` and emitted as structured log lines with
trace correlation (docs/observability.md).

The ring is in-process and fixed-size (``slow-log-size``): recording is
O(1) and the memory bound is entries x truncated-query-size, so an
always-on threshold cannot grow the heap.  Health/status probes are
tagged at the HTTP edge and never reach record().

Port copy of the JAX package's ``utils/slowlog.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import time
from collections import deque

from .locks import make_lock

# Default ceiling on query text stored per entry: the log must bound
# memory even against megabyte PQL bodies.  Per-instance override via
# the ``slow-log-text-max`` knob (a recorded-workload replay harness
# wants entries it can replay VERBATIM, so it raises the ceiling and
# skips the ones still marked ``textTruncated`` — bench.py's harvest).
QUERY_TEXT_MAX = 512


class SlowQueryLog:
    def __init__(self, threshold_s: float = 1.0, size: int = 128,
                 logger=None, stats=None, text_max: int | None = None):
        self.threshold_s = threshold_s
        self.size = max(int(size), 1)
        # `is not None`, not truthiness: an explicit 0 means "store no
        # query text" (e.g. sensitive PQL bodies), not "use the default"
        self.text_max = int(text_max) if text_max is not None \
            else QUERY_TEXT_MAX
        self.logger = logger
        self.stats = stats
        self._entries: deque = deque(maxlen=self.size)
        self._lock = make_lock("slowlog")
        self.recorded = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_s > 0

    def record(self, *, index: str, query: str, duration_s: float,
               shards: int | None = None, trace_id: str | None = None,
               status: int = 200, profile: dict | None = None,
               explain: dict | None = None):
        full_len = len(query or "")
        query = (query or "")[:self.text_max]
        entry = {
            # wall stamp for operator correlation only; the duration was
            # measured by the caller from a perf_counter pair
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "durationS": round(duration_s, 4),
            "index": index,
            "query": query,
            "shards": shards,
            "traceID": trace_id,
            "status": status,
        }
        if full_len > len(query):
            # an explicit flag, not a length heuristic: replay tooling
            # must KNOW the text is partial (a truncated batch replays
            # as a parse error)
            entry["textTruncated"] = True
        if profile is not None:
            entry["profile"] = profile
        if explain is not None:
            entry["explain"] = explain
        with self._lock:
            self._entries.append(entry)
            self.recorded += 1
        if self.stats is not None:
            self.stats.count("slowlog.recorded")
        if self.logger is not None:
            # structured line with trace correlation (utils/logger.py):
            # `trace=<id>` joins the log stream to /debug/traces
            emit = getattr(self.logger, "event", None)
            if emit is not None:
                emit("slow-query", durationS=entry["durationS"],
                     index=index, shards=shards, status=status,
                     trace=trace_id, query=query)
            else:
                self.logger.info(
                    f"slow-query durationS={entry['durationS']} "
                    f"index={index} shards={shards} status={status} "
                    f"trace={trace_id} query={query!r}")

    def snapshot(self) -> dict:
        with self._lock:
            entries = list(self._entries)
        return {
            "thresholdS": self.threshold_s,
            "size": self.size,
            "textMax": self.text_max,
            "recorded": self.recorded,
            "entries": entries,
        }

    def clear(self):
        with self._lock:
            self._entries.clear()
