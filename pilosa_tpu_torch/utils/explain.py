"""Query EXPLAIN: the per-query decision record
(docs/observability.md "Query EXPLAIN").

``?profile=true`` answers *where the time went*; ``?explain=true``
answers *why the query took the path it did*: how the request lowered
(whole-query program signature, or the counted fallback reason), which
replica each shard was routed to and what score chose it (EWMA RTT x
queue pressure x residency tier, breaker pre-skips), what the caches
decided (result-cache key components and hit/miss, rank-cache prune vs
full-scan fallback), which hedges fired and which won, and what the
device actually launched (signature, padded vs actual rows, decode
bytes).

All of that is telemetry the layers already compute at decision time —
this module is the contextvar spine that collects it, exactly the
``utils/profile.py`` pattern: the HTTP handler activates a record for
``?explain=true`` (and silently whenever the slow-query log is on, so
slow entries carry the record), deep layers append via module-level
``note()``/``set_info()`` (one contextvar read when inactive), and the
response embeds ``explain`` ONLY when requested.  Answers are
byte-identical with explain on — the record rides the response
envelope, never the results.

The launches section is assembled from the profile tree's
``device.launch``/``batcher.launch`` events rather than re-collected
(explain activation implies profile collection), so one launch has one
source of truth and the explain record cross-checks against the launch
ledger by signature.

Port copy of the JAX package's ``utils/explain.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

from .locks import make_lock

# Per-section entry cap: a 10k-shard fan-out must not build a 10k-row
# routing table into every slow-log entry.  Overflow is counted in the
# section's `truncated` field, never silently dropped.
SECTION_MAX = 256


class ExplainRecord:
    """One query's decision record.  Sections are append-only lists
    (routing / dispatch / caches / hedges / plan); ``info`` holds
    scalars.  Appends may come from any thread that inherited the
    request's context (the fan-out pool workers do, via Tracer.task's
    contextvar propagation)."""

    def __init__(self):
        self._lock = make_lock("explain")
        self._sections: dict[str, list] = {}
        self._truncated: dict[str, int] = {}
        self.info: dict = {}

    def note(self, section: str, entry: dict):
        with self._lock:
            rows = self._sections.setdefault(section, [])
            if len(rows) >= SECTION_MAX:
                self._truncated[section] = \
                    self._truncated.get(section, 0) + 1
                return
            rows.append(entry)

    def set_info(self, key: str, value):
        with self._lock:
            self.info[key] = value

    def to_dict(self, profile: dict | None = None) -> dict:
        with self._lock:
            out = dict(self.info)
            for section, rows in self._sections.items():
                out[section] = list(rows)
            for section, n in self._truncated.items():
                out.setdefault("truncated", {})[section] = n
        if profile is not None:
            launches = []
            _collect_launches(profile, launches)
            if launches:
                out["launches"] = launches[:SECTION_MAX]
        return out


def _collect_launches(node: dict, out: list):
    """Walk a profile tree for device-launch evidence: ``device.launch``
    events carry the executable signature + padded-vs-actual rows +
    decode bytes; ``batcher.launch`` events carry the fused-batch
    attribution for launches that ran on the dispatcher thread."""
    name = node.get("name")
    if name in ("device.launch", "batcher.launch"):
        entry = {"stage": name,
                 "durationMS": node.get("durationMS")}
        entry.update(node.get("tags") or {})
        out.append(entry)
    for c in node.get("children", ()):
        _collect_launches(c, out)


_VAR: contextvars.ContextVar[ExplainRecord | None] = \
    contextvars.ContextVar("pilosa_tpu_explain", default=None)


def current() -> ExplainRecord | None:
    return _VAR.get()


def active() -> bool:
    """Cheap gate for call sites whose entry CONSTRUCTION is the cost
    (the router's per-shard score table)."""
    return _VAR.get() is not None


def wants(section: str) -> bool:
    """True when a record is active AND ``section`` still has capacity.
    Hot call sites that build per-item entries in a loop (the router's
    per-shard score table on a many-thousand-shard fan-out) gate each
    iteration on this, so the SECTION_MAX cap bounds construction, not
    just storage — without it the overflow entries are built, locked,
    and then dropped."""
    rec = _VAR.get()
    if rec is None:
        return False
    with rec._lock:
        return len(rec._sections.get(section, ())) < SECTION_MAX


@contextmanager
def activate(rec: ExplainRecord | None):
    """Install ``rec`` for the with-block; activate(None) is a no-op
    passthrough (the profile.activate convention)."""
    if rec is None:
        yield None
        return
    token = _VAR.set(rec)
    try:
        yield rec
    finally:
        _VAR.reset(token)


def note(section: str, entry: dict):
    rec = _VAR.get()
    if rec is not None:
        rec.note(section, entry)


def set_info(key: str, value):
    rec = _VAR.get()
    if rec is not None:
        rec.set_info(key, value)
