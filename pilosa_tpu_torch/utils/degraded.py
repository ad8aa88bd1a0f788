"""Per-request degraded-state accumulator (docs/robustness.md
"Corruption quarantine" and "Partial results").

A query that touches quarantined fragments still answers — those
fragments contribute EMPTY rows — but the response must say so: silent
partial answers are how corruption poisons downstream systems.  The HTTP
handler opens a collector around query execution; the coordinator notes
peer-reported quarantine counts as fan-out responses are consumed (on
the request thread), the handler adds the local count, and the response
carries a ``degraded`` object when the total is non-zero.

The same collector carries the PARTIAL-RESULTS contract
(``?partialResults=true`` / the ``partial-results`` server default): a
read fan-out whose shards are truly unservable — every replica dead,
partitioned, or exhausted — may degrade to a partial answer instead of
failing, but ONLY when the collector allows it, and the response's
``degraded`` object then names exactly the missing shards and the nodes
that failed to serve them, so a caller can never mistake partial for
complete.

Contextvar-based like utils/profile.py: zero cost and inert when no
collector is active (internal hops, background work).

Port copy of the JAX package's ``utils/degraded.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars

_collector: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "ptpu-degraded", default=None)


@contextlib.contextmanager
def collect(allow_partial: bool = False):
    """Activate a fresh accumulator for this request; yields the dict
    that note()/note_missing() mutate.  ``allow_partial``: the caller
    opted into partial results (?partialResults=true or the
    partial-results server default) — without it, unservable shards
    still fail the query loudly."""
    acc = {"quarantinedFragments": 0, "missingShards": {},
           "missingNodes": set(), "allowPartial": bool(allow_partial)}
    token = _collector.set(acc)
    try:
        yield acc
    finally:
        _collector.reset(token)


def note(n: int = 1):
    """Record n quarantined fragments touched by the current request
    (no-op outside a collector)."""
    acc = _collector.get()
    if acc is not None and n:
        acc["quarantinedFragments"] += n


def partial_allowed() -> bool:
    """May the current request degrade to a partial answer?  False
    outside a collector (internal hops, background work): the fan-out
    then fails loudly, exactly the pre-partial behavior."""
    acc = _collector.get()
    return bool(acc is not None and acc["allowPartial"])


def note_missing(index: str, shards, nodes=()):
    """Record shards the current request could NOT serve (every replica
    unavailable) and the nodes that failed to serve them.  The response
    builder turns these into ``degraded.missingShards`` /
    ``degraded.missingNodes`` — the exact-loss contract partial results
    stand on."""
    acc = _collector.get()
    if acc is None:
        return
    acc["missingShards"].setdefault(index, set()).update(
        int(s) for s in shards)
    acc["missingNodes"].update(nodes)


def is_partial() -> bool:
    """Did the current request actually lose shards?  (Used to keep a
    partial answer OUT of the result cache — a later healthy repeat
    must not serve the degraded answer.)"""
    acc = _collector.get()
    return bool(acc is not None and acc["missingShards"])


def is_degraded() -> bool:
    """Did the current request degrade in ANY way — lost shards OR
    quarantined fragments?  This is the result-cache fill guard:
    ``is_partial()`` alone would memoize a quarantined-degraded answer
    (empty rows standing in for poisoned fragments) and keep serving it
    after the fragments heal."""
    acc = _collector.get()
    return bool(acc is not None and (acc["missingShards"]
                                     or acc["quarantinedFragments"]))


def to_response(acc: dict) -> dict | None:
    """The wire ``degraded`` object for a finished collector, or None
    when the request was not degraded at all."""
    out = {}
    if acc["quarantinedFragments"]:
        out["quarantinedFragments"] = acc["quarantinedFragments"]
    if acc["missingShards"]:
        out["missingShards"] = {i: sorted(s)
                                for i, s in acc["missingShards"].items()}
        out["missingNodes"] = sorted(acc["missingNodes"])
    return out or None
