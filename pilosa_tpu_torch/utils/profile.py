"""Per-query profiles: an EXPLAIN ANALYZE for PQL
(docs/observability.md).

A ``QueryProfile`` is a stage-timing tree collected over one query's
lifetime — admission wait, parse/plan, result-cache lookup, batcher
queue + coalesce, per-shard-slice device exec with upload/evict counts,
per-peer fan-out RTT, reduce — threaded through the layers via a
contextvar like the deadline context (utils/deadline.py), so deep layers
add stages without new parameters on every dispatch signature.

The HTTP handler activates a profile for query routes whenever the
client asked for one (``?profile=true``, or the ``profile-default``
knob) OR the slow-query log is enabled (slow entries carry the tree);
the response embeds it only when requested.  Collection cost is a
handful of contextvar reads and dict appends per query — bench.py's
observability smoke leg asserts the profile-off serving path stays
within noise of the batching leg.

Stages nest on the owning request thread via ``stage()``; contributions
from OTHER threads (the dispatch batcher's queue wait, fused launches)
attach as finished events under a node captured at submit time
(``capture()`` + ``QueryProfile.event(..., node=...)``) — appends are
lock-protected, and the owner is blocked on the future while they
happen.

Port copy of the JAX package's ``utils/profile.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager

from .locks import make_lock


class ProfileNode:
    __slots__ = ("name", "duration_s", "tags", "children")

    def __init__(self, name: str):
        self.name = name
        self.duration_s: float | None = None
        self.tags: dict = {}
        self.children: list[ProfileNode] = []

    def to_dict(self) -> dict:
        out = {"name": self.name,
               "durationMS": None if self.duration_s is None
               else round(self.duration_s * 1e3, 4)}
        if self.tags:
            out["tags"] = self.tags
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class QueryProfile:
    """One query's stage tree.  The stage stack is owned by the request
    thread; ``event()`` may be called from any thread."""

    def __init__(self):
        self.root = ProfileNode("query")
        self._t0 = time.perf_counter()
        self._stack = [self.root]
        self._lock = make_lock("profile")

    @contextmanager
    def stage(self, name: str):
        node = ProfileNode(name)
        with self._lock:
            self._stack[-1].children.append(node)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            node.duration_s = time.perf_counter() - t0
            self._stack.pop()

    def event(self, name: str, duration_s: float,
              node: ProfileNode | None = None, **tags):
        """Append an already-finished stage under ``node`` (a node
        captured via capture()) or the current stack top."""
        ev = ProfileNode(name)
        ev.duration_s = duration_s
        ev.tags = tags
        with self._lock:
            (node if node is not None else self._stack[-1]) \
                .children.append(ev)

    def tag(self, key, value):
        self._stack[-1].tags[key] = value

    def current_node(self) -> ProfileNode:
        return self._stack[-1]

    def to_dict(self) -> dict:
        if self.root.duration_s is None:
            self.root.duration_s = time.perf_counter() - self._t0
        return self.root.to_dict()

    def finish(self):
        self.root.duration_s = time.perf_counter() - self._t0


_VAR: contextvars.ContextVar[QueryProfile | None] = \
    contextvars.ContextVar("pilosa_tpu_query_profile", default=None)


def current() -> QueryProfile | None:
    return _VAR.get()


@contextmanager
def activate(prof: QueryProfile | None):
    """Install ``prof`` for the with-block; activate(None) is a no-op
    passthrough (keeps call sites simple, like deadline.activate)."""
    if prof is None:
        yield None
        return
    token = _VAR.set(prof)
    try:
        yield prof
    finally:
        _VAR.reset(token)


@contextmanager
def stage(name: str):
    """Open a named stage on the active profile; yields the node (None
    when no profile is active — the hot-path cost is one contextvar
    read)."""
    prof = _VAR.get()
    if prof is None:
        yield None
        return
    with prof.stage(name) as node:
        yield node


def event(name: str, duration_s: float, **tags):
    prof = _VAR.get()
    if prof is not None:
        prof.event(name, duration_s, **tags)


def capture():
    """(profile, current node) for cross-thread contributions, or
    (None, None) when no profile is active."""
    prof = _VAR.get()
    if prof is None:
        return None, None
    return prof, prof.current_node()
