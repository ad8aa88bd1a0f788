"""End-to-end query deadlines (reference executor.go:2455 mapReduce
carrying ctx into every remoteExec hop).

A ``QueryContext`` is created at the HTTP edge (``?timeout=`` query
parameter, the ``X-Pilosa-Tpu-Deadline`` header on internal hops, or the
server's configured ``query-timeout`` default) and threaded through
``api.query`` -> ``Cluster.execute`` / ``Executor.execute`` -> the mesh
shard-slice loops.  Long-running phases call ``check()`` between units of
work (per PQL call, per shard slice, per fan-out retry wave) so an
expired query aborts instead of running to completion; the handler maps
``DeadlineExceeded`` to HTTP 504 with elapsed/budget in the body.

Across the wire the coordinator sends its REMAINING budget in the
``X-Pilosa-Tpu-Deadline`` header, so remotes inherit the shrunken budget
rather than restarting the clock (client-side socket timeouts are clamped
to the same remaining budget, bounding the total latency to ~the budget
even against a hung peer).

The active context also rides a contextvar so deep layers (mesh slice
iteration) can check it without threading a parameter through every
dispatch signature; worker threads that cross a pool boundary receive the
budget explicitly (the fan-out passes remaining seconds as an argument).

Port copy of the JAX package's ``utils/deadline.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager

# Remaining-budget header on node-to-node hops (seconds, float text).
DEADLINE_HEADER = "X-Pilosa-Tpu-Deadline"


class DeadlineExceeded(Exception):
    """The query ran past its deadline or was cancelled (HTTP 504)."""


class QueryContext:
    """Deadline + cancellation flag for one query's lifetime."""

    __slots__ = ("budget", "start", "deadline", "cancelled")

    def __init__(self, budget: float | None = None):
        self.budget = budget if budget and budget > 0 else None
        self.start = time.monotonic()
        self.deadline = None if self.budget is None \
            else self.start + self.budget
        self.cancelled = False

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def remaining(self) -> float | None:
        """Seconds left in the budget; None = unlimited."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        if self.cancelled:
            return True
        return self.deadline is not None \
            and time.monotonic() >= self.deadline

    def cancel(self):
        """Mark the query cancelled; the next check() aborts it."""
        self.cancelled = True

    def check(self, where: str = ""):
        """Raise DeadlineExceeded if expired/cancelled; no-op otherwise."""
        if not self.expired():
            return
        what = "query cancelled" if self.cancelled \
            else "query deadline exceeded"
        at = f" at {where}" if where else ""
        budget = f"{self.budget:.3f}s" if self.budget is not None else "-"
        raise DeadlineExceeded(
            f"{what}{at} (elapsed {self.elapsed():.3f}s, budget {budget})")


_CURRENT: contextvars.ContextVar[QueryContext | None] = \
    contextvars.ContextVar("pilosa_tpu_query_ctx", default=None)


def current() -> QueryContext | None:
    """The active QueryContext of this thread of execution, if any."""
    return _CURRENT.get()


@contextmanager
def activate(ctx: QueryContext | None):
    """Install ``ctx`` as the current context for the with-block.
    ``activate(None)`` is a no-op passthrough (keeps call sites simple)."""
    if ctx is None:
        yield None
        return
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def check_current(where: str = ""):
    """check() on the current context; no-op when none is active."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.check(where)
