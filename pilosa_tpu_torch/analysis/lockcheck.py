"""Runtime lock-order race detector (docs/static-analysis.md).

A committer race — two inline flushers acking a WAL sequence another
thread was still writing — was an ORDERING bug no unit test saw until
interleavings lined up.  Go's engine leans on ``-race``; this is the
ordering half of that idea for the port's lock-using modules: every
lock the project takes is created through ``utils/locks.py`` with a
lock-CLASS name (``fragment``, ``holder``, ``budget``,
``committer-flush``, ...), and when ``PILOSA_TPU_LOCKCHECK`` is set the
factories hand out instrumented primitives that

* keep the per-thread held-lock stack,
* record every acquisition edge (class held -> class acquired) into a
  process-global order graph with the first sample site per edge,
* flag same-class nesting on distinct objects immediately (unless the
  class is declared self-nesting-safe below), plus same-thread
  re-acquire of a non-reentrant lock (guaranteed self-deadlock),
* detect order-inversion cycles over the class graph at report time.

Reports surface at process exit (stderr) and at ``/debug/locks``; with
``PILOSA_TPU_LOCKCHECK=strict`` a dirty report hard-fails the process,
which is how CI turns the chaos/overload/ingest suites' interleavings
into race coverage.  Unarmed processes pay nothing: the factories
return plain ``threading`` primitives and this module is never
imported.

Port copy of the JAX package's ``analysis/lockcheck.py``, unchanged in
behaviour.
"""

from __future__ import annotations

import os
import threading
import traceback

# Lock classes that may legitimately nest instances of themselves.
# Keep this list justified (docs/static-analysis.md hierarchy table):
#   stats      — StatsClient._share_with hands one shared lock to every
#                child client, so "nesting" is the same object via two
#                names; distinct-instance nesting (server stats inside a
#                private bench instance) is scoped and acyclic.
#   budget     — DeviceBudget instances (device / host-stage / ingest-
#                delta) are independent leaf registries; eviction
#                callbacks run OUTSIDE the lock by design, so nested
#                instances cannot form a cycle.
SELF_NESTING_OK = {"stats", "budget"}

_MODE = os.environ.get("PILOSA_TPU_LOCKCHECK", "").strip().lower()


def mode() -> str:
    return _MODE


def armed() -> bool:
    return _MODE not in ("", "0", "off")


def strict() -> bool:
    return _MODE in ("strict", "fail")


class _Graph:
    """Process-global acquisition-order graph + violation log.  Guarded
    by a RAW lock — the checker must never recurse into itself."""

    def __init__(self):
        self._mu = threading.Lock()
        # (held_cls, acquired_cls) -> first sample site
        self.edges: dict[tuple[str, str], str] = {}
        # kind -> {dedupe_key: description}
        self.violations: dict[str, dict[str, str]] = {}

    def _site(self, skip: int = 3) -> str:
        # nearest non-lockcheck frame: the acquisition site itself
        for frame in reversed(traceback.extract_stack()[:-skip]):
            if "lockcheck" not in frame.filename \
                    and "threading" not in frame.filename:
                return f"{frame.filename}:{frame.lineno} in {frame.name}"
        return "?"

    def note_edge(self, held: str, acquired: str):
        key = (held, acquired)
        if key in self.edges:          # cheap unlocked membership probe
            return
        site = self._site()
        with self._mu:
            self.edges.setdefault(key, site)

    def note_violation(self, kind: str, dedupe: str, desc: str):
        with self._mu:
            self.violations.setdefault(kind, {}).setdefault(dedupe, desc)

    def cycles(self) -> list[list[str]]:
        """Elementary order-inversion cycles over the class graph
        (self-edges are the same-class-nesting check's business)."""
        with self._mu:
            adj: dict[str, set[str]] = {}
            for a, b in self.edges:
                if a != b:
                    adj.setdefault(a, set()).add(b)
        out: list[list[str]] = []
        seen_cycles: set[frozenset] = set()

        def dfs(start: str, node: str, path: list[str],
                on_path: set[str]):
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(path + [start])
                elif nxt not in on_path and nxt > start:
                    # only expand nodes ordered after start: each cycle
                    # is found exactly once, from its smallest node
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out

    def report(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            edges = [{"from": a, "to": b, "site": s}
                     for (a, b), s in sorted(self.edges.items())]
            violations = [
                {"kind": kind, "detail": desc}
                for kind, entries in sorted(self.violations.items())
                for desc in entries.values()
            ]
        for cyc in cycles:
            edge_sites = {f"{a}->{b}": self.edges.get((a, b), "?")
                          for a, b in zip(cyc, cyc[1:])}
            violations.append({
                "kind": "order-inversion",
                "detail": f"lock classes acquired in conflicting orders: "
                          f"{' -> '.join(cyc)} (sites: {edge_sites})"})
        return {"mode": _MODE or "off", "armed": armed(),
                "lockClasses": sorted({c for e in self.edges for c in e}),
                "edges": edges, "violations": violations}

    def reset(self):
        with self._mu:
            self.edges.clear()
            self.violations.clear()


GRAPH = _Graph()
_TLS = threading.local()


def _held() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _note_acquiring(lock: "_CheckedBase"):
    # Reentrancy guard: a gc callback (utils/gcnotify.py) can fire inside
    # the checker's own bookkeeping (note_edge allocates) and acquire an
    # instrumented lock — re-entering the graph lock on the same thread
    # would self-deadlock the detector.  Held-stack pushes still happen;
    # only graph/violation recording is skipped for the nested acquire.
    if getattr(_TLS, "busy", False):
        return
    _TLS.busy = True
    try:
        _note_acquiring_inner(lock)
    finally:
        _TLS.busy = False


def _note_acquiring_inner(lock: "_CheckedBase"):
    held = _held()
    # Lazily prune hand-offs: threading.Lock legally releases on a
    # thread other than the acquirer, which pops nothing from the
    # acquirer's stack.  An entry whose lock is no longer held by THIS
    # thread is stale — without the prune it would fabricate edges (and
    # phantom strict-mode inversions) forever after.
    me = threading.get_ident()
    if any(h._holder_tid != me for h in held):
        held[:] = [h for h in held if h._holder_tid == me]
    for h in held:
        if h is lock and not lock._reentrant:
            GRAPH.note_violation(
                "self-deadlock",
                f"{lock._cls}:{id(lock)}",
                f"thread {threading.current_thread().name} re-acquired "
                f"non-reentrant '{lock._cls}' lock it already holds at "
                f"{GRAPH._site(skip=4)}")
        elif h._cls == lock._cls and h is not lock \
                and lock._cls not in SELF_NESTING_OK:
            GRAPH.note_violation(
                "same-class-nesting",
                f"{lock._cls}@{GRAPH._site(skip=4)}",
                f"two distinct '{lock._cls}' locks nested without a "
                f"declared hierarchy at {GRAPH._site(skip=4)} "
                f"(thread {threading.current_thread().name})")
    if held:
        GRAPH.note_edge(held[-1]._cls, lock._cls)


class _CheckedBase:
    _reentrant = False

    def __init__(self, cls_name: str):
        self._cls = cls_name
        self._holder_tid: int | None = None

    # -- bookkeeping around the inner primitive ----------------------------

    def _pre(self):
        _note_acquiring(self)

    def _pushed(self):
        self._holder_tid = threading.get_ident()
        _held().append(self)

    def _popped(self):
        # clear ownership FIRST: a cross-thread release (lock handoff)
        # finds nothing in this thread's stack, and the acquirer's stale
        # entry is pruned lazily in _note_acquiring_inner
        self._holder_tid = None
        held = _held()
        # release order need not be LIFO; remove the newest entry for
        # this object
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break


class CheckedLock(_CheckedBase):
    """Instrumented non-reentrant lock; full threading.Lock surface so
    Condition can wrap it."""

    def __init__(self, cls_name: str):
        super().__init__(cls_name)
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._pre()  # record BEFORE blocking: a deadlock still logs
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if not blocking:
                self._pre()
            self._pushed()
        return ok

    def release(self):
        self._popped()
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


class CheckedRLock(_CheckedBase):
    """Instrumented reentrant lock; exposes the private Condition hooks
    (_is_owned/_release_save/_acquire_restore) so Condition.wait keeps
    the held-stack honest across the release/re-acquire."""

    _reentrant = True

    def __init__(self, cls_name: str):
        super().__init__(cls_name)
        self._inner = threading.RLock()
        self._owner: int | None = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        first = self._owner != me
        if first and blocking:
            self._pre()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if first and not blocking:
                self._pre()
            self._owner = me
            self._count += 1
            if first:
                self._pushed()
        return ok

    def release(self):
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        last = self._count == 0
        if last:
            self._owner = None
            self._popped()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    # -- Condition protocol ------------------------------------------------

    def _is_owned(self):
        return self._owner == threading.get_ident()

    def _release_save(self):
        count = self._count
        self._count = 0
        self._owner = None
        self._popped()
        return self._inner._release_save(), count

    def _acquire_restore(self, state):
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._count = count
        self._pushed()


def checked_condition(cls_name: str, rlock: bool = False):
    lock = CheckedRLock(cls_name) if rlock else CheckedLock(cls_name)
    return threading.Condition(lock)


# -- reporting --------------------------------------------------------------


def report() -> dict:
    return GRAPH.report()


def reset():
    GRAPH.reset()


def _exit_report():
    rep = GRAPH.report()
    if not rep["violations"]:
        return
    import sys
    print(f"lockcheck: {len(rep['violations'])} violation(s) "
          f"(PILOSA_TPU_LOCKCHECK={_MODE}):", file=sys.stderr)
    for v in rep["violations"]:
        print(f"  [{v['kind']}] {v['detail']}", file=sys.stderr)
    if strict():
        # atexit cannot change the interpreter's exit status any other
        # way; a dirty strict run must fail CI.  Flush BOTH streams:
        # os._exit discards buffered pipe output, and losing the pytest
        # tail would hide which test drove the interleaving.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(70)


if armed():
    import atexit
    atexit.register(_exit_report)
