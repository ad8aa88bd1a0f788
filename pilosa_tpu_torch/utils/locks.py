"""Named lock factories — the adoption point for the lock-order race
detector (analysis/lockcheck.py).

Every lock in the project is created here with a lock-CLASS name
(``fragment``, ``holder``, ``budget``, ``committer-flush``, ...).
Unarmed (the default), these return plain ``threading`` primitives —
zero overhead, zero imports beyond threading.  With
``PILOSA_TPU_LOCKCHECK`` set (``1`` to observe, ``strict`` to fail the
process on violations) they return instrumented primitives that feed
the global acquisition-order graph reported at process exit and at
``/debug/locks``.

This module must stay import-light and cycle-free: it is imported by
every lock-using module, including utils/ siblings.

Port copy of the JAX package's ``utils/locks.py``: the armed factories
come from the port's own ``analysis/lockcheck.py``.
"""

from __future__ import annotations

import os
import threading

LOCKCHECK_MODE = os.environ.get("PILOSA_TPU_LOCKCHECK", "").strip().lower()
ARMED = LOCKCHECK_MODE not in ("", "0", "off")

if ARMED:
    from ..analysis import lockcheck as _lockcheck


def make_lock(cls_name: str):
    """A non-reentrant lock belonging to lock class ``cls_name``."""
    if ARMED:
        return _lockcheck.CheckedLock(cls_name)
    return threading.Lock()


def make_rlock(cls_name: str):
    """A reentrant lock belonging to lock class ``cls_name``."""
    if ARMED:
        return _lockcheck.CheckedRLock(cls_name)
    return threading.RLock()


def make_condition(cls_name: str, rlock: bool = False):
    """A Condition over a named lock (``rlock=True`` for the
    threading.Condition() default of a reentrant inner lock)."""
    if ARMED:
        return _lockcheck.checked_condition(cls_name, rlock=rlock)
    return threading.Condition(
        threading.RLock() if rlock else threading.Lock())


def report() -> dict:
    """The /debug/locks payload; cheap stub when unarmed."""
    if ARMED:
        return _lockcheck.report()
    return {"mode": LOCKCHECK_MODE or "off", "armed": False,
            "lockClasses": [], "edges": [], "violations": []}
