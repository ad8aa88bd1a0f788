"""Named lock factories — the adoption point for the lock-order race
detector (the JAX package's analysis/lockcheck.py).

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

Port copy of the JAX package's ``utils/locks.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.  The
``lockcheck`` arm (``PILOSA_TPU_LOCKCHECK``, which imports
the JAX package's
``analysis/lockcheck.py``) is outside this slice and is
dropped: every factory returns a plain ``threading`` primitive.
"""

from __future__ import annotations

import threading


def make_lock(cls_name: str):
    """A non-reentrant lock belonging to lock class ``cls_name``."""
    return threading.Lock()


def make_rlock(cls_name: str):
    """A reentrant lock belonging to lock class ``cls_name``."""
    return threading.RLock()


def make_condition(cls_name: str, rlock: bool = False):
    """A Condition over a named lock (``rlock=True`` for the
    threading.Condition() default of a reentrant inner lock)."""
    return threading.Condition(
        threading.RLock() if rlock else threading.Lock())
