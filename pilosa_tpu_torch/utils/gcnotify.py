"""GC-cycle notification (reference gcnotify/gcnotify.go).

The reference registers for Go GC cycle notifications so long-running
maintenance (anti-entropy) can observe collector pressure.  CPython's
collector is a different beast (refcounting + generational cycle
collector), but the observable the row asks for is the same: per-cycle
counts and stop-the-world pause time.  ``gc.callbacks`` delivers
start/stop around every cyclic collection; this module aggregates them
into per-generation counters surfaced as ``runtime.gc_*`` gauges
(server.collect_runtime_stats) and /metrics.

Port copy of the JAX package's ``utils/gcnotify.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import gc
import time

from .locks import make_lock


class GcNotifier:
    """Aggregates gc.callbacks events; safe to create/close repeatedly."""

    def __init__(self):
        self._lock = make_lock("gcnotify")
        self.collections = [0, 0, 0]
        self.pause_s = [0.0, 0.0, 0.0]
        self.collected = 0   # objects reclaimed by the cycle collector
        self.uncollectable = 0
        self._t0 = None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        gen = min(int(info.get("generation", 0)), 2)
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        dt = 0.0 if self._t0 is None else time.perf_counter() - self._t0
        self._t0 = None
        with self._lock:
            self.collections[gen] += 1
            self.pause_s[gen] += dt
            self.collected += int(info.get("collected", 0))
            self.uncollectable += int(info.get("uncollectable", 0))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "collections": list(self.collections),
                "pause_s": list(self.pause_s),
                "collected": self.collected,
                "uncollectable": self.uncollectable,
            }

    def close(self):
        try:
            gc.callbacks.remove(self._callback)
        except ValueError:
            pass


_global = None
_global_lock = make_lock("gcnotify-global")


def global_notifier() -> GcNotifier:
    global _global
    with _global_lock:
        if _global is None:
            _global = GcNotifier()
        return _global
