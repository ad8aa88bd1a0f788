"""Flight recorder: on-trigger diagnostic bundles (docs/observability.md
"SLOs & alerting").

Every debug surface in the tree is a bounded ring: the time-series
window, the event journal, the slow-query log, the span buffer, the
launch ledger.  That boundedness is what makes them safe to run
always-on — and what makes a 3am p99 spike unforensicable by 9am, after
the rings have rotated.  The flight recorder closes that gap: when the
SLO engine (utils/slo.py) fires an alert — or an operator asks via
``POST /debug/bundle`` / ``pilosa-tpu bundle`` — it snapshots the whole
debug plane into one JSON bundle on disk:

* ``/debug/vars`` (the full expvar body, alerts included)
* the full time-series window
* the event-journal tail
* the slow-query log with per-entry profile trees
* the compile registry and launch ledger
* the active alert table

Bundles live under ``<data-dir>/flightrec/`` inside a
``flight-recorder-mb`` disk budget, LRU-pruned by file mtime (the
compile-cache prune discipline) — oldest bundles go first, the bundle
just written is never pruned.  On-fire captures are rate-limited
(``MIN_INTERVAL_S``) so a flapping alert cannot fill the budget with
near-identical bundles; on-demand captures bypass the limit.

Capture runs on the Server's monitor thread (or a handler thread for
on-demand requests) and must never fail the caller: collection and
write errors are logged and counted, never raised.

Port copy of the JAX package's ``utils/flightrec.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import time

from .locks import make_lock


def _wall_stamp() -> float: return time.time()  # display-only wall clock


_REASON_SAFE = re.compile(r"[^a-zA-Z0-9._-]+")


class FlightRecorder:
    # seconds between automatic (on-fire) captures; on-demand captures
    # pass force=True and skip the limiter
    MIN_INTERVAL_S = 60.0

    def __init__(self, directory: str, budget_mb: int = 64,
                 min_interval_s: float | None = None,
                 logger=None, stats=None):
        self.dir = directory
        self.budget_mb = max(int(budget_mb), 1)
        self.min_interval_s = self.MIN_INTERVAL_S \
            if min_interval_s is None else float(min_interval_s)
        self.logger = logger
        self.stats = stats
        self._lock = make_lock("flightrec")
        self._seq = 0
        self._last_mono: float | None = None
        self.captures = 0
        self.rate_limited = 0
        self.errors = 0
        self.pruned = 0
        # {"path","reason","wall","bytes"} of the newest bundle — the
        # stamp /debug/vars and the diagnostics payload surface
        self.last: dict | None = None

    def capture(self, reason: str, collect, force: bool = False
                ) -> str | None:
        """Write one bundle; returns its path, or None when rate-limited
        or failed.  ``collect`` is a zero-arg callable building the
        payload dict — called OUTSIDE the lock (it walks the debug
        surfaces, which take their own leaf locks)."""
        reason = _REASON_SAFE.sub("-", reason or "manual")[:64] or "manual"
        now = time.monotonic()
        with self._lock:
            if not force and self._last_mono is not None \
                    and now - self._last_mono < self.min_interval_s:
                self.rate_limited += 1
                return None
            # reserve the slot before the (slow) collect so a burst of
            # fire transitions can't all pass the limiter together
            self._last_mono = now
            self._seq += 1
            seq = self._seq
        try:
            payload = collect()
            payload = dict(payload)
            payload.setdefault("reason", reason)
            payload["wall"] = _wall_stamp()
            os.makedirs(self.dir, exist_ok=True)
            name = f"bundle-{int(payload['wall'])}-{seq:04d}-{reason}.json"
            path = os.path.join(self.dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            size = os.path.getsize(path)
        except Exception as e:
            self.errors += 1
            if self.logger is not None:
                self.logger.error(f"flight-recorder capture failed: {e}")
            return None
        with self._lock:
            self.captures += 1
            self.last = {"path": path, "reason": reason,
                         "wall": payload["wall"], "bytes": size}
        if self.stats is not None:
            self.stats.count("flightrec.captures")
        self.prune(keep=path)
        if self.logger is not None:
            self.logger.info(
                f"flight-recorder bundle {name} ({size >> 10} KiB)")
        return path

    def prune(self, keep: str | None = None) -> int:
        """LRU-prune the bundle directory to the MB budget by file
        mtime (the warmup compile-cache discipline); ``keep`` is never
        deleted even when a single bundle exceeds the budget."""
        try:
            entries = []
            for name in os.listdir(self.dir):
                if not (name.startswith("bundle-")
                        and name.endswith(".json")):
                    continue
                path = os.path.join(self.dir, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue  # raced a concurrent prune
                entries.append((st.st_mtime, st.st_size, path))
        except OSError:
            return 0  # directory absent: nothing captured yet
        budget = self.budget_mb << 20
        total = sum(size for _, size, _ in entries)
        deleted = 0
        for _, size, path in sorted(entries):
            if total <= budget:
                break
            if keep is not None and os.path.abspath(path) \
                    == os.path.abspath(keep):
                continue
            try:
                os.remove(path)
                total -= size
                deleted += 1
            except OSError as e:
                if self.logger is not None:
                    self.logger.error(
                        f"flight-recorder prune failed for {path}: {e}")
        if deleted:
            with self._lock:
                self.pruned += deleted
        return deleted

    def disk_bytes(self) -> int:
        try:
            return sum(
                os.path.getsize(os.path.join(self.dir, n))
                for n in os.listdir(self.dir)
                if n.startswith("bundle-") and n.endswith(".json"))
        except OSError:
            return 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "budgetMb": self.budget_mb,
                    "minIntervalS": self.min_interval_s,
                    "captures": self.captures,
                    "rateLimited": self.rate_limited,
                    "errors": self.errors, "pruned": self.pruned,
                    "diskBytes": self.disk_bytes(),
                    "last": dict(self.last) if self.last else None}
