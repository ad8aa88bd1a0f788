"""In-process time-series ring (docs/observability.md "Device runtime").

Every point metric the node exports is a single instantaneous value, so
"what happened 90 seconds ago" — the eviction storm, the compile burst —
was unanswerable without external scrape infrastructure.  This ring
keeps the last ``window_s`` seconds of fixed-interval samples of the
runtime's load-bearing gauges and deltas (device budget split, host
stage, admission depth, batcher occupancy, compile/retrace counts, edge
histogram deltas), served as JSON at /debug/timeseries and rendered by
the zero-dependency dashboard at /debug/dashboard.

Interval pacing and inter-sample math use a monotonic clock (``now_fn``,
perf_counter by default — the PR 2 timing discipline; injectable for
fake-clock tests).  Each sample also carries a ``_wall_stamp`` for
display/correlation only, never subtracted (scripts/check.sh lint).

Memory bound: capacity = ceil(window / interval) + 1 samples of one flat
dict each — an always-on default (5 s x 10 min = 121 samples) costs a
few hundred KB, independent of uptime.

Port copy of the JAX package's ``utils/timeseries.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import time
from collections import deque

from .devobs import _wall_stamp
from .locks import make_lock


class TimeSeriesRing:
    """Fixed-interval ring of flat metric samples.

    ``sample(values)`` appends when at least ~one interval has elapsed
    since the last accepted sample (monotonic clock) and returns whether
    it was accepted — callers may over-poll safely; the ring keeps the
    cadence.  ``force=True`` bypasses the gate (tests, epoch marks)."""

    # Accept samples this fraction of an interval early: Event.wait()
    # jitter must not make an on-cadence sampler skip every other tick.
    INTERVAL_SLACK = 0.9

    def __init__(self, interval_s: float = 5.0, window_s: float = 600.0,
                 now_fn=time.perf_counter):
        self.interval_s = max(float(interval_s), 0.001)
        self.window_s = max(float(window_s), self.interval_s)
        self.capacity = max(
            2, int(math.ceil(self.window_s / self.interval_s)) + 1)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = make_lock("timeseries")
        self._now = now_fn
        self._t0 = now_fn()
        self._last_t: float | None = None
        self.samples_total = 0

    def sample(self, values: dict, force: bool = False) -> bool:
        t = self._now()
        with self._lock:
            if not force and self._last_t is not None and \
                    t - self._last_t < self.interval_s * self.INTERVAL_SLACK:
                return False
            self._last_t = t
            self.samples_total += 1
            entry = {"wall": _wall_stamp(),
                     "uptimeS": round(t - self._t0, 3)}
            entry.update(values)
            self._ring.append(entry)
        return True

    def window_covered_s(self) -> float:
        """Monotonic span between the oldest and newest retained sample
        — the "how far back can I see" answer."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1]["uptimeS"] - self._ring[0]["uptimeS"]

    def last(self, n: int = 1) -> list[dict]:
        with self._lock:
            return list(self._ring)[-n:]

    def snapshot(self) -> dict:
        """/debug/timeseries: config + the ring, oldest first."""
        with self._lock:
            samples = list(self._ring)
            total = self.samples_total
        covered = samples[-1]["uptimeS"] - samples[0]["uptimeS"] \
            if len(samples) >= 2 else 0.0
        return {"intervalS": self.interval_s, "windowS": self.window_s,
                "capacity": self.capacity,
                "samplesTotal": total,
                "coveredS": round(covered, 3),
                "samples": samples}
