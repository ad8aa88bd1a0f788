"""Per-shard load tracking for read routing — the ``ShardLoadTracker``
of the JAX package's ``parallel/balancer.py``, copied alone.

The read fan-out counts each shard group it dispatches here, per serving
node; the ``loaded`` routing policy and ``/debug/vars`` read the
windowed counts.  The JAX module's ``HotShardBalancer``, which turns
sustained skew into shard handoffs through the placement overlay, is not
ported (the cluster refuses ``balancer = true``).
"""

from __future__ import annotations

import time

from ..utils.locks import make_lock

# Floor on the per-window dispatch count before a shard can be "hot":
# skew over a handful of queries is noise, not load.
HOT_MIN_COUNT = 32


class ShardLoadTracker:
    """Windowed per-shard dispatch counters.

    Two rotating windows (current + previous): rates are computed over
    the PREVIOUS (complete) window so a half-filled current window never
    reads as a load drop.  Values are per-serving-node counters, so the
    same table answers both "which shard is hot" and "did more than one
    node serve it" (the replica-spread signal the routing tests
    assert)."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = window_s
        self._lock = make_lock("shard-load")
        self._cur: dict[tuple[str, int], dict[str, int]] = {}
        self._prev: dict[tuple[str, int], dict[str, int]] = {}
        self._cur_start = time.monotonic()

    def _rotate_locked(self, now: float):
        if now - self._cur_start >= self.window_s:
            self._prev = self._cur
            self._cur = {}
            self._cur_start = now

    def note(self, index: str, shards, nid: str):
        """``nid`` was dispatched a read covering ``shards``."""
        now = time.monotonic()
        with self._lock:
            self._rotate_locked(now)
            for s in shards:
                by_node = self._cur.setdefault((index, int(s)), {})
                by_node[nid] = by_node.get(nid, 0) + 1

    def maybe_rotate(self):
        """Age the windows on the clock even when no traffic is noting
        dispatches: without this, counts from a past burst would keep a
        shard 'hot' forever on an idle cluster and the balancer would
        hand it off again every tick until every node owned it."""
        with self._lock:
            self._rotate_locked(time.monotonic())

    def rotate(self):
        """Force a window rotation (tests, so a decision never waits
        out a whole wall-clock window)."""
        with self._lock:
            self._prev = self._cur
            self._cur = {}
            self._cur_start = time.monotonic()

    def _counts_locked(self) -> dict[tuple[str, int], int]:
        out: dict[tuple[str, int], int] = {}
        for table in (self._prev, self._cur):
            for key, by_node in table.items():
                out[key] = out.get(key, 0) + sum(by_node.values())
        return out

    def node_counts(self) -> dict[str, int]:
        """Dispatches per serving node over both windows (the balancer's
        least-loaded-target signal)."""
        with self._lock:
            out: dict[str, int] = {}
            for table in (self._prev, self._cur):
                for by_node in table.values():
                    for nid, c in by_node.items():
                        out[nid] = out.get(nid, 0) + c
            return out

    def hot_shards(self, threshold: float,
                   min_count: int = HOT_MIN_COUNT
                   ) -> list[tuple[str, int, int]]:
        """(index, shard, count) for shards whose dispatch count over the
        tracked windows exceeds ``threshold`` x the mean across all
        active shards (and the absolute ``min_count`` floor), hottest
        first."""
        with self._lock:
            counts = self._counts_locked()
        if not counts:
            return []
        mean = sum(counts.values()) / len(counts)
        hot = [(idx, s, c) for (idx, s), c in counts.items()
               if c >= min_count and c >= threshold * mean]
        hot.sort(key=lambda t: -t[2])
        return hot

    def snapshot(self, top: int = 10) -> dict:
        """Hottest shards with their per-node serve split, for
        /debug/vars."""
        with self._lock:
            counts = self._counts_locked()
            merged: dict[tuple[str, int], dict[str, int]] = {}
            for table in (self._prev, self._cur):
                for key, by_node in table.items():
                    tgt = merged.setdefault(key, {})
                    for nid, c in by_node.items():
                        tgt[nid] = tgt.get(nid, 0) + c
        ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
        return {
            "windowS": self.window_s,
            "trackedShards": len(counts),
            "hottest": [{"index": idx, "shard": s, "count": c,
                         "nodes": merged.get((idx, s), {})}
                        for (idx, s), c in ranked],
        }
