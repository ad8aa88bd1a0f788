"""Hot-shard rebalancing (docs/cluster.md "Read routing & rebalancing").

Static jump-hash placement cannot react to load: a shard that turns hot
stays pinned to its ``replica_n`` owners forever.  This module detects
sustained per-shard load skew from the read fan-out's dispatch counters
(:class:`ShardLoadTracker`) and executes BOUNDED shard handoffs: the
coordinator tells an underloaded node to copy the hot shard's fragments
(reusing the existing resize-fetch machinery — the same
``/internal/fragment/data`` checkpoint copy a membership resize uses)
and then records the node as an EXTRA owner in the cluster's
placement-overlay table, broadcast epoch-gated like resize-complete so
every node routes — and fans writes out — consistently.

Overlay owners are real owners: writes fan to them, anti-entropy keeps
them converged, and the holder cleaner spares their fragments.  The
overlay therefore only ever widens a shard's replica set (hot-spot
splitting), never moves data away from a jump-hash owner — removing the
overlay (or running with ``balancer=off``, the default) restores the
static placement exactly.

The balancer thread runs on the COORDINATOR only (it owns the overlay
epoch and the broadcast, like resize); every node still tracks load so
/debug/vars shows per-shard heat anywhere.

Port copy of the JAX package's ``parallel/balancer.py``
(``ShardLoadTracker`` and ``HotShardBalancer``).  A handoff's copy runs
through the port's resize-fetch (``parallel/cluster.py``
``_apply_resize_fetch``), whose ``bulk_import`` bumps the fragment
generation, so the overlay owner's stacked executor stages the copied
shard afresh on its device.
"""

from __future__ import annotations

import time

from ..utils.locks import make_lock

# Floor on the per-window dispatch count before a shard can be "hot":
# skew over a handful of queries is noise, not load.
HOT_MIN_COUNT = 32
# Handoffs executed per balancer tick — rebalancing is deliberately slow
# and bounded; a tick that moved everything at once would thundering-herd
# the fragment fetches.
MAX_HANDOFFS_PER_TICK = 1
# Fragment copies ride one cluster-message POST, like resize fetches.
FETCH_TIMEOUT_S = 600.0


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


class HotShardBalancer:
    """Coordinator-side handoff engine over a :class:`ShardLoadTracker`.

    ``tick()`` is the whole algorithm — the background thread (started by
    ``Cluster.open`` when ``balancer=true``) just calls it on the
    ``balancer-interval`` cadence; tests call it directly."""

    def __init__(self, cluster, tracker: ShardLoadTracker,
                 threshold: float = 4.0, stats=None, logger=None,
                 min_count: int = HOT_MIN_COUNT):
        self.cluster = cluster
        self.tracker = tracker
        self.threshold = threshold
        self.min_count = min_count
        self.stats = stats
        self.logger = logger
        self.handoffs = 0
        self.errors = 0
        self.last_error: str | None = None

    def tick(self) -> int:
        """One balancing pass: find hot shards, widen the hottest one's
        replica set by one underloaded node.  Returns handoffs executed.
        Never raises — a failed handoff counts ``balancer.errors`` and
        the next tick retries."""
        cluster = self.cluster
        if not cluster.is_coordinator or cluster.state == "RESIZING":
            return 0
        # age the load windows by wall clock FIRST: an idle cluster's
        # stale burst counts must not read as sustained heat
        self.tracker.maybe_rotate()
        done = 0
        for index, shard, count in self.tracker.hot_shards(
                self.threshold, self.min_count):
            if done >= MAX_HANDOFFS_PER_TICK:
                break
            target = self._pick_target(index, shard)
            if target is None:
                continue
            try:
                self._handoff(index, shard, target)
            except Exception as e:
                self.errors += 1
                self.last_error = f"{index}/{shard} -> {target}: {e}"
                if self.stats is not None:
                    self.stats.count("balancer.errors")
                if self.logger is not None:
                    self.logger.error(
                        f"balancer handoff failed: {self.last_error}")
                continue
            done += 1
            self.handoffs += 1
            if self.stats is not None:
                self.stats.count("balancer.handoffs")
            if self.logger is not None:
                self.logger.info(
                    f"balancer: shard {index}/{shard} (count {count}) "
                    f"handed off to {target} "
                    f"(overlay epoch {cluster.overlay_epoch})")
        return done

    def _pick_target(self, index: str, shard: int) -> str | None:
        """Least-loaded READY node that is not already an owner."""
        cluster = self.cluster
        owners = set(cluster.shard_owner_nodes(index, shard))
        loads = self.tracker.node_counts()
        best, best_load = None, None
        for n in cluster.nodes:
            if n.id in owners or n.state != "READY":
                continue
            load = loads.get(n.id, 0)
            if best_load is None or load < best_load:
                best, best_load = n.id, load
        return best

    def _handoff(self, index: str, shard: int, target: str):
        """Copy the shard to ``target`` (resize-fetch reuse: full
        checkpoint fragment copies from a current owner), then publish it
        as an overlay owner.  The copy lands BEFORE the overlay broadcast
        so no node ever routes a read at a replica that lacks the data;
        a crash in between leaves an unused copy the holder cleaner
        GCs — never a data-less owner."""
        cluster = self.cluster
        owners = cluster.shard_owner_nodes(index, shard)
        sources = [o for o in owners
                   if o == cluster.node_id
                   or cluster.by_id[o].state == "READY"]
        if not sources:
            raise RuntimeError("no live source replica")
        src_host = cluster.by_id[sources[0]].host
        fetch_msg = {
            "type": "resize-fetch",
            "fetch": [{"index": index, "shard": shard,
                       "source": src_host}],
            "schema": cluster.holder.schema(),
        }
        if target == cluster.node_id:
            cluster.handle_message(fetch_msg)
        else:
            cluster.client.send_message(cluster.by_id[target].host,
                                        fetch_msg,
                                        timeout=FETCH_TIMEOUT_S)
        cluster.add_overlay(index, shard, target)

    def snapshot(self) -> dict:
        return {
            "handoffs": self.handoffs,
            "errors": self.errors,
            "lastError": self.last_error,
            "threshold": self.threshold,
            "load": self.tracker.snapshot(),
        }
