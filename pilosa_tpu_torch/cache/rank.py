"""Per-fragment rank cache (reference cache.go:40 rankCache / :299
lruCache, consulted by fragment.go:1570 top).

Each fragment of a ``cacheType: ranked|lru`` field keeps an in-memory map
of its hottest rows' EXACT per-fragment bit counts, maintained
incrementally on the write paths (set_bit / clear_bit / bulk_import
recompute just the touched rows from the sparse store) and rebuilt lazily
after bulk mutations that touch more than ``RANK_REBUILD_ROWS`` distinct
rows (or whole-row stores, mutex imports, BSI imports).

Exactness — where the reference diverges from a full scan, we do not.
The reference answers TopN straight from the cache, so a row whose count
decayed below the cache floor silently vanishes from results.  Here the
cache is only a CANDIDATE PRUNER: every cache tracks ``bound``, an upper
bound on the count any row OUTSIDE the cache can have (the best excluded
count at build time, ratcheted up by evictions and rejected admissions).
``topn_from_rank`` unions the cached rows across shards, computes exact
global counts for that candidate set (cached counts are exact; uncached
rows of an incomplete cache are recounted from the host sparse store),
and serves the answer only when the n-th candidate's count strictly
exceeds the summed bounds — i.e. when no pruned row can possibly reach
the top n, ties included.  Otherwise it reports a candidate fallback and
the executor runs the full scan.

Port copy of the JAX package's ``cache/rank.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"

# Distinct rows a single batched write may touch before incremental
# maintenance gives up and marks the cache for a lazy full rebuild
# (config knob ``rank-rebuild-rows``; the process-wide value follows the
# most recent Server's config, like the device-budget globals).
RANK_REBUILD_ROWS = 4096


class RankCache:
    """Row -> exact per-fragment count for up to ``size`` rows.

    ``ranked`` evicts the lowest-count row on overflow; ``lru`` evicts the
    least-recently-written one (dict insertion order is the recency
    order).  ``complete`` means every row with any set bit is present —
    the cache then IS the fragment's exact count vector.  ``bound`` is
    the pruning invariant described in the module docstring; it only
    ratchets up between rebuilds, so a cache degraded by churn falls back
    (and is marked for rebuild) rather than ever returning a wrong
    answer."""

    __slots__ = ("cache_type", "size", "rows", "complete", "bound",
                 "built_bound", "dirty", "builds")

    def __init__(self, cache_type: str, size: int):
        self.cache_type = cache_type
        self.size = max(int(size), 0)
        self.rows: dict[int, int] = {}
        self.complete = False
        self.bound = 0
        self.built_bound = 0
        self.dirty = True
        self.builds = 0

    # -- build (cache.go Recalculate / fragment.go RecalculateCache) -------

    def build(self, frag):
        """Full rebuild from the fragment's host sparse store: O(nnz)."""
        rids, counts = frag.row_counts_all_host()
        if rids.size <= self.size:
            self.rows = {int(r): int(c) for r, c in zip(rids, counts)}
            self.complete = True
            self.bound = self.built_bound = 0
        else:
            # keep the top ``size`` by (-count, row) — the TopN ordering
            order = np.lexsort((rids, -counts))
            kept = order[: self.size]
            self.rows = {int(rids[i]): int(counts[i]) for i in kept}
            self.complete = False
            # best excluded count bounds every row we do not track
            self.bound = self.built_bound = int(counts[order[self.size]])
        self.dirty = False
        self.builds += 1

    def ensure(self, frag) -> bool:
        """Rebuild if dirty; returns True when a rebuild ran."""
        if not self.dirty:
            return False
        self.build(frag)
        return True

    def invalidate(self):
        self.dirty = True

    # -- incremental maintenance (cache.go Add/BulkAdd) --------------------

    def note_write(self, frag, rows):
        """Called under the fragment lock after a successful mutation with
        the (possibly repeated) row ids it touched."""
        if self.dirty:
            return
        rows = np.unique(np.asarray(rows, dtype=np.int64))
        if rows.size > RANK_REBUILD_ROWS:
            self.dirty = True  # bulk mutation: rebuild lazily
            return
        counts = frag.row_counts_host(rows)
        for row, c in zip(rows.tolist(), counts.tolist()):
            self._update(int(row), int(c))

    def _update(self, row: int, count: int):
        if count <= 0:
            # an emptied row leaves the cache; completeness is preserved
            # (we still know every nonzero row) and the bound stays — a
            # pruned row's count never rises from someone else's clear
            self.rows.pop(row, None)
            return
        if row in self.rows:
            self.rows[row] = count
            if self.cache_type == CACHE_TYPE_LRU:
                # refresh recency (dict order = insertion order)
                self.rows[row] = self.rows.pop(row)
            return
        if len(self.rows) < self.size:
            self.rows[row] = count
            return
        # cache full: admit-and-evict, ratcheting the bound so pruning
        # stays sound for whatever leaves (or never enters) the cache
        if self.size == 0:
            self.complete = False
            self.bound = max(self.bound, count)
            return
        if self.cache_type == CACHE_TYPE_LRU:
            evict_row = next(iter(self.rows))
        else:
            evict_row, _ = min(self.rows.items(),
                               key=lambda kv: (kv[1], -kv[0]))
            if self.rows[evict_row] >= count:
                # the newcomer ranks below everything cached: reject it
                self.complete = False
                self.bound = max(self.bound, count)
                return
        evicted = self.rows.pop(evict_row)
        self.rows[row] = count
        self.complete = False
        self.bound = max(self.bound, evicted)

    def degraded(self) -> bool:
        """The bound has ratcheted past its built value — pruning power is
        decaying and a rebuild would restore it."""
        return self.bound > self.built_bound


def iter_rank_caches(holder):
    """Every (fragment, rank cache) pair in the holder — the one walk
    behind the /internal/cache/clear route, recalculate-caches, and the
    bench's cold-path flush."""
    for idx in list(holder.indexes.values()):
        for f in list(idx.fields.values()):
            for v in list(f.views.values()):
                for frag in list(v.fragments.values()):
                    if frag.rank_cache is not None:
                        yield frag, frag.rank_cache


def topn_from_rank(field, shards, n: int, stats=None):
    """Exact unfiltered TopN from the field's per-fragment rank caches, or
    None when coverage can't be proven (the caller falls back to the full
    scan).  Byte-identical to the device path: identical counts ranked by
    the same (-count, ascending id) order (results.rank_counts).

    ``n == 0`` means unlimited, which needs every nonzero row — served
    only when every cache is complete."""
    from ..core import VIEW_STANDARD
    from ..executor.results import Pair

    v = field.view(VIEW_STANDARD)
    entries = []  # (frag, rc, rows-snapshot, complete, bound) per shard
    if v is not None:
        for shard in shards:
            frag = v.fragment(shard)
            if frag is None:
                continue
            rc = frag.rank_cache
            if rc is None:
                return None  # cache disabled mid-flight: full scan
            # snapshot under the fragment lock: concurrent writers mutate
            # rc.rows in place, and iterating a live dict would race
            with frag._lock:
                if rc.ensure(frag) and stats is not None:
                    stats.count("rankcache.build")
                entries.append((frag, rc, dict(rc.rows), rc.complete,
                                rc.bound))
    candidates: set[int] = set()
    bound = 0
    for _frag, _rc, rows, complete, rc_bound in entries:
        candidates.update(rows)
        if not complete:
            bound += rc_bound
    # exact global counts for the candidate set: cached counts are exact;
    # a candidate missing from an INCOMPLETE cache is recounted from that
    # fragment's host sparse store (complete caches prove absence = 0)
    totals: dict[int, int] = dict.fromkeys(candidates, 0)
    for frag, _rc, rows, complete, _b in entries:
        missing = [] if complete else \
            [r for r in candidates if r not in rows]
        if missing:
            marr = np.asarray(sorted(missing), dtype=np.int64)
            for r, c in zip(marr.tolist(),
                            frag.row_counts_host(marr).tolist()):
                totals[r] += int(c)
        for r, c in rows.items():
            totals[r] += c
    pairs = sorted(
        (Pair(r, c) for r, c in totals.items() if c > 0),
        key=lambda p: (-p.count, p.id))
    from ..utils import explain as qexplain
    if bound == 0:
        if stats is not None:
            stats.count("rankcache.hit")
        qexplain.note("caches", {"cache": "rank", "outcome": "prune",
                                 "candidates": len(candidates),
                                 "bound": 0})
        return pairs[:n] if n else pairs
    if n and len(pairs) >= n and pairs[n - 1].count > bound:
        if stats is not None:
            stats.count("rankcache.hit")
        qexplain.note("caches", {"cache": "rank", "outcome": "prune",
                                 "candidates": len(candidates),
                                 "bound": bound})
        return pairs[:n]
    # coverage unproven: full scan, and mark churn-degraded caches so the
    # next query rebuilds them instead of falling back forever
    for _frag, rc, _rows, _complete, _b in entries:
        if rc.degraded():
            rc.invalidate()
    if stats is not None:
        stats.count("rankcache.fallback")
    qexplain.note("caches", {"cache": "rank", "outcome": "fallback",
                             "candidates": len(candidates),
                             "bound": bound})
    return None
