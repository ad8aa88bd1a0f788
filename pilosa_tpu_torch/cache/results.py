"""Generation-keyed result cache — copied from the JAX package's
``cache/results.py`` (it imports no JAX).

Memoizes finished read-query results keyed by (scope, index, normalized
query repr, shard set) PLUS everything the answer is a pure function of:
the index's fragment GENERATION VECTOR (every fragment stamps a unique,
monotonically increasing ``gen`` on mutation — storage/fragment.py), the
schema epoch (DDL / BSI depth growth), and the attr epoch (row/column
attribute writes).  Invalidation is therefore STRUCTURAL, never TTL-based:
a mutation changes a gen, the current key stops matching, and the stale
entry simply ages out of the LRU.

Entries are LRU-bounded by bytes (``limit_bytes``; 0 disables, the bare
``Executor`` default), with an optional per-tenant quota.  A fill that
supersedes an older entry for the same (scope, index, query, shards)
under different generations counts as an INVALIDATION and evicts the
stale entry eagerly, so churned queries don't pool garbage.
``gen_summary`` (the compact form the cluster plane piggybacks) is
copied for the serving and cluster slices.

Deviation: ``bypassed()`` makes lookups miss on its thread of execution.
The port's warm start replays each corpus query twice (its second run
captures the program's CUDA graph), and a cached answer would skip the
device.
"""

from __future__ import annotations

import contextvars
from collections import OrderedDict
from contextlib import contextmanager

import numpy as np

from ..utils import tenant as qtenant
from ..utils.locks import make_lock


# Set while the warm-start replay runs (warmup/replayer.py): a replay
# must reach the device to capture its program, so lookups miss.
_BYPASS: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("result_cache_bypass", default=False)


@contextmanager
def bypassed():
    """Lookups on this thread of execution miss while inside."""
    token = _BYPASS.set(True)
    try:
        yield
    finally:
        _BYPASS.reset(token)


# -- generation vectors ------------------------------------------------------

def gen_vector(holder, index: str, shards=None) -> tuple:
    """Precise per-fragment generation vector of ``index`` (optionally
    restricted to a shard set) — the local component of a cache key.
    Fragment creation/deletion changes the tuple shape, so appearing and
    vanishing fragments invalidate too."""
    idx = holder.index(index)
    if idx is None:
        return ()
    parts = []
    for fname, f in sorted(idx.fields.items()):
        for vname, v in sorted(f.views.items()):
            for shard, frag in sorted(v.fragments.items()):
                if shards is None or shard in shards:
                    parts.append((fname, vname, shard, frag.gen))
    return tuple(parts)


def gen_summary(holder, index: str) -> tuple[int, int, int]:
    """Compact (count, max, sum) of the index's fragment gens for wire
    piggybacking.  Gens come from one strictly increasing process counter,
    so ``max`` strictly increases on ANY mutation and ``count`` moves on
    fragment create/GC — the triple changes whenever the data does."""
    idx = holder.index(index)
    if idx is None:
        return (0, 0, 0)
    n = mx = total = 0
    for f in list(idx.fields.values()):
        for v in list(f.views.values()):
            for frag in list(v.fragments.values()):
                g = frag.gen
                n += 1
                total += g
                if g > mx:
                    mx = g
    return (n, mx, total)


def query_is_readonly(query) -> bool:
    """True when no call in the tree mutates state (Options can wrap
    writes, so the check is recursive)."""
    from ..pql.ast import WRITE_CALLS

    def walk(c):
        if c.name in WRITE_CALLS:
            return False
        return all(walk(ch) for ch in c.children)

    return all(walk(c) for c in query.calls)


def _result_bytes(results) -> int:
    """Conservative host-byte estimate of a results list (for the LRU
    byte budget)."""
    total = 64
    for r in results:
        total += 64
        segments = getattr(r, "segments", None)
        if segments is not None:
            for seg in segments.values():
                total += np.asarray(seg).nbytes
        elif isinstance(r, list):
            total += 64 * len(r)
        rows = getattr(r, "rows", None)
        if isinstance(rows, list):
            total += 8 * len(rows)
    return total


def _host_results(results):
    """Pull RowResult segments to host numpy IN PLACE: cached entries must
    not pin device (HBM) buffers, and every consumer already accepts
    numpy segments (the non-mesh path returns them natively)."""
    for r in results:
        segments = getattr(r, "segments", None)
        if segments is not None:
            r.segments = {s: np.asarray(seg) for s, seg in segments.items()}
    return results


class ResultCache:
    """(scope…, gens…) -> results list; thread-safe, LRU by bytes.

    ``limit_bytes == 0`` disables lookups and fills entirely (the bare-
    Executor default; the server wires ``result-cache-mb`` through).

    ``tenant_quota_bytes`` (``tenant-cache-quota-mb``; 0 = no per-tenant
    cap) bounds any ONE tenant's resident bytes: a fill that pushes its
    tenant over quota evicts that tenant's own oldest entries first, and
    global byte pressure also lands on over-quota tenants' entries before
    anyone else's — one tenant's churn cannot flush its neighbors
    (docs/robustness.md "Tenant isolation")."""

    def __init__(self, limit_bytes: int = 0, stats=None,
                 tenant_quota_bytes: int = 0):
        self.limit_bytes = limit_bytes
        self.tenant_quota_bytes = tenant_quota_bytes
        self.stats = stats
        self._lock = make_lock("result-cache")
        # key -> (results, nbytes, tenant)
        self._entries: OrderedDict = OrderedDict()
        self._by_query: dict = {}  # qkey -> full key (stale-entry sweep)
        self._tenant_bytes: dict[str, int] = {}
        self.resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evicts = 0
        self.invalidates = 0
        self.quota_evicts = 0

    def _count(self, name: str):
        if self.stats is not None:
            self.stats.count(name)

    def lookup(self, key):
        """Cached results list (shallow copy) or None."""
        if _BYPASS.get():
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        self._count("resultcache.hit" if entry is not None
                    else "resultcache.miss")
        return list(entry[0]) if entry is not None else None

    def _unlink(self, key) -> int:
        """Pop ``key`` and keep the byte ledgers consistent; returns the
        freed bytes (0 when absent).  Caller holds the lock."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return 0
        _r, nb, t = entry
        self.resident_bytes -= nb
        if t is not None:
            left = self._tenant_bytes.get(t, 0) - nb
            if left > 0:
                self._tenant_bytes[t] = left
            else:
                self._tenant_bytes.pop(t, None)
        return nb

    def _evict_tenant_lru(self, tenant, keep) -> bool:
        """Evict ``tenant``'s least-recently-used entry (quota
        pressure), never ``keep`` — the entry being filled; a lone
        over-quota entry rides transiently over, so a quota smaller
        than one answer still caches that answer.  Caller holds the
        lock."""
        for k, entry in self._entries.items():  # LRU order
            if entry[2] == tenant and k != keep:
                self._unlink(k)
                self.evicts += 1
                self.quota_evicts += 1
                self._count("resultcache.evict")
                if self.stats is not None:
                    self.stats.count(f"tenant.{tenant}.quota_evict")
                qtenant.REGISTRY.note_quota_evict(tenant, entry[1])
                return True
        return False

    def _global_victim(self):
        """Global-pressure victim key: the oldest entry of any
        OVER-QUOTA tenant if one exists, else the plain LRU head.
        Caller holds the lock."""
        if self.tenant_quota_bytes > 0:
            over = {t for t, b in self._tenant_bytes.items()
                    if b > self.tenant_quota_bytes}
            if over:
                for k, entry in self._entries.items():
                    if entry[2] in over:
                        return k
        return next(iter(self._entries))

    def fill(self, qkey, key, results, tenant=None):
        """Insert under ``key``; ``qkey`` is the generation-free prefix
        used to eagerly drop a superseded (stale-gen) entry.  ``tenant``
        charges the entry's bytes to that tenant's quota (None falls
        back to the ambient request tenant)."""
        nbytes = _result_bytes(results)
        if nbytes > self.limit_bytes:
            return  # larger than the whole budget: never admit
        if tenant is None:
            tenant = qtenant.current_or_none()
        results = _host_results(results)
        with self._lock:
            old_key = self._by_query.get(qkey)
            if old_key is not None and old_key != key:
                if self._unlink(old_key):
                    self.invalidates += 1
                    self._count("resultcache.invalidate")
            self._by_query[qkey] = key
            self._unlink(key)
            self._entries[key] = (results, nbytes, tenant)
            self.resident_bytes += nbytes
            if tenant is not None:
                self._tenant_bytes[tenant] = \
                    self._tenant_bytes.get(tenant, 0) + nbytes
                # per-tenant quota: the filling tenant's own LRU pays
                while self.tenant_quota_bytes > 0 \
                        and self._tenant_bytes.get(tenant, 0) \
                        > self.tenant_quota_bytes \
                        and self._evict_tenant_lru(tenant, key):
                    pass
            while self.resident_bytes > self.limit_bytes and self._entries:
                self._unlink(self._global_victim())
                self.evicts += 1
                self._count("resultcache.evict")
            # _by_query is bookkeeping only; prune dangling pointers so it
            # cannot outgrow the entry table
            if len(self._by_query) > 2 * len(self._entries) + 64:
                live = set(self._entries)
                self._by_query = {q: k for q, k in self._by_query.items()
                                  if k in live}

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_query.clear()
            self._tenant_bytes.clear()
            self.resident_bytes = 0
        return n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.resident_bytes,
                "limitBytes": self.limit_bytes,
                "tenantQuotaBytes": self.tenant_quota_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evicts": self.evicts,
                "invalidates": self.invalidates,
                "quotaEvicts": self.quota_evicts,
                "tenantBytes": dict(self._tenant_bytes),
            }
