"""Device-memory budget: LRU accounting of device-resident bytes, with
pinning for in-flight work.

The reference's memory story is mmap + the OS page cache (fragments are
lazily paged, syswrap caps map counts — syswrap/mmap.go:46, fragment.go:311).
On TPU the equivalent scarce resource is HBM: every fragment queried gets a
dense device mirror, and mesh execution additionally keeps stacked shard
blocks resident.  This registry tracks those allocations against a
configurable budget and evicts the least-recently-used entries (dropping
the owner's reference so the buffer frees) when a new allocation would
exceed it.

Entries referenced by an in-flight plan or a prefetch in progress are
PINNED: eviction skips them (preferring the unpinned-coldest) and a fully
pinned budget admits the incoming entry over-limit rather than dropping a
buffer out from under a dispatch.  The budget also keeps streaming
counters — cumulative upload bytes, prefetch hits/misses, evictions —
surfaced through ``stats()`` at /debug/vars and the runtime gauges.

One process-wide default budget keeps wiring simple (Server config
``device_budget_mb`` / PILOSA_TPU_DEVICE_BUDGET_MB sets it); tests construct
private instances.  ``HOST_STAGE_BUDGET`` is a second instance bounding the
HOST-side dense staging cache (storage/fragment.py staged_dense) with the
same LRU machinery — there "upload bytes" counts staged host bytes.

Port copy of the JAX package's ``storage/membudget.py``: the PyTorch
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..utils import tenant as qtenant
from ..utils.locks import make_rlock


class DeviceBudget:
    def __init__(self, limit_bytes: int | None = None,
                 tenant_quota_bytes: int = 0):
        self.limit_bytes = limit_bytes  # None = unlimited (accounting only)
        # Per-tenant residency cap (``tenant-cache-quota-mb``; 0 = off):
        # a tenant staging past it evicts ITS OWN unpinned-coldest
        # entries, and global pressure prefers over-quota tenants'
        # entries — one index's working set cannot flush the fleet's
        # (docs/robustness.md "Tenant isolation").
        self.tenant_quota_bytes = tenant_quota_bytes
        # key -> [nbytes, evict cb, pin count, compressed bytes, tenant]
        self._entries: OrderedDict[tuple, list] = OrderedDict()
        self._tenant_bytes: dict[str, int] = {}
        self.quota_evictions = 0
        self._total = 0
        self._compressed = 0  # portion of _total held in packed form
        self._peak = 0
        self.evictions = 0
        self.evicted_bytes = 0  # an eviction storm's size, not just count
        self.evict_errors = 0   # callbacks that raised (leaked residency)
        # streaming pipeline counters (parallel/mesh_exec.py): bytes
        # (re-)registered = bytes shipped to the device, and whether a
        # scheduled slice's prefetch completed before the consumer
        # reached it
        self.upload_bytes = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._lock = make_rlock("budget")
        # last eviction-pressure event (monotonic): one journal entry
        # per PRESSURE_EVENT_MIN_S under sustained thrash, not one per
        # make-room pass
        self._pressure_emitted_at: float | None = None

    # One make-room pass evicting this fraction of the limit is an
    # eviction storm worth a timeline entry (docs/observability.md
    # "Cluster plane"); smaller churn stays a counter.
    PRESSURE_EVENT_FRACTION = 0.125
    PRESSURE_EVENT_MIN_S = 5.0

    @property
    def resident_bytes(self) -> int:
        return self._total

    def _pop_locked(self, key: tuple) -> list:
        """Pop ``key`` keeping the byte ledgers (total, compressed,
        per-tenant) consistent.  Caller must hold self._lock."""
        e = self._entries.pop(key)
        self._total -= e[0]
        self._compressed -= e[3]
        t = e[4]
        if t is not None:
            left = self._tenant_bytes.get(t, 0) - e[0]
            if left > 0:
                self._tenant_bytes[t] = left
            else:
                self._tenant_bytes.pop(t, None)
        return e

    def _over_quota_locked(self) -> set:
        if self.tenant_quota_bytes <= 0:
            return set()
        return {t for t, b in self._tenant_bytes.items()
                if b > self.tenant_quota_bytes}

    def _evict_lru_locked(self, incoming: int) -> list[Callable[[], None]]:
        """Pop LRU entries until ``incoming`` more bytes fit the limit;
        returns their callbacks for the caller to run OUTSIDE the lock
        (owners may take their own locks without ordering against this
        one).  Caller must hold self._lock.

        Pinned entries are NEVER popped — an in-flight dispatch or a
        prefetch holds them — so eviction takes the unpinned-coldest,
        preferring entries of tenants OVER their residency quota (the
        over-quota tenant pays for the pressure it created); when
        everything left is pinned, the budget runs transiently
        over-limit instead of corrupting in-flight work."""
        to_evict: list[Callable[[], None]] = []
        if self.limit_bytes is None:
            return to_evict
        while self._entries and self._total + incoming > self.limit_bytes:
            victim = None
            over = self._over_quota_locked()
            if over:
                for key, e in self._entries.items():  # LRU -> MRU order
                    if e[2] == 0 and e[4] in over:
                        victim = key
                        self.quota_evictions += 1
                        break
            if victim is None:
                for key, e in self._entries.items():
                    if e[2] == 0:
                        victim = key
                        break
            if victim is None:
                break  # all pinned: admit over-limit
            e = self._pop_locked(victim)
            self.evictions += 1
            self.evicted_bytes += e[0]
            to_evict.append(e[1])
        return to_evict

    def _evict_tenant_locked(self, tenant, keep: tuple
                             ) -> list[Callable[[], None]]:
        """Per-tenant quota pressure: pop ``tenant``'s unpinned-coldest
        entries until it fits its quota, never popping ``keep`` (the
        entry being registered) — a lone over-quota entry runs
        transiently over, like the all-pinned case.  Caller holds
        self._lock; returns callbacks to run outside it."""
        to_evict: list[Callable[[], None]] = []
        if self.tenant_quota_bytes <= 0 or tenant is None:
            return to_evict
        while self._tenant_bytes.get(tenant, 0) > self.tenant_quota_bytes:
            victim = None
            for key, e in self._entries.items():  # LRU -> MRU order
                if e[4] == tenant and e[2] == 0 and key != keep:
                    victim = key
                    break
            if victim is None:
                break
            e = self._pop_locked(victim)
            self.evictions += 1
            self.quota_evictions += 1
            self.evicted_bytes += e[0]
            to_evict.append(e[1])
        return to_evict

    def _run_evictions(self, to_evict: list[Callable[[], None]]):
        for cb in to_evict:
            try:
                cb()
            except Exception:
                # the entry is already unaccounted; a failed callback
                # means its owner may still hold the buffer (leaked
                # residency) — that must be visible in stats(), not
                # silent (the budget itself must survive regardless).
                # Counted under the lock like every other counter:
                # callbacks run outside it, so concurrent failures race.
                with self._lock:
                    self.evict_errors += 1

    def register(self, key: tuple, nbytes: int, evict: Callable[[], None],
                 compressed_bytes: int = 0, tenant: str | None = None):
        """Account ``nbytes`` under ``key``; ``evict`` drops the owner's
        reference when called.  Evicts LRU entries first if needed (never
        evicting the incoming entry itself).  Re-registering an existing
        key keeps its pin count (the owner re-staged data an in-flight
        user still holds pinned).  ``compressed_bytes`` is the portion of
        ``nbytes`` held as packed container streams rather than dense
        tensors (docs/memory-budget.md "Compressed residency") — it
        splits the resident gauge, not the accounting.  ``tenant``
        charges the bytes against that tenant's residency quota (None
        falls back to the ambient request tenant)."""
        if tenant is None:
            tenant = qtenant.current_or_none()
        with self._lock:
            pins = 0
            if key in self._entries:
                pins = self._pop_locked(key)[2]
            evicted0 = self.evicted_bytes
            to_evict = self._evict_lru_locked(nbytes)
            freed = self.evicted_bytes - evicted0
            self._entries[key] = [nbytes, evict, pins, compressed_bytes,
                                  tenant]
            self._total += nbytes
            self._compressed += compressed_bytes
            if tenant is not None:
                self._tenant_bytes[tenant] = \
                    self._tenant_bytes.get(tenant, 0) + nbytes
                quota0 = self.evicted_bytes
                quota_evict = self._evict_tenant_locked(tenant, key)
                quota_freed = self.evicted_bytes - quota0
                to_evict.extend(quota_evict)
            else:
                quota_evict, quota_freed = [], 0
            self._peak = max(self._peak, self._total)
            self.upload_bytes += nbytes
        if quota_evict:
            qtenant.REGISTRY.note_quota_evict(tenant, quota_freed)
        self._note_pressure(freed, len(to_evict))
        self._run_evictions(to_evict)

    def _note_pressure(self, freed: int, n_evicted: int):
        """Journal an eviction storm: one make-room pass that evicted a
        large slice of the budget (rate-limited — sustained thrash is
        one timeline entry per interval, with the counters carrying the
        magnitude)."""
        if self.limit_bytes is None or freed < max(
                int(self.limit_bytes * self.PRESSURE_EVENT_FRACTION), 1):
            return
        import time as _time
        now = _time.monotonic()
        last = self._pressure_emitted_at
        if last is not None and now - last < self.PRESSURE_EVENT_MIN_S:
            return
        self._pressure_emitted_at = now
        from ..utils import events
        events.emit("membudget.pressure", freedBytes=freed,
                    entries=n_evicted, limitBytes=self.limit_bytes,
                    residentBytes=self._total)

    def reset_peak(self):
        """Restart the high-water mark from the current residency (bench /
        diagnostics epochs; the gauge analog of prometheus' counter
        resets)."""
        with self._lock:
            self._peak = self._total

    def shrink_to_limit(self):
        """Evict LRU entries until residency fits the (possibly just
        lowered) limit — ``register`` only evicts on new allocations, so a
        runtime limit decrease applies lazily without this."""
        with self._lock:
            to_evict = self._evict_lru_locked(0)
        self._run_evictions(to_evict)

    def touch(self, key: tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def pin(self, key: tuple) -> bool:
        """Mark ``key`` in use by an in-flight plan or prefetch: eviction
        will not pop it until every pin is released.  Returns False (and
        pins nothing) when the key is not registered — callers proceed
        unprotected; correctness is unaffected because jax keeps device
        buffers alive for enqueued computations, pinning only prevents a
        wasteful re-stage."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return False
            e[2] += 1
            return True

    def unpin(self, key: tuple):
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e[2] > 0:
                e[2] -= 1

    def note_prefetch(self, hit: bool):
        """Record whether a scheduled slice was already staged when the
        consumer reached it (parallel/mesh_exec.py streaming)."""
        with self._lock:
            if hit:
                self.prefetch_hits += 1
            else:
                self.prefetch_misses += 1

    def unregister(self, key: tuple):
        with self._lock:
            if key in self._entries:
                self._pop_locked(key)

    def stats(self) -> dict:
        with self._lock:
            pinned_bytes = sum(e[0] for e in self._entries.values()
                               if e[2] > 0)
            return {
                "residentBytes": self._total,
                "compressedBytes": self._compressed,
                "denseBytes": self._total - self._compressed,
                "peakBytes": self._peak,
                "limitBytes": self.limit_bytes,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "evictedBytes": self.evicted_bytes,
                "evictErrors": self.evict_errors,
                "uploadBytes": self.upload_bytes,
                "prefetchHits": self.prefetch_hits,
                "prefetchMisses": self.prefetch_misses,
                "pinnedBytes": pinned_bytes,
                "tenantQuotaBytes": self.tenant_quota_bytes,
                "quotaEvictions": self.quota_evictions,
                "tenantBytes": dict(self._tenant_bytes),
            }


# Process-wide default (accounting-only until a limit is configured).
DEFAULT_BUDGET = DeviceBudget()

# Ingest delta-overlay budget (docs/ingest.md): accounts the host-side
# journals whose bits are OR'd into resident device state as overlays
# (storage/fragment.py ingest_apply, parallel/mesh_exec.py).  This
# instance is ACCOUNTING-ONLY (limit stays None): folding a journal must
# take the owning fragment's lock, and running that as a register-time
# eviction callback while ANOTHER fragment's lock is held would order
# fragment locks against each other (deadlock).  The limit lives in
# INGEST_DELTA_LIMIT_BYTES instead, enforced cooperatively — a fragment
# self-folds past its per-fragment share, and the ingest committer's
# flush loop (the only cross-fragment folder, single-threaded) folds the
# rest when the total runs over.  ``ingest-delta-mb`` sets it; 0 disables
# overlay journaling entirely (every flush folds immediately).
INGEST_DELTA_BUDGET = DeviceBudget()
INGEST_DELTA_LIMIT_BYTES = 64 << 20

# Host-side dense staging cache budget (fragment.staged_dense): bounds the
# expanded dense blocks kept around so a re-upload after HBM eviction
# skips the sparse->dense expansion.  limit 0 = staging disabled (every
# upload re-expands), None = unbounded.  Server config ``host_stage_mb``
# sets it; 4 GiB default keeps steady-state re-uploads at transfer speed
# without letting staging rival the sparse store for host memory.
HOST_STAGE_BUDGET = DeviceBudget(limit_bytes=4 << 30)
