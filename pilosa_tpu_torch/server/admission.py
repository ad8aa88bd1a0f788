"""Admission control: bounded concurrent-query slots + weighted-fair
per-tenant wait queues in front of the executor.

The stdlib ThreadingHTTPServer spawns a thread per connection, so without
a gate a burst of queries all execute at once: device dispatch contends,
every query slows down, and the burst's tail piles onto an already-losing
position (congestion collapse).  The slot pool bounds concurrency; a
short bounded wait queue absorbs jitter; everything beyond that is
rejected IMMEDIATELY with 503 + Retry-After so clients back off instead
of queueing invisibly inside the server (the reference relies on Go's
scheduler + fixed worker pools, executor.go:80-110; here the pool is
explicit).

Fairness (docs/robustness.md "Tenant isolation"): the wait queue is
per-TENANT, drained by deficit round-robin — each tenant queue earns
``weight`` credits per scheduling visit (capped at ``weight * burst``,
the burst allowance an idle tenant banks for its return) and spends one
per admitted query, so slot grants converge to the weight ratio no
matter how hard one tenant floods.  When the total queue is full, the
tenant most over its fair share of the queue sheds FIRST — its own
newest waiter is evicted (or the arriving request rejected, when the
arriver IS the over-quota tenant) — so a polite tenant's waiters are
untouched by a neighbor's flood.  ``fair=False`` restores the single
FIFO queue and reject-the-arrival shedding exactly (the pre-isolation
behavior, kept for differential benches).

Rejections carry a COMPUTED Retry-After: the queue-timeout base scaled
by queue pressure, with decorrelated jitter so a synchronized client
cohort cannot re-stampede the queue on the same tick (clients honor
fractional values — cli.py ingest).

The ``/internal/`` query plane gets its OWN controller instance: a
coordinator holding a public slot fans out to peers whose internal
handling must never compete with (or be starved by) their public
traffic — otherwise N coordinators' fan-outs could fill every node's
public pool and deadlock the cluster against itself.

``begin_drain`` flips the controller into drain mode: new work is
rejected (503, Retry-After) while ``wait_drained`` lets in-flight queries
finish under a deadline — the graceful-shutdown half of the overload
armor (Server.close/drain).

Port copy of the JAX package's ``server/admission.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import random
import time
from collections import OrderedDict, deque

from ..utils import tenant as qtenant
from ..utils.events import EVENTS
from ..utils.locks import make_condition

RETRY_AFTER_CAP_S = 30.0
MIN_WEIGHT = 0.05        # a zero/negative weight must not stall a queue
TENANT_STATS_MAX = 128   # per-tenant counter table LRU cap
SHED_EVENT_MIN_S = 1.0   # journal rate limit per (tenant, pool)


class AdmissionRejected(Exception):
    """Query rejected at admission (HTTP 503 + Retry-After)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


def decorrelated_retry_after(base: float,
                             cap: float = RETRY_AFTER_CAP_S) -> float:
    """Jittered client backoff: uniform in [base, 3*base] (capped) so a
    cohort rejected on the same tick spreads its retries instead of
    re-stampeding in phase.  Fractional seconds on purpose — clients
    parse floats."""
    base = min(max(base, 1.0), cap)
    return round(min(cap, random.uniform(base, 3.0 * base)), 2)


class _TenantQueue:
    """One tenant's FIFO of waiters + its DRR scheduling state."""

    __slots__ = ("name", "weight", "deficit", "waiters")

    def __init__(self, name: str, weight: float, burst: float):
        self.name = name
        self.weight = weight
        # burst credits: a (re)appearing tenant starts with its full
        # allowance banked, so short bursts ride through un-queued-on
        self.deficit = weight * burst
        self.waiters: deque[dict] = deque()


class AdmissionController:
    """Slot pool + bounded weighted-fair wait queues.

    ``max_slots <= 0`` means unlimited concurrency — in-flight tracking
    still runs so draining works.  The wait queues hold at most
    ``2 * max_slots`` waiters TOTAL (beyond that the server is
    definitively overloaded and queueing only adds latency); each waiter
    gives up after ``queue_timeout`` seconds.  ``weights`` maps tenant
    name -> relative share (unlisted tenants weigh 1.0); ``burst`` is
    the banked-credit multiple; ``fair=False`` restores the legacy
    single-FIFO queue."""

    def __init__(self, max_slots: int = 0, queue_timeout: float = 0.5,
                 max_queue: int | None = None, stats=None,
                 name: str = "public",
                 weights: dict[str, float] | None = None,
                 burst: float = 8.0, fair: bool = True):
        self.max_slots = max_slots
        self.queue_timeout = queue_timeout
        self.max_queue = max_queue if max_queue is not None \
            else max(1, 2 * max_slots)
        self.stats = stats
        self.name = name
        self.weights = dict(weights or {})
        self.burst = max(float(burst), 1.0)
        self.fair = bool(fair)
        self._cond = make_condition("admission")
        self.in_use = 0
        self.waiting = 0
        self.draining = False
        # counters (surfaced at /debug/vars and, via stats, /metrics)
        self.admitted = 0
        self.queued = 0
        self.rejected_busy = 0       # waited queue_timeout, no slot freed
        self.rejected_queue_full = 0  # wait queue overflow
        self.rejected_draining = 0
        self.shed_over_quota = 0     # queue-full evictions of the most
        #                              over-share tenant's newest waiter
        # per-tenant queues live only while non-empty; counters persist
        self._queues: dict[str, _TenantQueue] = {}
        self._rr: list[str] = []    # DRR visit order (active queues)
        self._rr_idx = 0
        self._tenants: OrderedDict[str, dict] = OrderedDict()
        self._last_shed_event: dict[str, float] = {}

    # -- small helpers ------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return max(float(self.weights.get(tenant, 1.0)), MIN_WEIGHT)

    def _retry_after(self) -> float:
        """Computed, jittered backoff: base = queue timeout scaled by
        how full the wait queue already is."""
        base = max(1.0, self.queue_timeout
                   * (1.0 + self.waiting / max(self.max_queue, 1)))
        return decorrelated_retry_after(base)

    def retry_after(self) -> float:
        """Public alias for callers outside the controller (the ingest
        backpressure 503s reuse the pool's computed backoff)."""
        return self._retry_after()

    def _count(self, metric: str):
        if self.stats is not None:
            self.stats.count(f"admission.{self.name}.{metric}")

    def _tstats(self, tenant: str) -> dict:
        st = self._tenants.get(tenant)
        if st is None:
            while len(self._tenants) >= TENANT_STATS_MAX:
                self._tenants.popitem(last=False)
            st = self._tenants[tenant] = {
                "admitted": 0, "queued": 0, "shed": 0, "waitS": 0.0}
        else:
            self._tenants.move_to_end(tenant)
        return st

    def _queue_for(self, tenant: str) -> _TenantQueue:
        key = tenant if self.fair else ""
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = _TenantQueue(
                key, self._weight(tenant), self.burst)
            self._rr.append(key)
        return q

    def _drop_queue(self, key: str):
        self._queues.pop(key, None)
        if key in self._rr:
            i = self._rr.index(key)
            self._rr.pop(i)
            if i < self._rr_idx:
                self._rr_idx -= 1
            if self._rr:
                self._rr_idx %= len(self._rr)

    def _reject(self, counter: str, msg: str, tenant: str):
        setattr(self, counter, getattr(self, counter) + 1)
        self._count("rejected")
        self._tstats(tenant)["shed"] += 1
        raise AdmissionRejected(msg, retry_after=self._retry_after())

    # -- acquire / release --------------------------------------------------

    def acquire(self, tenant: str | None = None) -> float:
        """Take a slot (returns seconds spent queued, 0.0 for immediate
        admission) or raise AdmissionRejected.  Every successful acquire
        MUST be paired with release().  The tenant defaults to the
        request context (utils/tenant.py)."""
        t = tenant if tenant is not None else qtenant.current()
        try:
            return self._acquire(t)
        except AdmissionRejected:
            # attribution OUTSIDE the condition: the registry/stats/
            # journal take their own locks
            self._attribute_shed(t, time.monotonic())
            raise

    def _acquire(self, t: str) -> float:
        with self._cond:
            if self.draining:
                self._reject("rejected_draining", "server is draining", t)
            if self.max_slots <= 0 or self.in_use < self.max_slots:
                self.in_use += 1
                self.admitted += 1
                self._tstats(t)["admitted"] += 1
                self._count("admitted")
                return 0.0
            if self.waiting >= self.max_queue \
                    and not self._make_room(t):
                self._reject(
                    "rejected_queue_full",
                    f"too many concurrent queries "
                    f"({self.in_use} running, {self.waiting} queued)", t)
            q = self._queue_for(t)
            w = {"tenant": t, "granted": False, "shed": False}
            q.waiters.append(w)
            self.waiting += 1
            self.queued += 1
            st = self._tstats(t)
            st["queued"] += 1
            t0 = time.monotonic()
            deadline = t0 + self.queue_timeout
            try:
                while True:
                    if w["granted"]:
                        waited = time.monotonic() - t0
                        self.admitted += 1
                        st["admitted"] += 1
                        st["waitS"] += waited
                        self._count("admitted")
                        return waited
                    if w["shed"]:
                        # evicted at queue-full time as the most
                        # over-share tenant (already off the queue)
                        self.shed_over_quota += 1
                        self._reject(
                            "rejected_queue_full",
                            f"shed: tenant {t!r} over its fair share "
                            f"of the wait queue", t)
                    if self.draining:
                        self._unlink(q, w)
                        self._reject("rejected_draining",
                                     "server is draining", t)
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self._unlink(q, w)
                        self._reject(
                            "rejected_busy",
                            f"no query slot freed within "
                            f"{self.queue_timeout:.3g}s "
                            f"({self.in_use} running)", t)
                    self._cond.wait(left)
            finally:
                self.waiting -= 1

    def _unlink(self, q: _TenantQueue, w: dict):
        try:
            q.waiters.remove(w)
        except ValueError:
            pass
        if not q.waiters:
            self._drop_queue(q.name)

    def _make_room(self, arriving: str) -> bool:
        """Queue-full policy (fair mode): shed from the tenant most
        over its weight-normalized share of the queue.  If that's the
        arriver, reject it (return False); otherwise evict the
        over-share tenant's NEWEST waiter and admit the arrival to the
        queue (True) — a polite tenant is untouched by a flood."""
        if not self.fair or not self._rr:
            return False
        key = arriving  # fair mode keys queues by tenant
        shares = {k: len(self._queues[k].waiters)
                  / self._weight(self._queues[k].waiters[0]["tenant"])
                  for k in self._rr if self._queues[k].waiters}
        arriving_share = (shares.get(key, 0) + 1) / self._weight(arriving)
        victim = max(shares, key=lambda k: shares[k], default=None)
        if victim is None or shares[victim] < arriving_share:
            return False  # the arriver is the over-quota tenant
        vq = self._queues[victim]
        w = vq.waiters.pop()  # newest waiter: least sunk wait cost
        w["shed"] = True
        if not vq.waiters:
            self._drop_queue(victim)
        self._cond.notify_all()
        return True

    def _grant_locked(self):
        """Hand freed slots to waiters by deficit round-robin: each
        visit banks ``weight`` credits (capped at weight*burst), each
        grant spends one — service converges to the weight ratio."""
        while self._rr and (self.max_slots <= 0
                            or self.in_use < self.max_slots):
            if self.fair:
                guard = 0
                while True:
                    key = self._rr[self._rr_idx % len(self._rr)]
                    q = self._queues[key]
                    if q.deficit >= 1.0:
                        break
                    q.deficit = min(q.deficit + q.weight,
                                    q.weight * self.burst)
                    self._rr_idx = (self._rr_idx + 1) % len(self._rr)
                    guard += 1
                    if guard > 64 * len(self._rr):  # unreachable: the
                        break  # MIN_WEIGHT floor bounds refill rounds
                q.deficit -= 1.0
            else:
                q = self._queues[self._rr[0]]  # legacy: one FIFO queue
            w = q.waiters.popleft()
            if not q.waiters:
                self._drop_queue(q.name)
            w["granted"] = True
            self.in_use += 1
        self._cond.notify_all()

    def release(self):
        with self._cond:
            self.in_use -= 1
            # grant under the SAME lock hold: an arrival can never
            # steal the freed slot past a queued waiter.  notify_all
            # (via _grant_locked): granted waiters AND wait_drained may
            # be parked on the same condition (tiny scale, not hot).
            self._grant_locked()

    def _attribute_shed(self, tenant: str, now: float):
        """Per-tenant shed accounting outside the condition: stats
        series, the tenant registry, and a rate-limited journal event
        (a flood must not write one event per rejected request)."""
        if self.stats is not None:
            self.stats.count(f"tenant.{tenant}.shed")
        qtenant.REGISTRY.note_shed(tenant, self.name)
        last = self._last_shed_event.get(tenant, 0.0)
        if now - last >= SHED_EVENT_MIN_S:
            self._last_shed_event[tenant] = now
            EVENTS.emit("tenant.shed", tenant=tenant, pool=self.name)

    # -- drain -------------------------------------------------------------

    def begin_drain(self):
        """Stop admitting; queued waiters are rejected immediately."""
        with self._cond:
            self.draining = True
            self._cond.notify_all()

    def wait_drained(self, timeout: float) -> bool:
        """Block until in-flight work finishes (True) or the drain
        deadline passes (False — the caller closes anyway)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self.in_use > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def snapshot(self) -> dict:
        with self._cond:
            tenants = {}
            for t, st in self._tenants.items():
                q = self._queues.get(t) if self.fair else None
                tenants[t] = {
                    "weight": self._weight(t),
                    "admitted": st["admitted"],
                    "queued": st["queued"],
                    "shed": st["shed"],
                    "waiting": len(q.waiters) if q is not None else 0,
                    "deficit": round(q.deficit, 3)
                    if q is not None else None,
                    "avgWaitMs": round(
                        st["waitS"] / st["queued"] * 1e3, 3)
                    if st["queued"] else 0.0,
                }
            return {
                "maxSlots": self.max_slots,
                "queueTimeoutS": self.queue_timeout,
                "maxQueue": self.max_queue,
                "inUse": self.in_use,
                "waiting": self.waiting,
                "draining": self.draining,
                "admitted": self.admitted,
                "queued": self.queued,
                "rejectedBusy": self.rejected_busy,
                "rejectedQueueFull": self.rejected_queue_full,
                "rejectedDraining": self.rejected_draining,
                "shedOverQuota": self.shed_over_quota,
                "fair": self.fair,
                "tenants": tenants,
            }
