"""Tenant identity: the contextvar spine of the isolation plane
(docs/robustness.md "Tenant isolation").

Every protection in the overload armor (admission slots, cache byte
budgets, hedge budgets) is meaningless against a hostile NEIGHBOR
unless the server knows which customer a request belongs to.  Identity
is derived per request: the index name by default (each index is a
tenant — the natural unit of blast radius), overridable with an
explicit ``X-Pilosa-Tpu-Tenant`` token for deployments that map many
indexes to one customer.  The token grammar is strict and validated at
the edge — garbage, oversize, or empty tokens are a clean 400, never an
exception — because the tenant name becomes a metrics label, a journal
field, and a queue key.

The active tenant rides a contextvar exactly like utils/deadline.py
and utils/profile.py: the HTTP handler activates it for the whole
request, the fan-out pool re-installs context via Tracer.task, and deep
layers (admission, result cache, HBM budget, hedge loop) read
``current()`` with one contextvar get.  An EXPLICIT token additionally
propagates on outbound internal hops (the coordinator's fan-out RPCs
carry the header) so a peer's internal admission pool attributes the
work to the same tenant; derived identities need no header — the peer
re-derives the same name from the index in the path.

``REGISTRY`` is the process-wide per-tenant accounting surface
(qps/p99/shed/hedge-denied/quota columns at /debug/vars "tenants" and
the /debug/cluster rollup), LRU-capped so hostile identifier churn
cannot grow it without bound.

Port copy of the JAX package's ``utils/tenant.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import contextvars
import re
import time
from collections import OrderedDict, deque
from contextlib import contextmanager

from .locks import make_lock

TENANT_HEADER = "X-Pilosa-Tpu-Tenant"
# Token grammar: short, printable, metrics-safe.  The name lands in
# stats series / journal events / debug tables, so the charset is the
# metrics charset, not "whatever fits in an HTTP header".
TENANT_MAX_LEN = 64
_TOKEN_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]*$")

DEFAULT_TENANT = "default"


class TenantError(ValueError):
    """Malformed tenant token (HTTP 400 at the handler)."""


def validate_token(token: str) -> str:
    """The validated token, or TenantError.  Never raises anything
    else — the fuzz contract: arbitrary header bytes are a clean 400."""
    if not isinstance(token, str) or not token:
        raise TenantError("tenant token must be a non-empty string")
    if len(token) > TENANT_MAX_LEN:
        raise TenantError(
            f"tenant token exceeds {TENANT_MAX_LEN} characters")
    if not _TOKEN_RE.match(token):
        raise TenantError(
            "tenant token must match [A-Za-z0-9][A-Za-z0-9_.-]* "
            "(letters, digits, '_', '.', '-'; leading alphanumeric)")
    return token


def derive(header_value: str | None, index: str | None
           ) -> tuple[str, bool]:
    """(tenant, explicit) for one request: the validated header token
    when present (explicit — forwarded on internal hops), else the
    index name, else the shared default bucket."""
    if header_value is not None:
        return validate_token(header_value), True
    if index:
        return str(index), False
    return DEFAULT_TENANT, False


def parse_weights(spec: str) -> dict[str, float]:
    """``"analytics:4,batch:1"`` -> {"analytics": 4.0, "batch": 1.0}.
    Unlisted tenants weigh 1.0; weights clamp to a small positive floor
    at use time so a zero/negative entry cannot stall its queue."""
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition(":")
        if not sep:
            raise TenantError(
                f"tenant weight {part!r} must be name:weight")
        try:
            out[validate_token(name.strip())] = float(w)
        except ValueError as e:
            raise TenantError(f"bad tenant weight {part!r}: {e}") from None
    return out


# -- request context ---------------------------------------------------------

# (name, explicit) — None outside any request (background work stays
# unattributed rather than polluting the default bucket's accounting)
_CTX: contextvars.ContextVar[tuple[str, bool] | None] = \
    contextvars.ContextVar("ptpu-tenant", default=None)


def context() -> tuple[str, bool] | None:
    """The raw (name, explicit) context for cross-thread hand-off:
    Tracer.task captures it alongside the trace context and re-installs
    both in pool workers, so fan-out RPCs keep the request's tenant."""
    return _CTX.get()


def current() -> str:
    """The active request's tenant (the shared default bucket when no
    tenant context is active — bare executors, background threads)."""
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else DEFAULT_TENANT


def current_or_none() -> str | None:
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else None


def header_value() -> str | None:
    """The header to forward on an outbound internal hop: only an
    EXPLICIT token propagates (a derived identity is re-derived from
    the index name on the peer — same answer, no header)."""
    ctx = _CTX.get()
    return ctx[0] if ctx is not None and ctx[1] else None


@contextmanager
def activate(name: str | None, explicit: bool = False):
    """Install ``name`` as the current tenant; None is a passthrough
    (the deadline.activate convention)."""
    if name is None:
        yield
        return
    token = _CTX.set((name, explicit))
    try:
        yield
    finally:
        _CTX.reset(token)


# -- process-wide per-tenant accounting --------------------------------------

MAX_TENANTS = 128       # registry LRU cap (identifier-churn armor)
LATENCY_RING = 256      # per-tenant latency samples for p50/p99


class TenantRegistry:
    """Per-tenant request/shed/hedge/quota counters + a small latency
    ring — the single source for the /debug/vars "tenants" table and
    the fleet rollup's per-tenant columns."""

    def __init__(self):
        self._lock = make_lock("tenant-registry")
        self._tenants: OrderedDict[str, dict] = OrderedDict()
        self.evicted = 0

    def _slot(self, tenant: str) -> dict:
        st = self._tenants.get(tenant)
        if st is None:
            while len(self._tenants) >= MAX_TENANTS:
                self._tenants.popitem(last=False)
                self.evicted += 1
            st = self._tenants[tenant] = {
                "requests": 0, "errors": 0, "shed": 0,
                "hedgeDenied": 0, "quotaEvicts": 0,
                "quotaEvictBytes": 0, "busyS": 0.0,
                "lat": deque(maxlen=LATENCY_RING),
                "sheds_by_pool": {}, "t0": time.monotonic(),
            }
        else:
            self._tenants.move_to_end(tenant)
        return st

    def note_request(self, tenant: str, dur_s: float, status: int):
        with self._lock:
            st = self._slot(tenant)
            st["requests"] += 1
            if status >= 400:
                st["errors"] += 1
            st["busyS"] += dur_s
            st["lat"].append(dur_s)

    def note_shed(self, tenant: str, pool: str):
        with self._lock:
            st = self._slot(tenant)
            st["shed"] += 1
            st["sheds_by_pool"][pool] = \
                st["sheds_by_pool"].get(pool, 0) + 1

    def note_hedge_denied(self, tenant: str):
        with self._lock:
            self._slot(tenant)["hedgeDenied"] += 1

    QUOTA_EVENT_MIN_S = 1.0  # journal rate limit per tenant

    def note_quota_evict(self, tenant: str, nbytes: int):
        emit_event = False
        with self._lock:
            st = self._slot(tenant)
            st["quotaEvicts"] += 1
            st["quotaEvictBytes"] += int(nbytes)
            # quota-breach journal entry, rate-limited per tenant (a
            # churning flood is one timeline entry per interval with the
            # counters carrying the magnitude); emitted OUTSIDE the
            # registry lock — the journal takes its own
            now = time.monotonic()
            last = st.get("quota_event_at")
            if last is None or now - last >= self.QUOTA_EVENT_MIN_S:
                st["quota_event_at"] = now
                emit_event = True
        if emit_event:
            from .events import EVENTS
            EVENTS.emit("tenant.quota", tenant=tenant,
                        evictedBytes=int(nbytes))

    def clear(self):
        with self._lock:
            self._tenants.clear()
            self.evicted = 0

    def snapshot(self) -> dict:
        """tenant -> qps/p50/p99/shed/hedge/quota columns (qps over the
        tenant's own observation window)."""
        out = {}
        with self._lock:
            now = time.monotonic()
            for name, st in self._tenants.items():
                lat = sorted(st["lat"])
                window = max(now - st["t0"], 1e-6)
                row = {
                    "requests": st["requests"],
                    "errors": st["errors"],
                    "qps": round(st["requests"] / window, 3),
                    "shed": st["shed"],
                    "shedByPool": dict(st["sheds_by_pool"]),
                    "hedgeDenied": st["hedgeDenied"],
                    "quotaEvicts": st["quotaEvicts"],
                    "quotaEvictBytes": st["quotaEvictBytes"],
                }
                if lat:
                    row["p50Ms"] = round(
                        lat[len(lat) // 2] * 1e3, 3)
                    row["p99Ms"] = round(
                        lat[min(len(lat) - 1,
                                int(len(lat) * 0.99))] * 1e3, 3)
                out[name] = row
        return out


REGISTRY = TenantRegistry()


# -- hedge budgets -----------------------------------------------------------

class HedgeBudget:
    """Per-tenant token bucket gating speculative (hedged) reads: one
    tenant's straggler storm must not amplify ITS load onto the whole
    fleet.  ``rate`` tokens refill per second with an equal burst
    capacity; 0 disables the budget (every hedge admitted).  Buckets
    are LRU-capped like the registry."""

    def __init__(self, rate: float = 0.0):
        self.rate = max(float(rate), 0.0)
        self._lock = make_lock("hedge-budget")
        self._buckets: OrderedDict[str, list] = OrderedDict()
        self.denied = 0

    def try_take(self, tenant: str, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                while len(self._buckets) >= MAX_TENANTS:
                    self._buckets.popitem(last=False)
                b = self._buckets[tenant] = [self.rate, now]
            else:
                self._buckets.move_to_end(tenant)
                b[0] = min(self.rate, b[0] + (now - b[1]) * self.rate)
                b[1] = now
            if b[0] >= n:
                b[0] -= n
                return True
            self.denied += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "denied": self.denied,
                    "tenants": {t: round(b[0], 3)
                                for t, b in self._buckets.items()}}
