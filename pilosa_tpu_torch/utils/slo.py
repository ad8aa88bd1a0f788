"""SLO engine: declarative objectives + burn-rate alerting over the
telemetry plane (docs/observability.md "SLOs & alerting").

The tree emits telemetry at three layers — per-query traces/profiles,
the device compile registry / launch ledger / time-series ring, and the
fleet rollup + event journal — but nothing *evaluates* any of it: an
operator learns about a violated latency objective by reading a
dashboard, after the bounded rings have rotated the evidence out.  This
module is the evaluation layer:

* **Declarative SLOs** — availability (non-5xx fraction of
  ``http.query``) and latency (fraction of queries under
  ``slo-latency-ms``) against an ``slo-target`` objective, judged with
  the classic multi-window burn-rate method (Google SRE workbook ch. 5):
  an alert fires only when BOTH a fast and a slow window burn error
  budget faster than ``BURN_THRESHOLD``x the sustainable rate — the fast
  window keeps resolution snappy after a heal, the slow window keeps a
  momentary blip from paging.  Windows are scaled to the existing
  ``timeseries-interval`` ring (no new sampling machinery): the counters
  ride ``Server.sample_timeseries`` as ``sloErrorsDelta`` /
  ``sloSlowQueriesDelta`` / ``httpQueriesDelta`` columns.
* **A pathology rules engine** — small predicates over the same
  time-series columns and stats counters for the known failure modes the
  event journal already names: retrace storm, hedge storm, eviction
  pressure, ingest backpressure, quarantine, breaker flapping.
* **Alert lifecycle** — ``alert.fire``/``alert.resolve`` events in the
  journal, ``alert.active`` / ``alerts.fired_total`` stats series,
  ``/debug/alerts``, an on-fire hook the flight recorder
  (utils/flightrec.py) hangs a rate-limited diagnostic capture on.

Evaluation runs on the Server's existing time-series monitor thread
(one pass per accepted sample) and must never block a query or a
scrape: each pass reads the ring snapshot and a handful of O(1) stats
counters, and the engine lock only guards its own alert table.

Port copy of the JAX package's ``utils/slo.py``, with the same rule ids,
thresholds and windows.  Every column the rules read has a counterpart
on the card, sampled by the port's ``Server.sample_timeseries``:
``retracesDelta`` counts CUDA graph captures under the retrace rule of
utils/devobs.py, and the eviction, ingest, quarantine, breaker, hedge
and query columns come from the same counters as in the JAX package.
Fields left out of the port because only a TPU has them: the persistent
XLA compile cache's status (``cacheEnabled`` reads false; see
warmup/__init__.py) and the Pallas backend flag (``device.kernel_backend``
reads 1 for the CUDA kernels instead).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import events
from .locks import make_lock


def _wall_stamp() -> float: return time.time()  # display-only wall clock


# -- pathology thresholds (module-level so tests can tighten them) ----------
# retraces in the slow window: ONE retrace is already the PR-7-class red
# flag, but warmup replay legitimately re-traces a handful at startup
RETRACE_STORM = 3
# hedges per query over the slow window (plus an absolute floor so a
# single hedged query in an idle interval can't page)
HEDGE_STORM_FRAC = 0.5
HEDGE_STORM_MIN = 10
# device-budget evictions in the slow window: sustained churn, not the
# occasional eviction a working set near its budget produces
EVICTION_PRESSURE = 20
# ingest 503 rejections in the slow window: the committer's merge
# backlog latch is refusing acked writes
INGEST_BACKPRESSURE = 1
# breaker OPEN transitions in the slow window: >= 2 means a peer is
# cycling open -> half-open -> open (flapping), not just down once
BREAKER_FLAPS = 2


@dataclass
class AlertRule:
    """One declarative rule: ``check(ctx)`` returns a human-readable
    detail string while the condition holds, None when healthy.  The
    rule id is the operator contract — every id has a catalog row with
    a runbook line in docs/observability.md (the ``alert-names``
    two-way lint)."""
    id: str
    severity: str          # "page" | "ticket"
    summary: str
    check: Callable[["EvalContext"], Optional[str]]
    clear_after: int = 2   # consecutive healthy evaluations to resolve


RULES: dict[str, AlertRule] = {}


def alert_rule(rule_id: str, severity: str = "ticket", summary: str = "",
               clear_after: int = 2):
    """Register a rule under its literal id (the ``project_rule`` /
    failpoint-registry pattern — the analyzer's ``alert-names`` rule
    collects these literals for the docs catalog lint)."""
    def deco(fn):
        RULES[rule_id] = AlertRule(rule_id, severity, summary, fn,
                                   clear_after)
        return fn
    return deco


class EvalContext:
    """The read-only view one evaluation pass sees: the newest ring
    samples (delta + gauge columns, oldest first) plus the engine's
    objective knobs."""

    def __init__(self, samples: list[dict], engine: "SLOEngine"):
        self.samples = samples
        self.engine = engine

    def sum(self, col: str, n: int) -> float:
        """Sum of a delta column over the newest ``n`` samples."""
        return sum(s.get(col, 0.0) for s in self.samples[-n:])

    def last(self, col: str, default: float = 0.0) -> float:
        """Newest sample's value of a gauge column."""
        if not self.samples:
            return default
        return self.samples[-1].get(col, default)

    def burn(self, bad_col: str, total_col: str, n: int) -> float:
        """Burn rate over the newest ``n`` samples: the fraction of bad
        events divided by the error budget (1 - target).  1.0 means the
        budget is being spent exactly at the sustainable rate; an
        interval with no traffic burns nothing."""
        total = self.sum(total_col, n)
        if total <= 0:
            return 0.0
        bad = self.sum(bad_col, n)
        budget = max(1.0 - self.engine.target, 1e-9)
        return (bad / total) / budget


# -- burn-rate SLO rules ----------------------------------------------------


@alert_rule("slo-availability-burn", severity="page",
            summary="availability SLO error budget burning: 5xx "
                    "fraction of http.query over target in both windows")
def _availability_burn(ctx: EvalContext) -> Optional[str]:
    e = ctx.engine
    fast = ctx.burn("sloErrorsDelta", "httpQueriesDelta", e.fast_n)
    slow = ctx.burn("sloErrorsDelta", "httpQueriesDelta", e.slow_n)
    if fast > e.burn_threshold and slow > e.burn_threshold:
        return (f"5xx burn {fast:.1f}x fast / {slow:.1f}x slow "
                f"(target {e.target:g})")
    return None


@alert_rule("slo-latency-burn", severity="page",
            summary="latency SLO error budget burning: queries over "
                    "slo-latency-ms exceed target in both windows")
def _latency_burn(ctx: EvalContext) -> Optional[str]:
    e = ctx.engine
    fast = ctx.burn("sloSlowQueriesDelta", "httpQueriesDelta", e.fast_n)
    slow = ctx.burn("sloSlowQueriesDelta", "httpQueriesDelta", e.slow_n)
    if fast > e.burn_threshold and slow > e.burn_threshold:
        detail = (f"over-{e.latency_ms:g}ms burn {fast:.1f}x fast / "
                  f"{slow:.1f}x slow (target {e.target:g})")
        worst = e.worst_tenant()
        if worst is not None:
            detail += (f"; worst tenant {worst[0]} "
                       f"p99 {worst[1]:.0f}ms")
        return detail
    return None


# -- pathology rules (the failure modes the event journal names) ------------


@alert_rule("retrace-storm",
            summary="executables re-tracing in steady state (the "
                    "PR-7-class silent decode-bug red flag)")
def _retrace_storm(ctx: EvalContext) -> Optional[str]:
    n = ctx.sum("retracesDelta", ctx.engine.slow_n)
    if n >= RETRACE_STORM:
        return f"{n:g} retraces in the slow window"
    return None


@alert_rule("hedge-storm",
            summary="hedged reads on most queries: a replica is "
                    "persistently straggling")
def _hedge_storm(ctx: EvalContext) -> Optional[str]:
    hedges = ctx.sum("hedgesDelta", ctx.engine.slow_n)
    queries = ctx.sum("httpQueriesDelta", ctx.engine.slow_n)
    if hedges >= HEDGE_STORM_MIN \
            and hedges > HEDGE_STORM_FRAC * max(queries, 1.0):
        return f"{hedges:g} hedges over {queries:g} queries"
    return None


@alert_rule("eviction-pressure",
            summary="device budget thrashing: sustained eviction churn "
                    "instead of a resident working set")
def _eviction_pressure(ctx: EvalContext) -> Optional[str]:
    n = ctx.sum("evictionsDelta", ctx.engine.slow_n)
    if n >= EVICTION_PRESSURE:
        return f"{n:g} evictions in the slow window"
    return None


@alert_rule("ingest-backpressure",
            summary="streaming ingest refusing writes: the group "
                    "committer's merge backlog latched backpressure")
def _ingest_backpressure(ctx: EvalContext) -> Optional[str]:
    n = ctx.sum("ingestRejectedDelta", ctx.engine.slow_n)
    if n >= INGEST_BACKPRESSURE:
        return f"{n:g} ingest rejections in the slow window"
    return None


@alert_rule("quarantine",
            summary="fragments quarantined by corruption checks and "
                    "not yet repaired from replicas")
def _quarantine(ctx: EvalContext) -> Optional[str]:
    n = ctx.last("quarantinedFragments")
    if n > 0:
        return f"{n:g} fragment(s) quarantined"
    return None


@alert_rule("breaker-flapping",
            summary="a peer breaker cycling open/half-open/open "
                    "instead of staying up or staying down")
def _breaker_flapping(ctx: EvalContext) -> Optional[str]:
    n = ctx.sum("breakerOpensDelta", ctx.engine.slow_n)
    if n >= BREAKER_FLAPS:
        return f"{n:g} breaker opens in the slow window"
    return None


class SLOEngine:
    """Evaluates the registered rules against a TimeSeriesRing and keeps
    the active-alert table.  One instance per Server (it reads that
    server's ring); the rule REGISTRY is module-level and shared."""

    # burn-rate both windows must exceed before an SLO alert fires.
    # 10x means a 99.9% target's monthly budget would be gone in ~3
    # days — urgent, but tolerant of one bad scrape interval.
    BURN_THRESHOLD = 10.0
    # window pair scaled to the ring (classic 5m/1h compressed onto the
    # in-process window): fast = 5% of capacity, slow = 25%
    FAST_FRAC = 0.05
    SLOW_FRAC = 0.25
    HISTORY = 64  # fire/resolve transitions kept for /debug/alerts

    def __init__(self, ring, stats, *, latency_ms: float = 500.0,
                 target: float = 0.999, rules: str = "all",
                 logger=None, on_fire=None, tenant_registry=None):
        self.ring = ring
        self.stats = stats
        self.latency_ms = float(latency_ms)
        self.target = min(max(float(target), 0.0), 0.9999999)
        self.logger = logger
        self.on_fire = on_fire  # callable(alert_dict) on fire transition
        self.tenant_registry = tenant_registry
        self.burn_threshold = self.BURN_THRESHOLD
        cap = max(getattr(ring, "capacity", 1), 1)
        self.fast_n = max(2, int(cap * self.FAST_FRAC))
        self.slow_n = max(self.fast_n * 3, int(cap * self.SLOW_FRAC))
        self.rules = self._select(rules)
        self.enabled = bool(self.rules)
        self._lock = make_lock("slo")
        self.active: dict[str, dict] = {}
        self.fired_total = 0
        self.resolved_total = 0
        self.evaluations = 0
        self._quiet: dict[str, int] = {}  # consecutive healthy evals
        self._history: deque = deque(maxlen=self.HISTORY)

    def _select(self, spec: str) -> dict[str, AlertRule]:
        spec = (spec or "all").strip()
        if spec in ("off", "none", ""):
            return {}
        if spec == "all":
            return dict(RULES)
        chosen = {}
        for rid in (s.strip() for s in spec.split(",")):
            if not rid:
                continue
            if rid in RULES:
                chosen[rid] = RULES[rid]
            elif self.logger is not None:
                self.logger.error(
                    f"alert-rules names unknown rule '{rid}' "
                    f"(known: {', '.join(sorted(RULES))})")
        return chosen

    def worst_tenant(self) -> tuple[str, float] | None:
        """Optional per-tenant scoping (the PR 17 registry): the tenant
        with the highest p99 over the objective, for the latency
        alert's detail line.  None when no tenant is over or the
        registry is absent/empty."""
        reg = self.tenant_registry
        if reg is None:
            return None
        worst = None
        for tenant, cols in reg.snapshot().items():
            p99 = cols.get("p99Ms") or 0.0
            if p99 > self.latency_ms and \
                    (worst is None or p99 > worst[1]):
                worst = (tenant, p99)
        return worst

    def evaluate(self) -> None:
        """One evaluation pass over the newest slow-window samples.
        Runs on the Server's time-series monitor thread right after an
        accepted sample; never raises (a dead evaluator is a muted
        pager — the PR 6 swallow class is logged per rule instead)."""
        if not self.enabled:
            return
        samples = self.ring.last(self.slow_n)
        ctx = EvalContext(samples, self)
        firing: dict[str, str] = {}
        for rid, rule in self.rules.items():
            try:
                detail = rule.check(ctx)
            except Exception as e:
                if self.logger is not None:
                    self.logger.error(f"alert rule {rid} failed: {e}")
                continue
            if detail is not None:
                firing[rid] = detail
        fired, resolved = [], []
        with self._lock:
            self.evaluations += 1
            for rid, detail in firing.items():
                self._quiet[rid] = 0
                cur = self.active.get(rid)
                if cur is not None:
                    cur["detail"] = detail  # keep the newest evidence
                    continue
                rule = self.rules[rid]
                alert = {"id": rid, "severity": rule.severity,
                         "summary": rule.summary, "detail": detail,
                         "sinceWall": _wall_stamp(),
                         "sinceMono": time.monotonic(),
                         "firedAtEvaluation": self.evaluations}
                self.active[rid] = alert
                self.fired_total += 1
                fired.append(dict(alert))
            for rid in list(self.active):
                if rid in firing:
                    continue
                quiet = self._quiet.get(rid, 0) + 1
                self._quiet[rid] = quiet
                if quiet >= self.rules[rid].clear_after:
                    alert = self.active.pop(rid)
                    self.resolved_total += 1
                    resolved.append(alert)
            n_active = len(self.active)
            for a in fired:
                self._history.append(
                    {"action": "fire", "id": a["id"], "wall": a["sinceWall"],
                     "severity": a["severity"], "detail": a["detail"]})
            for a in resolved:
                self._history.append(
                    {"action": "resolve", "id": a["id"],
                     "wall": _wall_stamp(), "severity": a["severity"],
                     "detail": a["detail"]})
        # emissions OUTSIDE the lock: the journal, stats, logger, and
        # the flight-recorder hook acquire their own leaf locks
        for a in fired:
            events.emit("alert.fire", alert=a["id"],
                        severity=a["severity"], detail=a["detail"])
            if self.stats is not None:
                self.stats.count("alerts.fired_total")
            if self.logger is not None:
                self.logger.error(
                    f"ALERT fire [{a['severity']}] {a['id']}: "
                    f"{a['detail']}")
            if self.on_fire is not None:
                try:
                    self.on_fire(a)
                except Exception as e:
                    if self.logger is not None:
                        self.logger.error(
                            f"alert on-fire hook failed: {e}")
        for a in resolved:
            events.emit("alert.resolve", alert=a["id"],
                        severity=a["severity"])
            if self.logger is not None:
                self.logger.info(f"ALERT resolve {a['id']}")
        if self.stats is not None:
            self.stats.gauge("alert.active", n_active)

    def vars_summary(self) -> dict:
        """The compact form embedded in /debug/vars (and shipped per
        node by the fleet rollup — keep it small on the wire)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "firedTotal": self.fired_total,
                "resolvedTotal": self.resolved_total,
                "evaluations": self.evaluations,
                "active": {rid: {"severity": a["severity"],
                                 "detail": a["detail"],
                                 "sinceWall": a["sinceWall"]}
                           for rid, a in self.active.items()},
            }

    def snapshot(self) -> dict:
        """The full /debug/alerts body: objectives, windows, the active
        table with durations, recent transitions, and the rule list."""
        now = time.monotonic()
        interval = getattr(self.ring, "interval_s", 0.0)
        with self._lock:
            active = {}
            for rid, a in self.active.items():
                row = {k: v for k, v in a.items() if k != "sinceMono"}
                row["durationS"] = round(now - a["sinceMono"], 3)
                active[rid] = row
            return {
                "enabled": self.enabled,
                "target": self.target,
                "latencyMs": self.latency_ms,
                "burnThreshold": self.burn_threshold,
                "windows": {"fastN": self.fast_n, "slowN": self.slow_n,
                            "fastS": round(self.fast_n * interval, 3),
                            "slowS": round(self.slow_n * interval, 3)},
                "evaluations": self.evaluations,
                "firedTotal": self.fired_total,
                "resolvedTotal": self.resolved_total,
                "active": active,
                "history": list(self._history),
                "rules": [{"id": r.id, "severity": r.severity,
                           "summary": r.summary,
                           "clearAfter": r.clear_after}
                          for r in self.rules.values()],
            }
