"""Fleet metrics rollup: one node answers for the whole cluster
(docs/observability.md "Cluster plane").

With per-node observability alone, diagnosing a fleet-wide p99
regression or a mis-routing episode means ssh-ing to every node and
correlating ``/debug/vars`` by hand.  The :class:`FleetRollup` makes any
node (in practice the coordinator) aggregate its peers:

* ``GET /debug/cluster`` — per-node summaries (qps, p50/p99, HBM split,
  evictions, retraces, hedges, quarantines, ingest backlog) extracted
  from each peer's ``/debug/vars``, plus the local hot-shard table,
  overlay epoch, and a merged fleet event timeline;
* ``pilosa_tpu_cluster_*`` Prometheus gauges with ``node`` labels,
  appended to ``/metrics`` (own exposition, like the launch ledger's).

Fetch discipline: peer pulls ride the existing bounded
:class:`InternalClient` — per-peer circuit breakers apply (an open
breaker fails the pull instantly), fetches run CONCURRENTLY on a
dedicated pool with the cluster's probe timeout, and non-READY peers
are not fetched at all.  A failed or skipped pull serves the peer's
LAST summary stamped ``stale: true`` + ``staleS`` — a dead node can
never block a scrape, only age in it.  Results are TTL-cached
(``TTL_S``) so scrape storms collapse to one refresh.

The merged timeline pulls each peer's event journal with the
``/debug/events?since=<seq>`` cursor (utils/events.py), deduplicating
by (node, seq) — the fleet answer to "what state transitions happened
around that spike", with per-node attribution intact.

Port copy of the JAX package's ``parallel/rollup.py``
(``summarize_vars`` and ``FleetRollup``).  A port node's ``/debug/vars``
carries the JAX package's ``device`` and ``alerts`` sections, so the
summary fields ``compiles``, ``retraces``, ``launches`` and
``paddingWasteRatio`` read its capture registry and launch ledger
(utils/devobs.py; captures stand where compiles stand) and
``activeAlerts``, ``alertsFired`` and ``alertIds`` its SLO engine.  The
registry and ledger are process-wide, so nodes that share one process
report the same device counters.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..utils.events import EVENTS
from ..utils.locks import make_lock

# display-only wall stamp (durations/ages come from monotonic pairs)
def _wall_stamp() -> float: return time.time()


def summarize_vars(v: dict) -> dict:
    """The per-node summary extracted from one /debug/vars snapshot —
    shared by the peer (wire) and local (in-process) paths so the
    rollup agrees with every node's own surface by construction."""
    counts = v.get("counts") or {}
    timings = v.get("timings") or {}
    hq = timings.get("http.query") or {}
    bud = v.get("deviceBudget") or {}
    dev = v.get("device") or {}
    comp = dev.get("compiles") or {}
    lau = dev.get("launches") or {}
    wq = v.get("wholeQuery") or {}
    ing = v.get("ingest") or {}
    adm = (v.get("admission") or {}).get("public") or {}
    cl = v.get("cluster") or {}
    quarantined = v.get("storage", {}).get("quarantined") or []
    # tenant isolation plane: the per-tenant qps/p99/shed/quota columns
    # each node publishes (docs/robustness.md "Tenant isolation")
    tenants = {}
    for name, row in (v.get("tenants") or {}).items():
        tenants[name] = {
            "qps": float(row.get("qps") or 0.0),
            "p99Ms": row.get("p99Ms"),
            "shed": int(row.get("shed") or 0),
            "hedgeDenied": int(row.get("hedgeDenied") or 0),
            "quotaEvicts": int(row.get("quotaEvicts") or 0),
        }
    return {
        "queries": int(hq.get("count") or 0),
        "p50Ms": round(hq["p50"] * 1e3, 3) if hq.get("p50") else None,
        "p99Ms": round(hq["p99"] * 1e3, 3) if hq.get("p99") else None,
        "hbmResidentBytes": int(bud.get("residentBytes") or 0),
        "hbmCompressedBytes": int(bud.get("compressedBytes") or 0),
        "hbmDenseBytes": int(bud.get("denseBytes") or 0),
        "hbmPinnedBytes": int(bud.get("pinnedBytes") or 0),
        "evictions": int(bud.get("evictions") or 0),
        "compiles": int(comp.get("compiles") or 0),
        "retraces": int(comp.get("retraces") or 0),
        "launches": int(lau.get("launches") or 0),
        "paddingWasteRatio": float(lau.get("paddingWasteRatio") or 0.0),
        "hedges": int(counts.get("cluster.hedges") or 0),
        "hedgeWins": int(counts.get("cluster.hedge_wins") or 0),
        "retryWaves": int(counts.get("cluster.retry_waves") or 0),
        "partialResults": int(counts.get("cluster.partial_results") or 0),
        "routingFallbacks": int(counts.get("routing.fallback") or 0),
        "wholeQueryFallbacks": int(wq.get("fallbacks") or 0),
        "quarantinedFragments": len(quarantined),
        "ingestBacklogBytes": int(ing.get("pendingBytes") or 0),
        "admissionInUse": int(adm.get("inUse") or 0),
        "admissionWaiting": int(adm.get("waiting") or 0),
        "overlayEpoch": int((cl.get("overlay") or {}).get("epoch") or 0),
        "tenants": tenants,
        # SLO engine (docs/observability.md "SLOs & alerting"): the
        # per-node alert state the fleet panel and the coordinator's
        # pilosa_tpu_cluster_active_alerts family render — stale peers
        # keep their last-known alert set, stamped stale like the rest
        "activeAlerts": len((v.get("alerts") or {}).get("active") or {}),
        "alertsFired": int((v.get("alerts") or {}).get("firedTotal")
                           or 0),
        "alertIds": sorted((v.get("alerts") or {}).get("active") or {}),
    }


class FleetRollup:
    """Owned by the Server when a cluster is configured; /debug/cluster
    and the /metrics cluster family both go through ``refresh()`` +
    ``snapshot()``."""

    TTL_S = 2.0            # scrape storms collapse to one refresh
    TIMELINE_MAX = 1024    # merged fleet events retained
    EVENTS_PER_PULL = 256  # per-peer events folded per refresh

    def __init__(self, cluster, local_vars_fn=None, stats=None):
        self.cluster = cluster
        self.local_vars_fn = local_vars_fn
        self.stats = stats
        self._lock = make_lock("rollup")
        # one refresh at a time; a caller losing the race serves the
        # cache the winner is about to replace (monotonic staleness,
        # never a thundering herd of peer fetches)
        self._refresh_serial = make_lock("rollup-refresh")
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, len(cluster.nodes)),
            thread_name_prefix="ptpu-rollup")
        # nid -> {"summary", "wall", "mono", "stale", "error"}
        self._peers: dict[str, dict] = {}
        # nid -> (mono, queries) for qps deltas between refreshes
        self._prev_q: dict[str, tuple[float, int]] = {}
        self._qps: dict[str, float] = {}
        # per-PEER fetch cursor (highest seq pulled from that peer's
        # /debug/events) and per-EMITTER merge cursor (dedup by the
        # event's OWN node stamp — in-process multi-server tests share
        # one process-wide journal, so the same event can arrive via
        # several peers' pulls)
        self._cursor: dict[str, int] = {}
        self._merge_cursor: dict[str, int] = {}
        self._timeline: deque = deque(maxlen=self.TIMELINE_MAX)
        self._last_refresh: float | None = None
        self.refreshes = 0
        self.fetch_errors = 0

    def close(self):
        self._pool.shutdown(wait=False)

    # -- refresh -----------------------------------------------------------

    def _fetch_peer(self, node, timeout):
        """(vars, events, error) for one READY peer — runs on the
        rollup pool; breaker discipline applies inside the client."""
        client = self.cluster.client
        since = self._cursor.get(node.id, 0)
        try:
            v = client.debug_vars(node.host, timeout=timeout)
            ev = client.debug_events(node.host, since=since,
                                     timeout=timeout,
                                     limit=self.EVENTS_PER_PULL)
            return v, ev, None
        except Exception as e:
            return None, None, e

    def refresh(self, force: bool = False):
        """Refresh the per-peer cache if the TTL elapsed.  Never blocks
        on a dead node: non-READY peers are skipped outright, READY
        fetches run concurrently under the probe timeout, and failures
        leave the previous summary in place (stamped stale)."""
        now = time.monotonic()
        with self._lock:
            fresh = (not force and self._last_refresh is not None
                     and now - self._last_refresh < self.TTL_S)
        if fresh:
            return
        if not self._refresh_serial.acquire(blocking=False):
            return  # a concurrent refresh is filling the cache
        try:
            self._refresh_locked()
        finally:
            self._refresh_serial.release()

    def _refresh_locked(self):
        cluster = self.cluster
        timeout = cluster._probe_timeout()
        peers = cluster.peers()
        ready = [n for n in peers if n.state == "READY"
                 and not cluster.client.breaker_open(n.host)]
        # READY peers skipped because their breaker is open still age:
        # the docs' staleness contract is "a failed or SKIPPED pull
        # serves the last summary stamped stale" — without this, a
        # breaker-open peer's aging summary reads as fresh
        skipped = [n for n in peers
                   if n.state == "READY" and n not in ready]
        try:
            futs = [(n, self._pool.submit(self._fetch_peer, n, timeout))
                    for n in ready]
        except RuntimeError:  # pool shut down: close() raced a scrape
            futs = []
        local_summary = None
        if self.local_vars_fn is not None:
            try:
                local_summary = summarize_vars(self.local_vars_fn())
            except Exception:
                # the local surface failing must not fail the fleet view
                self.fetch_errors += 1
        local_events = EVENTS.since(self._cursor.get(cluster.node_id, 0),
                                    limit=self.EVENTS_PER_PULL)
        results = [(n, *f.result()) for n, f in futs]
        now = time.monotonic()
        with self._lock:
            self.refreshes += 1
            self._last_refresh = now
            for n in skipped:
                entry = self._peers.get(n.id)
                if entry is not None:
                    entry["stale"] = True
                    entry.setdefault("error", None)
                    entry["error"] = entry["error"] or "breaker open"
                else:
                    self._peers[n.id] = {
                        "summary": None, "wall": None, "mono": None,
                        "stale": True, "error": "breaker open"}
            if local_summary is not None:
                self._note_node(cluster.node_id, local_summary, now)
            for e in local_events:
                self._fold_event(cluster.node_id, e)
            for n, v, ev, err in results:
                if err is not None:
                    self.fetch_errors += 1
                    entry = self._peers.get(n.id)
                    if entry is not None:
                        entry["stale"] = True
                        entry["error"] = f"{type(err).__name__}: {err}"
                    else:
                        self._peers[n.id] = {
                            "summary": None, "wall": None, "mono": None,
                            "stale": True,
                            "error": f"{type(err).__name__}: {err}"}
                    continue
                self._note_node(n.id, summarize_vars(v), now)
                for e in (ev or {}).get("events", []):
                    self._fold_event(n.id, e)

    def _note_node(self, nid: str, summary: dict, now: float):
        prev = self._prev_q.get(nid)
        q = summary["queries"]
        if prev is not None and now > prev[0] and q >= prev[1]:
            self._qps[nid] = (q - prev[1]) / (now - prev[0])
        self._prev_q[nid] = (now, q)
        self._peers[nid] = {"summary": summary,
                            "wall": _wall_stamp(), "mono": now,
                            "stale": False, "error": None}

    def _fold_event(self, nid: str, e: dict):
        """Merge one node's journal entry into the fleet timeline.  The
        fetch cursor (per pulled-from peer) bounds the next pull; the
        merge cursor (per the event's own emitter stamp) makes re-pulls
        and shared-journal duplicates idempotent."""
        seq = int(e.get("seq", 0))
        if seq > self._cursor.get(nid, 0):
            self._cursor[nid] = seq
        emitter = e.get("node") or nid
        if seq <= self._merge_cursor.get(emitter, 0):
            return
        self._merge_cursor[emitter] = seq
        merged = dict(e)
        merged["node"] = emitter
        self._timeline.append(merged)

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> dict:
        """GET /debug/cluster: per-node summaries (staleness-stamped),
        the merged fleet timeline (wall-ordered, newest last), and the
        coordinator-local overlay/balancer state."""
        cluster = self.cluster
        now = time.monotonic()
        with self._lock:
            nodes = {}
            for n in cluster.nodes:
                entry = self._peers.get(n.id)
                info = {"state": n.state, "host": n.host,
                        "qps": round(self._qps.get(n.id, 0.0), 2)}
                if entry is None or entry["summary"] is None:
                    info["stale"] = True
                    if entry is not None and entry.get("error"):
                        info["error"] = entry["error"]
                else:
                    info.update(entry["summary"])
                    stale = entry["stale"] or n.state != "READY"
                    info["stale"] = stale
                    if entry["mono"] is not None:
                        info["staleS"] = round(now - entry["mono"], 3)
                    if entry.get("error"):
                        info["error"] = entry["error"]
                nodes[n.id] = info
            # fleet-wide per-tenant rollup: qps/shed/hedge/quota summed
            # across nodes, p99 as the worst node's (a tenant's tail is
            # wherever it is slowest)
            fleet_tenants: dict[str, dict] = {}
            for info in nodes.values():
                for name, row in (info.get("tenants") or {}).items():
                    agg = fleet_tenants.setdefault(name, {
                        "qps": 0.0, "p99Ms": None, "shed": 0,
                        "hedgeDenied": 0, "quotaEvicts": 0})
                    agg["qps"] = round(agg["qps"] + row["qps"], 3)
                    agg["shed"] += row["shed"]
                    agg["hedgeDenied"] += row["hedgeDenied"]
                    agg["quotaEvicts"] += row["quotaEvicts"]
                    if row.get("p99Ms") is not None:
                        agg["p99Ms"] = max(agg["p99Ms"] or 0.0,
                                           row["p99Ms"])
            timeline = sorted(self._timeline,
                              key=lambda e: (e.get("wall", 0),
                                             e.get("seq", 0)))
            out = {
                "wall": _wall_stamp(),
                "ttlS": self.TTL_S,
                "refreshes": self.refreshes,
                "fetchErrors": self.fetch_errors,
                "coordinator": cluster.nodes[0].id,
                "overlayEpoch": cluster.overlay_epoch,
                "epoch": cluster.epoch,
                "nodes": nodes,
                "tenants": fleet_tenants,
                "timeline": timeline,
            }
        out["hotShards"] = cluster.balancer.snapshot()
        return out

    def prometheus_text(self) -> str:
        """``pilosa_tpu_cluster_*`` gauges with node labels — own
        exposition appended to /metrics (the launch-ledger pattern;
        cataloged in docs/observability.md "Cluster plane")."""
        gauges = (
            ("qps", "qps"), ("p99Ms", "p99_ms"),
            ("hbmResidentBytes", "hbm_resident_bytes"),
            ("hbmCompressedBytes", "hbm_compressed_bytes"),
            ("evictions", "evictions"),
            ("retraces", "retraces"),
            ("hedges", "hedges"), ("hedgeWins", "hedge_wins"),
            ("retryWaves", "retry_waves"),
            ("partialResults", "partial_results"),
            ("quarantinedFragments", "quarantined_fragments"),
            ("ingestBacklogBytes", "ingest_backlog_bytes"),
            ("overlayEpoch", "overlay_epoch"),
            ("activeAlerts", "active_alerts"),
            ("alertsFired", "alerts_fired_total"),
        )
        snap = self.snapshot()
        lines = []
        for field, metric in gauges:
            name = f"pilosa_tpu_cluster_{metric}"
            lines.append(f"# TYPE {name} gauge")
            for nid, info in sorted(snap["nodes"].items()):
                val = info.get("qps") if field == "qps" \
                    else info.get(field)
                if val is None:
                    continue
                lines.append(f'{name}{{node="{nid}"}} {val}')
        lines.append("# TYPE pilosa_tpu_cluster_stale gauge")
        for nid, info in sorted(snap["nodes"].items()):
            lines.append(f'pilosa_tpu_cluster_stale{{node="{nid}"}} '
                         f'{1 if info.get("stale") else 0}')
        return "\n".join(lines) + "\n"
