"""Load-aware replica read routing (docs/cluster.md "Read routing &
rebalancing").

The static half of the reference design groups read fan-out shards by
their jump-hash PRIMARY (cluster.go:883, executor.go:2435 shardsByNode):
replicas only absorb failures, so one hot index saturates one node while
its replicas idle.  This module owns the read-side placement decision
instead: every coordinator fan-out asks the :class:`ReadRouter` which
replica answers each shard, scored from what the cluster already
measures —

* per-peer EWMA RTT and coordinator-observed in-flight RPC depth (fed by
  ``Cluster._fan_out_multi``'s existing per-peer timing);
* peer admission-pool depth, piggybacked on ``/internal/query`` responses
  and ``/status`` probes (the same piggyback pattern as the gen
  summaries);
* per-shard residency tiers (HBM-resident / host-staged / disk-only)
  advertised by each node from its ``DeviceBudget``/staging state
  (``Cluster.residency_summary``), so the router prefers the replica
  that can answer without an upload — the shard schedule's residency
  order extended across the cluster.

Policies (``read-routing`` knob):

* ``primary``      — the pre-PR behavior, byte-for-byte: self if an
  owner, else the first READY owner in placement order.
* ``round-robin``  — rotate among READY owners per shard.
* ``loaded``       — scored selection as above; with no load data yet it
  falls back to the primary choice, counted ``routing.fallback``.

Replica choice never changes answers: writes fan to every replica
synchronously and anti-entropy converges the rest, so any READY owner
holds the same bits (the differential suite in tests/test_routing.py
proves byte-identity).  Writes and anti-entropy do NOT route through
this module — only the read fan-out does.

Breaker pre-skip: a peer whose circuit breaker is open is excluded
BEFORE dispatch (counted ``routing.breaker_skip`` and marked DOWN, the
same convergence the fail-fast path produced) instead of burning a
``CircuitOpenError`` round through the fan-out's retry machinery first.
When every candidate's breaker is open the skip is waived so the
fail-fast error still surfaces loudly.

Port copy of the JAX package's ``parallel/routing.py``.  The residency
tiers come from ``Cluster.residency_summary``, which reads the port's
stacked executor and device budget: the HBM-resident tier is the card's
memory (a fragment with a device mirror, or a shard in a cached stack).
"""

from __future__ import annotations

import time

from ..utils import explain as qexplain
from ..utils.locks import make_lock

# EWMA smoothing for per-peer RTT: new = (1-a)*old + a*sample.
EWMA_ALPHA = 0.25
# Residency summaries older than this (seconds since last piggyback) are
# ignored — a stale map must not keep routing to a node that already
# evicted the shard.
RESIDENCY_TTL_S = 30.0
# Score discount for a fully HBM-resident shard (host-staged counts
# half): 1.0 would make residency override load entirely; 0.6 keeps an
# overloaded-but-resident replica beatable by an idle cold one.
RESIDENCY_DISCOUNT = 0.6
# Local execution skips the wire: its score gets this factor so that at
# equal load the coordinator still prefers itself (the primary policy's
# self-preference, kept as a bias instead of an absolute).
LOCAL_BIAS = 0.8

POLICIES = ("primary", "round-robin", "loaded")

# Hedged reads (docs/robustness.md "Tail-tolerant fan-out"): with
# hedge-delay-ms = 0 (auto) the hedge fires at this multiple of the
# CLUSTER's cheapest known EWMA RTT — "how long should this RPC take if
# a healthy replica served it", the Dean & Barroso quantile idea on the
# signal the router already keeps.  Deliberately NOT the dispatched
# peer's own EWMA: a persistently straggling peer would inflate its own
# hedge delay until hedging never fires, exactly when it matters most.
HEDGE_EWMA_MULT = 4.0
# Floor so micro-RTT local clusters don't turn every read into two.
HEDGE_MIN_DELAY_S = 0.01


def tier_fraction(tiers: dict | None, shard: int) -> float:
    """Residency fraction for scoring — the ONE tier mapping (1.0
    HBM-resident, 0.5 host-staged, 0.0 disk-only/unknown), shared by the
    peer (piggybacked-summary) and local paths so a tier-weight change
    can never skew local-vs-remote scoring."""
    if not tiers:
        return 0.0
    if shard in tiers.get("hbm", ()):
        return 1.0
    if shard in tiers.get("host", ()):
        return 0.5
    return 0.0


class PeerLoad:
    """Routing state for one node, folded from RPC timings and
    piggybacked load/residency summaries."""

    __slots__ = ("ewma_rtt_s", "last_rtt_s", "inflight", "reported_inflight",
                 "reported_queued", "residency", "residency_ts",
                 "dispatches", "errors", "hedges", "hedge_wins")

    def __init__(self):
        self.ewma_rtt_s: float | None = None
        self.last_rtt_s: float | None = None
        self.inflight = 0           # coordinator-observed in-flight RPCs
        self.reported_inflight = 0  # peer's own admission in-use (piggyback)
        self.reported_queued = 0    # peer's admission wait-queue depth
        # index -> {"hbm": set[int], "host": set[int]} shard tiers
        self.residency: dict[str, dict[str, set[int]]] = {}
        self.residency_ts: float | None = None  # monotonic, for staleness
        self.dispatches = 0
        self.errors = 0
        # hedged reads: speculative duplicates dispatched TO this peer,
        # and how many of those answered first (per-peer hedge state for
        # /debug/vars cluster.routing)
        self.hedges = 0
        self.hedge_wins = 0

    def note_rtt(self, rtt_s: float):
        self.last_rtt_s = rtt_s
        if self.ewma_rtt_s is None:
            self.ewma_rtt_s = rtt_s
        else:
            self.ewma_rtt_s = ((1 - EWMA_ALPHA) * self.ewma_rtt_s
                               + EWMA_ALPHA * rtt_s)

    def shard_tier(self, index: str, shard: int,
                   now: float) -> float:
        """tier_fraction over the piggybacked summary, 0.0 when the
        summary is stale (older than RESIDENCY_TTL_S)."""
        if self.residency_ts is None or \
                now - self.residency_ts > RESIDENCY_TTL_S:
            return 0.0
        return tier_fraction(self.residency.get(index), shard)


class ReadRouter:
    """Per-shard replica selection for the read fan-out.

    Owned by :class:`parallel.cluster.Cluster`; the cluster
    feeds it dispatch/completion events and piggybacked peer summaries,
    and calls :meth:`group_shards` wherever it used to group by primary.
    All mutable state lives behind one leaf lock (never held across I/O
    or another lock)."""

    def __init__(self, cluster, policy: str = "loaded",
                 residency_routing: bool = True, stats=None):
        if policy not in POLICIES:
            raise ValueError(
                f"read-routing must be one of {POLICIES}, got {policy!r}")
        self.cluster = cluster
        self.policy = policy
        self.residency_routing = residency_routing
        self.stats = stats
        self._peers: dict[str, PeerLoad] = {}
        self._lock = make_lock("routing")
        self._rr = 0  # round-robin rotation cursor
        self.fallbacks = 0
        self.breaker_skips = 0

    # -- state feeds -------------------------------------------------------

    def _peer(self, nid: str) -> PeerLoad:
        p = self._peers.get(nid)
        if p is None:
            with self._lock:
                p = self._peers.setdefault(nid, PeerLoad())
        return p

    def note_dispatch(self, nid: str, n_shards: int):
        """A shard group was handed to ``nid`` (RPC submitted or local
        execution started)."""
        p = self._peer(nid)
        with self._lock:
            p.inflight += 1
            p.dispatches += 1

    def note_done(self, nid: str, rtt_s: float | None, ok: bool = True):
        p = self._peer(nid)
        with self._lock:
            if p.inflight > 0:
                p.inflight -= 1
            if ok and rtt_s is not None:
                p.note_rtt(rtt_s)
            elif not ok:
                p.errors += 1

    def note_hedge(self, nid: str):
        """A speculative duplicate was dispatched to ``nid``."""
        p = self._peer(nid)
        with self._lock:
            p.hedges += 1

    def note_hedge_win(self, nid: str):
        """``nid``'s hedged answer arrived before the original's."""
        p = self._peer(nid)
        with self._lock:
            p.hedge_wins += 1

    def note_query_load(self, nid: str, load: dict | None):
        """Admission depth piggybacked on an /internal/query response."""
        if not load:
            return
        p = self._peer(nid)
        with self._lock:
            p.reported_inflight = int(load.get("inFlight", 0))
            p.reported_queued = int(load.get("queued", 0))

    def note_status(self, nid: str, status: dict):
        """Fold a /status probe's piggybacked load + residency summary."""
        p = self._peer(nid)
        load = status.get("load") or {}
        res = status.get("residency")
        with self._lock:
            if load:
                p.reported_inflight = int(load.get("inFlight", 0))
                p.reported_queued = int(load.get("queued", 0))
            if res is not None:
                p.residency = {
                    iname: {"hbm": set(t.get("hbm", ())),
                            "host": set(t.get("host", ()))}
                    for iname, t in res.items()}
                p.residency_ts = time.monotonic()

    # -- selection ---------------------------------------------------------

    def group_shards(self, index: str, shards, exclude=frozenset()
                     ) -> dict[str, list[int]]:
        """shard -> chosen replica, grouped (the read fan-out's
        replacement for grouping by jump-hash primary).  Raises
        ClusterError with the legacy message when a shard has no
        available node, so the fan-out's re-admit machinery is
        unchanged."""
        from .cluster import ClusterError

        cluster = self.cluster
        now = time.monotonic()
        local_res = None
        policy = self.policy
        rr = 0
        if policy == "round-robin":
            with self._lock:
                rr = self._rr
                self._rr += 1
        groups: dict[str, list[int]] = {}
        scores: dict[str, float | None] = {}
        fell_back = False
        # EXPLAIN (utils/explain.py): per-shard choice + score breakdown
        # collected only when a record is active, and only WHILE the
        # routing section has capacity — past the cap a minimal note
        # keeps the truncation counted without building the per-
        # candidate breakdowns the record would drop anyway
        explain_active = qexplain.active()
        for s in shards:
            want_explain = explain_active and qexplain.wants("routing")
            # legacy candidate order exactly (the cluster's
            # _ready_owner_order — overlay-aware — plus the exclude
            # filter): ready owners, or ALL owners when none are ready.
            # An all-excluded ready set raises so the fan-out's re-admit
            # machinery decides, rather than this layer quietly
            # targeting a DOWN node.
            candidates = [o for o in cluster._ready_owner_order(index, s)
                          if o not in exclude]
            if not candidates:
                raise ClusterError(
                    f"no available node for shard {s} of {index!r}")
            pre_skip = list(candidates)
            candidates = self._skip_open_breakers(candidates)
            primary_pick = cluster.node_id \
                if cluster.node_id in candidates else candidates[0]
            breakdown = None
            if policy == "primary" or len(candidates) == 1:
                pick = primary_pick
            elif policy == "round-robin":
                pick = candidates[(rr + int(s)) % len(candidates)]
            else:  # loaded
                if local_res is None and self.residency_routing:
                    local_res = cluster.residency_summary()
                breakdown = {} if want_explain else None
                pick, fb = self._pick_loaded(index, int(s), candidates,
                                             primary_pick, scores, now,
                                             local_res,
                                             breakdown=breakdown)
                fell_back = fell_back or fb
            if want_explain:
                entry = {"shard": int(s), "chosen": pick,
                         "policy": policy,
                         "candidates": list(candidates)}
                skipped = [nid for nid in pre_skip
                           if nid not in candidates]
                if skipped:
                    entry["breakerSkipped"] = skipped
                if breakdown:
                    entry["scores"] = breakdown
                qexplain.note("routing", entry)
            elif explain_active:
                # over the section cap: dropped by note(), but counted
                # in the record's `truncated` so overflow stays visible
                qexplain.note("routing", {"shard": int(s)})
            groups.setdefault(pick, []).append(s)
        if fell_back:
            with self._lock:
                self.fallbacks += 1
            if self.stats is not None:
                self.stats.count("routing.fallback")
        return groups

    def _skip_open_breakers(self, candidates: list[str]) -> list[str]:
        """Drop breaker-open peers BEFORE dispatch (counted
        ``routing.breaker_skip``; the skipped node is marked DOWN, the
        same convergence the fail-fast path produced).  Waived when every
        candidate is open — the fan-out must still surface the failure
        rather than invent 'no available node'."""
        cluster = self.cluster
        client = cluster.client
        open_ = [nid for nid in candidates
                 if nid != cluster.node_id
                 and client.breaker_open(cluster.by_id[nid].host)]
        if not open_ or len(open_) == len(candidates):
            return candidates
        for nid in open_:
            with self._lock:
                self.breaker_skips += 1
            if self.stats is not None:
                self.stats.count("routing.breaker_skip")
            cluster._mark_down(nid)
        return [nid for nid in candidates if nid not in open_]

    def _pick_loaded(self, index: str, shard: int, candidates: list[str],
                     primary_pick: str, score_cache: dict, now: float,
                     local_res, breakdown: dict | None = None
                     ) -> tuple[str, bool]:
        """Scored choice: EWMA RTT x queue pressure, discounted for
        residency.  A candidate with no RTT history yet scores with the
        cheapest KNOWN candidate's EWMA (optimistic default — a
        never-tried replica must stay explorable, or the first-served
        node would keep every shard forever); when EVERY candidate is
        unknown the router falls back to the primary choice (returned
        flag counts ``routing.fallback``).  ``breakdown``: optional dict
        filled with each candidate's score components (the EXPLAIN
        routing section)."""
        infos = []
        for nid in candidates:
            if nid not in score_cache:
                score_cache[nid] = self._load_factors(nid)
            infos.append((nid,) + score_cache[nid])
        known = [ewma for _, ewma, _ in infos if ewma is not None]
        if not known:
            if breakdown is not None:
                breakdown["fallback"] = "no-rtt-history"
            return primary_pick, True
        default_ewma = min(known)
        local_id = self.cluster.node_id
        best = None
        best_score = None
        for nid, ewma, pressure in infos:
            score = (ewma if ewma is not None else default_ewma) * pressure
            if nid == local_id:
                score *= LOCAL_BIAS
            frac = 0.0
            if self.residency_routing:
                if nid == local_id:
                    frac = self._local_tier(local_res, index, shard)
                else:
                    with self._lock:
                        frac = self._peers[nid].shard_tier(index, shard,
                                                           now) \
                            if nid in self._peers else 0.0
                score = score * (1.0 - RESIDENCY_DISCOUNT * frac)
            if breakdown is not None:
                breakdown[nid] = {
                    "ewmaMs": round((ewma if ewma is not None
                                     else default_ewma) * 1e3, 3),
                    "ewmaDefaulted": ewma is None,
                    "pressure": round(pressure, 3),
                    "residencyTier": frac,
                    "localBias": nid == local_id,
                    "score": round(score * 1e3, 4)}
            if best_score is None or score < best_score:
                best, best_score = nid, score
        return best, False

    def _load_factors(self, nid: str) -> tuple[float | None, float]:
        """(ewma_rtt or None, queue-pressure factor) — the residency-
        independent parts of the score, cached per group_shards call."""
        with self._lock:
            p = self._peers.get(nid)
            if p is None:
                return None, 1.0
            return p.ewma_rtt_s, (1.0 + p.inflight
                                  + p.reported_inflight
                                  + 2.0 * p.reported_queued)

    @staticmethod
    def _local_tier(local_res, index: str, shard: int) -> float:
        # the local summary is TTL-fresh by construction
        # (Cluster.residency_summary caches for 2s) — no staleness gate
        return tier_fraction((local_res or {}).get(index), shard)

    # -- hedged reads (docs/robustness.md "Tail-tolerant fan-out") ---------

    def hedge_delay(self, fixed_s: float = 0.0) -> float | None:
        """Seconds an in-flight read RPC may run before a speculative
        duplicate fires.  ``fixed_s > 0`` (hedge-delay-ms) wins; auto
        mode derives HEDGE_EWMA_MULT x the cheapest KNOWN peer EWMA (see
        the constant's comment for why not the dispatched peer's own).
        None = no history yet — a cold cluster must not hedge blind."""
        if fixed_s > 0:
            return fixed_s
        with self._lock:
            known = [p.ewma_rtt_s for p in self._peers.values()
                     if p.ewma_rtt_s is not None]
        if not known:
            return None
        return max(HEDGE_MIN_DELAY_S, HEDGE_EWMA_MULT * min(known))

    def hedge_candidate(self, index: str, shards,
                        exclude=frozenset()) -> str | None:
        """Best replica to receive a speculative duplicate of a whole
        dispatched shard group: must be READY, own EVERY shard of the
        group (a partial hedge could double-count shards against the
        original's aggregate answer), not excluded, not breaker-open,
        and not the local node (local execution is not a network
        straggler).  Cheapest load score wins; None = nobody qualifies
        and the group goes unhedged."""
        cluster = self.cluster
        cand: set[str] | None = None
        for s in shards:
            owners = {o for o in cluster._ready_owner_order(index, s)
                      if cluster.by_id[o].state == "READY"}
            cand = owners if cand is None else cand & owners
            if not cand:
                return None
        cand -= set(exclude)
        cand.discard(cluster.node_id)
        cand = {nid for nid in cand
                if not cluster.client.breaker_open(
                    cluster.by_id[nid].host)}
        if not cand:
            return None
        # same optimistic default as _pick_loaded: a no-history
        # candidate scores with the cheapest KNOWN candidate's EWMA so
        # it stays explorable WITHOUT unconditionally beating a known-
        # fast idle replica (and its queue pressure still counts —
        # hedges fire exactly when latency matters most).  All-unknown
        # degenerates to pure pressure ordering.
        infos = [(nid,) + self._load_factors(nid) for nid in sorted(cand)]
        known = [ewma for _, ewma, _ in infos if ewma is not None]
        default_ewma = min(known) if known else 1.0
        best = None
        best_score = None
        for nid, ewma, pressure in infos:
            score = (ewma if ewma is not None else default_ewma) * pressure
            if best_score is None or score < best_score:
                best, best_score = nid, score
        return best

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        """Per-peer routing state for /debug/vars ``cluster.routing``."""
        now = time.monotonic()
        with self._lock:
            peers = {}
            for nid, p in self._peers.items():
                peers[nid] = {
                    "ewmaRttMs": round(p.ewma_rtt_s * 1e3, 3)
                    if p.ewma_rtt_s is not None else None,
                    "lastRttMs": round(p.last_rtt_s * 1e3, 3)
                    if p.last_rtt_s is not None else None,
                    "inFlight": p.inflight,
                    "reportedInFlight": p.reported_inflight,
                    "reportedQueued": p.reported_queued,
                    "residencyAgeS": round(now - p.residency_ts, 3)
                    if p.residency_ts is not None else None,
                    "residentShards": {
                        iname: {"hbm": len(t.get("hbm", ())),
                                "host": len(t.get("host", ()))}
                        for iname, t in p.residency.items()},
                    "dispatches": p.dispatches,
                    "errors": p.errors,
                    "hedges": p.hedges,
                    "hedgeWins": p.hedge_wins,
                }
            out = {
                "policy": self.policy,
                "residencyRouting": self.residency_routing,
                "fallbacks": self.fallbacks,
                "breakerSkips": self.breaker_skips,
                "peers": peers,
            }
        # breaker state rides along so one surface answers "why was this
        # peer skipped"; wire mode likewise answers "which internal
        # query wire would the next fan-out to this peer speak"
        # (docs/cluster.md "Internal query wire")
        for nid, info in out["peers"].items():
            node = self.cluster.by_id.get(nid)
            if node is not None:
                info["breakerOpen"] = \
                    self.cluster.client.breaker_open(node.host)
                info["state"] = node.state
                info["wire"] = \
                    self.cluster.client.peer_wire_mode(node.host)
        return out

    def peer_states(self) -> list[tuple[str, dict]]:
        """(nid, flat-gauge dict) pairs for the /metrics exporter."""
        snap = self.snapshot()
        out = []
        for nid, p in snap["peers"].items():
            out.append((nid, {
                "ewma_rtt_ms": p["ewmaRttMs"] or 0.0,
                "inflight": p["inFlight"] + p["reportedInFlight"],
                "queued": p["reportedQueued"],
                "residency_age_s": p["residencyAgeS"]
                if p["residencyAgeS"] is not None else -1.0,
                "breaker_open": 1 if p.get("breakerOpen") else 0,
                "dispatches": p["dispatches"],
            }))
        return out
