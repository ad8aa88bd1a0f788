"""Cluster: static-membership distribution layer (reference cluster.go,
broadcast.go, http/client.go).

The reference runs a gossip-managed elastic cluster (memberlist, resize
jobs).  Per the TPU-native design (SURVEY §5.8) membership here is a
*static node list from config* — the mesh analog of a fixed TPU topology —
with a thin control plane over HTTP:

* shard -> node placement: FNV-1a partition + jump hash ring with ReplicaN
  successors (parallel/placement.py; cluster.go:871-959);
* query fan-out: shards grouped by owner, local shards on the local
  executor, remote groups POSTed as pinned single-call requests
  (executor.go:2455 mapReduce, :2414 remoteExec), with replica retry when
  a node is down (executor.go:2482-2514);
* write fan-out: Set/Clear go to every replica of the target shard
  (executor.go:2137-2166); Store/ClearRow to every node with its owned
  shard list; attr writes broadcast (executor.go:2207-2412);
* import regroup/forward: bits grouped by shard, each batch sent to every
  owner (api.go:920-1028);
* DDL broadcast: create/delete index/field POSTed to every peer
  (broadcast.go:30 SendSync, server.go:569 receiveMessage);
* failure detection: periodic /status probes; a node that fails a probe is
  marked DOWN and the cluster goes DEGRADED (cluster.go:1724
  confirmNodeDown; NORMAL<->DEGRADED cluster.go:571-583).

Reductions between nodes happen host-side on small results (counts,
ValCounts, pairs, compressed row segments); the heavy per-shard bitmap
work stays on each node's device (its stacked executor, kernels and
whole-query graphs).  A node answers ``/internal/query`` through the
same executor as a public request, so a node's share of an over-budget
request streams through the shard schedule (parallel/stacked.py).

Port copy of the read plane of the JAX package's ``parallel/cluster.py``:
errors, the result wire and the breaker; ``InternalClient`` (pooled
connections, breakers, the wire-mode downgrade, ``query_calls``,
``send_message``, the import forwards, ``available_shards``);
``RemoteTranslateStore`` and ``Node``; the ``Cluster`` with its health
probes, states, shard ownership, residency and load summaries, peer
data-version registry, shard discovery, ``execute`` and the batched
multi-call fan-out (retry waves, all-or-nothing flights, hedged reads),
the two-phase TopN, the column / all-node / attr writes, the reductions,
the DDL broadcast, message handling and the import regroup and forward;
and the internal routes ``/internal/query/{index}``,
``/internal/cluster/message``, ``/internal/import*``,
``/internal/translate*`` and ``/internal/index/{index}/shards``.

Not ported yet (the cluster plane's second part):

* the placement overlay and the hot-shard balancer (``HotShardBalancer``;
  ``balancer = true`` is refused here and by the server); only
  ``ShardLoadTracker`` is ported, for the ``loaded`` routing policy;
* anti-entropy and repair (``sync_holder``, ``repair_quarantined``, the
  block merge): ``anti_entropy_interval > 0`` is accepted and runs
  nothing;
* topology persistence (``.topology``) and resize (``/cluster/resize/*``,
  the resize-fetch / resize-complete / placement-overlay messages, the
  holder cleaner): membership is the static host list and ``epoch``
  stays 0;
* the fragment block, data, fetch and list routes that anti-entropy and
  resize use;
* TLS between nodes (``configure_tls``): the server refuses TLS
  certificates;
* ``rollup.py`` and ``utils/netchaos.py``.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any

import numpy as np

from ..core import SHARD_WIDTH, SHARD_WORDS
from ..executor.executor import TOPN_EXTRAS
from ..executor.results import (
    GroupCount, FieldRow, Pair, RowIdentifiers, RowResult, ValCount,
    merge_pairs, sort_pairs,
)
from ..pql import Call, Query, parse
from ..pql.wire import call_from_wire, call_to_wire
from ..utils import degraded
from ..utils import events
from ..utils import explain as qexplain
from ..utils import profile as qprof
from ..utils import tenant as qtenant
from ..utils.deadline import DEADLINE_HEADER, current as current_ctx
from ..utils.faults import FAULTS
from ..utils.locks import make_lock, make_rlock
from ..utils.tracing import GLOBAL_TRACER, PROBE_HEADER, TRACE_HEADER
from . import qwire
from .placement import Placement

NODE_READY = "READY"
NODE_DOWN = "DOWN"
# Alive but replaying its warmup corpus (docs/warmup.md): probes fold a
# peer's advertised warming phase here, so every `state == NODE_READY`
# gate (read routing, AE, broadcast, repair donors) automatically keeps
# traffic off a cold process.  Warming is NOT counted by _update_state —
# a warming peer never flips the cluster DEGRADED.
NODE_WARMING = "WARMING"


STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"


class ClusterError(RuntimeError):
    pass


class IngestBackpressure(ClusterError):
    """A forwarded ingest batch was refused 503 by the shard owner (its
    group-commit backlog is over high-water).  The coordinator maps this
    back to its own 503 + Retry-After so the producer backs off the
    whole (idempotent) stream — backpressure propagates end-to-end
    instead of queueing invisibly (docs/ingest.md)."""


class CircuitOpenError(ClusterError):
    """Fail-fast rejection: the target peer's circuit breaker is open
    (N consecutive transport failures).  A ClusterError subclass so
    callers that only know ClusterError still handle it, but DISTINCT so
    the fan-out treats it like a transport failure (exclude + replica
    retry + mark DOWN) rather than an application error from a live
    peer."""


# -- result wire codec ------------------------------------------------------
# (the reference's protobuf QueryResponse, encoding/proto/proto.go; JSON +
# compressed raw segments here)

def _seg_to_wire(seg) -> str:
    words = np.asarray(seg, dtype=np.uint32)
    return base64.b64encode(zlib.compress(words.tobytes(), 1)).decode()


def _seg_from_wire(s: str) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(s))
    words = np.frombuffer(raw, dtype=np.uint32)
    if words.size != SHARD_WORDS:
        raise ClusterError(f"bad segment size {words.size}")
    return words


def result_to_wire(r) -> dict:
    if isinstance(r, RowResult):
        out = {"t": "row", "segments": {
            str(s): _seg_to_wire(seg) for s, seg in r.segments.items()}}
        if r.attrs:
            out["attrs"] = r.attrs
        return out
    if isinstance(r, ValCount):
        return {"t": "valcount", "val": r.val, "count": r.count}
    if isinstance(r, RowIdentifiers):
        return {"t": "rowids", "rows": r.rows, "keys": r.keys}
    if isinstance(r, list) and (not r or isinstance(r[0], Pair)):
        return {"t": "pairs",
                "pairs": [[p.id, p.count, p.key] for p in r]}
    if isinstance(r, list) and r and isinstance(r[0], GroupCount):
        return {"t": "groups", "groups": [
            {"group": [[fr.field, fr.row_id, fr.row_key] for fr in g.group],
             "count": g.count} for g in r]}
    return {"t": "raw", "v": r}


def result_from_wire(d: dict):
    t = d.get("t")
    if t == "row":
        return RowResult({int(s): _seg_from_wire(w)
                          for s, w in d["segments"].items()},
                         attrs=d.get("attrs"))
    if t == "valcount":
        return ValCount(d["val"], d["count"])
    if t == "rowids":
        return RowIdentifiers(rows=d["rows"], keys=d.get("keys") or [])
    if t == "pairs":
        return [Pair(i, c, k) for i, c, k in d["pairs"]]
    if t == "groups":
        return [GroupCount([FieldRow(f, ri, rk) for f, ri, rk in g["group"]],
                           g["count"]) for g in d["groups"]]
    return d.get("v")


# -- internal RPC client ----------------------------------------------------

class _Breaker:
    """Per-peer circuit breaker state (closed -> open -> half-open)."""

    __slots__ = ("fails", "state", "opened_at", "trial_inflight",
                 "opened_total", "fast_fails", "half_open_emitted")

    def __init__(self):
        self.fails = 0
        self.state = "closed"
        self.opened_at = 0.0
        self.trial_inflight = False
        self.opened_total = 0
        self.fast_fails = 0
        # breaker.half_open journals once per OPEN episode, not once per
        # admitted trial: probes are always admitted as trials, so a
        # dead peer would otherwise emit every health interval and flood
        # the bounded event ring for the whole outage
        self.half_open_emitted = False


class InternalClient:
    """Node-to-node HTTP(S) RPC (reference http/client.go:69
    InternalClient).  Hosts may carry an ``https://`` prefix; mutual-TLS
    client credentials come from ``configure_tls``.

    Every request runs through a PER-PEER circuit breaker:
    ``breaker_threshold`` consecutive TRANSPORT failures (timeouts,
    refused/reset connections — HTTP error statuses are a live peer and
    do not count) open the circuit, and further requests fail fast with
    ``CircuitOpenError`` instead of each burning a full socket timeout
    against a dead node.  After ``breaker_cooldown`` seconds ONE trial
    request is let through (half-open); success closes the circuit,
    failure re-arms the cooldown.  ``Cluster.probe_peers`` runs on the
    health cadence and its /status probes double as the half-open
    trials, so breaker state and NODE_DOWN converge on the same answer
    (cluster.go:1724 confirmNodeDown).  ``breaker_threshold <= 0``
    disables breaking entirely."""

    # Pooled connections idle longer than this are proactively replaced:
    # servers close idle keep-alives after 120 s (handler timeout), and a
    # connection the server already FIN'd often fails only at RESPONSE
    # time — where POSTs must not retry (the peer may have executed the
    # request).  Never reusing a socket old enough to be at risk keeps
    # the narrow retry policy sound.
    POOL_IDLE_MAX = 60.0

    def __init__(self, timeout: float = 30.0, breaker_threshold: int = 5,
                 breaker_cooldown: float = 5.0, stats=None,
                 wire_mode: str = qwire.WIRE_BIN1):
        self.timeout = timeout
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.stats = stats
        # Internal query wire preference (docs/cluster.md "Internal query
        # wire"): "bin1" speaks the PTPUQRY1 framed binary transport to
        # peers that advertise it (or whose capability is still unknown —
        # optimistic, pre-first-probe) and downgrades per-peer to the
        # verbatim JSON path on refusal; "json" restores JSON exactly.
        self.wire_mode = wire_mode
        # host -> capability learned from its /status `wire` list; absent
        # means unknown (optimistically binary).  Plain dicts mutated
        # with single GIL-atomic ops, like _host_gen below.
        self._peer_wire: dict[str, str] = {}
        # host -> True after a 415/400 refusal of a binary POST; cleared
        # when the peer's /status re-advertises bin1 (rolling-upgrade
        # recovery — a restarted peer that now speaks binary gets it
        # back within one health interval)
        self._wire_down: dict[str, bool] = {}
        # per-thread keep-alive connections (the server speaks HTTP/1.1):
        # a cluster fan-out must not pay a TCP handshake per sub-query
        self._local = threading.local()
        # every pooled connection also registers here so close() can
        # release sockets owned by other threads' pools
        self._all_conns: set = set()
        self._conns_lock = make_lock("client-conns")
        self._breakers: dict[str, _Breaker] = {}
        self._breaker_lock = make_lock("breaker")
        # per-host pool generation (see note_recovered); conns stamp the
        # generation at creation and are lazily discarded on mismatch
        self._host_gen: dict[str, int] = {}

    def note_recovered(self, host: str):
        """A peer that was DOWN is reachable again: every pooled
        connection to it predates the outage and points at a dead (or
        restarted) process.  Reusing one is worse than useless — the
        send can land in the severed socket's kernel buffer and fail
        only at getresponse(), exactly where non-idempotent POSTs must
        NOT be retried, turning the peer's recovery into spurious write
        failures.  Bumping the host's pool generation makes every
        thread lazily discard its stale conn and dial fresh (GIL-atomic
        int bump; racing requests see either generation, both safe)."""
        self._host_gen[host] = self._host_gen.get(host, 0) + 1

    # -- internal query wire negotiation -----------------------------------

    def note_peer_wire(self, host: str, caps):
        """Fold a peer's advertised wire capability (its /status ``wire``
        list) into the negotiation state.  A peer advertising bin1 clears
        any earlier downgrade — the rolling-upgrade recovery path (a peer
        that persists in refusing binary despite advertising it just
        re-downgrades within its next RPC).  No ``wire`` key (an older
        peer) reads as JSON-only."""
        bin1 = isinstance(caps, (list, tuple)) and qwire.WIRE_BIN1 in caps
        self._peer_wire[host] = qwire.WIRE_BIN1 if bin1 else qwire.WIRE_JSON
        if bin1:
            self._wire_down.pop(host, None)

    def peer_wire_mode(self, host: str) -> str:
        """The wire this client would speak to ``host`` right now:
        binary when the client prefers it, the peer has not refused it,
        and the peer's advertised capability is bin1 — or still UNKNOWN
        (optimistic pre-probe: a refusal costs one downgraded retry,
        while pessimism would leave the first health interval's whole
        fan-out on JSON)."""
        if self.wire_mode != qwire.WIRE_BIN1 or self._wire_down.get(host):
            return qwire.WIRE_JSON
        if self._peer_wire.get(host, qwire.WIRE_BIN1) != qwire.WIRE_BIN1:
            return qwire.WIRE_JSON
        return qwire.WIRE_BIN1

    def _wire_downgrade(self, host: str, status: int):
        """A peer refused a binary POST (415 from a new peer pinned to
        internal-wire=json; 400 from an old peer that read PTPUQRY1 as a
        broken JSON body): latch this host to the JSON wire and journal
        the downgrade.  A genuine application-level 400 on the binary
        path trips this too — the cost is one spurious JSON retry that
        fails with the same error, and the next /status probe clears the
        latch if the peer advertises bin1."""
        self._wire_down[host] = True
        if self.stats is not None:
            self.stats.count("cluster.wire_fallback")
        events.emit("wire.downgrade", host=host, status=status)

    # -- circuit breaker ---------------------------------------------------

    def _breaker(self, host: str) -> _Breaker:
        b = self._breakers.get(host)
        if b is None:
            # insert under the lock: breaker_snapshot iterates the dict
            # under it, and an unlocked insert resizing the dict mid-
            # iteration would 500 the /debug/vars endpoint
            with self._breaker_lock:
                b = self._breakers.setdefault(host, _Breaker())
        return b

    def _breaker_allow(self, host: str, trial: bool = False):
        """Admit the request or raise CircuitOpenError.  When the circuit
        is open and the cooldown has elapsed, admit exactly ONE trial
        (half-open) — concurrent callers keep failing fast until the
        trial resolves.  ``trial=True`` (health probes) is ALWAYS
        admitted as the half-open trial regardless of cooldown: probes
        are the designated recovery path, and a dead node's own failed
        probes re-arm the cooldown every cycle — gating the probe on it
        would let the breaker latch a RECOVERED node DOWN forever."""
        if self.breaker_threshold <= 0:
            return
        b = self._breaker(host)
        admitted = emit_half_open = False
        with self._breaker_lock:
            if b.state == "closed":
                return
            now = time.monotonic()
            if trial or (now - b.opened_at >= self.breaker_cooldown
                         and not b.trial_inflight):
                b.trial_inflight = True  # half-open trial
                admitted = True
                emit_half_open = not b.half_open_emitted
                b.half_open_emitted = True
            else:
                b.fast_fails += 1
                if self.stats is not None:
                    self.stats.count("breaker.fail_fast")
        if admitted:
            if emit_half_open:
                # journaled OUTSIDE the breaker lock (events is a leaf
                # lock; transitions are rare, never the fail-fast hot
                # path) and once per open EPISODE — probes are always
                # admitted as trials, so per-trial emission would flood
                # the ring for a whole outage
                events.emit("breaker.half_open", host=host)
            return
        raise CircuitOpenError(
            f"circuit open for {host} ({b.fails} consecutive failures); "
            f"failing fast")

    def _breaker_success(self, host: str):
        if self.breaker_threshold <= 0:
            return
        b = self._breaker(host)
        # lock-free fast path for the overwhelmingly common steady state:
        # every fan-out RPC success would otherwise serialize on the one
        # process-wide breaker lock just to rewrite values it already
        # has.  Racing a concurrent failure here is benign — both fields
        # only move toward this state on success, and a missed reset
        # costs at most one extra failure toward the threshold.
        if b.state == "closed" and b.fails == 0:
            return
        with self._breaker_lock:
            was_open = b.state == "open"
            b.fails = 0
            b.trial_inflight = False
            b.half_open_emitted = False
            b.state = "closed"
        if was_open:
            events.emit("breaker.close", host=host)

    def _breaker_failure(self, host: str):
        if self.breaker_threshold <= 0:
            return
        b = self._breaker(host)
        opened = False
        with self._breaker_lock:
            b.trial_inflight = False
            b.fails += 1
            now = time.monotonic()
            if b.state == "open":
                b.opened_at = now  # failed trial re-arms the cooldown
            elif b.fails >= self.breaker_threshold:
                b.state = "open"
                b.opened_at = now
                b.opened_total += 1
                b.half_open_emitted = False
                opened = True
                if self.stats is not None:
                    self.stats.count("breaker.opened")
        if opened:
            events.emit("breaker.open", host=host, fails=b.fails)

    def breaker_snapshot(self) -> dict:
        """Per-peer breaker state for /debug/vars."""
        with self._breaker_lock:
            return {host: {"state": b.state, "consecutiveFails": b.fails,
                           "openedTotal": b.opened_total,
                           "fastFails": b.fast_fails}
                    for host, b in self._breakers.items()}

    def breaker_open(self, host: str) -> bool:
        """Is ``host``'s circuit currently open?  The read router skips
        such peers BEFORE dispatch (routing.breaker_skip) instead of
        letting each fan-out burn a CircuitOpenError round through the
        retry machinery.  Lock-free read: a racing transition costs one
        query a suboptimal (but correct) replica choice."""
        if self.breaker_threshold <= 0:
            return False
        b = self._breakers.get(host)
        return b is not None and b.state == "open"

    def close(self):
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, set()
        for c in conns:
            try:
                c.close()
            # lint: allow(swallowed-exception) — client shutdown: the
            # socket may already be dead, and there is nothing to do
            except Exception:
                pass

    def _new_conn(self, host: str, timeout: float):
        https = host.startswith("https://")
        hostport = host.removeprefix("https://").removeprefix("http://")
        h, _, p = hostport.rpartition(":")
        if https:
            import ssl
            # the default VERIFIED context: client certificates
            # (configure_tls) are not ported
            return http.client.HTTPSConnection(
                h or "localhost", int(p), timeout=timeout,
                context=ssl.create_default_context())
        return http.client.HTTPConnection(h or "localhost", int(p),
                                          timeout=timeout)

    def _request(self, host: str, method: str, path: str,
                 body: bytes | None = None,
                 ctype: str = "application/json",
                 timeout: float | None = None,
                 headers_extra: dict | None = None,
                 breaker_trial: bool = False) -> tuple[int, bytes]:
        """Breaker-gated request: open circuit -> CircuitOpenError fast;
        transport failures (OSError/HTTPException, including injected
        faults) count toward opening it, HTTP error statuses do not.
        ``breaker_trial``: health probes — always admitted (see
        _breaker_allow)."""
        self._breaker_allow(host, trial=breaker_trial)
        try:
            out = self._request_inner(host, method, path, body, ctype,
                                      timeout, headers_extra)
        except (OSError, http.client.HTTPException):
            self._breaker_failure(host)
            raise
        self._breaker_success(host)
        return out

    def _request_inner(self, host: str, method: str, path: str,
                       body: bytes | None = None,
                       ctype: str = "application/json",
                       timeout: float | None = None,
                       headers_extra: dict | None = None
                       ) -> tuple[int, bytes]:
        FAULTS.hit("client.request", key=f"{host} {path}")
        timeout = timeout or self.timeout
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        headers = {"Content-Type": ctype,
                   "Content-Length": str(len(body or b""))}
        # Trace propagation (http/client.go:1043 inject): every outbound
        # hop carries trace_id:parent_span_id when a trace is active, so
        # remote spans parent correctly under the calling span.  Probes
        # run on the probe pool with no active trace — no header.
        trace_hdr = GLOBAL_TRACER.inject()
        if trace_hdr is not None:
            headers[TRACE_HEADER] = trace_hdr
        # Tenant propagation (docs/robustness.md "Tenant isolation"):
        # only an EXPLICIT token forwards — a derived identity is
        # re-derived from the index on the peer, same answer, no header.
        tenant_hdr = qtenant.header_value()
        if tenant_hdr is not None:
            headers[qtenant.TENANT_HEADER] = tenant_hdr
        if headers_extra:
            headers.update(headers_extra)

        def drop(conn):
            conn.close()
            conns.pop(host, None)
            with self._conns_lock:
                self._all_conns.discard(conn)

        # One reconnect retry, ONLY when a POOLED connection fails during
        # SEND — the stale-keep-alive case, where the request provably
        # never reached the peer.  A fresh-connection failure must not
        # retry (it would double every timeout against a dead node), and
        # a response-phase failure must not retry (the peer may have
        # executed a non-idempotent request already).
        host_gen = self._host_gen.get(host, 0)
        for attempt in (0, 1):
            conn = conns.get(host)
            # a conn pooled before the peer's last recovery points at the
            # DEAD pre-restart process (see note_recovered): discard it
            # rather than risk a response-phase failure on a POST
            if conn is not None and \
                    getattr(conn, "_ptpu_gen", 0) != host_gen:
                drop(conn)
                conn = None
            # a pooled entry whose socket is gone (client.close() raced a
            # fan-out thread) is NOT a live keep-alive: replace it so it
            # re-registers and gets fresh-connection (no-retry) semantics
            if conn is not None and conn.sock is not None and \
                    time.monotonic() - getattr(
                        conn, "_ptpu_last_use",
                        time.monotonic()) > self.POOL_IDLE_MAX:
                drop(conn)
                conn = None
            reused = conn is not None and conn.sock is not None
            if conn is None or conn.sock is None:
                if conn is not None:
                    drop(conn)
                conn = conns[host] = self._new_conn(host, timeout)
                conn._ptpu_gen = host_gen
                with self._conns_lock:
                    self._all_conns.add(conn)
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
            except (OSError, http.client.HTTPException):
                drop(conn)
                if reused and attempt == 0:
                    continue
                raise
            try:
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException):
                drop(conn)
                # a FIN'd keep-alive often fails only here (the send
                # lands in the kernel buffer); GETs are idempotent, so
                # they get the reconnect retry — POSTs may have executed
                # on the peer and must not resend
                if reused and attempt == 0 and method == "GET":
                    continue
                raise
            if resp.will_close:
                drop(conn)
            else:
                conn._ptpu_last_use = time.monotonic()
            return resp.status, data

    def _json(self, host, method, path, obj=None, timeout=None,
              headers=None, breaker_trial=False):
        body = None if obj is None else json.dumps(obj).encode()
        status, data = self._request(host, method, path, body,
                                     timeout=timeout, headers_extra=headers,
                                     breaker_trial=breaker_trial)
        if status >= 400:
            raise self._http_error(host, path, status, data)
        return json.loads(data) if data else {}

    @staticmethod
    def _http_error(host, path, status, data) -> ClusterError:
        try:
            msg = json.loads(data).get("error", data.decode())
        # lint: allow(swallowed-exception) — error-body decode
        # fallback; the ClusterError below carries the raw body
        except Exception:
            msg = data.decode(errors="replace")
        return ClusterError(f"{host} {path}: {status} {msg}")

    # -- RPCs --------------------------------------------------------------

    def status(self, host: str, timeout: float | None = None,
               probe: bool = False) -> dict:
        """``probe=True``: this is a health probe — it rides through an
        open breaker as the half-open trial (the designated recovery
        path; see _breaker_allow), and is TAGGED on the wire so the
        peer excludes it from latency histograms and the slow-query log
        (background traffic must not pollute p99)."""
        headers = {PROBE_HEADER: "1"} if probe else None
        return self._json(host, "GET", "/status", timeout=timeout,
                          headers=headers, breaker_trial=probe)

    def debug_vars(self, host: str, timeout: float | None = None) -> dict:
        """One peer's /debug/vars snapshot — the fleet rollup's pull
        (parallel/rollup.py).  Probe-tagged on the wire (background
        traffic) and subject to the breaker like any other RPC, but NOT
        a breaker trial: the rollup must never be the thing that closes
        a breaker the probes haven't vetted."""
        return self._json(host, "GET", "/debug/vars", timeout=timeout,
                          headers={PROBE_HEADER: "1"})

    def debug_events(self, host: str, since: int = 0,
                     timeout: float | None = None,
                     limit: int | None = None) -> dict:
        """One peer's event journal after ``since`` (the /debug/events
        cursor contract, utils/events.py)."""
        path = f"/debug/events?since={int(since)}"
        if limit is not None:
            path += f"&limit={int(limit)}"
        return self._json(host, "GET", path, timeout=timeout,
                          headers={PROBE_HEADER: "1"})

    @staticmethod
    def _deadline_extras(deadline_s, base_timeout):
        """(headers, timeout) for a deadline-carrying hop: the header
        ships the coordinator's REMAINING budget so the remote inherits
        it, and the socket timeout is clamped just above that budget so
        a hung peer costs ~the budget, not the full default timeout (a
        small grace lets the remote's own 504 arrive instead of being
        cut off mid-response)."""
        if deadline_s is None:
            return None, None
        deadline_s = max(deadline_s, 0.001)
        headers = {DEADLINE_HEADER: f"{deadline_s:.6f}"}
        timeout = min(base_timeout,
                      deadline_s + max(0.05, 0.5 * deadline_s))
        return headers, timeout

    def query_call(self, host: str, index: str, call: Call,
                   shards: list[int] | None) -> Any:
        """(http/client.go:268 QueryNode — pinned single-call query)"""
        out = self._json(host, "POST", f"/internal/query/{index}", {
            "call": call_to_wire(call),
            "shards": shards,
        })
        return result_from_wire(out["result"])

    def query_calls(self, host: str, index: str, calls: list[Call],
                    shards: list[int] | None,
                    deadline_s: float | None = None
                    ) -> tuple[list[Any], float]:
        """Pinned MULTI-call query: the peer executes the whole batch as
        one device wave (its executor's grouped/prepared path) instead of
        one dispatch per call.  Returns (results, peer_exec_seconds) so
        the coordinator can attribute wire vs device time.

        ``deadline_s``: the coordinator's remaining deadline budget —
        shipped in the X-Pilosa-Tpu-Deadline header (the remote inherits
        it) and used to clamp the socket timeout.

        The third return element is the peer's fragment-generation
        summary for the index (piggybacked so the coordinator can key
        cross-node result-cache entries; cache/results.py).  4th: the
        peer's quarantined-fragment count — the coordinator folds it
        into the response's degraded flag (utils/degraded.py).  5th: the
        peer's admission-queue depth, piggybacked for the read router's
        load scores (parallel/routing.py — the same piggyback pattern
        as gens).

        Rides the PTPUQRY1 binary wire when negotiation allows
        (peer_wire_mode) and falls back to the verbatim JSON envelope on
        refusal — same results, same piggybacks, byte-identical merged
        answers either way (docs/cluster.md "Internal query wire")."""
        headers, timeout = self._deadline_extras(deadline_s, self.timeout)
        path = f"/internal/query/{index}"
        calls_wire = [call_to_wire(c) for c in calls]
        if self.peer_wire_mode(host) == qwire.WIRE_BIN1:
            body = qwire.encode_request(calls_wire, shards)
            status, data = self._request(
                host, "POST", path, body, ctype=qwire.CONTENT_TYPE,
                timeout=timeout, headers_extra=headers)
            if status < 400:
                try:
                    results, trailer, nframes = qwire.decode_response(data)
                except qwire.FrameError as e:
                    raise ClusterError(
                        f"{host} {path}: bad binary response: {e}")
                if self.stats is not None:
                    # request frames (calls + shards) count too: the
                    # bench's bytes/query split wants BOTH directions
                    self.stats.count("cluster.wire_bytes_tx", len(body))
                    self.stats.count("cluster.wire_bytes_rx", len(data))
                    self.stats.count("cluster.wire_frames", nframes + 2)
                GLOBAL_TRACER.adopt(trailer.get("spans"))
                return (results, float(trailer.get("execS", 0.0)),
                        trailer.get("gens"),
                        int(trailer.get("quarantined", 0)),
                        trailer.get("load"))
            if status not in (415, 400):
                raise self._http_error(host, path, status, data)
            # 415: a bin1-capable peer pinned to internal-wire=json.
            # 400: an old peer that read the frames as broken JSON.
            # Either way: latch this host to JSON and retry the SAME
            # request on the JSON wire — safe because every call through
            # here is an idempotent internal read (writes fan out on
            # their own paths and never ride query_calls).
            self._wire_downgrade(host, status)
        body = json.dumps({"calls": calls_wire,
                           "shards": shards}).encode()
        status, data = self._request(host, "POST", path, body,
                                     timeout=timeout, headers_extra=headers)
        if status >= 400:
            raise self._http_error(host, path, status, data)
        if self.stats is not None:
            # counted on the JSON leg too, so bin1-vs-json bytes/query
            # compare from the same counters (docs/observability.md)
            self.stats.count("cluster.wire_bytes_tx", len(body))
            self.stats.count("cluster.wire_bytes_rx", len(data))
        out = json.loads(data) if data else {}
        # remote span summaries piggyback on the response (like the gen
        # summaries): fold them into the local ring so /debug/traces on
        # the coordinator renders the whole cluster tree
        GLOBAL_TRACER.adopt(out.get("spans"))
        return ([result_from_wire(r) for r in out["results"]],
                float(out.get("execS", 0.0)), out.get("gens"),
                int(out.get("quarantined", 0)), out.get("load"))

    def send_message(self, host: str, msg: dict,
                     timeout: float | None = None):
        """(broadcast.go SendTo -> POST /internal/cluster/message).
        ``timeout`` overrides the default 30 s for long-running messages
        (a resize-fetch copies whole fragment sets inside one POST)."""
        self._json(host, "POST", "/internal/cluster/message", msg,
                   timeout=timeout)

    def import_local(self, host: str, index: str, field: str, payload: dict):
        """Forward a pre-grouped import batch to a shard owner
        (http/client.go Import; applied locally, never re-forwarded)."""
        self._json(host, "POST",
                   f"/internal/import/{index}/{field}", payload)

    def ingest_frames(self, host: str, index: str, field: str,
                      body: bytes, timeout: float | None = None) -> dict:
        """Forward routed ingest frames to a shard owner as a binary
        stream (docs/ingest.md): ``body`` is magic + frames, exactly the
        public wire format.  Returns after the OWNER's group commit
        acked; a 503 surfaces as IngestBackpressure so the coordinator
        can push back to its own producer."""
        status, data = self._request(
            host, "POST", f"/internal/ingest/{index}/{field}", body,
            ctype="application/octet-stream", timeout=timeout)
        if status == 503:
            raise IngestBackpressure(
                f"{host}: ingest backlog over high-water")
        if status >= 400:
            try:
                msg = json.loads(data).get("error", data.decode())
            # lint: allow(swallowed-exception) — error-body decode
            # fallback; the ClusterError below carries the raw body
            except Exception:
                msg = data.decode(errors="replace")
            raise ClusterError(f"{host} ingest: {status} {msg}")
        return json.loads(data) if data else {}

    def import_roaring_binary(self, host: str, index: str, field: str,
                              shard: int, view: str, data: bytes,
                              clear: bool):
        """Forward one view's roaring blob raw — the node-to-node half
        of killing the 4/3 base64-in-JSON blowup on roaring imports."""
        status, resp = self._request(
            host, "POST",
            f"/internal/import-roaring/{index}/{field}/{shard}"
            f"?view={view}&clear={'true' if clear else 'false'}",
            data, ctype="application/octet-stream")
        if status >= 400:
            try:
                msg = json.loads(resp).get("error", resp.decode())
            # lint: allow(swallowed-exception) — error-body decode
            # fallback; the ClusterError below carries the raw body
            except Exception:
                msg = resp.decode(errors="replace")
            raise ClusterError(
                f"{host} import-roaring: {status} {msg}")

    def available_shards(self, host: str, index: str,
                         timeout: float | None = None) -> list[int]:
        out = self._json(host, "GET", f"/internal/index/{index}/shards",
                         timeout=timeout)
        return out.get("shards", [])


class RemoteTranslateStore:
    """Key translation routed to the coordinator with a read-through cache
    — the static-cluster replacement for the reference's primary-writes +
    streamed-replication scheme (translate.go:35, holder.go:812)."""

    def __init__(self, client: InternalClient, host: str, index: str,
                 field: str | None):
        self.client = client
        self.host = host
        self.index = index
        self.field = field
        self._k2i: dict[str, int] = {}
        self._i2k: dict[int, str] = {}
        self._sync_after = 0  # contiguous replication watermark
        self._lock = make_rlock("remote-translate")

    def _path(self) -> str:
        p = f"/internal/translate/{self.index}"
        return p + (f"/{self.field}" if self.field else "")

    # entries per catch-up page (bounds coordinator lock hold + response
    # size; the loop below drains all pages)
    SYNC_PAGE = 50_000

    def sync_entries(self) -> int:
        """Streaming replication catch-up (holder.go:812
        holderTranslateStoreReplicator): page entries after our CONTIGUOUS
        replication watermark from the coordinator, so reads on this
        replica stop paying a coordinator round trip for keys written
        since the last pass.  The watermark is separate from the lookup
        cache — a read-through hit on a high id must not make replication
        skip everything below it.  Driven from the anti-entropy loop."""
        total = 0
        while True:
            out = self.client._json(
                self.host, "POST", self._path(),
                {"after": self._sync_after, "limit": self.SYNC_PAGE})
            entries = out.get("entries", [])
            if entries:
                with self._lock:
                    for kid, key in entries:
                        self._k2i[key] = kid
                        self._i2k[kid] = key
                self._sync_after = max(self._sync_after,
                                       max(kid for kid, _ in entries))
                total += len(entries)
            if len(entries) < self.SYNC_PAGE:
                return total

    def translate_key(self, key: str) -> int:
        with self._lock:
            kid = self._k2i.get(key)
        if kid is not None:
            return kid
        out = self.client._json(self.host, "POST", self._path(),
                                {"keys": [key]})
        kid = out["ids"][0]
        with self._lock:
            self._k2i[key] = kid
            self._i2k[kid] = key
        return kid

    def translate_keys(self, keys) -> list[int]:
        """One POST for the whole uncached set (the endpoint accepts lists;
        a per-key loop would cost N coordinator round trips for N keyed
        columns)."""
        keys = list(keys)
        with self._lock:
            missing = sorted({k for k in keys if k not in self._k2i})
        if missing:
            out = self.client._json(self.host, "POST", self._path(),
                                    {"keys": missing})
            with self._lock:
                for k, kid in zip(missing, out["ids"]):
                    self._k2i[k] = kid
                    self._i2k[kid] = k
        with self._lock:
            return [self._k2i[k] for k in keys]

    def translate_id(self, kid: int) -> str | None:
        with self._lock:
            key = self._i2k.get(kid)
        if key is not None:
            return key
        out = self.client._json(self.host, "POST", self._path(),
                                {"ids": [kid]})
        key = out["keys"][0]
        if key is not None:
            with self._lock:
                self._k2i[key] = kid
                self._i2k[kid] = key
        return key

    def translate_ids(self, ids) -> list[str | None]:
        """One POST for the whole uncached set (see translate_keys)."""
        ids = list(ids)
        with self._lock:
            missing = sorted({i for i in ids if i not in self._i2k})
        if missing:
            out = self.client._json(self.host, "POST", self._path(),
                                    {"ids": missing})
            with self._lock:
                for kid, key in zip(missing, out["keys"]):
                    if key is not None:
                        self._k2i[key] = kid
                        self._i2k[kid] = key
        with self._lock:
            return [self._i2k.get(i) for i in ids]

    def find_key(self, key: str) -> int | None:
        with self._lock:
            return self._k2i.get(key)

    def close(self):
        pass


# -- node & cluster ---------------------------------------------------------

class Node:
    def __init__(self, node_id: str, host: str):
        self.id = node_id
        self.host = host
        self.state = NODE_READY
        # consecutive probe failures (health-down-threshold gate)
        self.probe_fails = 0

    def to_dict(self, coordinator_id: str) -> dict:
        return {"id": self.id, "uri": self.host,
                "isCoordinator": self.id == coordinator_id,
                "state": self.state}


class Cluster:
    """Static-membership cluster (the module server.py:103 wires in).

    ``hosts`` is the ordered node list from config; node ids are
    "node0".."nodeN-1" by position and ``node_id`` selects which entry is
    this process (matching the reference's URI-identity with explicit
    names).  Node 0 is the coordinator (primary for DDL broadcast).
    """

    def __init__(self, node_id: str, hosts: list[str], replica_n: int = 1,
                 holder=None, hasher=None, health_interval: float = 5.0,
                 health_down_threshold: int = 2,
                 breaker_threshold: int = 5, stats=None,
                 read_routing: str = "loaded",
                 residency_routing: bool = True,
                 balancer: bool = False,
                 balancer_interval: float = 30.0,
                 hedge_reads: bool = True,
                 hedge_delay_ms: float = 0.0,
                 internal_wire: str = qwire.WIRE_BIN1,
                 tenant_hedge_budget: float = 0.0):
        if balancer:
            raise ClusterError(
                "balancer = true: the hot-shard balancer is not ported "
                "(only its ShardLoadTracker)")
        if internal_wire not in (qwire.WIRE_JSON, qwire.WIRE_BIN1):
            raise ClusterError(
                f"internal_wire must be one of "
                f"{[qwire.WIRE_JSON, qwire.WIRE_BIN1]}, "
                f"got {internal_wire!r}")
        # Internal query wire (docs/cluster.md "Internal query wire"):
        # governs BOTH directions — what this node's client speaks to
        # peers (subject to per-peer negotiation) and what its handler
        # accepts (415 on binary POSTs when pinned to "json").
        self.internal_wire = internal_wire
        self.nodes = [Node(f"node{i}", h) for i, h in enumerate(hosts)]
        self.by_id = {n.id: n for n in self.nodes}
        if node_id not in self.by_id:
            raise ClusterError(
                f"node_id {node_id!r} not in cluster hosts (expected one of "
                f"{sorted(self.by_id)})")
        self.node_id = node_id
        self.holder = holder
        self.replica_n = replica_n
        self.placement = Placement([n.id for n in self.nodes],
                                   replica_n=replica_n, hasher=hasher)
        # soft probe failures (timeouts, resets) needed before NODE_DOWN;
        # a refused connection (nothing listening) flips immediately —
        # see _note_probe_failure
        self.health_down_threshold = max(1, health_down_threshold)
        # breaker half-open trials ride the health cadence, so breaker
        # state and probe-driven NODE_DOWN converge on the same answer
        self.client = InternalClient(
            breaker_threshold=breaker_threshold,
            breaker_cooldown=max(health_interval, 1.0)
            if health_interval > 0 else 5.0,
            stats=stats, wire_mode=internal_wire)
        self.api = None
        self.state = STATE_STARTING
        self.health_interval = health_interval
        self._closing = threading.Event()
        self._health_thread = None
        # membership epoch: static membership here (resize is not
        # ported), so it stays 0; reported on /status as the JAX
        # package reports it
        self.epoch = 0
        # per-index remote shard availability, folded from every
        # successful peer poll (the in-memory analog of field.go:263's
        # gossiped available-shard bitmaps).  A DOWN peer's shards stay
        # visible here, so a query over them FAILS loudly instead of
        # silently shrinking to the live nodes' data.  Related but not
        # redundant: Field.remote_available_shards records per-FIELD
        # knowledge learned at import fan-out time; this map records
        # per-INDEX knowledge learned from peer polls (the poll API is
        # index-level).  Both feed the query scope; shards leave this
        # map via forget_index_shards and resize data-loss pruning.
        # Mutated from concurrent query threads (peer polls) AND cluster
        # messages; _shards_lock (a leaf lock, never held across I/O or
        # another lock) guards every access instead of leaning on GIL
        # atomicity of single set ops.
        self._remote_shards: dict[str, set[int]] = {}
        self._shards_lock = make_lock("cluster-shards")
        # Per-(index, peer) data-version registry for the coordinator-
        # scope result cache (cache/results.py): bumped whenever this
        # node forwards a write/import/repair to the peer, and whenever a
        # piggybacked gen summary (on /internal/query responses and
        # /status probes) differs from the last one seen.  Cache keys
        # embed the versions, so a bump structurally invalidates every
        # entry that depended on that peer's data.  _gen_lock is a leaf
        # lock (never held across I/O).
        self._peer_data_ver: dict[tuple[str, str], int] = {}
        self._peer_gen_seen: dict[tuple[str, str], tuple] = {}
        self._gen_lock = make_lock("peer-gen")
        self.stats = stats
        from .balancer import ShardLoadTracker
        from .routing import ReadRouter
        self.router = ReadRouter(self, policy=read_routing,
                                 residency_routing=residency_routing,
                                 stats=stats)
        # per-shard load counters the loaded routing policy and
        # /debug/vars read
        self.load_tracker = ShardLoadTracker(
            window_s=max(balancer_interval, 1.0))
        # Tail-tolerant fan-out (docs/robustness.md "Tail-tolerant
        # fan-out"): hedged reads fire a speculative duplicate of a
        # straggling shard-group RPC at the next-best replica; safe
        # because every call through _fan_out_multi is an idempotent
        # internal read (writes fan out through their own replica-
        # synchronous paths and are NEVER hedged).  hedge_delay_ms = 0
        # derives the delay from the router's EWMA RTT.
        self.hedge_reads = bool(hedge_reads)
        self.hedge_delay_ms = float(hedge_delay_ms)
        # Per-tenant hedge token budget (docs/robustness.md "Tenant
        # isolation"): each speculative duplicate draws a token from the
        # requesting tenant's bucket; an exhausted bucket reads unhedged
        # (counted, never an error).  0 (the bare-Cluster default)
        # disables the budget entirely.
        self.hedge_budget = qtenant.HedgeBudget(rate=tenant_hedge_budget)
        # structured-event sink (cluster.fanout_failed); the Server
        # wires its logger in, standalone clusters stay silent
        self.logger = None
        # residency-summary TTL cache (walking every fragment per /status
        # probe would make probes O(fragments); 2s staleness is far under
        # RESIDENCY_TTL_S)
        self._residency_cache: tuple[float, dict] | None = None
        # set by Server.register_internal_routes: the admission pools the
        # load piggyback reports (None standalone — zero-load answers)
        self._server = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.nodes)))
        # DEDICATED probe pool: health probes must never queue behind
        # query fan-out RPCs blocked on a hung peer's socket timeout in
        # the shared pool — that would delay NODE_DOWN detection (and
        # the breaker's half-open trial) by exactly the latency the
        # probes exist to bound
        self._probe_pool = ThreadPoolExecutor(
            max_workers=max(2, len(self.nodes)),
            thread_name_prefix="ptpu-probe")
        # One probe pass at a time: the health thread and an explicit
        # probe_peers() call must not interleave, or a pass that gathered
        # its results while a peer was still dead could apply a stale
        # DOWN after a newer pass already marked the recovered peer READY
        self._probe_serial = make_lock("probe-serial")

    # -- lifecycle ---------------------------------------------------------

    def open(self, api):
        self.api = api
        self.state = STATE_NORMAL
        if self.health_interval > 0:
            self._health_thread = threading.Thread(
                target=self._monitor_health, daemon=True)
            self._health_thread.start()

    def close(self):
        self._closing.set()
        self._pool.shutdown(wait=False)
        self._probe_pool.shutdown(wait=False)
        self.client.close()

    @property
    def local(self) -> Node:
        return self.by_id[self.node_id]

    def peers(self) -> list[Node]:
        return [n for n in self.nodes if n.id != self.node_id]

    @property
    def is_coordinator(self) -> bool:
        return self.node_id == self.nodes[0].id

    def remote_translate_factory(self, path, index, field):
        """translate_factory for non-coordinator nodes: route key
        translation to the coordinator (see RemoteTranslateStore)."""
        return RemoteTranslateStore(self.client, self.nodes[0].host,
                                    index, field)

    # -- failure detection (cluster.go:1724 confirmNodeDown) ---------------

    def _monitor_health(self):
        while not self._closing.wait(self.health_interval):
            self.probe_peers()

    # floor for the per-probe timeout so tiny health intervals (tests)
    # don't flap probes on scheduler jitter
    PROBE_TIMEOUT_MIN = 2.0

    def _probe_timeout(self) -> float:
        if self.health_interval <= 0:
            return self.client.timeout
        return min(self.client.timeout,
                   max(2 * self.health_interval, self.PROBE_TIMEOUT_MIN))

    def _probe_status(self, node, timeout):
        try:
            return self.client.status(node.host, timeout=timeout,
                                      probe=True), None
        except Exception as e:
            return None, e

    def _note_probe_failure(self, n: Node, err: Exception):
        """One probe miss is not death (cluster.go:1724 confirmNodeDown):
        soft failures (timeouts, resets) need health_down_threshold
        CONSECUTIVE misses before NODE_DOWN so a transient hiccup can't
        flip the cluster DEGRADED.  A DEFINITE failure — connection
        refused, i.e. nothing is listening — flips immediately, and an
        already-DOWN node stays down.  (Probes bypass an open breaker as
        its half-open trial, so CircuitOpenError never reaches here.)"""
        n.probe_fails += 1
        if isinstance(err, ConnectionRefusedError) \
                or n.state == NODE_DOWN \
                or n.probe_fails >= self.health_down_threshold:
            if n.state != NODE_DOWN:
                events.emit("node.down", peer=n.id,
                            reason=f"{type(err).__name__}: {err}"[:160])
            n.state = NODE_DOWN

    def probe_peers(self):
        # One pass at a time (see _probe_serial): a pass's gathered
        # results must be applied before the next pass starts, or a
        # stale failure could overwrite a newer recovery.
        with self._probe_serial:
            self._probe_peers_serialized()

    def _probe_peers_serialized(self):
        # Probe CONCURRENTLY over the dedicated pool: one hung peer must
        # cost one probe timeout of wall clock, not serialize the whole
        # loop behind its full socket timeout.  State is
        # applied sequentially below once every future resolves.
        peers = self.peers()
        timeout = self._probe_timeout()
        try:
            futs = [(n, self._probe_pool.submit(self._probe_status, n,
                                                timeout))
                    for n in peers]
        except RuntimeError:
            return  # pool shut down: close() raced the health thread
        for n, fut in futs:
            st, err = fut.result()
            was_down = n.state == NODE_DOWN
            if st is None:
                self._note_probe_failure(n, err)
                continue
            n.probe_fails = 0
            # a peer replaying its warmup corpus advertises warming on
            # /status; treat it as alive-but-not-READY so routing and
            # repair skip it until its replay finishes (docs/warmup.md)
            prev = n.state
            n.state = NODE_WARMING if st.get("warming") else NODE_READY
            if prev != NODE_READY and n.state == NODE_READY:
                # node.up marks ENTERING SERVICE: a restarted peer that
                # comes back warming emits it when the warmup finishes,
                # not when its socket first answers
                events.emit("node.up", peer=n.id)
            # fold the probe's piggybacked gen summaries into the result-
            # cache registry: writes that entered the cluster through
            # OTHER nodes (never crossing this coordinator) stop matching
            # cached entries within one health interval
            for iname, summary in (st.get("dataGens") or {}).items():
                self.note_peer_gens(iname, n.id, tuple(summary))
            # fold the peer's load + residency summary into the read
            # router (parallel/routing.py): the probe cadence keeps tier
            # preferences fresh even for peers the fan-out never hits
            self.router.note_status(n.id, st)
            # fold the peer's advertised wire capability (clears a stale
            # per-peer JSON downgrade once the peer speaks bin1 again —
            # the rolling-upgrade recovery path)
            self.client.note_peer_wire(n.host, st.get("wire"))
            if was_down:
                # every pooled connection to the peer predates its
                # outage/restart — invalidate them BEFORE any traffic
                # (writes included) re-targets the node, or a stale
                # keep-alive's response-phase failure turns recovery
                # into spurious non-retryable POST errors
                self.client.note_recovered(n.host)
            if was_down:
                # Schema catch-up: a node that was DOWN during a DDL
                # broadcast missed it permanently (broadcast skips DOWN
                # peers), so on recovery push the full schema (the
                # reference replays state via ClusterStatus on rejoin,
                # cluster.go:1301 mergeClusterStatus/applySchema).
                try:
                    self.client.send_message(n.host, {
                        "type": "apply-schema",
                        "schema": self.holder.schema(),
                    })
                # lint: allow(swallowed-exception) — DOWN is the
                # handling: the next recovery probe retries catch-up
                except Exception:
                    n.state = NODE_DOWN
        self._update_state()

    def _update_state(self):
        if self.state in (STATE_STARTING, STATE_RESIZING):
            return
        down = any(n.state == NODE_DOWN for n in self.nodes)
        self.state = STATE_DEGRADED if down else STATE_NORMAL

    def _mark_down(self, node_id: str):
        n = self.by_id.get(node_id)
        if n is not None:
            if n.state != NODE_DOWN:
                events.emit("node.down", peer=node_id,
                            reason="marked down by fan-out/broadcast")
            n.state = NODE_DOWN
            self._update_state()

    # -- info --------------------------------------------------------------

    def node_statuses(self) -> list[dict]:
        coord = self.nodes[0].id
        return [n.to_dict(coord) for n in self.nodes]

    def shard_nodes_info(self, index: str, shard: int) -> list[dict]:
        return [{"id": nid, "uri": self.by_id[nid].host}
                for nid in self.shard_owner_nodes(index, shard)]

    def shard_owner_nodes(self, index: str, shard: int) -> list[str]:
        """Owners of a shard: the jump-hash placement owners.  Every
        ownership decision — read routing, write fan-out, import
        grouping — consults this.  (The JAX package adds the balancer's
        placement-overlay owners here; the balancer is not ported.)"""
        return self.placement.shard_nodes(index, shard)

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return node_id in self.shard_owner_nodes(index, shard)

    def owned_shards(self, node_id: str, index: str, shards) -> list[int]:
        """``placement.owned_shards``: shards (replicas included) the
        node holds."""
        return [s for s in shards
                if node_id in self.shard_owner_nodes(index, s)]



    # -- residency tiers + load (status/query piggybacks) ------------------

    # shards listed per tier per index in a residency summary; beyond it
    # the summary truncates (the router treats unlisted as disk-only,
    # which only costs a preference, never correctness)
    RESIDENCY_MAX_SHARDS = 2048
    RESIDENCY_CACHE_TTL = 2.0
    # One query firing this many speculative duplicates is a hedge storm
    # (journaled once per query in the event timeline): the cluster is
    # tail-degrading broadly, not routing around one slow peer.
    HEDGE_STORM_MIN = 4

    def residency_summary(self) -> dict:
        """Per-index shard residency tiers this node can serve from:
        ``hbm`` (device mirror or a mesh stack holds the shard — answers
        without an upload), ``host`` (dense stage / packed stream cached
        — answers without re-expansion), everything else disk-only.
        Advertised on /status probes; the router prefers replicas that
        hold the queried shards high (docs/cluster.md).  TTL-cached:
        probes and fan-outs must not walk every fragment each time.
        Reads fragment attributes without their locks — a torn read
        costs one probe interval of preference, never correctness."""
        now = time.monotonic()
        cached = self._residency_cache
        if cached is not None and now - cached[0] < self.RESIDENCY_CACHE_TTL:
            return cached[1]
        hbm: dict[str, set[int]] = {}
        host: dict[str, set[int]] = {}
        api = self.api
        mesh = getattr(getattr(api, "executor", None), "stacked", None) \
            if api is not None else None
        if mesh is not None:
            with mesh._sc_lock:
                stack_keys = list(mesh._stack_cache.keys())
            for iname, _keys, shards in stack_keys:
                hbm.setdefault(iname, set()).update(int(s) for s in shards)
        if self.holder is not None:
            for iname, _f, _v, shard, frag in self.holder.iter_fragments():
                if frag._mirrors:
                    hbm.setdefault(iname, set()).add(shard)
                elif frag._stage is not None or frag._packed is not None:
                    host.setdefault(iname, set()).add(shard)
        out = {}
        cap = self.RESIDENCY_MAX_SHARDS
        for iname in set(hbm) | set(host):
            h = sorted(hbm.get(iname, set()))
            st = sorted(host.get(iname, set()) - hbm.get(iname, set()))
            entry = {"hbm": h[:cap], "host": st[:cap]}
            if len(h) > cap or len(st) > cap:
                entry["truncated"] = True
            out[iname] = entry
        self._residency_cache = (now, out)
        return out

    def local_load(self) -> dict:
        """This node's admission depth, piggybacked on /status and
        /internal/query responses for the router's load scores."""
        srv = self._server
        if srv is None:
            return {"inFlight": 0, "queued": 0}
        a = srv.admission.snapshot()
        b = srv.admission_internal.snapshot()
        return {"inFlight": a["inUse"] + b["inUse"],
                "queued": a["waiting"] + b["waiting"]}

    def wire_capabilities(self) -> list[str]:
        """The internal-query wire formats this node's handler accepts,
        advertised on /status for peer negotiation (docs/cluster.md
        "Internal query wire").  JSON is always accepted; bin1 only when
        the internal-wire knob allows it."""
        caps = [qwire.WIRE_JSON]
        if self.internal_wire == qwire.WIRE_BIN1:
            caps.append(qwire.WIRE_BIN1)
        return caps

    # -- peer data-version registry (result-cache keying) ------------------

    def note_peer_write(self, index: str, node_ids):
        """A write/import/repair was forwarded to these peers: their data
        (from our point of view) changed — bump their versions so cached
        cross-node results stop matching."""
        with self._gen_lock:
            for nid in node_ids:
                if nid == self.node_id:
                    continue
                self._peer_data_ver[(index, nid)] = \
                    self._peer_data_ver.get((index, nid), 0) + 1

    def note_peer_gens(self, index: str, nid: str, summary):
        """Fold a piggybacked gen summary (from an /internal/query
        response or a /status probe) into the registry; cache keys embed
        the last-seen summary, so a changed one stops every dependent
        entry from matching."""
        if summary is None:
            return
        with self._gen_lock:
            self._peer_gen_seen[(index, nid)] = tuple(summary)

    def _peer_seen_vector(self, index: str) -> tuple:
        """Last-seen per-peer gen summaries.  At FILL time this reflects
        the fan-out's own responses — i.e. it describes exactly the data
        the results were computed from."""
        with self._gen_lock:
            return tuple((n.id, self._peer_gen_seen.get((index, n.id)))
                         for n in self.nodes if n.id != self.node_id)

    def _peer_write_vector(self, index: str) -> tuple:
        with self._gen_lock:
            return tuple((n.id, self._peer_data_ver.get((index, n.id), 0))
                         for n in self.nodes if n.id != self.node_id)

    # -- shard discovery ---------------------------------------------------

    def forget_index_shards(self, index: str):
        """Drop remembered remote shard availability for a deleted
        index (both deletion paths — local API and cluster message —
        funnel here)."""
        with self._shards_lock:
            self._remote_shards.pop(index, None)

    def _available_shards(self, index: str,
                          mark_down: bool = True,
                          on_error=None,
                          patient: bool = False) -> list[int]:
        """Union of local + peer available shards.  The reference gossips
        per-field available-shard bitmaps (field.go:263); with static
        membership we ask peers directly and fold the answer into
        remote-known shards so it converges without re-asking.
        ``mark_down=False`` for read-only informational callers (e.g.
        /internal/shards/max): a transient peer timeout there must not
        flip the cluster DEGRADED.  ``on_error``: optional
        ``(node_id, exc)`` callback — the anti-entropy pass surfaces
        these swallowed failures as DATA (a peer poll failing here used
        to mark the node DOWN, which silently empties every later peer
        loop in the pass; without the callback the whole pass would look
        like a clean no-op success).

        A poll failure routes through the PROBER's consecutive-miss
        accounting (_note_probe_failure) rather than marking the peer
        DOWN outright: one transient discovery timeout used to flip a
        READY node DOWN and silently shrink every later fan-out wave,
        bypassing the health-down-threshold discipline every other
        failure path honors.  A successful poll clears the miss streak
        exactly like a successful probe.

        ``patient=True`` disables the hedge-derived straggler grace:
        anti-entropy and resize need the COMPLETE answer (a shard
        missing from the remembered map would be silently skipped by a
        sync pass, or omitted from a resize's fetch lists — a one-shot
        data-placement gap), so they wait out slow polls; only the
        query path trades completeness for bounded discovery time."""
        idx = self.holder.index(index)
        shards = set(idx.available_shards()) if idx is not None else set()
        peers = [n for n in self.peers() if n.state == NODE_READY]
        # Polls run CONCURRENTLY with a bounded, deadline-clamped
        # timeout: this discovery step precedes every coordinator
        # fan-out, so a straggling peer must cost ONE bounded poll of
        # wall clock — not a serial sweep of default socket timeouts
        # (the tail-at-scale hole one layer above the fan-out itself).
        # task() re-installs the request's trace context so the poll's
        # outbound hop still carries the trace header.
        if peers:
            timeout = self._probe_timeout()
            ctx = current_ctx()
            if ctx is not None:
                rem = ctx.remaining()
                if rem is not None:
                    timeout = max(min(timeout, rem + 0.05), 0.05)
            try:
                futs = [(n, self._pool.submit(
                    GLOBAL_TRACER.task(self.client.available_shards),
                    n.host, index, timeout)) for n in peers]
            except RuntimeError:
                futs = []  # pool shut down: close() raced this query
            # Straggler grace: wait up to the hedge delay, then stop
            # BLOCKING on slow polls — the remembered map serves the
            # query (exactly the long-standing poll-FAILURE semantic,
            # reached in bounded time), and the abandoned poll still
            # completes in the background, folding its answer into the
            # map for the next query.  Writes this coordinator acked
            # are never at risk: forwarding already recorded their
            # shards in the per-field remote sets at ack time.  With
            # hedging off (or a cold EWMA), polls stay fully patient.
            grace = self.router.hedge_delay(
                max(self.hedge_delay_ms, 0.0) / 1e3) \
                if not patient and self.hedge_reads and futs else None
            pending = {fut: n for n, fut in futs}
            if pending:
                done, _slow = futures_wait(set(pending), timeout=grace)
                for fut in list(pending):
                    if fut in done:
                        self._fold_poll(index, pending.pop(fut), fut,
                                        mark_down, on_error)
                for fut, n in pending.items():
                    fut.add_done_callback(
                        self._poll_finalizer(index, n, mark_down,
                                             on_error))
        # include every shard ever reported by a peer: a DOWN owner's
        # shards must stay in the query's scope so the fan-out surfaces
        # the failure instead of silently returning partial results
        with self._shards_lock:
            shards |= self._remote_shards.get(index, set())
        return sorted(shards)

    def _fold_poll(self, index: str, n: Node, fut, mark_down: bool,
                   on_error):
        """Fold one completed available-shards poll into the remembered
        map + the prober's miss accounting (shared by the in-grace and
        background-completion paths)."""
        try:
            got = fut.result()
        except Exception as e:
            if on_error is not None:
                on_error(n.id, e)
            if mark_down:
                self._note_probe_failure(n, e)
                self._update_state()
            return
        if n.state == NODE_READY:
            n.probe_fails = 0
        with self._shards_lock:
            self._remote_shards.setdefault(index, set()).update(got)

    def _poll_finalizer(self, index: str, n: Node, mark_down: bool,
                        on_error):
        """Done-callback for a poll its query stopped waiting on (the
        straggler grace elapsed): the late answer still converges the
        remembered map, and a real failure still counts its miss."""
        def _done(fut):
            self._fold_poll(index, n, fut, mark_down, on_error)
        return _done

    # -- query fan-out (executor.go:2455 mapReduce) ------------------------

    def execute(self, index: str, query, shards=None,
                ctx=None) -> list[Any]:
        """``ctx``: optional QueryContext (utils/deadline.py); installed
        as the current context for the whole fan-out so remotes inherit
        the remaining budget and retry waves abort once it expires."""
        from ..utils.deadline import activate
        if ctx is None:
            ctx = current_ctx()
        with activate(ctx):
            return self._execute_ctx(index, query, shards)

    def _execute_ctx(self, index: str, query, shards) -> list[Any]:
        if isinstance(query, str):
            with qprof.stage("parse"):
                query = parse(query)
        if self.holder.index(index) is None:
            from ..api import NotFoundError
            raise NotFoundError(f"index not found: {index}")
        # Reject writes while RESIZING BEFORE translation: a create-on-
        # miss key lookup for a rejected write must not durably mutate
        # the replicated translate stores mid-resize.
        if self.state == STATE_RESIZING:
            writes = sorted({name for c in query.calls
                             for name in self._write_names(c)})
            if writes:
                from ..api import DisallowedError
                raise DisallowedError(
                    f"write calls {writes} are blocked while the cluster "
                    f"is resizing (reads keep serving)")
        # key translation happens ONCE at the coordinating node; fanned-out
        # internal calls carry ids only (executor.go:147 skips
        # translateCalls when opt.Remote)
        translator = self.api.executor.translator
        with qprof.stage("translate"):
            query = translator.translate_query(index, query)
        if shards is None:
            shards = self._available_shards(index)
        # Coordinator-scope result cache: keyed on the NORMALIZED plan
        # repr (post-translation), the shard set, the local fragment
        # generation vector, and the per-peer data versions (see
        # note_peer_write/note_peer_gens) — so local mutations, forwarded
        # writes, and peer-reported gen changes all structurally
        # invalidate (cache/results.py).
        qkey = local_part = None
        cache = self.api.executor.result_cache
        if cache is not None and cache.limit_bytes > 0:
            from ..core import attr_epoch, schema_epoch
            from ..cache.results import gen_vector, query_is_readonly
            if query_is_readonly(query):
                qkey = ("cluster", index, repr(query), tuple(shards))
                # local gens/epochs and the per-peer WRITE versions are
                # captured here and reused verbatim at fill time: a write
                # landing during the fan-out must key the entry to the
                # PRE-write state (so it never matches again), not be
                # masked by a post-write re-read of the counters
                local_part = (gen_vector(self.holder, index),
                              schema_epoch(), attr_epoch(),
                              self._peer_write_vector(index))
                with qprof.stage("resultcache.lookup") as pnode:
                    out = cache.lookup(
                        qkey + local_part
                        + (self._peer_seen_vector(index),))
                    if pnode is not None:
                        pnode.tags["outcome"] = \
                            "hit" if out is not None else "miss"
                        pnode.tags["scope"] = "cluster"
                qexplain.note("caches", {
                    "cache": "result", "scope": "cluster",
                    "outcome": "hit" if out is not None else "miss",
                    "key": {"index": index, "shards": len(shards),
                            "genVector": hash(local_part[0]) & 0xFFFFFFFF,
                            "peerWriteVector": hash(local_part[3])
                            & 0xFFFFFFFF}})
                if out is not None:
                    return out
        if len(query.calls) > 1 and \
                all(self._batchable_read(c) for c in query.calls):
            results = self._execute_calls_batched(index, query.calls,
                                                  shards)
        else:
            from ..utils.deadline import check_current
            results = []
            for c in query.calls:
                check_current("cluster call dispatch")
                results.append(self._execute_call(index, c, shards))
        if translator.needs_translation(index):
            results = translator.translate_results(index, query.calls,
                                                   results)
        if qkey is not None and not degraded.is_degraded():
            # Fill key = lookup-time local state + the peer gen summaries
            # AS OBSERVED by this fan-out's responses.  Only the seen
            # vector is re-read: the responses describe exactly the data
            # the results came from (so the first warm repeat hits),
            # while everything captured at lookup time guarantees a
            # concurrent write's invalidation can never be overwritten.
            # A DEGRADED answer — shards lost under partialResults OR
            # quarantined fragments answering empty — is never cached: a
            # later healthy repeat must recompute, not serve the
            # degraded result (is_partial alone would memoize the
            # quarantined case).
            cache.fill(qkey, qkey + local_part +
                       (self._peer_seen_vector(index),), results,
                       tenant=qtenant.current_or_none())
        return results

    @classmethod
    def _write_names(cls, c: Call):
        """Write-call names inside ``c``, looking through Options
        wrappers (Options(Set(...)) must not slip past the resize write
        block)."""
        from ..executor.executor import WRITE_CALLS
        if c.name in WRITE_CALLS:
            yield c.name
        elif c.name == "Options":
            for ch in c.children:
                yield from cls._write_names(ch)

    def _batchable_read(self, c: Call) -> bool:
        """Calls whose cluster fan-out can ride one multi-call POST per
        node (plus one shared second phase for bounded TopN).  Writes
        must keep execution order, Options can override shards per call,
        and TopN extras need the coordinator's global finalize — those
        stay on the per-call path."""
        from ..executor.executor import WRITE_CALLS
        if c.name in WRITE_CALLS or c.name == "Options":
            return False
        if c.name == "TopN" and any(k in c.args for k in TOPN_EXTRAS):
            return False
        return True

    def _execute_calls_batched(self, index: str, calls, shards):
        """Fan a multi-call read query out as ONE pinned POST per owner
        node — each node answers the whole batch in one device wave via
        its executor's grouped/prepared path — plus one shared second
        wave finishing every bounded TopN.  The r4 distributed bench paid
        one dispatch round trip per call per phase (a 16-call batch = 32
        sequential device RTTs per node); this is the same reduce
        semantics (executor.go:2455 mapReduce, :879 TopN two-phase) at
        two RTTs per batch."""
        stats = self.api.stats
        two_phase: set[int] = set()
        phase1: list[Call] = []
        for i, c in enumerate(calls):
            if c.name == "TopN" and "n" in c.args:
                if c.args.get("n") and "ids" not in c.args and \
                        len(self.nodes) > 1:
                    two_phase.add(i)
                    phase1.append(self._topn_phase1_call(c))
                else:
                    # exact path: n applies at reduce, nodes must not
                    # truncate rows whose count only wins globally
                    p = c.clone()
                    del p.args["n"]
                    phase1.append(p)
            else:
                phase1.append(c)
        grouped = self._fan_out_multi(index, phase1, shards)
        results: list[Any] = [None] * len(calls)
        phase2: list[tuple[int, Call]] = []
        with stats.timer("cluster.multi.reduce"), qprof.stage("reduce"):
            for i, c in enumerate(calls):
                if i in two_phase:
                    cands = sorted({p.id for r in grouped[i] for p in r})
                    if not cands:
                        results[i] = []
                        continue
                    phase2.append((i, self._topn_phase2_call(c, cands)))
                else:
                    results[i] = self._reduce(index, c, grouped[i])
        if phase2:
            r2 = self._fan_out_multi(index, [p for _, p in phase2],
                                     shards)
            with stats.timer("cluster.multi.reduce"), \
                    qprof.stage("reduce"):
                for (i, _p2), rr in zip(phase2, r2):
                    results[i] = self._topn_finalize(calls[i], rr)
        return results

    def _fan_out_multi(self, index: str, calls: list[Call],
                       shards: list[int]) -> list[list[Any]]:
        """Fan one pinned multi-call query to shard owners, tail-
        tolerantly (docs/robustness.md "Tail-tolerant fan-out"); returns
        per-call lists of group results.

        Responses are consumed AS THEY COMPLETE: a failed owner's shards
        re-dispatch to a replica immediately, while other peers are
        still in flight, instead of after the whole wave drains.  A
        straggling-but-alive peer gets a HEDGE — after its hedge delay
        (hedge-delay-ms, or EWMA-derived; parallel/routing.py) the same
        call set speculatively duplicates to the next-best replica and
        the first answer wins, the loser is ignored.  Safe because every
        call through this path is an idempotent internal read — writes
        fan out through their own replica-synchronous paths and are
        never hedged.  Shards whose every replica is exhausted either
        fail the query loudly (with a per-node attempt log on the error
        and a ``cluster.fanout_failed`` event) or, when the request
        opted into partial results (utils/degraded.py), degrade to a
        partial answer that names exactly the missing shards.

        Per-node wire overhead (POST elapsed minus the peer's reported
        execution time) and peer execution time feed /debug/vars for the
        distributed latency breakdown."""
        stats = self.api.stats
        out: list[list[Any]] = [[] for _ in calls]
        q = Query(list(calls))
        if not shards:
            for i, r in enumerate(self.api.executor.execute(
                    index, q, [], translate=False)):
                out[i].append(r)
            return out
        ctx = current_ctx()
        # a shard group may be re-dispatched at most this many times —
        # the same bound the old whole-wave retry loop enforced
        max_wave = len(self.nodes) + 1
        hedge_enabled = self.hedge_reads and len(self.nodes) > 1
        hedge_fixed_s = max(self.hedge_delay_ms, 0.0) / 1e3
        exclude: set[str] = set()
        remaining: set[int] = {int(s) for s in shards}
        failed_nodes: set[str] = set()
        attempts: list[dict] = []  # per-node attempt log (error surface)
        last_err: Exception | None = None
        partial_counted = False
        hedges_fired = 0  # this query's speculative duplicates
        # one in-flight dispatch per future.  First-answer-wins is
        # per-SHARD-SET with all-or-nothing acceptance: a flight's
        # results are per-group AGGREGATES (a Count over its whole
        # shard list) and can never be split, so a completed flight is
        # accepted only when EVERY one of its shards is still
        # unanswered; otherwise it is discarded whole and any leftover
        # shards nothing else covers re-dispatch.  `cover` counts the
        # in-flight flights per shard so a failure only re-dispatches
        # shards no surviving twin still covers.
        inflight: dict[Any, dict] = {}  # future -> flight dict
        cover: dict[int, int] = {}

        def submit(nid: str, nshards: list[int], wave: int,
                   hedge: bool = False):
            for s in nshards:
                cover[s] = cover.get(s, 0) + 1
            # remotes inherit the coordinator's REMAINING budget (wire
            # header + clamped socket timeout), recomputed per dispatch
            # so retries and hedges inherit the shrunken budget
            deadline_s = ctx.remaining() if ctx is not None else None
            # deadline rides as an extra arg ONLY when a budget is set,
            # so the un-budgeted call convention stays stable
            args = (self.by_id[nid].host, index, calls, list(nshards))
            if deadline_s is not None:
                args += (deadline_s,)
            # router feed: coordinator-observed in-flight depth and the
            # per-shard load counters the balancer watches
            self.router.note_dispatch(nid, len(nshards))
            self.load_tracker.note(index, nshards, nid)
            qexplain.note("dispatch", {
                "node": nid, "shards": [int(s) for s in nshards[:64]],
                "wave": wave, "hedge": hedge})

            # the router's RTT sample is timed INSIDE the pool worker:
            # the consumption loop's elapsed also counts local execution
            # and other peers' result waits, which would systematically
            # inflate remote scores vs local
            def timed_rpc(*a, _fn=self.client.query_calls):
                t = time.perf_counter()
                return _fn(*a), time.perf_counter() - t

            hedge_at = None
            if hedge_enabled and not hedge:
                d = self.router.hedge_delay(hedge_fixed_s)
                if d is not None:
                    hedge_at = time.perf_counter() + d
            span_tags = {"host": self.by_id[nid].host}
            if hedge:
                span_tags["hedge"] = True
            # task(): the pool worker re-installs this thread's trace
            # context and runs the RPC under a per-peer client span —
            # the injected header then carries that span's id, so the
            # remote's spans parent under it (docs/observability.md)
            fut = self._pool.submit(
                GLOBAL_TRACER.task(timed_rpc,
                                   name=f"cluster.rpc {nid}",
                                   **span_tags),
                *args)
            inflight[fut] = {"nid": nid,
                             "shards": tuple(int(s) for s in nshards),
                             "wave": wave, "hedge": hedge,
                             "hedged": False,
                             "t0": time.perf_counter(),
                             "hedge_at": hedge_at}

        def run_local(nshards: list[int], wave: int):
            self.router.note_dispatch(self.node_id, len(nshards))
            self.load_tracker.note(index, nshards, self.node_id)
            qexplain.note("dispatch", {
                "node": self.node_id,
                "shards": [int(s) for s in nshards[:64]],
                "wave": wave, "local": True})
            t_local = time.perf_counter()
            try:
                with stats.timer("cluster.multi.local_exec"), \
                        qprof.stage("local_exec"):
                    for i, r in enumerate(self.api.executor.execute(
                            index, q, list(nshards), translate=False)):
                        out[i].append(r)
            finally:
                self.router.note_done(
                    self.node_id, time.perf_counter() - t_local)
            remaining.difference_update(int(s) for s in nshards)

        def unservable(shard_set: set[int], exhausted: bool):
            """Every replica of these shards is gone: degrade to a
            partial answer when the request opted in, else raise with
            the per-node attempt log attached."""
            nonlocal partial_counted
            if ctx is not None:
                ctx.check("cluster fan-out")  # expired -> 504, not 500
            if degraded.partial_allowed():
                degraded.note_missing(index, shard_set, failed_nodes)
                if not partial_counted:
                    stats.count("cluster.partial_results")
                    partial_counted = True
                self._fanout_event(index, shard_set, attempts,
                                   partial=True)
                remaining.difference_update(shard_set)
                return
            self._fanout_event(index, shard_set, attempts, partial=False)
            base = "query retries exhausted" if exhausted else \
                (f"no replicas available for shards "
                 f"{sorted(shard_set)} of {index!r}")
            err = ClusterError(base + self._attempts_suffix(attempts))
            err.attempts = list(attempts)
            raise err from last_err

        def dispatch_shards(shard_set: set[int], wave: int):
            if wave >= max_wave:
                unservable(shard_set, exhausted=True)
                return
            if wave > 0:
                stats.count("cluster.retry_waves")
            nonlocal last_err
            try:
                groups = self._group_shards(index, sorted(shard_set),
                                            exclude)
            except ClusterError as e:
                # re-admit owners that failed with an APPLICATION error
                # (they responded — still READY): one failure is not
                # death, so they get another pass.  Transport-failed
                # owners were marked DOWN and stay excluded — a dead or
                # partitioned sole owner must fail after ONE timeout,
                # not len(nodes)+1 of them.
                readmit = {nid for nid in exclude
                           if self.by_id[nid].state == NODE_READY}
                if not readmit:
                    last_err = e
                    unservable(shard_set, exhausted=False)
                    return
                exclude.difference_update(readmit)
                try:
                    groups = self._group_shards(index, sorted(shard_set),
                                                exclude)
                except ClusterError as e2:
                    last_err = e2
                    unservable(shard_set, exhausted=False)
                    return
            local_shards = groups.pop(self.node_id, None)
            for nid, nshards in groups.items():
                submit(nid, nshards, wave)
            if local_shards is not None:
                run_local(local_shards, wave)

        def record_failure(fl: dict, e: Exception, down: bool):
            nonlocal last_err
            last_err = e
            attempts.append({"node": fl["nid"], "wave": fl["wave"],
                             "hedge": fl["hedge"],
                             "shards": len(fl["shards"]),
                             "error": f"{type(e).__name__}: {e}"})
            failed_nodes.add(fl["nid"])
            self.router.note_done(fl["nid"], None, ok=False)
            if down:
                self._mark_down(fl["nid"])
            exclude.add(fl["nid"])
            # re-dispatch only the shards no surviving twin (hedge or
            # primary) still covers — a still-flying duplicate gets to
            # answer before another retry burns a wave
            retry = {s for s in fl["shards"]
                     if s in remaining and cover.get(s, 0) == 0}
            if retry:
                dispatch_shards(retry, fl["wave"] + 1)

        def accept(fl: dict, res, exec_s, peer_gens, peer_quarantined,
                   peer_load, rtt):
            self.router.note_done(fl["nid"], rtt)
            self.router.note_query_load(fl["nid"], peer_load)
            unanswered = [s for s in fl["shards"] if s in remaining]
            if len(unanswered) != len(fl["shards"]):
                # a racing flight (hedge winner / replica retry) already
                # answered part of this group.  The group's results are
                # aggregates over its WHOLE shard list — they cannot be
                # split — so discard them entirely, and re-dispatch any
                # leftover shards nothing else still covers (rare: only
                # a lost race can produce leftovers, so progress was
                # made elsewhere and this terminates)
                leftover = {s for s in unanswered
                            if cover.get(s, 0) == 0}
                if leftover:
                    dispatch_shards(leftover, fl["wave"])
                return
            if fl["hedge"]:
                stats.count("cluster.hedge_wins")
                self.router.note_hedge_win(fl["nid"])
                qexplain.note("hedges", {"outcome": "won",
                                         "node": fl["nid"],
                                         "shards": len(fl["shards"])})
            if peer_quarantined:
                # peer answered with quarantined fragments serving
                # empty: surface it on THIS response (consumed on the
                # request thread, where the handler's degraded
                # collector is active)
                degraded.note(peer_quarantined)
            elapsed = time.perf_counter() - fl["t0"]
            stats.timing("cluster.multi.peer_exec", exec_s)
            stats.timing("cluster.multi.wire_overhead",
                         max(elapsed - exec_s, 0.0))
            # per-peer fan-out RTT in the profile tree: total round
            # trip, the peer's own execution time, and the wire/
            # serialization overhead between them
            qprof.event(f"peer.{fl['nid']}", elapsed,
                        shards=len(fl["shards"]),
                        peerExecS=round(exec_s, 6),
                        wireS=round(max(elapsed - exec_s, 0.0), 6))
            self.note_peer_gens(index, fl["nid"], peer_gens)
            for i, r in enumerate(res):
                out[i].append(r)
            remaining.difference_update(fl["shards"])

        try:
            # the initial dispatch runs INSIDE the finalizer scope: if
            # local execution (or a mid-submit pool shutdown) raises
            # while remote RPCs are already flying, their router
            # in-flight depth must still unwind via the done-callbacks
            dispatch_shards(remaining.copy(), 0)
            # run until every shard is answered or abandoned — NOT until
            # every future drains: once a hedge (or a replica retry) has
            # answered a group, its loser must not hold the query open
            while remaining:
                if not inflight:
                    # unanswered shards with nothing flying: fail or
                    # degrade (clears `remaining` either way)
                    unservable(remaining.copy(), exhausted=True)
                    continue
                if ctx is not None:
                    ctx.check("cluster fan-out")
                # wake for whichever comes first: a completion, the
                # next hedge deadline, or the query deadline
                timeout = None
                if hedge_enabled:
                    now = time.perf_counter()
                    due = [fl["hedge_at"] - now
                           for fl in inflight.values()
                           if fl["hedge_at"] is not None
                           and not fl["hedge"] and not fl["hedged"]]
                    if due:
                        timeout = max(0.0, min(due))
                if ctx is not None:
                    rem = ctx.remaining()
                    if rem is not None:
                        rem = max(rem, 0.001)
                        timeout = rem if timeout is None \
                            else min(timeout, rem)
                done, _still = futures_wait(set(inflight),
                                            timeout=timeout,
                                            return_when=FIRST_COMPLETED)
                for fut in done:
                    fl = inflight.pop(fut)
                    for s in fl["shards"]:
                        cover[s] = cover.get(s, 1) - 1
                    try:
                        ((res, exec_s, peer_gens, peer_quarantined,
                          peer_load), rtt) = fut.result()
                    except CircuitOpenError as e:
                        # fail-fast: the peer's breaker is open (N
                        # consecutive transport failures) — treat like
                        # a dead node, not an application error from a
                        # live one.  (The router pre-skips open
                        # breakers, so this only fires when EVERY
                        # candidate was open or the breaker opened
                        # mid-flight.)
                        record_failure(fl, e, down=True)
                    except ClusterError as e:
                        # the peer RESPONDED (HTTP error): it is alive,
                        # so an application-level failure must not
                        # poison membership — just retry these shards
                        # on a replica
                        record_failure(fl, e, down=False)
                    except Exception as e:
                        record_failure(fl, e, down=True)
                    else:
                        accept(fl, res, exec_s, peer_gens,
                               peer_quarantined, peer_load, rtt)
                if hedge_enabled and remaining and inflight:
                    now = time.perf_counter()
                    for fl in list(inflight.values()):
                        if (fl["hedge"] or fl["hedged"]
                                or fl["hedge_at"] is None
                                or now < fl["hedge_at"]):
                            continue
                        fl["hedged"] = True  # at most one hedge round
                        hedge_shards = [s for s in fl["shards"]
                                        if s in remaining]
                        if not hedge_shards:
                            continue
                        # Per-tenant hedge budget (docs/robustness.md
                        # "Tenant isolation"): each hedge round draws a
                        # token from the requesting tenant's bucket; an
                        # exhausted bucket keeps the read UNHEDGED —
                        # counted and visible, never an error — so one
                        # tenant's straggler storm cannot amplify its
                        # own load onto the fleet.
                        hedge_tenant = qtenant.current()
                        if not self.hedge_budget.try_take(hedge_tenant):
                            stats.count("cluster.hedge_budget_denied")
                            stats.count(
                                f"tenant.{hedge_tenant}.hedge_denied")
                            qtenant.REGISTRY.note_hedge_denied(
                                hedge_tenant)
                            qexplain.note("hedges", {
                                "outcome": "budget_denied",
                                "tenant": hedge_tenant,
                                "insteadOf": fl["nid"],
                                "shards": len(hedge_shards)})
                            continue
                        excl = exclude | {fl["nid"]}
                        # cheapest shape first: ONE replica owning the
                        # whole group duplicates it in a single RPC;
                        # otherwise split by the router's own grouping
                        # so every shard still gets a speculative
                        # second chance (jump-hash rarely gives a big
                        # group one common alternate owner)
                        target = self.router.hedge_candidate(
                            index, hedge_shards, excl)
                        if target is not None:
                            groups = {target: list(hedge_shards)}
                        else:
                            try:
                                groups = self._group_shards(
                                    index, sorted(hedge_shards), excl)
                            except ClusterError:
                                continue  # nobody can hedge this group
                            # hedges go to REMOTE replicas only: local
                            # execution is not a network-straggler
                            # path, and running it inline here would
                            # stall consumption of completed responses
                            groups.pop(self.node_id, None)
                        for nid, nshards in groups.items():
                            stats.count("cluster.hedges")
                            self.router.note_hedge(nid)
                            qexplain.note("hedges", {
                                "outcome": "fired", "node": nid,
                                "insteadOf": fl["nid"],
                                "shards": len(nshards)})
                            hedges_fired += 1
                            if hedges_fired == self.HEDGE_STORM_MIN:
                                # one query speculating this widely is a
                                # tail-latency incident, not routine
                                # hedging — journal it once per query
                                events.emit("cluster.hedge_storm",
                                            index=index,
                                            hedges=hedges_fired)
                            submit(nid, nshards, fl["wave"],
                                   hedge=True)
        finally:
            # abandoned flights (hedge-race losers, RPCs still flying
            # when the query finished/raised/expired): finalize their
            # router bookkeeping off-thread — the in-flight depth must
            # unwind, and a straggler's TRUE RTT still feeds its EWMA
            # (how the router learns the peer is slow)
            for fut, fl in list(inflight.items()):
                fut.add_done_callback(self._flight_finalizer(fl))
        return out

    def _flight_finalizer(self, fl: dict):
        """Done-callback for a fan-out flight its query abandoned (a
        hedge race loser, or any RPC still in flight when the query
        completed, raised, or hit its deadline).  Runs on the pool
        worker: only router bookkeeping — never the query's own state,
        which may already be serialized and gone."""
        def _done(fut):
            try:
                ((_res, _exec_s, _gens, _quar, load),
                 rtt) = fut.result()
            except Exception:
                # the query already finished without this flight; the
                # router's error counter (note_done ok=False) is the
                # only consumer of the outcome
                self.router.note_done(fl["nid"], None, ok=False)
            else:
                self.router.note_done(fl["nid"], rtt)
                self.router.note_query_load(fl["nid"], load)
        return _done

    @staticmethod
    def _format_attempt(a: dict) -> str:
        """One attempt-log entry as 'node waveN [hedge]: error' — the
        shared format of the error suffix and the structured event."""
        return (f"{a['node']} wave{a['wave']}"
                + (" hedge" if a["hedge"] else "")
                + f": {a['error']}")

    @staticmethod
    def _attempts_suffix(attempts: list[dict]) -> str:
        """Human-readable per-node attempt trail for fan-out errors —
        'which node failed how, in which wave' used to be discarded."""
        if not attempts:
            return ""
        tail = attempts[-8:]
        parts = [Cluster._format_attempt(a) for a in tail]
        more = f" (+{len(attempts) - len(tail)} earlier)" \
            if len(attempts) > len(tail) else ""
        return " [attempts: " + "; ".join(parts) + more + "]"

    def _fanout_event(self, index: str, shard_set, attempts: list[dict],
                      partial: bool):
        """Structured ``cluster.fanout_failed`` event: the per-node
        failure detail that used to vanish into a bare ClusterError."""
        if self.stats is not None:
            self.stats.count("cluster.fanout_failed")
        logger = self.logger
        if logger is None:
            return
        try:
            logger.event(
                "cluster.fanout_failed", index=index,
                shards=sorted(int(s) for s in shard_set)[:64],
                partial=partial,
                attempts="; ".join(
                    self._format_attempt(a) for a in attempts[-8:]))
        # lint: allow(swallowed-exception) — telemetry must never fail
        # the query path; the error
        # itself still raises/degrades through the caller
        except Exception:
            pass

    def _execute_call(self, index: str, c: Call, shards: list[int]):
        if c.name in ("Set", "Clear"):
            return self._execute_col_write(index, c)
        if c.name in ("Store", "ClearRow"):
            return self._execute_all_nodes_write(index, c, shards)
        if c.name in ("SetRowAttrs", "SetColumnAttrs"):
            return self._execute_attr_write(index, c)
        if c.name == "Options":
            return self._execute_options(index, c, shards)
        return self._execute_read(index, c, shards)

    def _execute_options(self, index: str, c: Call, shards: list[int]):
        """Unwrap Options at the coordinator: fan out the CHILD call (so
        per-call reduce semantics — Count sum, ValCount add, TopN
        n-stripping — apply to the real call, not the wrapper) and shape
        the merged result here (executor.go:340-403; attr stores are
        replicated on every node)."""
        from ..executor.executor import Executor

        if len(c.children) != 1:
            raise ClusterError("Options() requires exactly one child")
        if "shards" in c.args:
            if not isinstance(c.args["shards"], list):
                raise ClusterError("Options() shards must be a list")
            shards = [int(s) for s in c.args["shards"]]
        exclude_columns = Executor._options_bool(c, "excludeColumns")
        column_attrs = Executor._options_bool(c, "columnAttrs")
        exclude_row_attrs = Executor._options_bool(c, "excludeRowAttrs")
        result = self._execute_call(index, c.children[0], shards)
        if isinstance(result, RowResult):
            if exclude_columns:
                result.segments = {}
            if column_attrs:
                Executor.attach_column_attrs(self.holder, index, result)
            if exclude_row_attrs:
                result.attrs = {}
        return result

    def _local_exec(self, index: str, c: Call, shards: list[int]):
        return self.api.executor.execute(index, Query([c]), shards,
                                         translate=False)[0]

    def _ready_owner_order(self, index: str, shard: int) -> list[str]:
        owners = self.shard_owner_nodes(index, shard)
        ready = [o for o in owners if self.by_id[o].state == NODE_READY]
        return ready or owners

    def _group_shards(self, index: str,
                      shards: list[int],
                      exclude: set[str] = frozenset()) -> dict[str, list]:
        """shard -> executor node, chosen by the read router
        (parallel/routing.py): ``read-routing=primary`` reproduces the
        legacy grouping — self if it owns the shard, else the first
        READY owner (executor.go:2435 shardsByNode) — while
        ``round-robin``/``loaded`` spread reads across replicas."""
        return self.router.group_shards(index, shards, exclude)

    def _execute_topn_extras(self, index: str, c: Call, shards: list[int]):
        """TopN with tanimoto/attr filtering, finalized GLOBALLY at the
        coordinator: per-node tanimoto on node-local counts would keep or
        drop different rows than a single node holding all the data.  Fans
        out raw filtered counts (plus, for tanimoto, the unfiltered counts
        and the source-row count), then applies Executor._topn_finalize on
        the merged totals (fragment.go:1704 semantics, exact)."""
        from ..executor.executor import Executor, topn_extras

        tan_thresh, attr_name, attr_values = topn_extras(c)
        base = c.clone()
        for k in TOPN_EXTRAS + ("n",):
            base.args.pop(k, None)
        pairs = self._execute_read(index, base, shards)
        row_tot = np.zeros(0, dtype=np.int64)
        src = 0
        if tan_thresh:
            unfiltered = base.clone()
            unfiltered.children = []
            pairs_u = self._execute_read(index, unfiltered, shards)
            src = self._execute_read(
                index, Call("Count", children=[c.children[0].clone()]),
                shards)
            for p in pairs_u:
                if p.id >= row_tot.size:
                    grown = np.zeros(p.id + 1, dtype=np.int64)
                    grown[: row_tot.size] = row_tot
                    row_tot = grown
                row_tot[p.id] = p.count
        size = 1 + max((p.id for p in pairs), default=0)
        counts = np.zeros(size, dtype=np.int64)
        for p in pairs:
            counts[p.id] = p.count
        n, _ = c.uint_arg("n")
        field_name, _ = c.string_arg("_field")
        field = self.holder.field(index, field_name)
        return Executor._topn_finalize(
            counts, row_tot, src, c.args.get("ids"), n, tan_thresh,
            attr_name, attr_values, field)

    @staticmethod
    def _topn_phase1_call(c: Call) -> Call:
        """Phase-1 candidate call: per-node top list with 4x slack
        (executor.go:879-899).  APPROXIMATE like the reference's
        cache-based phase 1: a row can rank below every node's candidate
        cutoff yet sum into the global top k; the slack makes that
        require a pathologically skewed distribution, and the counts
        reported for returned rows are always exact (phase 2)."""
        n, _ = c.uint_arg("n")
        phase1 = c.clone()
        phase1.args["n"] = max(4 * n, n + 16)
        return phase1

    @staticmethod
    def _topn_phase2_call(c: Call, candidates: list[int]) -> Call:
        """Phase-2 exact-recount call over the candidate union."""
        phase2 = c.clone()
        del phase2.args["n"]
        phase2.args["ids"] = candidates
        return phase2

    @staticmethod
    def _topn_finalize(c: Call, group_results) -> list:
        """Merge phase-2 per-group pairs and apply the original n."""
        n, _ = c.uint_arg("n")
        merged = merge_pairs(group_results)
        return sort_pairs([p for p in merged if p.count > 0], n or None)

    def _execute_topn_two_phase(self, index: str, c: Call,
                                shards: list[int]):
        """TopN(n=k) across nodes in two bounded phases: phase 1 fans
        out a per-node candidate top list — each node ships O(k) pairs,
        not every nonzero row — and phase 2 re-fetches exact global
        counts for the union of candidate ids (see _topn_phase1_call)."""
        results = []
        for r in self._fan_out_read(index, self._topn_phase1_call(c),
                                    shards):
            results.extend(r)
        candidates = sorted({p.id for p in results})
        if not candidates:
            return []
        return self._topn_finalize(c, self._fan_out_read(
            index, self._topn_phase2_call(c, candidates), shards))

    def _execute_read(self, index: str, c: Call, shards: list[int]):
        send = c
        if c.name == "TopN" and \
                any(k in c.args for k in TOPN_EXTRAS):
            return self._execute_topn_extras(index, c, shards)
        if c.name == "TopN" and "n" in c.args:
            if c.args.get("n") and "ids" not in c.args \
                    and len(self.nodes) > 1:
                # bounded two-phase protocol; n=0 (unlimited), explicit
                # ids, and single-node clusters take the exact path below
                return self._execute_topn_two_phase(index, c, shards)
            # exact path: strip the limit so no node truncates rows whose
            # global count only wins across nodes; n applies at reduce
            send = c.clone()
            del send.args["n"]
        return self._reduce(index, c,
                            self._fan_out_read(index, send, shards))

    def _fan_out_read(self, index: str, send: Call,
                      shards: list[int]) -> list[Any]:
        """Fan a pinned read call out to shard owners with replica retry;
        returns the per-group raw results (executor.go:2455 mapReduce).
        The single-call case of ``_fan_out_multi`` — one retry/owner-
        grouping machinery, not two."""
        return self._fan_out_multi(index, [send], shards)[0]

    # -- writes ------------------------------------------------------------

    def _require_ready(self, node_ids, what: str):
        """Writes need every replica reachable: silently skipping a DOWN
        owner would lose the write on that replica (and union-only
        anti-entropy could later resurrect cleared bits from it).  The
        reference likewise surfaces replica-write failures
        (executor.go:2156-2166 remoteExec error propagation)."""
        down = [nid for nid in node_ids
                if nid != self.node_id
                and self.by_id[nid].state != NODE_READY]
        if down:
            raise ClusterError(
                f"cannot {what}: replica node(s) {down} unavailable")

    def _execute_col_write(self, index: str, c: Call):
        """Set/Clear: fan to every replica of the column's shard
        (executor.go:2137-2166)."""
        col = c.args.get("_col")
        if not isinstance(col, int) or isinstance(col, bool):
            return self._local_exec(index, c, [])
        shard = col // SHARD_WIDTH
        owners = self.shard_owner_nodes(index, shard)
        self._require_ready(owners, f"write shard {shard} of {index!r}")
        self.note_peer_write(index, owners)
        futures = []
        for nid in owners:
            if nid != self.node_id:
                futures.append(self._pool.submit(
                    GLOBAL_TRACER.task(self.client.query_call),
                    self.by_id[nid].host, index, c, [shard]))
        result = self._local_exec(index, c, [shard]) \
            if self.node_id in owners else None
        remote = None
        for f in futures:
            remote = f.result()  # raise on replica-write failure
        return result if result is not None else remote

    def _execute_all_nodes_write(self, index: str, c: Call,
                                 shards: list[int]):
        """Store/ClearRow touch every owned fragment on every node."""
        involved = [n.id for n in self.nodes
                    if self.owned_shards(n.id, index, shards)]
        self._require_ready(involved, f"{c.name} on {index!r}")
        self.note_peer_write(index, involved)
        changed = False
        futures = []
        for n in self.nodes:
            owned = self.owned_shards(n.id, index, shards)
            if not owned or n.id == self.node_id:
                continue
            futures.append(self._pool.submit(
                GLOBAL_TRACER.task(self.client.query_call),
                n.host, index, c, owned))
        local_owned = self.owned_shards(self.node_id, index, shards)
        if local_owned:
            changed = bool(self._local_exec(index, c, local_owned))
        for f in futures:
            changed = bool(f.result()) or changed
        return changed

    def _execute_attr_write(self, index: str, c: Call):
        """Attr stores are replicated on every node (executor.go:2207
        SetRowAttrs local write + broadcast).  Requires every node READY —
        a DOWN peer silently skipped would diverge permanently since DDL
        replay doesn't carry attrs; anti-entropy attr sync repairs the
        divergence a mid-fan-out failure can still leave."""
        self._require_ready([n.id for n in self.nodes],
                            f"{c.name} on {index!r}")
        self.note_peer_write(index, [n.id for n in self.peers()])
        # local write FIRST: if it fails, no peer has diverged yet
        out = self._local_exec(index, c, [])
        futures = [self._pool.submit(
            GLOBAL_TRACER.task(self.client.query_call), n.host, index,
            c, [])
            for n in self.peers()]
        errors = []
        for f in futures:
            try:
                f.result()
            except Exception as e:
                errors.append(str(e))
        if errors:
            raise ClusterError(
                "attr write incomplete (anti-entropy will repair): "
                + "; ".join(errors))
        return out

    # -- reduce (executor.go:2482 reduce fns per call type) ----------------

    def _reduce(self, index: str, c: Call, results: list[Any]):
        results = [r for r in results if r is not None]
        if not results:
            return None
        name = c.name
        first = results[0]
        if name == "Count":
            return sum(int(r) for r in results)
        if isinstance(first, RowResult):
            segments = {}
            attrs = {}
            for r in results:
                segments.update(r.segments)
                attrs = attrs or r.attrs  # row attrs replicated per node
            return RowResult(segments, attrs=attrs or None)
        if isinstance(first, ValCount):
            acc = first
            for r in results[1:]:
                if name == "Sum":
                    acc = acc.add(r)
                elif name in ("Min", "MinRow"):
                    acc = acc.smaller(r)
                else:
                    acc = acc.larger(r)
            return acc
        if name == "TopN":
            n, _ = c.uint_arg("n")
            pairs = merge_pairs(results)
            return sort_pairs([p for p in pairs if p.count > 0], n or None)
        if isinstance(first, RowIdentifiers):
            rows = sorted(set().union(*[set(r.rows) for r in results]))
            limit = c.args.get("limit")
            if limit is not None:
                rows = rows[:limit]
            return RowIdentifiers(rows=rows)
        if name == "GroupBy":
            return self._reduce_group_by(c, results)
        return first

    @staticmethod
    def _reduce_group_by(c: Call, results: list[list[GroupCount]]):
        """(executor.go:1195 mergeGroupCounts)"""
        acc: dict[tuple, GroupCount] = {}
        for node_groups in results:
            for g in node_groups:
                key = tuple((fr.field, fr.row_id) for fr in g.group)
                if key in acc:
                    acc[key] = GroupCount(g.group, acc[key].count + g.count)
                else:
                    acc[key] = g
        out = sorted(acc.values(), key=lambda g: tuple(
            (fr.field, fr.row_id) for fr in g.group))
        limit = c.args.get("limit")
        return out[:limit] if limit is not None else out

    # -- DDL broadcast (broadcast.go:30, server.go:569 receiveMessage) -----

    def broadcast(self, msg: dict):
        """Send a cluster message to every READY peer, synchronously."""
        errors = []
        for n in self.peers():
            if n.state != NODE_READY:
                continue
            try:
                self.client.send_message(n.host, msg)
            except Exception as e:
                # Mark DOWN so the next successful probe triggers the
                # apply-schema catch-up; a peer that missed a DDL broadcast
                # while staying READY would diverge permanently.
                self._mark_down(n.id)
                errors.append(f"{n.id}: {e}")
        if errors:
            raise ClusterError("broadcast failed: " + "; ".join(errors))

    def handle_message(self, msg: dict):
        """Apply a received cluster message locally (server.go:569)."""
        t = msg.get("type")
        holder = self.holder
        if t == "create-index":
            holder.create_index_if_not_exists(
                msg["index"], keys=msg.get("keys", False),
                track_existence=msg.get("trackExistence", True))
        elif t == "delete-index":
            self.forget_index_shards(msg["index"])
            try:
                holder.delete_index(msg["index"])
            except ValueError:
                pass
        elif t == "create-field":
            from ..storage import FieldOptions
            idx = holder.index(msg["index"])
            if idx is None:
                # can happen if this node missed the create-index while
                # down; the field implies the index
                idx = holder.create_index_if_not_exists(msg["index"])
            # lenient: applying a peer's schema must never crash this
            # node — the coordinator already validated user input
            idx.create_field_if_not_exists(
                msg["field"], FieldOptions.from_dict(
                    msg.get("options", {}), lenient=True))
        elif t == "apply-schema":
            from ..storage import FieldOptions
            for idx_def in msg.get("schema", []):
                opts = idx_def.get("options", {})
                idx = holder.create_index_if_not_exists(
                    idx_def["name"], keys=opts.get("keys", False),
                    track_existence=opts.get("trackExistence", True))
                for fdef in idx_def.get("fields", []):
                    idx.create_field_if_not_exists(
                        fdef["name"],
                        FieldOptions.from_dict(fdef.get("options", {}),
                                               lenient=True))
        elif t == "delete-field":
            idx = holder.index(msg["index"])
            if idx is not None:
                try:
                    idx.delete_field(msg["field"])
                except ValueError:
                    pass
        elif t == "set-state":
            # coordinator-driven state transition (resize begin/abort —
            # cluster.go:1116 setStateAndBroadcast)
            self.state = msg["state"]
            self._update_state()
        else:
            # resize-fetch, resize-complete and placement-overlay belong
            # to the resize and balancer planes, which are not ported
            raise ClusterError(f"unknown cluster message type {t!r}")

    # -- import forwarding (api.go:920-1028) -------------------------------

    def _forward_grouped(self, index: str, field: str, cols: np.ndarray,
                         payload_fn):
        """Shared import fan-out: group bits by shard, build one payload
        per owner node via ``payload_fn(selection_mask)``, apply locally /
        POST remotely in parallel (api.go:963-996 importsByNode)."""
        shards = cols // SHARD_WIDTH
        by_node: dict[str, list[int]] = {}
        for s in np.unique(shards):
            owners = self.shard_owner_nodes(index, int(s))
            self._require_ready(owners, f"import shard {int(s)}")
            for nid in owners:
                by_node.setdefault(nid, []).append(int(s))
        idx = self.holder.index(index)
        # forwarded imports mutate the owners' data: invalidate cached
        # cross-node results that depended on them
        self.note_peer_write(index, by_node)
        futures = []
        local_payload = None
        for nid, nshards in by_node.items():
            payload = payload_fn(np.isin(shards, nshards))
            if nid == self.node_id:
                local_payload = payload
                continue
            futures.append(self._pool.submit(
                GLOBAL_TRACER.task(self.client.import_local),
                self.by_id[nid].host, index, field, payload))
            if idx is not None:
                f = idx.field(field)
                if f is not None:
                    f.remote_available_shards.update(
                        s for s in nshards
                        if not self.owns_shard(self.node_id, index, s))
        if local_payload is not None:
            self.api.apply_import_local(index, field, local_payload)
        for fut in futures:
            fut.result()  # propagate owner-import failures

    def import_bits(self, index: str, field: str, rows: np.ndarray,
                    cols: np.ndarray, timestamps=None, clear: bool = False):
        """Group bits by shard, send each shard batch to every owner."""
        self._forward_grouped(index, field, cols, lambda sel: {
            "rowIDs": rows[sel].tolist(),
            "columnIDs": cols[sel].tolist(),
            "timestamps": ([timestamps[i] for i in np.nonzero(sel)[0]]
                           if timestamps else None),
            "clear": clear,
        })

    def import_values(self, index: str, field: str, cols: np.ndarray,
                      vals: np.ndarray, clear: bool = False):
        self._forward_grouped(index, field, cols, lambda sel: {
            "columnIDs": cols[sel].tolist(),
            "values": vals[sel].tolist() if not clear else None,
            "clear": clear,
        })

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool):
        """Forward a pre-serialized roaring import to each shard owner.
        Single-view imports (the overwhelmingly common shape) ship RAW
        over /internal/import-roaring — no base64, no JSON envelope;
        multi-view imports keep the legacy JSON forward."""
        self.note_peer_write(index, self.shard_owner_nodes(index, shard))
        for nid in self.shard_owner_nodes(index, shard):
            if nid == self.node_id:
                self.api.apply_import_roaring_local(index, field, shard,
                                                    views, clear)
            elif len(views) == 1:
                (view, data), = views.items()
                self.client.import_roaring_binary(
                    self.by_id[nid].host, index, field, shard,
                    view or "standard", data, clear)
            else:
                payload = {
                    "shard": shard,
                    "clear": clear,
                    "views": {k: base64.b64encode(v).decode()
                              for k, v in views.items()},
                }
                self.client.import_local(self.by_id[nid].host, index, field,
                                         payload)

    # -- internal HTTP routes (handler.go:302-314 /internal/*) -------------

    def register_routes(self, router, server=None):
        cluster = self
        if server is not None:
            # load piggybacks (local_load) report this server's
            # admission pools
            self._server = server

        def _exec_multi(req, index, calls_wire, shards):
            """Execute a multi-call batch and build its piggybacks —
            shared by the JSON and PTPUQRY1 branches so the two wires
            can never drift in semantics.  Returns (results, trailer):
            the trailer is the piggyback dict (execS, gens, quarantined,
            load, spans) that the JSON wire inlines into its response
            object and the binary wire ships as its trailer frame."""
            from ..cache.results import gen_summary
            calls = [call_from_wire(c) for c in calls_wire]
            t0 = time.perf_counter()
            res = cluster.api.executor.execute(
                index, Query(calls), shards or [], translate=False)
            # post-execution gen summary: lets the coordinator key its
            # cross-node result-cache entries to the data this answer
            # was computed from
            trailer = {"execS": time.perf_counter() - t0,
                       "gens": list(gen_summary(cluster.holder, index))}
            # quarantined fragments answered as EMPTY: piggyback the
            # count so the coordinator's response says so
            # (utils/degraded.py, docs/robustness.md)
            nq = len(cluster.holder.quarantined_fragments(index))
            if nq:
                trailer["quarantined"] = nq
            # admission depth piggyback (parallel/routing.py): every
            # answered sub-query refreshes the coordinator's load view
            # of this node, like the gen summaries above
            trailer["load"] = cluster.local_load()
            # span summaries piggyback like the gen summaries: the
            # handler collected this request's finished spans (and its
            # own in-flight HTTP span) so the coordinator can adopt
            # them into one cluster-wide trace tree
            spans = getattr(req, "_span_collect", None)
            if spans is not None:
                spans = list(spans)
                hs = getattr(req, "_trace_span", None)
                if hs is not None and hs.sampled:
                    spans.append(hs.to_dict())
                trailer["spans"] = spans
            return res, trailer

        def internal_query(req, args):
            if req.headers.get("Content-Type", "").split(";")[0].strip() \
                    == qwire.CONTENT_TYPE:
                # PTPUQRY1 binary wire (docs/cluster.md "Internal query
                # wire").  A node pinned to internal-wire=json answers
                # 415 — the capability-mismatch signal the client's
                # negotiation downgrades on (it retries as JSON).
                from ..api import UnsupportedMediaTypeError
                if cluster.internal_wire != qwire.WIRE_BIN1:
                    raise UnsupportedMediaTypeError(
                        "internal query wire is pinned to json")
                try:
                    calls_wire, shards, nreq = qwire.decode_request(
                        req.body)
                except qwire.FrameError as e:
                    from ..api import ApiError
                    raise ApiError(f"bad query wire request: {e}")
                res, trailer = _exec_multi(req, args["index"],
                                           calls_wire, shards)
                payload, nresp = qwire.encode_response(res, trailer)
                if cluster.stats is not None:
                    cluster.stats.count("cluster.wire_bytes_rx",
                                        len(req.body))
                    cluster.stats.count("cluster.wire_bytes_tx",
                                        len(payload))
                    cluster.stats.count("cluster.wire_frames",
                                        nreq + nresp)
                return qwire.CONTENT_TYPE, payload
            body = req.json()
            shards = body.get("shards")
            if "calls" in body:
                res, trailer = _exec_multi(req, args["index"],
                                           body["calls"], shards)
                out = {"results": [result_to_wire(r) for r in res]}
                out.update(trailer)
                return out
            call = call_from_wire(body["call"])
            result = cluster._local_exec(args["index"], call, shards or [])
            return {"result": result_to_wire(result)}

        # gate="internal": admission rides the SEPARATE internal slot
        # pool so coordinator fan-out can never self-deadlock behind
        # public traffic (server/admission.py); the deadline header is
        # parsed by the handler and flows into the executor via the
        # current query context
        router.add("POST", "/internal/query/{index}", internal_query,
                   gate="internal")

        def cluster_message(req, args):
            cluster.handle_message(req.json())
            return {}

        router.add("POST", "/internal/cluster/message", cluster_message)

        def internal_import(req, args):
            body = req.json()
            if "views" in body:
                views = {k: base64.b64decode(v)
                         for k, v in body["views"].items()}
                cluster.api.apply_import_roaring_local(
                    args["index"], args["field"], int(body["shard"]),
                    views, body.get("clear", False))
            else:
                cluster.api.apply_import_local(args["index"], args["field"],
                                               body)
            return {}

        router.add("POST", "/internal/import/{index}/{field}",
                   internal_import)

        def internal_import_roaring(req, args):
            """Raw roaring blob, one view per POST (the binary forward
            half of the octet-stream import path; docs/ingest.md)."""
            view = req.query.get("view", ["standard"])[0]
            clear = req.query.get("clear", ["false"])[0] == "true"
            cluster.api.apply_import_roaring_local(
                args["index"], args["field"], int(args["shard"]),
                {view: req.body}, clear)
            return {}

        router.add("POST",
                   "/internal/import-roaring/{index}/{field}/{shard}",
                   internal_import_roaring)

        def internal_translate(req, args):
            """Coordinator-side key<->id service (http/translator.go)."""
            idx = cluster.holder.index(args["index"])
            if idx is None:
                raise ClusterError(f"index not found: {args['index']}")
            if "field" in args:
                f = idx.field(args["field"])
                if f is None:
                    raise ClusterError(f"field not found: {args['field']}")
                store = f.translate_store()
            else:
                store = idx.translate_store()
            body = req.json()
            if "keys" in body:
                return {"ids": store.translate_keys(body["keys"])}
            if "after" in body:
                # replica catch-up stream (holder.go:812; translate.go:82).
                # A missing/0 limit clamps to one page — the server, not
                # client politeness, enforces the pagination bound.
                limit = int(body.get("limit") or 0)
                page = RemoteTranslateStore.SYNC_PAGE
                limit = min(limit, page) if limit > 0 else page
                return {"entries": store.entries_from(
                    int(body["after"]), limit)}
            return {"keys": store.translate_ids(body.get("ids", []))}

        router.add("POST", "/internal/translate/{index}", internal_translate)
        router.add("POST", "/internal/translate/{index}/{field}",
                   internal_translate)

        def index_shards(req, args):
            idx = cluster.holder.index(args["index"])
            shards = sorted(idx.available_shards()) if idx else []
            return {"shards": shards}

        router.add("GET", "/internal/index/{index}/shards", index_shards)

