"""HTTP handler: the public + internal REST surface (reference
http/handler.go:276-314 route table).

Wraps only the API façade, like the reference (handler.go:60 Handler wraps
*pilosa.API).  stdlib ThreadingHTTPServer + a regex route table replaces
gorilla/mux; JSON replaces protobuf on the public surface (the reference
already speaks JSON for DDL and query responses; bulk imports also accept
the pilosa-roaring binary format for compatibility).

Port of the JAX package's ``server/handler.py``.  The router, the
request wrapper (body limits, admission gates, deadline and trace
headers, streaming routes) and the public routes are copied;
``/debug/vars`` and ``/metrics`` report the parts the port has (stats,
budgets, the capture registry and launch ledger with the kernel
wrappers' launch counts, the stack cache with its overlay and re-stage
counters, the ingest committer, the warm start, the time-series ring,
the SLO engine and flight recorder, the cluster's breakers, routing
state, placement overlay, balancer and anti-entropy health, and on the
coordinator's ``/metrics`` the fleet rollup's ``pilosa_tpu_cluster_*``
family).  The device-runtime routes are the JAX package's:
``/debug/compiles`` (captures stand where compiles stand,
utils/devobs.py), ``/debug/launches``, ``/debug/timeseries``,
``/debug/alerts``, ``POST /debug/bundle`` and the dashboards
``/debug/dashboard`` and ``/debug/dashboard/cluster``.
``/debug/cluster`` answers the fleet rollup (parallel/rollup.py), or
this node's own summary without a cluster.  With a cluster, the server
registers the cluster plane's node-to-node routes
(``/internal/query``, ``/internal/cluster/message``,
``/internal/import*``, ``/internal/translate*``,
``/internal/index/{index}/shards``, ``/internal/fragment/*``,
``/internal/attr/diff``) and the resize routes
(``/cluster/resize/add-node``, ``/cluster/resize/remove-node``), and
``/ingest`` forwards each record to its shard owners through
``/internal/ingest``.
"""

from __future__ import annotations

import json
import re
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .. import __version__
from ..api import API, ApiError, ConflictError, NotFoundError
from ..storage.fragment import FragmentQuarantinedError
from ..utils import degraded
from ..utils import explain as qexplain
from ..utils.locks import make_lock
from ..utils import profile as qprof
from ..utils import tenant as qtenant
from ..utils.deadline import (DEADLINE_HEADER, DeadlineExceeded,
                              QueryContext, activate)
from ..utils.tracing import (GLOBAL_TRACER, PROBE_HEADER, TRACE_HEADER,
                             parse_trace_header)
from ..executor import RowResult, ValCount, RowIdentifiers
from ..executor.results import GroupCount, Pair
from .admission import AdmissionRejected, decorrelated_retry_after


def _ingest_retry_after(req) -> float:
    """Computed Retry-After for ingest-side 503s: the ingest pool's
    pressure-scaled, jittered backoff (a fixed constant re-stampedes a
    synchronized client cohort); bare test handlers without a pool still
    get the jitter."""
    adm = getattr(req, "admission_ingest", None)
    if adm is not None:
        return adm.retry_after()
    return decorrelated_retry_after(1.0)


def serialize_result(r) -> object:
    """Query result -> JSON-able (reference http/response.go)."""
    if isinstance(r, RowResult):
        return r.to_dict()
    if isinstance(r, ValCount):
        return r.to_dict()
    if isinstance(r, RowIdentifiers):
        return r.to_dict()
    if isinstance(r, list):
        if r and isinstance(r[0], Pair):
            return [p.to_dict() for p in r]
        if r and isinstance(r[0], GroupCount):
            return [g.to_dict() for g in r]
        return [serialize_result(x) for x in r]
    return r


from contextlib import nullcontext as _nullcontext

_NULL_CTX = _nullcontext()


def _profile_shards(node: dict):
    """Best-effort shard count from a profile tree: the first stage
    tagged with one (the executor's dispatch stage, or a fan-out peer
    event on the coordinator)."""
    tags = node.get("tags") or {}
    if "shards" in tags:
        return tags["shards"]
    for c in node.get("children", ()):
        n = _profile_shards(c)
        if n is not None:
            return n
    return None


class ClientAbort(Exception):
    """The client went away mid-response (broken pipe / reset while
    writing).  Expected serving noise, not a server error: counted as
    ``http.client_abort`` and the connection is dropped quietly instead
    of spewing a traceback per disconnect (load-generator teardown
    produces them by the hundred)."""


class Router:
    """Method+regex route table.

    ``gate`` marks routes that run query execution and therefore pass
    admission control: "query" rides the public slot pool, "internal"
    rides the separate node-to-node pool (a coordinator holding a public
    slot fans out to peers whose internal handling must never queue
    behind their public traffic — otherwise concurrent coordinators
    could deadlock the cluster against itself); "ingest" rides a third
    pool so sustained writes can never starve reads of their slots
    (docs/ingest.md).

    ``stream`` routes read their body incrementally off the socket
    themselves (``req.rfile`` + ``req._stream_len``) — the handler never
    buffers it, so a multi-GB ingest stream costs one frame of memory."""

    def __init__(self):
        self.routes: list[tuple] = []

    def add(self, method: str, pattern: str, fn, gate: str | None = None,
            stream: bool = False):
        rx = re.compile("^" + re.sub(
            r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
        self.routes.append((method, rx, fn, gate, stream))

    def match(self, method: str, path: str):
        found_path = False
        for m, rx, fn, gate, stream in self.routes:
            mt = rx.match(path)
            if mt:
                found_path = True
                if m == method:
                    return fn, mt.groupdict(), gate, stream
        return ("method_not_allowed" if found_path else None), {}, \
            None, False


def build_debug_vars(api: API, server=None) -> dict:
    """The /debug/vars snapshot body (module-level, as in the JAX
    package, whose fleet rollup reuses it)."""
    from ..storage.membudget import DEFAULT_BUDGET, HOST_STAGE_BUDGET
    out = api.stats.snapshot()
    # deviceBudget carries the streaming-pipeline counters too:
    # uploadBytes / prefetchHits / prefetchMisses / pinnedBytes
    out["deviceBudget"] = DEFAULT_BUDGET.stats()
    out["hostStage"] = HOST_STAGE_BUDGET.stats()
    ex = api.executor
    if ex.result_cache is not None:
        out["resultCache"] = ex.result_cache.snapshot()
    if ex.prepared is not None:
        out["preparedCache"] = {
            "entries": len(ex.prepared._entries),
            "hits": ex.prepared.hits,
            "misses": ex.prepared.misses,
            "guardMisses": ex.prepared.guard_misses,
        }
    if ex.stacked is not None:
        # the stacked executor stands where the JAX package reads its
        # mesh executor; it has no compiled executables to count, but
        # counts stack stagings against ingest overlays
        out["stackCache"] = {
            "entries": len(ex.stacked._stack_cache),
            "builds": ex.stacked.stack_builds,
            "overlays": ex.stacked.overlays,
        }
    # cross-query dynamic batching: fused/single launch counters, the
    # batch-size histogram and the queue-wait p50/p99
    if ex.batcher is not None:
        out["dispatchBatcher"] = ex.batcher.snapshot()
    # whole-query programs: requests served as one program vs fallbacks
    # to the grouped path, with the last fallback's node
    if ex.wholequery is not None:
        out["wholeQuery"] = {
            "enabled": ex.whole_query,
            "requests": ex.wq_requests,
            "fallbacks": ex.wq_fallbacks,
            "lastFallback": ex.wq_last_fallback,
        }
    # overload armor: slot/queue state and armed failpoints (docs/robustness.md); deadline-abort and admission
    # rejection COUNTERS live in "counts" via the stats client
    if server is not None and getattr(server, "admission",
                                      None) is not None:
        out["admission"] = {
            "public": server.admission.snapshot(),
            "internal": server.admission_internal.snapshot(),
            "ingest": server.admission_ingest.snapshot(),
        }
    if server is not None and getattr(server, "cluster",
                                      None) is not None:
        # per-peer breakers; routing state (EWMA RTT, in-flight,
        # residency summary age), the placement overlay, and the
        # balancer's hot-shard view
        cl = server.cluster
        out["breakers"] = cl.client.breaker_snapshot()
        out["cluster"] = {
            "routing": cl.router.snapshot(),
            "overlay": cl.overlay_snapshot(),
            "balancer": cl.balancer.snapshot(),
        }
    # tenant isolation plane (docs/robustness.md "Tenant isolation"):
    # per-tenant qps/p50/p99/shed/hedge-denied/quota columns — the
    # registry is process-wide, so bare-API servers report it too
    tenants = qtenant.REGISTRY.snapshot()
    if tenants:
        out["tenants"] = tenants
    from ..utils.faults import FAULTS
    armed = FAULTS.snapshot()
    if armed:
        out["failpoints"] = armed
    slog = getattr(server, "slowlog", None) if server is not None \
        else None
    if slog is not None:
        out["slowLog"] = {"thresholdS": slog.threshold_s,
                          "size": slog.size,
                          "textMax": slog.text_max,
                          "recorded": slog.recorded}
    # event journal (docs/observability.md "Cluster plane"): counters
    # only — the timeline itself is /debug/events
    from ..utils.events import EVENTS
    out["events"] = {"seq": EVENTS.last_seq(), "emitted": EVENTS.emitted,
                     "writeErrors": EVENTS.write_errors}
    # durability & recovery (docs/robustness.md): quarantine state,
    # torn-tail/repair event counters, anti-entropy health
    from ..storage.fragment import storage_events
    container_stats = api.holder.container_stats()
    out["storage"] = {
        "events": storage_events(),
        "quarantined": api.holder.quarantined_fragments(),
        "corruptAttrStores": api.holder.corrupt_attr_stores(),
        # compressed residency (docs/memory-budget.md): per-holder
        # container-type histogram + device-form census; the
        # compressed/dense byte split rides deviceBudget above
        "containers": container_stats,
    }
    if server is not None:
        server.update_storage_gauges(container_stats=container_stats)
        if getattr(server, "cluster", None) is not None:
            out["storage"]["antiEntropy"] = server.cluster.ae_snapshot()
    # device runtime (docs/observability.md "Device runtime"): the
    # capture registry and launch-ledger aggregates, plus the kernel
    # wrappers' launch counts; full detail at /debug/compiles,
    # /debug/launches, /debug/timeseries
    from ..ops import kernels
    from ..utils import devobs
    out["device"] = {"device": str(ex.device),
                     "compiles": devobs.COMPILES.totals(),
                     "launches": devobs.LEDGER.aggregates(),
                     "kernelLaunches": dict(kernels.LAUNCHES)}
    if ex.wholequery is not None:
        out["device"]["graphs"] = ex.wholequery.snapshot()
    # warm start: phase, replay progress and capture seconds
    warm = getattr(server, "warmup", None) if server is not None else None
    if warm is not None:
        out["warmup"] = warm.status()
    # streaming ingest (docs/ingest.md): group-commit backlog, flush
    # counters, and the delta-overlay journal footprint
    committer = getattr(server, "committer", None) \
        if server is not None else None
    if committer is not None:
        out["ingest"] = committer.snapshot()
    ts = getattr(server, "timeseries", None) if server is not None \
        else None
    if ts is not None:
        snap_ts = ts.snapshot()
        out["timeseries"] = {
            k: snap_ts[k] for k in ("intervalS", "windowS",
                                    "capacity", "samplesTotal",
                                    "coveredS")}
    # SLOs & alerting: the compact active-alert table — folded into
    # /debug/cluster per node by the fleet rollup; the full lifecycle
    # view is /debug/alerts
    slo_eng = getattr(server, "slo", None) if server is not None \
        else None
    if slo_eng is not None:
        out["alerts"] = slo_eng.vars_summary()
    flightrec = getattr(server, "flightrec", None) if server is not None \
        else None
    if flightrec is not None:
        out["flightRecorder"] = flightrec.snapshot()
    return out


def build_router(api: API, server=None) -> Router:
    r = Router()

    # -- public (handler.go:276-300) --------------------------------------
    def home(req, args):
        return {"message": "pilosa-tpu " + __version__}

    r.add("GET", "/", home)
    r.add("GET", "/version", lambda req, a: {"version": api.version()})
    r.add("GET", "/info", lambda req, a: api.info())
    r.add("GET", "/status", lambda req, a: api.status())
    r.add("GET", "/schema", lambda req, a: {"indexes": api.schema()})

    def post_schema(req, args):
        api.apply_schema(req.json().get("indexes", []))
        return {}

    r.add("POST", "/schema", post_schema)

    def get_indexes(req, args):
        return {"indexes": api.schema()}

    r.add("GET", "/index", get_indexes)

    def get_index(req, args):
        for idx in api.schema():
            if idx["name"] == args["index"]:
                return idx
        raise NotFoundError(f"index not found: {args['index']}")

    r.add("GET", "/index/{index}", get_index)

    def post_index(req, args):
        body = req.json()
        opts = body.get("options", {})
        api.create_index(args["index"], keys=opts.get("keys", False),
                         track_existence=opts.get("trackExistence", True))
        return {}

    r.add("POST", "/index/{index}", post_index)

    def delete_index(req, args):
        api.delete_index(args["index"])
        return {}

    r.add("DELETE", "/index/{index}", delete_index)

    def post_field(req, args):
        body = req.json()
        api.create_field(args["index"], args["field"],
                         body.get("options", {}))
        return {}

    r.add("POST", "/index/{index}/field/{field}", post_field)

    def delete_field(req, args):
        api.delete_field(args["index"], args["field"])
        return {}

    r.add("DELETE", "/index/{index}/field/{field}", delete_field)

    def post_query(req, args):
        query = req.body.decode()
        shards = None
        if "shards" in req.query:
            shards = [int(s) for s in req.query["shards"][0].split(",")]
        # Partial-results opt-in (docs/robustness.md "Partial
        # results"): ?partialResults=true (or the partial-results
        # server default) lets a READ succeed when shards are truly
        # unservable — the degraded object below then names exactly the
        # missing shards, so partial can never masquerade as complete.
        # the per-request parameter wins in BOTH directions: an
        # explicit ?partialResults=false demands the loud failure even
        # on a partial-results=true deployment
        pq = req.query.get("partialResults", [None])[0]
        partial = (pq == "true") if pq is not None else req.partial_results
        # Degraded-state collection (utils/degraded.py): quarantined
        # fragments answer as EMPTY — the response must say so.  The
        # coordinator notes peer-reported counts during fan-out; the
        # local holder's count is added here.
        with degraded.collect(allow_partial=partial) as deg:
            results = api.query(args["index"], query, shards)
            degraded.note(
                len(api.holder.quarantined_fragments(args["index"])))
        out = {"results": [serialize_result(x) for x in results]}
        deg_out = degraded.to_response(deg)
        if deg_out is not None:
            out["degraded"] = deg_out
        # top-level ColumnAttrSets, deduplicated by column id across the
        # query's calls like the reference's single set
        # (http/response.go QueryResponse)
        col_attrs: dict = {}
        for r in results:
            for a in getattr(r, "column_attrs", []):
                col_attrs.setdefault(a.get("id"), a)
        if col_attrs:
            out["columnAttrs"] = list(col_attrs.values())
        return out

    r.add("POST", "/index/{index}/query", post_query, gate="query")

    def post_import(req, args):
        body = req.json()
        if "values" in body or (body.get("clear")
                                and "rowIDs" not in body
                                and "rowKeys" not in body):
            api.import_values(args["index"], args["field"],
                              body.get("columnIDs"), body.get("values"),
                              clear=body.get("clear", False),
                              column_keys=body.get("columnKeys"))
        else:
            api.import_bits(args["index"], args["field"],
                            body.get("rowIDs"), body.get("columnIDs"),
                            body.get("timestamps"),
                            clear=body.get("clear", False),
                            row_keys=body.get("rowKeys"),
                            column_keys=body.get("columnKeys"))
        return {}

    r.add("POST", "/index/{index}/field/{field}/import", post_import)

    def post_import_roaring(req, args):
        clear = req.query.get("clear", ["false"])[0] == "true"
        ctype = req.headers.get("Content-Type", "")
        # Content-Type sniff: the base64-JSON envelope stays for
        # compatibility, but a raw roaring body (it can never start with
        # "{" — the roaring cookie's low byte is 0x3A..0x3C) is imported
        # directly even under a lying JSON header, so no client is ever
        # forced through the 4/3 base64 blowup + JSON parse.
        is_json = ctype.startswith("application/json") and \
            req.body.lstrip()[:1] == b"{"
        if is_json:
            import base64
            body = req.json()
            views = {k: base64.b64decode(v)
                     for k, v in body.get("views", {}).items()}
        else:
            view = req.query.get("view", ["standard"])[0]
            views = {view: req.body}
        api.import_roaring(args["index"], args["field"],
                           int(args["shard"]), views, clear=clear)
        return {}

    r.add("POST", "/index/{index}/field/{field}/import-roaring/{shard}",
          post_import_roaring)

    # -- streaming ingest (docs/ingest.md) ---------------------------------

    def _ingest_stream(req, args, forward: bool):
        """Shared body of the public and /internal/ ingest routes: read
        binary frames incrementally off the socket, route records to
        shard owners (public only), group-commit local records, and ack
        only after the covering flush hit the WAL."""
        from ..ingest import wire
        from ..parallel.cluster import IngestBackpressure

        index, field = args["index"], args["field"]
        ftype = api.check_ingest(index, field)
        committer = getattr(server, "committer", None) \
            if server is not None else None
        if committer is None:
            raise ApiError("streaming ingest requires a running server")
        cluster = getattr(server, "cluster", None)
        from ..core import SHARD_WIDTH
        reader = wire.FrameReader(req.rfile.read, req._stream_len,
                                  max_frame_bytes=req.ingest_max_frame_bytes)
        frames = records = fwd_records = 0
        last_seq = 0
        # per-peer forward buffers: re-encoded frames accumulate until
        # FWD_FLUSH_BYTES, then ship as one /internal/ingest POST (the
        # peer acks after ITS group commit, so the ack chain holds
        # end-to-end)
        fwd: dict[str, list[bytes]] = {}
        fwd_bytes: dict[str, int] = {}
        FWD_FLUSH_BYTES = 1 << 20
        local_id = cluster.node_id if cluster is not None else None

        def submit(recs, rectype) -> None:
            nonlocal last_seq
            if rectype == wire.REC_VALS:
                last_seq = committer.submit(index, field,
                                            cols=recs["col"],
                                            values=recs["value"])
            else:
                ts = recs["ts"] if rectype == wire.REC_BITS_TS else None
                last_seq = committer.submit(index, field,
                                            rows=recs["row"],
                                            cols=recs["col"], ts=ts)

        def ship(host: str):
            payload = b"".join([wire.MAGIC] + fwd.pop(host))
            fwd_bytes.pop(host, None)
            try:
                cluster.client.ingest_frames(host, index, field, payload)
            except IngestBackpressure as e:
                # the owner's backlog is full: propagate the 503 so the
                # client backs off the whole stream (frames are
                # idempotent — resending is safe)
                raise AdmissionRejected(
                    str(e), retry_after=_ingest_retry_after(req))

        try:
            while True:
                # backpressure: a slow device merge keeps the committer
                # backlog high, which parks the socket read here and
                # eventually turns into a retryable 503
                if not committer.wait_capacity():
                    if req.stats is not None:
                        req.stats.count("ingest.rejected")
                    raise AdmissionRejected(
                        "ingest backlog over high-water; retry",
                        retry_after=_ingest_retry_after(req))
                item = reader.next_frame()
                if item is None:
                    break
                rectype, recs, nbytes = item
                # per-frame validation at the socket: the committer
                # applies asynchronously and shares a flush across
                # producers, so bad records must 400 HERE, not poison a
                # flush.  Negative ids are rejected outright — a
                # negative row would wrap through the device overlay
                # scatter into the wrong rows of resident state.
                if (rectype == wire.REC_VALS) != (ftype == "int"):
                    raise ApiError(
                        f"record type {rectype} does not match field "
                        f"type {ftype!r} (values frames require an int "
                        f"field, bit frames a non-int field)")
                if len(recs):
                    if int(recs["col"].min()) < 0:
                        raise ApiError("negative column id in ingest "
                                       "frame")
                    if rectype != wire.REC_VALS \
                            and int(recs["row"].min()) < 0:
                        raise ApiError("negative row id in ingest frame")
                    if rectype == wire.REC_BITS_TS \
                            and int(recs["ts"].min()) < 0:
                        raise ApiError("negative timestamp in ingest "
                                       "frame")
                frames += 1
                records += len(recs)
                if req.stats is not None:
                    req.stats.count("ingest.frames")
                    req.stats.count("ingest.records", len(recs))
                    req.stats.count("ingest.bytes", nbytes)
                if cluster is None or not forward:
                    submit(recs, rectype)
                    continue
                shards = recs["col"] // SHARD_WIDTH
                idx_obj = api.holder.index(index)
                f_obj = idx_obj.field(field) if idx_obj is not None \
                    else None
                by_node: dict[str, list[int]] = {}
                for s in np.unique(shards):
                    # overlay-aware owners: a balancer-added replica
                    # receives ingest writes like any other owner
                    for nid in cluster.shard_owner_nodes(index, int(s)):
                        by_node.setdefault(nid, []).append(int(s))
                cluster.note_peer_write(index, by_node)
                for nid, nshards in by_node.items():
                    sub = recs[np.isin(shards, nshards)]
                    if nid == local_id:
                        submit(sub, rectype)
                        continue
                    fwd_records += len(sub)
                    host = cluster.by_id[nid].host
                    payload = wire.encode_frame(bytes([rectype])
                                                + sub.tobytes())
                    fwd.setdefault(host, []).append(payload)
                    fwd_bytes[host] = fwd_bytes.get(host, 0) \
                        + len(payload)
                    if f_obj is not None:
                        f_obj.remote_available_shards.update(
                            s for s in nshards
                            if not cluster.owns_shard(local_id, index, s))
                    if fwd_bytes[host] >= FWD_FLUSH_BYTES:
                        ship(host)
            for host in list(fwd):
                ship(host)
        except Exception:
            # Drain a bounded amount of the unread stream first: closing
            # with unread receive data resets the connection, and the
            # RST would destroy the 400/503 response (and its
            # Retry-After) before the client reads it — the same
            # courtesy the 413 path extends.  The connection still
            # closes (mid-stream state cannot be resynced).
            remaining = min(reader.remaining, 64 << 20)
            while remaining > 0:
                chunk = req.rfile.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                remaining -= len(chunk)
            req.close_connection = True
            raise
        if last_seq and not committer.wait_flushed(last_seq):
            req.close_connection = True
            raise AdmissionRejected(
                "ingest flush did not complete in time; retry",
                retry_after=_ingest_retry_after(req))
        return {"frames": frames, "records": records,
                "forwarded": fwd_records}

    def post_ingest(req, args):
        return _ingest_stream(req, args, forward=True)

    r.add("POST", "/index/{index}/field/{field}/ingest", post_ingest,
          gate="ingest", stream=True)

    def post_ingest_internal(req, args):
        # receive side of the ingest forward: the sender already routed,
        # never re-forward
        return _ingest_stream(req, args, forward=False)

    r.add("POST", "/internal/ingest/{index}/{field}", post_ingest_internal,
          gate="ingest", stream=True)

    def get_export(req, args):
        index = req.query.get("index", [""])[0]
        field = req.query.get("field", [""])[0]
        shard = int(req.query.get("shard", ["0"])[0])
        return ("text/csv", api.export_csv(index, field, shard))

    r.add("GET", "/export", get_export)

    r.add("POST", "/recalculate-caches",
          lambda req, a: api.recalculate_caches() or {})

    def cache_clear(req, args):
        """Admin flush of the query cache subsystem (docs/caching.md):
        drops every result-cache entry and marks every rank cache for
        lazy rebuild.  Node-local, like the other /internal/ admin
        surfaces."""
        from ..cache.rank import iter_rank_caches
        out = {"resultEntries": 0, "rankCaches": 0}
        rc = api.executor.result_cache
        if rc is not None:
            out["resultEntries"] = rc.clear()
        n = 0
        for _frag, cache in iter_rank_caches(api.holder):
            cache.invalidate()
            n += 1
        out["rankCaches"] = n
        return out

    r.add("POST", "/internal/cache/clear", cache_clear)

    # -- observability (handler.go:280-282) -------------------------------
    def debug_vars(req, args):
        """expvar-style snapshot: stats + HBM budget + query-cache state,
        so perf work can attribute latency to phases."""
        return build_debug_vars(api, server)

    def metrics(req, args):
        if server is not None:
            # refresh the storage.* + device.* gauges so scrapes see
            # current values
            server.update_storage_gauges()
        # trace-id exemplars are OpenMetrics-only syntax: a classic
        # 0.0.4 parser rejects the `# {...}` suffix and the whole
        # scrape goes dark.  They attach ONLY on the explicit
        # `?exemplars=true` opt-in (docs/observability.md "Trace
        # exemplars") — deliberately NOT Accept-header negotiation:
        # stock Prometheus advertises application/openmetrics-text by
        # default, and answering it with this exposition (whose counter
        # names predate the OpenMetrics `_total` rule) would break the
        # default scrape that works today.
        exemplars = req.query.get("exemplars", [""])[0] == "true"
        text = api.stats.prometheus_text(exemplars=exemplars)
        # the batcher's and launch ledger's histogram/summary series
        # don't fit the stats client's counter/gauge model; they export
        # their own lines
        if api.executor.batcher is not None:
            text += api.executor.batcher.prometheus_text()
        from ..utils import devobs
        text += devobs.LEDGER.prometheus_text()
        # fleet rollup (docs/observability.md "Cluster plane"): the
        # pilosa_tpu_cluster_* family with node labels.  Exported by
        # the COORDINATOR's scrape only — every node exporting it would
        # ingest each series N times and turn a scrape-all-nodes setup
        # into N*(N-1) peer pulls per interval.  refresh() is
        # TTL-cached and never blocks on a dead peer, so the scrape
        # stays bounded.
        rollup = getattr(server, "rollup", None) if server is not None \
            else None
        if rollup is not None and server.cluster.is_coordinator:
            rollup.refresh()
            text += rollup.prometheus_text()
        if exemplars:
            return ("application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8", text + "# EOF\n")
        return ("text/plain; version=0.0.4", text)

    if api.stats is not None:
        r.add("GET", "/metrics", metrics)
        r.add("GET", "/debug/vars", debug_vars)

    def debug_traces(req, args):
        """Span ring (bounded retention).  ``?trace=<id>`` returns one
        trace's spans; ``?index=`` / ``?minMs=`` / ``?status=`` search
        ROOT spans and return trace summaries — the drill-down behind a
        histogram exemplar (docs/observability.md "Trace exemplars")."""
        from ..utils.tracing import GLOBAL_TRACER
        tid = req.query.get("trace", [None])[0]
        if tid is not None:
            return {"spans": GLOBAL_TRACER.spans(tid)}
        index = req.query.get("index", [None])[0]
        min_ms = req.query.get("minMs", [None])[0]
        status_q = req.query.get("status", [None])[0]
        if index is not None or min_ms is not None \
                or status_q is not None:
            try:
                min_s = float(min_ms) / 1e3 if min_ms is not None \
                    else None
                status_i = int(status_q) if status_q is not None else None
            except (TypeError, ValueError):
                raise ApiError("minMs/status must be numbers")
            return {"traces": GLOBAL_TRACER.search(
                index=index, min_duration_s=min_s, status=status_i)}
        return {"spans": GLOBAL_TRACER.spans(None)}

    r.add("GET", "/debug/traces", debug_traces)

    def debug_events(req, args):
        """Event journal (utils/events.py): ``?since=<seq>`` returns
        only newer events — the cursor the fleet rollup merges per-node
        journals with."""
        from ..utils.events import EVENTS
        since = req.query.get("since", [None])[0]
        limit = req.query.get("limit", [None])[0]
        try:
            since_i = int(since) if since is not None else None
            limit_i = int(limit) if limit is not None else None
        except (TypeError, ValueError):
            raise ApiError("since/limit must be integers")
        if since_i is None:
            out = EVENTS.snapshot()
            if limit_i is not None:
                # newest entries for the no-cursor browse form (the
                # cursor form below keeps oldest); guard limit=0 — a
                # [-0:] slice would return everything
                out["events"] = out["events"][-limit_i:] \
                    if limit_i > 0 else []
            return out
        return {"seq": EVENTS.last_seq(),
                "events": EVENTS.since(since_i, limit=limit_i)}

    r.add("GET", "/debug/events", debug_events)

    def debug_cluster(req, args):
        """Fleet rollup (docs/observability.md "Cluster plane"):
        per-node summaries with staleness stamps + the merged event
        timeline.  Single-node servers answer with their own summary so
        dashboards work unchanged."""
        rollup = getattr(server, "rollup", None) if server is not None \
            else None
        if rollup is None:
            from ..parallel.rollup import FleetRollup, summarize_vars
            from ..utils.events import EVENTS
            info = {"state": "READY", "stale": False, "qps": 0.0}
            info.update(summarize_vars(build_debug_vars(api, server)))
            # same top-level keys FleetRollup.snapshot() emits
            # lint: allow(wall-clock) — display-only snapshot stamp,
            # never subtracted (mirrors FleetRollup._wall_stamp)
            return {"wall": time.time(), "ttlS": FleetRollup.TTL_S,
                    "refreshes": 0, "fetchErrors": 0,
                    "coordinator": "local", "overlayEpoch": 0,
                    "epoch": 0, "nodes": {"local": info},
                    "timeline": EVENTS.since(0), "hotShards": {}}
        rollup.refresh(
            force=req.query.get("refresh", [""])[0] == "true")
        return rollup.snapshot()

    r.add("GET", "/debug/cluster", debug_cluster)

    def debug_slow(req, args):
        """Slow-query log ring (docs/observability.md): queries that ran
        past slow-query-threshold, newest last, each with its trace id
        and profile tree for drill-down via /debug/traces."""
        slog = getattr(server, "slowlog", None) if server is not None \
            else None
        if slog is None:
            return {"thresholdS": 0, "entries": []}
        return slog.snapshot()

    r.add("GET", "/debug/slow", debug_slow)

    def debug_locks(req, args):
        """Lock-order race detector dump (docs/static-analysis.md):
        the acquisition-order graph over named lock classes plus any
        order-inversion/same-class-nesting violations.  Populated only
        when the process runs with PILOSA_TPU_LOCKCHECK set; unarmed it
        reports armed=false with empty tables."""
        from ..utils import locks
        return locks.report()

    r.add("GET", "/debug/locks", debug_locks)

    # -- device runtime (docs/observability.md "Device runtime") -----------

    def debug_compiles(req, args):
        """Capture registry: per-signature CUDA graph captures, capture
        wall time, last shape fingerprint and retraces (the rule is in
        utils/devobs.py)."""
        from ..utils import devobs
        return devobs.COMPILES.snapshot()

    r.add("GET", "/debug/compiles", debug_compiles)

    def debug_launches(req, args):
        """Launch ledger: the ring of recent device launches (padding,
        decode bytes, queue-vs-dispatch split, slice position) plus its
        lifetime aggregates."""
        from ..utils import devobs
        return devobs.LEDGER.snapshot()

    r.add("GET", "/debug/launches", debug_launches)

    def debug_timeseries(req, args):
        """In-process time-series ring (utils/timeseries.py): the last
        timeseries-window seconds of runtime samples."""
        ts = getattr(server, "timeseries", None) if server is not None \
            else None
        if ts is None:
            return {"intervalS": 0, "windowS": 0, "capacity": 0,
                    "samplesTotal": 0, "coveredS": 0, "samples": []}
        return ts.snapshot()

    r.add("GET", "/debug/timeseries", debug_timeseries)

    # -- SLOs & alerting (docs/observability.md "SLOs & alerting") ---------

    def debug_alerts(req, args):
        """SLO engine state (utils/slo.py): objectives, burn-rate
        windows, the active-alert table with durations, recent
        fire/resolve transitions, and the evaluated rule list — plus
        the flight recorder's capture accounting."""
        slo_eng = getattr(server, "slo", None) if server is not None \
            else None
        if slo_eng is None:
            out = {"enabled": False, "active": {}, "history": [],
                   "rules": [], "evaluations": 0, "firedTotal": 0,
                   "resolvedTotal": 0}
        else:
            out = slo_eng.snapshot()
        flightrec = getattr(server, "flightrec", None) \
            if server is not None else None
        if flightrec is not None:
            out["flightRecorder"] = flightrec.snapshot()
        return out

    r.add("GET", "/debug/alerts", debug_alerts)

    def debug_bundle(req, args):
        """On-demand flight-recorder capture (CLI ``bundle``): snapshots
        every debug surface into one JSON bundle on disk.  Bypasses the
        on-fire rate limit — an operator asking twice wants two
        bundles."""
        if server is None or getattr(server, "flightrec", None) is None:
            raise ApiError(
                "flight recorder disabled (flight-recorder-mb = 0)")
        reason = req.json().get("reason", "manual")
        if not isinstance(reason, str):
            raise ApiError("reason must be a string")
        path = server.capture_bundle(reason, force=True)
        if path is None:
            raise ApiError("bundle capture failed (see server log)")
        return {"path": path, "last": server.flightrec.last}

    r.add("POST", "/debug/bundle", debug_bundle)

    def debug_dashboard(req, args):
        from .dashboard import DASHBOARD_HTML
        return ("text/html; charset=utf-8", DASHBOARD_HTML)

    r.add("GET", "/debug/dashboard", debug_dashboard)

    def debug_dashboard_cluster(req, args):
        """Fleet page: per-node table + merged timeline rendered from
        /debug/cluster (docs/observability.md "Cluster plane")."""
        from .dashboard import CLUSTER_DASHBOARD_HTML
        return ("text/html; charset=utf-8", CLUSTER_DASHBOARD_HTML)

    r.add("GET", "/debug/dashboard/cluster", debug_dashboard_cluster)

    # -- pprof-style profiling (handler.go:280 /debug/pprof) ---------------

    def pprof_threads(req, args):
        """All-thread stack dump — the goroutine-profile analog."""
        import sys
        import traceback
        names = {t.ident: t.name for t in __import__("threading").enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"thread {tid} ({names.get(tid, '?')}):\n"
                       + "".join(traceback.format_stack(frame)))
        return ("text/plain", "\n".join(out))

    r.add("GET", "/debug/pprof/threads", pprof_threads)

    import threading as _threading
    profile_lock = make_lock("pprof-profile")

    def pprof_profile(req, args):
        """Sampling CPU profile: aggregate all-thread stacks at ~100 Hz
        for ?seconds=N (default 2, clamped to [0.1, 30]); returns
        collapsed stacks in flamegraph-folded text (one
        `frame;frame;frame count` per line).  One profile at a time —
        concurrent requests would each busy-sample every stack and
        multiply the overhead on a serving node."""
        import sys
        import time as _time
        try:
            seconds = float(req.query.get("seconds", ["2"])[0])
        except (TypeError, ValueError):
            raise ApiError("seconds must be a number")
        seconds = min(max(seconds, 0.1), 30.0)
        if not profile_lock.acquire(blocking=False):
            raise ConflictError("a profile is already running")
        interval = 0.01
        try:
            counts: dict = {}
            me = _threading.get_ident()
            deadline = _time.perf_counter() + seconds
            while _time.perf_counter() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    f = frame
                    while f is not None:
                        code = f.f_code
                        stack.append(
                            f"{code.co_name} "
                            f"({code.co_filename.rsplit('/', 1)[-1]}"
                            f":{f.f_lineno})")
                        f = f.f_back
                    key = ";".join(reversed(stack))
                    counts[key] = counts.get(key, 0) + 1
                _time.sleep(interval)
            lines = [f"{k} {v}" for k, v in
                     sorted(counts.items(), key=lambda kv: -kv[1])]
            return ("text/plain", "\n".join(lines))
        finally:
            profile_lock.release()

    r.add("GET", "/debug/pprof/profile", pprof_profile)

    # -- internal (handler.go:302-314) ------------------------------------
    r.add("GET", "/internal/shards/max",
          lambda req, a: {"standard": api.max_shards()})

    def fragment_nodes(req, args):
        index = req.query.get("index", [""])[0]
        shard = int(req.query.get("shard", ["0"])[0])
        return api.shard_nodes(index, shard)

    r.add("GET", "/internal/fragment/nodes", fragment_nodes)

    # the cluster plane's node-to-node routes (parallel/cluster.py
    # register_routes)
    if server is not None:
        server.register_internal_routes(r)

    return r


class _HandlerClass(BaseHTTPRequestHandler):
    router: Router = None
    protocol_version = "HTTP/1.1"
    # Socket read timeout: an idle keep-alive connection (or a client
    # that opens a socket and sends nothing) must not pin a handler
    # thread forever; pooled internal clients reconnect transparently
    # on a closed stale socket (InternalClient stale-retry).
    timeout = 120
    # Request-body ceiling: bounds a hostile/buggy client's ability to
    # allocate host memory with one POST (bulk imports of a dense shard
    # legitimately run to hundreds of MB, hence the generous default).
    # <= 0 means unlimited, matching device-budget-mb's 0 convention.
    max_body_bytes: int = 1 << 30
    # Optional higher — but still bounded — ceiling for /internal/
    # routes (max-body-internal-mb): the node-to-node plane (roaring
    # import fan-out, resize fragment copies) can legitimately ship
    # payloads beyond the public cap.  0 (the default) inherits the
    # public ceiling: the path prefix alone is NOT authentication, so a
    # bigger internal ceiling is OPT-IN and belongs behind mutual TLS —
    # an unauthenticated default exemption would re-open the
    # memory-exhaustion hole the public cap closes.
    max_body_bytes_internal: int = 0
    # Overload armor (docs/robustness.md).  admission/admission_internal:
    # AdmissionController slot pools for gate="query"/"internal" routes
    # (None = ungated).  default_query_timeout: seconds applied to public
    # queries that carry no explicit ?timeout=; 0 = unlimited.  stats:
    # StatsClient for the 503/504 counters.
    admission = None
    admission_internal = None
    # Streaming ingest (docs/ingest.md): its own slot pool (writes must
    # not starve reads or the /internal/ plane) and the per-frame byte
    # ceiling (ingest-max-frame-mb).
    admission_ingest = None
    ingest_max_frame_bytes: int = 32 << 20
    default_query_timeout: float = 0.0
    # Partial-results server default (docs/robustness.md "Partial
    # results"): when true, every public query behaves as if it carried
    # ?partialResults=true.  Off by default — losing shards should fail
    # loudly unless the deployment explicitly prefers availability.
    partial_results: bool = False
    stats = None
    # Observability (docs/observability.md).  slowlog: SlowQueryLog ring
    # capturing queries past slow-query-threshold (None = off).
    # profile_default: return the stage-timing tree on every query even
    # without ?profile=true.
    slowlog = None
    profile_default: bool = False

    # request helpers
    def json(self):
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid JSON body: {e}")

    @property
    def query(self):
        return self._query

    def _handle(self, method: str):
        parsed = urlparse(self.path)
        self._query = parse_qs(parsed.query)
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            # any body bytes in flight would desync the keep-alive
            # stream (the next "request line" would be body garbage)
            self.close_connection = True
            self._send(400, {"error": "invalid Content-Length"})
            return
        fn, args, gate, stream = self.router.match(method, parsed.path)
        stream = stream and not isinstance(fn, str) and fn is not None
        if stream:
            # streaming route (ingest): the handler fn reads frames
            # incrementally off the socket itself — the whole-body
            # ceiling doesn't apply (per-frame bounds do, wire.py); the
            # fn closes the connection on any mid-stream failure rather
            # than trying to resync the keep-alive stream
            self.body = b""
            self._stream_len = length
        else:
            # /internal/ routes trade the public ceiling for the
            # (bounded) internal one — see max_body_bytes_internal above
            # (docs/configuration.md max-body-mb)
            limit = self.max_body_bytes
            if limit > 0 and parsed.path.startswith("/internal/"):
                # 0 on the internal knob = same ceiling as the public
                # surface
                if self.max_body_bytes_internal > 0:
                    limit = max(limit, self.max_body_bytes_internal)
            if 0 < limit < length:
                # answer 413, then drain a bounded amount of the
                # in-flight body so the client sees the response instead
                # of an RST (closing with unread receive data resets the
                # connection); bodies beyond the drain cap close hard
                # anyway
                self._send(413, {"error": f"request body {length} bytes "
                                 f"exceeds limit {limit}"})
                self.close_connection = True
                remaining = min(length, 64 << 20)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                return
            self.body = self.rfile.read(length) if length > 0 else b""
        # handler.go:231 extract — the header carries
        # trace_id:parent_span_id[:0], so a remote hop's spans parent
        # under the coordinator's rpc span (docs/observability.md)
        tid, parent_id, sampled = parse_trace_header(
            self.headers.get(TRACE_HEADER))
        # Probe/background tagging: health probes (wire-tagged by
        # InternalClient) and the status/metrics/debug surfaces never
        # reach the latency histograms or the slow-query log — background
        # cadence must not pollute p99.
        background = (self.headers.get(PROBE_HEADER) is not None
                      or parsed.path in ("/status", "/metrics")
                      or parsed.path.startswith("/debug/"))
        ctx = None
        status = 200
        prof = None
        erec = None
        self._tenant = None
        want_profile = False
        want_explain = False
        trace_out = None
        t_req0 = time.perf_counter()
        try:
            if fn is None:
                status = 404
                self._send(404, {"error": f"path not found: {parsed.path}"})
                return
            if fn == "method_not_allowed":
                status = 405
                self._send(405, {"error": "method not allowed"})
                return
            # Deadline: an internal hop's header (the coordinator's
            # REMAINING budget) > explicit ?timeout= > the configured
            # query-timeout default for public queries.  <= 0 disables.
            budget = None
            try:
                hdr = self.headers.get(DEADLINE_HEADER)
                if hdr is not None:
                    budget = float(hdr)
                elif "timeout" in self._query:
                    budget = float(self._query["timeout"][0])
            except (TypeError, ValueError):
                raise ApiError(
                    "timeout/deadline must be a number of seconds")
            if budget is None and gate == "query" \
                    and self.default_query_timeout > 0:
                budget = self.default_query_timeout
            if budget is not None and budget > 0:
                ctx = QueryContext(budget)
            # Per-query profile (utils/profile.py): collected when the
            # client asked for one (?profile=true / profile-default) OR
            # the slow-query log is on (slow entries carry the tree);
            # embedded in the response only when requested.
            if gate == "query":
                want_profile = (self._query.get("profile", [""])[0]
                                == "true" or self.profile_default)
                # EXPLAIN (utils/explain.py): the decision record rides
                # the same collection discipline as the profile —
                # assembled when the client asked (?explain=true) OR
                # silently for slow-log entries; embedded only when
                # requested.  Explain implies profile collection: the
                # launches section reads the profile tree.
                want_explain = self._query.get("explain", [""])[0] \
                    == "true"
                slow_on = (self.slowlog is not None
                           and self.slowlog.enabled)
                if want_profile or want_explain or slow_on:
                    prof = qprof.QueryProfile()
                if want_explain or slow_on:
                    erec = qexplain.ExplainRecord()
            # Tenant identity (docs/robustness.md "Tenant isolation"):
            # derived for every GATED route — index name by default,
            # explicit X-Pilosa-Tpu-Tenant token override.  A malformed
            # token is a TenantError (ValueError) -> clean 400 below,
            # BEFORE any admission/stat carries the garbage as a label.
            tenant = None
            tenant_explicit = False
            if gate is not None:
                tenant, tenant_explicit = qtenant.derive(
                    self.headers.get(qtenant.TENANT_HEADER),
                    args.get("index"))
                self._tenant = tenant
            adm = self.admission if gate == "query" else \
                self.admission_internal if gate == "internal" else \
                self.admission_ingest if gate == "ingest" else None
            admitted = False
            with qtenant.activate(tenant, tenant_explicit):
                if adm is not None:
                    # slot wait is the first profile stage: under
                    # overload it IS the latency story
                    with (prof.stage("admission") if prof is not None
                          else _NULL_CTX):
                        # raises AdmissionRejected -> 503
                        waited = adm.acquire(tenant=tenant)
                    admitted = True
                    if erec is not None:
                        # EXPLAIN names the tenant queue the query
                        # waited in and for how long
                        erec.note("admission", {
                            "tenant": tenant, "pool": adm.name,
                            "queuedMs": round(waited * 1e3, 3)})
                try:
                    # /internal/ continuations collect this request's
                    # finished spans so /internal/query can piggyback
                    # them back to the coordinator (cluster.py reads
                    # these attrs)
                    collect = [] if (tid is not None
                                     and parsed.path.startswith(
                                         "/internal/")) \
                        else None
                    with activate(ctx):
                        if ctx is not None:
                            ctx.check("admission")
                        # background requests with no inbound trace must
                        # not root new sampled traces: probe cadence x
                        # peers would continuously evict real query
                        # traces from the bounded span ring
                        root_sampled = sampled if tid is not None \
                            else (False if background else None)
                        with GLOBAL_TRACER.span(
                                f"{method} {parsed.path}", trace_id=tid,
                                parent_id=parent_id, sampled=root_sampled,
                                collect=collect) as span, \
                                qprof.activate(prof), \
                                qexplain.activate(erec):
                            self._trace_span = span
                            self._span_collect = collect
                            trace_out = span.trace_id
                            if "index" in args:
                                # searchable root-span tags:
                                # /debug/traces?index=... filters on them
                                span.set_tag("index", args["index"])
                            out = fn(self, args)
                finally:
                    if admitted:
                        adm.release()
            if isinstance(out, tuple):
                ctype, payload = out
                self._send_raw(200, ctype, payload.encode()
                               if isinstance(payload, str) else payload)
            else:
                resp_headers = None
                if gate == "query" and trace_out is not None:
                    # echo the trace id so any client can jump straight
                    # to /debug/traces?trace=<id>
                    resp_headers = {TRACE_HEADER: trace_out}
                if want_profile and prof is not None:
                    prof.finish()
                    out = dict(out)
                    out["traceID"] = trace_out
                    out["profile"] = prof.to_dict()
                if want_explain and erec is not None:
                    # the record rides the response ENVELOPE: results
                    # stay byte-identical with explain on
                    erec.set_info("traceID", trace_out)
                    out = dict(out)
                    out["explain"] = erec.to_dict(
                        profile=prof.to_dict() if prof is not None
                        else None)
                self._send(200, out, headers=resp_headers)
        except AdmissionRejected as e:
            # overload/drain rejection: bounded, explicit, retryable
            status = 503
            self._send(503, {"error": str(e)},
                       headers={"Retry-After": str(e.retry_after)})
        except DeadlineExceeded as e:
            status = 504
            if self.stats is not None:
                self.stats.count("query.deadline_abort")
            body = {"error": str(e)}
            if ctx is not None:
                body["elapsedS"] = round(ctx.elapsed(), 4)
                body["budgetS"] = ctx.budget
            self._send(504, body)
        except FragmentQuarantinedError as e:
            # write refused on a quarantined fragment: RETRYABLE —
            # replica repair restores it on the repair-interval cadence
            status = 503
            if self.stats is not None:
                self.stats.count("storage.write_refused")
            self._send(503, {"error": str(e), "retryable": True},
                       headers={"Retry-After": "30"})
        except NotFoundError as e:
            status = 404
            self._send(404, {"error": str(e)})
        except ConflictError as e:
            status = 409
            self._send(409, {"error": str(e)})
        except ClientAbort:
            # the client hung up mid-response: already counted, nothing
            # left to send — just let the connection close
            status = 499
        except (ApiError, ValueError) as e:
            status = 400
            self._send(400, {"error": str(e)})
        except Exception as e:  # panic guard (handler.go:325 recover)
            status = 500
            traceback.print_exc()
            self._send(500, {"error": f"internal error: {e}"})
        finally:
            self._observe(gate, args, time.perf_counter() - t_req0,
                          status, background, prof, erec, trace_out)

    def _observe(self, gate, args, dur_s, status, background, prof,
                 erec, trace_id):
        """Post-request accounting (docs/observability.md): latency
        histograms (with the trace id attached as the landing bucket's
        exemplar) + the slow-query log.  Background traffic (probes,
        status/metrics/debug) was tagged by the caller and is excluded
        from both."""
        # status stamped post-finish onto the root span: the ring holds
        # Span objects and renders tags lazily, so /debug/traces search
        # by status sees it
        sp = getattr(self, "_trace_span", None)
        if sp is not None and trace_id is not None:
            sp.tags["status"] = status
        if background:
            return
        # exemplars must RESOLVE at /debug/traces — only sampled traces
        # qualify (docs/observability.md "Trace exemplars")
        exemplar = trace_id if (sp is not None and sp.sampled
                                and trace_id is not None) else None
        if self.stats is not None:
            self.stats.timing("http.request", dur_s, exemplar=exemplar)
            if gate == "query":
                self.stats.timing("http.query", dur_s, exemplar=exemplar)
                if status >= 500:
                    # availability SLO numerator (utils/slo.py): 5xx
                    # query responses, sheds and deadline aborts
                    # included — the client saw a failure either way
                    self.stats.count("http.query_5xx")
        # per-tenant accounting: latency/qps/error columns for the
        # /debug/vars "tenants" table and the fleet rollup
        tenant = getattr(self, "_tenant", None)
        if tenant is not None and gate == "query":
            qtenant.REGISTRY.note_request(tenant, dur_s, status)
            if self.stats is not None:
                self.stats.timing(f"tenant.{tenant}.query", dur_s)
        slog = self.slowlog
        if (gate == "query" and slog is not None and slog.enabled
                and dur_s >= slog.threshold_s):
            profile = shards = None
            if prof is not None:
                prof.finish()
                profile = prof.to_dict()
                shards = _profile_shards(profile)
            slog.record(index=args.get("index", ""),
                        query=self.body.decode("utf-8", "replace"),
                        duration_s=dur_s, shards=shards,
                        trace_id=trace_id, status=status, profile=profile,
                        explain=erec.to_dict(profile=profile)
                        if erec is not None else None)

    def _send(self, code: int, obj, headers: dict | None = None):
        self._send_raw(code, "application/json",
                       (json.dumps(obj) + "\n").encode(), headers)

    def _send_raw(self, code: int, ctype: str, payload: bytes,
                  headers: dict | None = None):
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            if headers:
                for k, v in headers.items():
                    self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError,
                TimeoutError) as e:
            # client disconnected mid-write: a stat, not a stack trace
            if self.stats is not None:
                self.stats.count("http.client_abort")
            self.close_connection = True
            raise ClientAbort(str(e)) from e

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")

    def log_message(self, fmt, *args):  # quiet by default
        pass


class TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose live connections can be severed.

    ``shutdown()`` only stops the accept loop: per-connection handler
    threads stay parked on keep-alive reads and keep serving the CLOSED
    server's object graph.  After a same-port restart, a peer's pooled
    internal-client connection would then write into the dead holder —
    the write reports success and vanishes.
    ``close_connections()`` severs every tracked socket so those threads
    exit and clients reconnect to the live server.

    The listen backlog holds a burst of clients that connect together:
    at socketserver's default of 5, 16 client processes connecting at
    once had connections reset."""

    request_queue_size = 128

    def server_bind(self):
        self._conns: set = set()
        self._conns_lock = make_lock("server-conns")
        super().server_bind()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address):
        # disconnect-while-reading surfaces here (the write path maps to
        # ClientAbort inside the handler): expected client churn, not a
        # traceback per dropped connection
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError, ClientAbort)):
            return
        super().handle_error(request, client_address)

    def close_connections(self):
        import socket as _socket
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass


def make_http_server(api: API, host: str = "localhost", port: int = 10101,
                     server=None, tls=None,
                     max_body_bytes: int | None = None,
                     max_body_bytes_internal: int | None = None,
                     admission=None, admission_internal=None,
                     admission_ingest=None,
                     ingest_max_frame_bytes: int | None = None,
                     default_query_timeout: float | None = None,
                     partial_results: bool | None = None,
                     slowlog=None, profile_default: bool | None = None,
                     ) -> ThreadingHTTPServer:
    """``tls``: optional (certificate, key, ca_certificate|None) paths —
    serves HTTPS, requiring client certificates (mutual TLS) when a CA is
    given (reference server/tlsconfig.go, server/server.go GetTLSConfig).

    ``admission``/``admission_internal``: AdmissionController pools for
    the public and node-to-node query routes; ``default_query_timeout``:
    deadline applied to public queries without an explicit ?timeout=."""
    router = build_router(api, server)
    attrs = {"router": router, "stats": api.stats}
    if max_body_bytes is not None:
        attrs["max_body_bytes"] = max_body_bytes
    if max_body_bytes_internal is not None:
        attrs["max_body_bytes_internal"] = max_body_bytes_internal
    if admission is not None:
        attrs["admission"] = admission
    if admission_internal is not None:
        attrs["admission_internal"] = admission_internal
    if admission_ingest is not None:
        attrs["admission_ingest"] = admission_ingest
    if ingest_max_frame_bytes is not None:
        attrs["ingest_max_frame_bytes"] = ingest_max_frame_bytes
    if default_query_timeout is not None:
        attrs["default_query_timeout"] = default_query_timeout
    if partial_results is not None:
        attrs["partial_results"] = partial_results
    if slowlog is not None:
        attrs["slowlog"] = slowlog
    if profile_default is not None:
        attrs["profile_default"] = profile_default
    cls = type("Handler", (_HandlerClass,), attrs)
    if tls is None:
        return TrackingHTTPServer((host, port), cls)
    import ssl
    cert, key, ca = tls
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    if ca:
        ctx.load_verify_locations(ca)
        ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS

    class _TLSServer(TrackingHTTPServer):
        """Per-connection TLS: the handshake runs in the HANDLER thread
        (finish_request), never the accept loop — a stalled or plain-TCP
        client must not block every other connection."""

        def finish_request(self, request, client_address):
            request.settimeout(30)  # bound the handshake
            tls_sock = ctx.wrap_socket(request, server_side=True)
            try:
                tls_sock.settimeout(None)
                super().finish_request(tls_sock, client_address)
            finally:
                # shutdown_request later runs on the detached raw socket;
                # close the SSLSocket here so the fd and TLS state are
                # released deterministically, not on refcount GC
                try:
                    tls_sock.close()
                except OSError:
                    pass

        def handle_error(self, request, client_address):
            # handshake failures (port scans, cert-less clients) are
            # expected noise, not tracebacks
            import sys
            exc = sys.exc_info()[1]
            if not isinstance(exc, (ssl.SSLError, OSError)):
                super().handle_error(request, client_address)

    return _TLSServer((host, port), cls)
