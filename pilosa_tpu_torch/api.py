"""API façade: every externally-reachable operation, validated against
cluster state (reference api.go:135-1330) — the port of the JAX
package's ``api.py``.

The HTTP layer wraps this and only this (http/handler.go:276 wraps *API);
nothing in the server package touches holder/executor directly.

With a ``cluster`` (parallel/cluster.py) the API gates methods on the
cluster state, runs queries through ``cluster.execute`` (the routed
fan-out), broadcasts schema changes, fans imports out to shard owners
and reports the node list, state, membership epoch and placement-overlay
epoch on ``/status``.

Deviations from the JAX module: ``device`` names the torch device the
executor runs on (None means ``cuda`` and raises without a card), and
there is no warm-start coordinator, so ``/status`` reports READY at
once, as a bare JAX ``API`` does.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from . import __version__
from .core import SHARD_WIDTH
from .executor import Executor
from .storage import FieldOptions, Holder
from .utils.locks import make_rlock
from .utils.stats import StatsClient

# Cluster states (cluster.go:47-50).
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"

# Which API methods are allowed in which states (api.go:99 validAPIMethods).
_DEGRADED_OK = {
    "Query", "Schema", "Status", "Version", "Info", "GetIndex", "GetIndexes",
    "ExportCSV", "ShardNodes", "Hosts",
}
# Queries keep serving during a resize like the reference (reads route by
# the pre-resize placement; old owners retain their fragments until the
# deferred holder cleaner runs after the membership switch).  WRITE calls
# inside a query are rejected by the cluster layer while RESIZING — data
# in flight between owners cannot accept mutations exactly-once.
_RESIZING_OK = {"Query", "Schema", "Status", "Version", "Info", "GetIndex",
                "GetIndexes", "ShardNodes", "Hosts", "ClusterMessage"}


class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class ConflictError(ApiError):
    pass


class DisallowedError(ApiError):
    """Method not allowed in current cluster state (api.go:119 validate)."""


class UnsupportedMediaTypeError(ApiError):
    """Request body format the handler does not accept — HTTP 415.  The
    capability-mismatch signal of internal query wire negotiation: a
    node pinned to internal-wire=json answers binary /internal/query
    POSTs with it, and the calling InternalClient downgrades that peer
    to the JSON wire (docs/cluster.md "Internal query wire")."""


class API:
    def __init__(self, holder: Holder, cluster=None, stats=None,
                 use_mesh: bool = True, device=None,
                 dispatch_batch: bool = True,
                 dispatch_batch_max: int = 32,
                 dispatch_batch_window_us: float = 200.0,
                 whole_query: bool = True,
                 whole_query_fallback: str = "legacy"):
        """``use_mesh=True`` (the default, config-gated by the server)
        executes served queries over stacked shard groups
        (parallel/stacked.py) — the production equivalent of the
        reference's worker pool + mapReduce (executor.go:80-110, 2455).
        ``device``: the torch device queries run on; None means ``cuda``
        and raises without a card (executor.resolve_device).  The
        ``dispatch_batch*`` and ``whole_query*`` arguments go to the
        Executor."""
        self.holder = holder
        self.cluster = cluster  # None = single-node
        self.stats = stats if stats is not None else StatsClient()
        self.executor = Executor(
            holder, device=device, stacked=use_mesh, stats=self.stats,
            dispatch_batch=dispatch_batch,
            dispatch_batch_max=dispatch_batch_max,
            dispatch_batch_window_us=dispatch_batch_window_us,
            whole_query=whole_query,
            whole_query_fallback=whole_query_fallback)
        self._lock = make_rlock("api-schema")

    # -- state validation (api.go:119) -------------------------------------

    def state(self) -> str:
        if self.cluster is None:
            return STATE_NORMAL
        return self.cluster.state

    def _validate(self, method: str):
        st = self.state()
        if st == STATE_NORMAL:
            return
        if st == STATE_DEGRADED and method in _DEGRADED_OK:
            return
        if st == STATE_RESIZING and method in _RESIZING_OK:
            return
        raise DisallowedError(
            f"api method {method} not allowed in state {st}")

    # -- query (api.go:135 Query) ------------------------------------------

    def query(self, index: str, query: str, shards=None,
              ctx=None) -> list[Any]:
        """``ctx``: optional QueryContext carrying the query's deadline
        (utils/deadline.py); defaults to the caller's active context (the
        HTTP handler installs one from ?timeout= / the deadline header /
        the query-timeout config default)."""
        self._validate("Query")
        if self.stats:
            self.stats.count("query", 1)
        from .utils.deadline import current
        if ctx is None:
            ctx = current()
        from .utils import profile as qprof
        from .utils.tracing import GLOBAL_TRACER
        with GLOBAL_TRACER.span("api.Query") as span:
            span.set_tag("index", index)
            prof = qprof.current()
            if prof is not None:
                # root tags of the EXPLAIN ANALYZE tree: the index and
                # the trace id the stages correlate to
                prof.tag("index", index)
                prof.tag("traceID", span.trace_id)
            if self.cluster is not None:
                return self.cluster.execute(index, query, shards, ctx=ctx)
            return self.executor.execute(index, query, shards, ctx=ctx)

    # -- DDL ---------------------------------------------------------------

    def _broadcast(self, msg: dict):
        """Schema changes propagate to every node synchronously
        (api.go:233 CreateField -> SendSync, broadcast.go:30)."""
        if self.cluster is not None:
            self.cluster.broadcast(msg)

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True):
        self._validate("CreateIndex")
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except FileExistsError as e:
            raise ConflictError(str(e))
        except ValueError as e:
            raise ApiError(str(e))
        self._broadcast({"type": "create-index", "index": name,
                         "keys": keys, "trackExistence": track_existence})
        return idx

    def delete_index(self, name: str):
        self._validate("DeleteIndex")
        try:
            self.holder.delete_index(name)
        except ValueError as e:
            raise NotFoundError(str(e))
        if self.cluster is not None:
            self.cluster.forget_index_shards(name)
        self._broadcast({"type": "delete-index", "index": name})

    def create_field(self, index: str, field: str,
                     options: dict | None = None):
        self._validate("CreateField")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            # from_dict validates cacheType/cacheSize (FieldOptions
            # __post_init__) — bad options must 400, not 500
            opts = FieldOptions.from_dict(options or {})
            f = idx.create_field(field, opts)
        except FileExistsError as e:
            raise ConflictError(str(e))
        except ValueError as e:
            raise ApiError(str(e))
        self._broadcast({"type": "create-field", "index": index,
                         "field": field, "options": options or {}})
        return f

    def delete_field(self, index: str, field: str):
        self._validate("DeleteField")
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(field)
        except ValueError as e:
            raise NotFoundError(str(e))
        self._broadcast({"type": "delete-field", "index": index,
                         "field": field})

    def schema(self) -> list[dict]:
        self._validate("Schema")
        return self.holder.schema()

    def apply_schema(self, schema: list[dict]):
        """POST /schema (http/handler.go handlePostSchema)."""
        self._validate("ApplySchema")
        for idx_def in schema:
            name = idx_def["name"]
            opts = idx_def.get("options", {})
            idx = self.holder.create_index_if_not_exists(
                name, keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True))
            self._broadcast({"type": "create-index", "index": name,
                             "keys": opts.get("keys", False),
                             "trackExistence": opts.get("trackExistence",
                                                        True)})
            for fdef in idx_def.get("fields", []):
                idx.create_field_if_not_exists(
                    fdef["name"], FieldOptions.from_dict(
                        fdef.get("options", {})))
                self._broadcast({"type": "create-field", "index": name,
                                 "field": fdef["name"],
                                 "options": fdef.get("options", {})})

    # -- import (api.go:920 Import / :1031 ImportValue / :368 ImportRoaring)

    def _translate_import_keys(self, idx, f, row_keys, column_keys,
                               row_ids, column_ids):
        """Key->id translation at the head of the import pipeline
        (api.go:926-961)."""
        if column_keys is not None:
            if not idx.keys:
                raise ApiError(
                    "columnKeys not allowed: index 'keys' option disabled")
            column_ids = idx.translate_store().translate_keys(column_keys)
        if row_keys is not None:
            if not f.options.keys:
                raise ApiError(
                    "rowKeys not allowed: field 'keys' option disabled")
            row_ids = f.translate_store().translate_keys(row_keys)
        return row_ids, column_ids

    def import_bits(self, index: str, field: str,
                    row_ids=None, column_ids=None, timestamps=None,
                    clear: bool = False, row_keys=None, column_keys=None):
        self._validate("Import")
        idx, f = self._index_field(index, field)
        row_ids, column_ids = self._translate_import_keys(
            idx, f, row_keys, column_keys, row_ids, column_ids)
        rows = np.asarray(row_ids or [], dtype=np.int64)
        cols = np.asarray(column_ids or [], dtype=np.int64)
        if rows.size != cols.size:
            raise ApiError("rowIDs and columnIDs length mismatch")
        if timestamps and len(timestamps) != cols.size:
            raise ApiError("timestamps length mismatch")
        if self.cluster is not None:
            # regroup by shard, forward each batch to its owners
            # (api.go:963-996)
            self.cluster.import_bits(index, field, rows, cols, timestamps,
                                     clear=clear)
            return
        self._import_bits_local(idx, f, rows, cols, timestamps, clear)

    @staticmethod
    def _import_bits_local(idx, f, rows, cols, timestamps, clear):
        ts = None
        if timestamps:
            from datetime import datetime, timezone
            ts = [None if t in (None, 0)
                  else datetime.fromtimestamp(t, timezone.utc)
                  .replace(tzinfo=None)
                  for t in timestamps]
        f.import_bits(rows, cols, ts, clear=clear)
        if not clear:
            idx.add_existence(cols)

    def import_values(self, index: str, field: str,
                      column_ids=None, values=None, clear: bool = False,
                      column_keys=None):
        self._validate("ImportValue")
        idx, f = self._index_field(index, field)
        _, column_ids = self._translate_import_keys(
            idx, f, None, column_keys, None, column_ids)
        cols = np.asarray(column_ids or [], dtype=np.int64)
        vals = np.asarray(values or [], dtype=np.int64)
        if not clear and cols.size != vals.size:
            raise ApiError("columnIDs and values length mismatch")
        if self.cluster is not None:
            self.cluster.import_values(index, field, cols, vals, clear=clear)
            return
        f.import_values(cols, vals, clear=clear)
        if not clear:
            idx.add_existence(cols)

    def apply_import_local(self, index: str, field: str, payload: dict):
        """Apply a forwarded (pre-grouped) import batch locally — the
        receive side of the cluster import fan-out; never re-forwards."""
        idx, f = self._index_field(index, field)
        if "values" in payload and payload.get("values") is not None:
            cols = np.asarray(payload.get("columnIDs") or [], dtype=np.int64)
            vals = np.asarray(payload["values"], dtype=np.int64)
            f.import_values(cols, vals, clear=payload.get("clear", False))
            if not payload.get("clear", False):
                idx.add_existence(cols)
            return
        rows = np.asarray(payload.get("rowIDs") or [], dtype=np.int64)
        cols = np.asarray(payload.get("columnIDs") or [], dtype=np.int64)
        if payload.get("clear", False) and "rowIDs" not in payload:
            f.import_values(cols, np.zeros(0, dtype=np.int64), clear=True)
            return
        self._import_bits_local(idx, f, rows, cols,
                                payload.get("timestamps"),
                                payload.get("clear", False))

    def check_ingest(self, index: str, field: str) -> str:
        """Validation head of the streaming ingest path (docs/ingest.md):
        cluster-state gate + index/field existence.  The committer
        applies records asynchronously, so unknown names must 404 at the
        socket before any frame is read, not at flush time.  Returns the
        field type so the handler can reject mismatched record types
        (values frames at a set field and vice versa) per frame."""
        self._validate("Import")
        _idx, f = self._index_field(index, field)
        return f.options.type

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool = False):
        """Import pre-serialized pilosa-roaring bitmaps, one per view
        (api.go:368 ImportRoaring)."""
        self._validate("ImportRoaring")
        if self.cluster is not None:
            self.cluster.import_roaring(index, field, shard, views, clear)
            return
        self.apply_import_roaring_local(index, field, shard, views, clear)

    def apply_import_roaring_local(self, index: str, field: str, shard: int,
                                   views: dict[str, bytes],
                                   clear: bool = False):
        idx, f = self._index_field(index, field)
        from .storage.roaring_io import unpack_roaring
        all_cols = []
        for view_name, data in views.items():
            if not view_name:
                view_name = "standard"
            rows, cols_local = unpack_roaring(data, self.holder.max_row_id)
            v = f._create_view_if_not_exists(view_name)
            frag = v.create_fragment_if_not_exists(shard)
            if clear:
                frag.bulk_import(rows, cols_local, clear=True)
            else:
                frag.bulk_import(rows, cols_local)
                if view_name == "standard":
                    all_cols.append(cols_local + shard * SHARD_WIDTH)
        if all_cols:
            idx.add_existence(np.unique(np.concatenate(all_cols)))

    def _index_field(self, index: str, field: str):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        return idx, f

    # -- export (api.go ExportCSV) -----------------------------------------

    def export_csv(self, index: str, field: str, shard: int) -> str:
        self._validate("ExportCSV")
        _, f = self._index_field(index, field)
        from .core import VIEW_STANDARD
        v = f.view(VIEW_STANDARD)
        frag = None if v is None else v.fragment(shard)
        if frag is None:
            return ""
        from .ops import bitset
        rows, cols = bitset.unpack_fragment(frag.words)
        offset = shard * SHARD_WIDTH
        return "".join(f"{r},{c + offset}\n" for r, c in zip(rows, cols))

    # -- info/status -------------------------------------------------------

    def status(self) -> dict:
        self._validate("Status")
        nodes = [{"id": "node0", "uri": "", "isCoordinator": True,
                  "state": "READY"}]
        state = STATE_NORMAL
        epoch = 0
        out = {}
        if self.cluster is not None:
            nodes = self.cluster.node_statuses()
            state = self.cluster.state
            epoch = self.cluster.epoch
            # per-index fragment-gen summaries ride the health probes so
            # peers' result caches see out-of-band writes within one
            # probe interval (cache/results.py gen_summary)
            from .cache.results import gen_summary
            out["dataGens"] = {
                name: list(gen_summary(self.holder, name))
                for name in list(self.holder.indexes)}
            # elastic-serving piggybacks (parallel/routing.py): admission
            # depth + per-shard residency tiers ride the health probes so
            # peers' read routers score this node without extra RPCs, and
            # the overlay epoch lets the coordinator re-push a missed
            # placement-overlay broadcast (docs/cluster.md)
            out["load"] = self.cluster.local_load()
            out["residency"] = self.cluster.residency_summary()
            out["overlayEpoch"] = self.cluster.overlay_epoch
            # internal-query wire capability advertisement: peers' probe
            # folds feed this to their InternalClient negotiation
            # (docs/cluster.md "Internal query wire")
            out["wire"] = self.cluster.wire_capabilities()
        out.update({"state": state, "nodes": nodes, "epoch": epoch,
                    "localID": nodes[0]["id"] if self.cluster is None
                    else self.cluster.node_id})
        # Storage health: quarantined fragments degrade this node (empty
        # reads + refused writes on those fragments) but do NOT take it
        # down — replica repair heals them while everything else serves.
        quarantined = self.holder.quarantined_fragments()
        out["storage"] = {
            "quarantinedFragments": len(quarantined),
            "degraded": bool(quarantined),
        }
        out["warming"] = False
        out["phase"] = "ready"
        return out

    def info(self) -> dict:
        self._validate("Info")
        return {"shardWidth": SHARD_WIDTH}

    def version(self) -> str:
        return __version__

    def max_shards(self) -> dict[str, int]:
        """(api.go MaxShards, /internal/shards/max).  Cluster-wide: a
        node answering for shards it doesn't own must still report them
        (the export CLI walks 0..max and routes each shard to an owner)."""
        if self.cluster is not None:
            return {name: max(self.cluster._available_shards(
                                  name, mark_down=False), default=0)
                    for name in list(self.holder.indexes)}
        return {name: max(idx.available_shards(), default=0)
                for name, idx in self.holder.indexes.items()}

    def shard_nodes(self, index: str, shard: int) -> list[dict]:
        self._validate("ShardNodes")
        if self.cluster is None:
            return [{"id": "node0", "uri": ""}]
        return self.cluster.shard_nodes_info(index, shard)

    def recalculate_caches(self):
        """(api.go RecalculateCaches): eagerly rebuild every fragment's
        rank cache so the next TopN doesn't pay the lazy rebuild.

        Rebuilds run as BACKGROUND work through the dispatch batcher
        (docs/batching.md): between fragments the loop yields while
        foreground tickets are queued, so a holder-wide recalculation
        can't starve live queries of the dispatcher (or the GIL) while
        it walks every fragment's sparse store."""
        self._validate("RecalculateCaches")
        from .cache.rank import iter_rank_caches
        from contextlib import nullcontext
        batcher = self.executor.batcher
        bg = batcher.background() if batcher is not None else nullcontext()
        with bg:
            for frag, cache in iter_rank_caches(self.holder):
                if batcher is not None:
                    batcher.yield_to_foreground()
                with frag._lock:
                    cache.build(frag)
        return None
