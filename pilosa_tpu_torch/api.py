"""API façade: every externally-reachable operation (reference
api.go:135-1330) — the port of the JAX package's ``api.py`` for one node.

The HTTP layer wraps this and only this (http/handler.go:276 wraps *API);
nothing in the server package touches holder/executor directly.

Deviations from the JAX module: single-node only.  The JAX API's
``cluster`` mode (state validation against cluster states, broadcasts of
schema changes, import fan-out to shard owners, cluster status fields)
waits for the port's cluster plane, so the cluster-state gate is gone
(a lone node is always NORMAL) and the forwarded-import entry points
(``apply_import_local``) are folded into the local ones.  There is no
warm-start coordinator: ``/status`` reports READY at once, as a bare JAX
``API`` does.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from . import __version__
from .core import SHARD_WIDTH, VIEW_STANDARD
from .executor import Executor
from .storage import FieldOptions, Holder
from .utils.stats import StatsClient

STATE_NORMAL = "NORMAL"


class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class ConflictError(ApiError):
    pass


class API:
    def __init__(self, holder: Holder, stats=None, use_mesh: bool = True,
                 device=None, dispatch_batch: bool = True,
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
        self.stats = stats if stats is not None else StatsClient()
        self.executor = Executor(
            holder, device=device, stacked=use_mesh, stats=self.stats,
            dispatch_batch=dispatch_batch,
            dispatch_batch_max=dispatch_batch_max,
            dispatch_batch_window_us=dispatch_batch_window_us,
            whole_query=whole_query,
            whole_query_fallback=whole_query_fallback)

    # -- query (api.go:135 Query) ------------------------------------------

    def query(self, index: str, query: str, shards=None,
              ctx=None) -> list[Any]:
        """``ctx``: optional QueryContext carrying the query's deadline
        (utils/deadline.py); defaults to the caller's active context (the
        HTTP handler installs one from ?timeout= / the deadline header /
        the query-timeout config default)."""
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
            return self.executor.execute(index, query, shards, ctx=ctx)

    # -- DDL ---------------------------------------------------------------

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True):
        try:
            return self.holder.create_index(name, keys=keys,
                                            track_existence=track_existence)
        except FileExistsError as e:
            raise ConflictError(str(e))
        except ValueError as e:
            raise ApiError(str(e))

    def delete_index(self, name: str):
        try:
            self.holder.delete_index(name)
        except ValueError as e:
            raise NotFoundError(str(e))

    def create_field(self, index: str, field: str,
                     options: dict | None = None):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            # from_dict validates cacheType/cacheSize (FieldOptions
            # __post_init__) — bad options must 400, not 500
            opts = FieldOptions.from_dict(options or {})
            return idx.create_field(field, opts)
        except FileExistsError as e:
            raise ConflictError(str(e))
        except ValueError as e:
            raise ApiError(str(e))

    def delete_field(self, index: str, field: str):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(field)
        except ValueError as e:
            raise NotFoundError(str(e))

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: list[dict]):
        """POST /schema (http/handler.go handlePostSchema)."""
        for idx_def in schema:
            opts = idx_def.get("options", {})
            idx = self.holder.create_index_if_not_exists(
                idx_def["name"], keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True))
            for fdef in idx_def.get("fields", []):
                idx.create_field_if_not_exists(
                    fdef["name"], FieldOptions.from_dict(
                        fdef.get("options", {})))

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
        idx, f = self._index_field(index, field)
        row_ids, column_ids = self._translate_import_keys(
            idx, f, row_keys, column_keys, row_ids, column_ids)
        rows = np.asarray(row_ids or [], dtype=np.int64)
        cols = np.asarray(column_ids or [], dtype=np.int64)
        if rows.size != cols.size:
            raise ApiError("rowIDs and columnIDs length mismatch")
        if timestamps and len(timestamps) != cols.size:
            raise ApiError("timestamps length mismatch")
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
        idx, f = self._index_field(index, field)
        _, column_ids = self._translate_import_keys(
            idx, f, None, column_keys, None, column_ids)
        cols = np.asarray(column_ids or [], dtype=np.int64)
        vals = np.asarray(values or [], dtype=np.int64)
        if not clear and cols.size != vals.size:
            raise ApiError("columnIDs and values length mismatch")
        f.import_values(cols, vals, clear=clear)
        if not clear:
            idx.add_existence(cols)

    def check_ingest(self, index: str, field: str) -> str:
        """Validation head of the streaming ingest path (docs/ingest.md):
        index/field existence.  The committer applies records
        asynchronously, so unknown names must 404 at the socket before
        any frame is read, not at flush time.  Returns the field type so
        the handler can reject mismatched record types (values frames at
        a set field and vice versa) per frame."""
        _idx, f = self._index_field(index, field)
        return f.options.type

    def import_roaring(self, index: str, field: str, shard: int,
                       views: dict[str, bytes], clear: bool = False):
        """Import pre-serialized pilosa-roaring bitmaps, one per view
        (api.go:368 ImportRoaring)."""
        idx, f = self._index_field(index, field)
        from .storage.roaring_io import unpack_roaring
        all_cols = []
        for view_name, data in views.items():
            if not view_name:
                view_name = VIEW_STANDARD
            rows, cols_local = unpack_roaring(data, self.holder.max_row_id)
            v = f._create_view_if_not_exists(view_name)
            frag = v.create_fragment_if_not_exists(shard)
            if clear:
                frag.bulk_import(rows, cols_local, clear=True)
            else:
                frag.bulk_import(rows, cols_local)
                if view_name == VIEW_STANDARD:
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
        _, f = self._index_field(index, field)
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
        # Storage health: quarantined fragments degrade this node (empty
        # reads + refused writes on those fragments) but do NOT take it
        # down.
        quarantined = self.holder.quarantined_fragments()
        return {
            "state": STATE_NORMAL,
            "nodes": [{"id": "node0", "uri": "", "isCoordinator": True,
                       "state": "READY"}],
            "epoch": 0, "localID": "node0",
            "storage": {"quarantinedFragments": len(quarantined),
                        "degraded": bool(quarantined)},
            "warming": False, "phase": "ready",
        }

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH}

    def version(self) -> str:
        return __version__

    def max_shards(self) -> dict[str, int]:
        """(api.go MaxShards, /internal/shards/max): the export CLI walks
        0..max."""
        return {name: max(idx.available_shards(), default=0)
                for name, idx in self.holder.indexes.items()}

    def shard_nodes(self, index: str, shard: int) -> list[dict]:
        return [{"id": "node0", "uri": ""}]

    def recalculate_caches(self):
        """(api.go RecalculateCaches): eagerly rebuild every fragment's
        rank cache so the next TopN doesn't pay the lazy rebuild.

        Rebuilds run as BACKGROUND work through the dispatch batcher:
        between fragments the loop yields while foreground tickets are
        queued, so a holder-wide recalculation can't starve live queries
        of the dispatcher (or the interpreter lock)."""
        from contextlib import nullcontext
        from .cache.rank import iter_rank_caches
        batcher = self.executor.batcher
        bg = batcher.background() if batcher is not None else nullcontext()
        with bg:
            for frag, cache in iter_rank_caches(self.holder):
                if batcher is not None:
                    batcher.yield_to_foreground()
                with frag._lock:
                    cache.build(frag)
