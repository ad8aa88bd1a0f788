"""Holder: root of all local data (holder.go:50-87).

Port copy of the JAX package's ``storage/holder.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import os
import shutil

from .fragment import Fragment
from .index import Index
from .field import Field, FieldOptions
from ..utils.locks import make_rlock


class Holder:
    def __init__(self, path: str | None = None,
                 max_op_n: int | None = None,
                 max_row_id: int | None = None):
        self.path = path
        self.max_op_n = max_op_n
        self.max_row_id = max_row_id  # per-fragment row-id cap (None=default)
        self.indexes: dict[str, Index] = {}
        # key-translation store factory propagated to indexes/fields;
        # None = local file-backed stores (cluster replicas set a
        # coordinator-routed factory before open())
        self.translate_factory = None
        self._lock = make_rlock("holder")

    # -- lifecycle (holder.go:137 Open) ------------------------------------

    def open(self):
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        for name in sorted(os.listdir(self.path)):
            idx_path = os.path.join(self.path, name)
            if not os.path.isdir(idx_path):
                continue
            # hidden dirs are infrastructure, not indexes (the warm-start
            # compile cache lives at <data-dir>/.compile-cache)
            if name.startswith("."):
                continue
            idx = Index(idx_path, name, max_op_n=self.max_op_n,
                        row_id_cap=self.max_row_id)
            idx.translate_factory = self.translate_factory
            idx.open()
            for f in idx.fields.values():
                f.translate_factory = self.translate_factory
            self.indexes[name] = idx

    def close(self):
        with self._lock:
            for idx in self.indexes.values():
                idx.close()

    # -- index management --------------------------------------------------

    def _index_path(self, name: str) -> str | None:
        return None if self.path is None else os.path.join(self.path, name)

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Index:
        """(holder.go:396 CreateIndex)"""
        with self._lock:
            if name in self.indexes:
                raise FileExistsError(f"index already exists: {name}")
            from ..core import validate_name
            validate_name(name, "index name")
            idx = Index(self._index_path(name), name, keys=keys,
                        track_existence=track_existence,
                        max_op_n=self.max_op_n, create=True,
                        row_id_cap=self.max_row_id)
            idx.translate_factory = self.translate_factory
            idx.save_meta()
            self.indexes[name] = idx
            from ..core import bump_schema_epoch
            bump_schema_epoch()
            return idx

    def create_index_if_not_exists(self, name: str, **kw) -> Index:
        with self._lock:
            if name in self.indexes:
                return self.indexes[name]
            return self.create_index(name, **kw)

    def delete_index(self, name: str):
        with self._lock:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise ValueError(f"index not found: {name}")
            from ..core import bump_schema_epoch
            bump_schema_epoch()
            idx.close()
            if idx.path is not None and os.path.isdir(idx.path):
                shutil.rmtree(idx.path)

    # -- accessors (holder.go:373-531) ------------------------------------

    def field(self, index: str, field: str) -> Field | None:
        idx = self.indexes.get(index)
        return None if idx is None else idx.field(field)

    def fragment(self, index: str, field: str, view: str,
                 shard: int) -> Fragment | None:
        f = self.field(index, field)
        if f is None:
            return None
        v = f.view(view)
        return None if v is None else v.fragment(shard)

    def iter_fragments(self, index: str | None = None):
        """Yield (index, field, view, shard, fragment) over local data
        (optionally one index) — the quarantine/repair scan surface."""
        items = [(index, self.indexes[index])] if index is not None \
            and index in self.indexes else list(self.indexes.items())
        for iname, idx in items:
            for fname, f in list(idx.fields.items()):
                for vname, v in list(f.views.items()):
                    for shard, frag in list(v.fragments.items()):
                        yield iname, fname, vname, shard, frag

    def quarantined_fragments(self, index: str | None = None) -> list[dict]:
        """Currently-quarantined fragments (docs/robustness.md): the
        degraded-state surface for /status, /debug/vars and query
        responses.  Called on every public query / health probe /
        metrics scrape, so the healthy case (no quarantine has EVER
        happened in this process) fast-outs without scanning the
        holder."""
        from .fragment import QUARANTINE_SEEN
        if not QUARANTINE_SEEN:
            return []
        out = []
        for iname, fname, vname, shard, frag in self.iter_fragments(index):
            if frag.quarantined is not None:
                out.append({"index": iname, "field": fname, "view": vname,
                            "shard": shard, "reason": frag.quarantined})
        return out

    def container_stats(self, index: str | None = None) -> dict:
        """Aggregate container-type histogram of the fragments currently
        holding a packed (compressed-resident) stream, plus how many
        fragments are in each device form (docs/memory-budget.md
        "Compressed residency").  Never packs on demand — fragments
        without a current pack count as dense-form or uncounted, keeping
        metric scrapes O(fragments) with O(1) work each."""
        out = {"array": 0, "bitmap": 0, "run": 0,
               "compressedFragments": 0, "denseFragments": 0}
        for *_ignored, frag in self.iter_fragments(index):
            st = frag.packed_stats()
            if st is not None and frag.device_form() == "compressed":
                out["array"] += st["array"]
                out["bitmap"] += st["bitmap"]
                out["run"] += st["run"]
                out["compressedFragments"] += 1
            else:
                out["denseFragments"] += 1
        return out

    def corrupt_attr_stores(self, index: str | None = None) -> list[dict]:
        """Attr stores whose JSON was corrupt at open (bad bytes moved
        aside to ``.corrupt``, store restarted empty; attr anti-entropy
        pulls the content back from peers).  Surfaced at /debug/vars so
        the silent reset is visible to operators."""
        from .fragment import storage_events
        if storage_events()["attr_corrupt"] == 0:
            return []  # fast-out: no attr store has EVER reset
        items = [(index, self.indexes[index])] if index is not None \
            and index in self.indexes else list(self.indexes.items())
        out = []
        for iname, idx in items:
            if idx.column_attrs.corrupt is not None:
                out.append({"index": iname, "field": None,
                            "reason": idx.column_attrs.corrupt})
            for fname, f in list(idx.fields.items()):
                if f.row_attrs.corrupt is not None:
                    out.append({"index": iname, "field": fname,
                                "reason": f.row_attrs.corrupt})
        return out

    def schema(self) -> list[dict]:
        """JSON-able schema (holder.go Schema)."""
        out = []
        for iname, idx in sorted(self.indexes.items()):
            out.append({
                "name": iname,
                "options": {"keys": idx.keys,
                            "trackExistence": idx.track_existence},
                "fields": [
                    {"name": f.name, "options": f.options.to_dict(),
                     "views": sorted(f.views)}
                    for f in idx.public_fields()
                ],
            })
        return out
