"""Index: a top-level namespace of fields sharing a column space
(index.go:37-69).

Port copy of the JAX package's ``storage/index.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import json
import os

import numpy as np

from ..core import EXISTENCE_FIELD_NAME, VIEW_STANDARD
from .attrs import AttrStore
from .field import Field, FieldOptions, FIELD_TYPE_SET, CACHE_TYPE_NONE
from ..utils.locks import make_rlock


class IndexError_(ValueError):
    pass


class Index:
    def __init__(self, path: str | None, name: str,
                 keys: bool = False, track_existence: bool = True,
                 max_op_n: int | None = None, create: bool = False,
                 row_id_cap: int | None = None):
        """``create=True`` for brand-new indexes (materialises the _exists
        field immediately); when reopening from disk, open() reads .meta
        first so a trackExistence=False index is not polluted with a
        spurious _exists field."""
        self.path = path
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.max_op_n = max_op_n
        self.row_id_cap = row_id_cap
        self.fields: dict[str, Field] = {}
        self.column_attrs = AttrStore(
            None if path is None else os.path.join(path, ".column_attrs"))
        # (path, index, field|None) -> store; None = local file-backed
        # (cluster replicas swap in a coordinator-routed store)
        self.translate_factory = None
        self._translate_store = None
        self._lock = make_rlock("index")

        if create and track_existence:
            self._open_existence_field()

    # -- persistence -------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def save_meta(self):
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        with open(self._meta_path(), "w") as f:
            json.dump({"keys": self.keys,
                       "trackExistence": self.track_existence}, f)

    def open(self):
        if self.path is None:
            return
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
            self.keys = meta.get("keys", False)
            self.track_existence = meta.get("trackExistence", True)
        fields_dir = os.path.join(self.path, "fields")
        if os.path.isdir(fields_dir):
            for fname in os.listdir(fields_dir):
                f = self._make_field(fname)
                f.open()
                self.fields[fname] = f
        if self.track_existence:
            self._open_existence_field()

    def close(self):
        with self._lock:
            for f in self.fields.values():
                f.close()
            if self._translate_store is not None:
                self._translate_store.close()
                self._translate_store = None

    # -- fields ------------------------------------------------------------

    def _field_path(self, name: str) -> str | None:
        if self.path is None:
            return None
        return os.path.join(self.path, "fields", name)

    def _make_field(self, name: str,
                    options: FieldOptions | None = None) -> Field:
        f = Field(self._field_path(name), self.name, name, options,
                  max_op_n=self.max_op_n, row_id_cap=self.row_id_cap)
        f.translate_factory = self.translate_factory
        return f

    def translate_store(self):
        """Column-key store for this index (index.go: per-index
        TranslateStore; keys live in <index>/.keys)."""
        with self._lock:
            if self._translate_store is None:
                from .translate import TranslateStore
                path = None if self.path is None \
                    else os.path.join(self.path, ".keys")
                if self.translate_factory is not None:
                    self._translate_store = self.translate_factory(
                        path, self.name, None)
                else:
                    self._translate_store = TranslateStore(path)
            return self._translate_store

    def _open_existence_field(self):
        """(index.go:215 openExistenceField): internal `_exists` field,
        no cache."""
        if EXISTENCE_FIELD_NAME not in self.fields:
            opts = FieldOptions(type=FIELD_TYPE_SET,
                                cache_type=CACHE_TYPE_NONE, cache_size=0)
            f = self._make_field(EXISTENCE_FIELD_NAME, opts)
            f.save_meta()
            self.fields[EXISTENCE_FIELD_NAME] = f

    def existence_field(self) -> Field | None:
        return self.fields.get(EXISTENCE_FIELD_NAME) \
            if self.track_existence else None

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def create_field(self, name: str,
                     options: FieldOptions | None = None) -> Field:
        with self._lock:
            if name in self.fields:
                raise FileExistsError(f"field already exists: {name}")
            if name != EXISTENCE_FIELD_NAME:
                from ..core import validate_name
                try:
                    validate_name(name, "field name")
                except ValueError as e:
                    raise IndexError_(str(e))
            f = self._make_field(name, options)
            f.save_meta()
            self.fields[name] = f
            from ..core import bump_schema_epoch
            bump_schema_epoch()
            return f

    def create_field_if_not_exists(self, name: str,
                                   options: FieldOptions | None = None):
        with self._lock:
            if name in self.fields:
                return self.fields[name]
            return self.create_field(name, options)

    def delete_field(self, name: str):
        with self._lock:
            f = self.fields.pop(name, None)
            if f is None:
                raise IndexError_(f"field not found: {name}")
            from ..core import bump_schema_epoch
            bump_schema_epoch()
            f.close()
            if f.path is not None and os.path.isdir(f.path):
                import shutil
                shutil.rmtree(f.path)

    def public_fields(self) -> list[Field]:
        return [f for n, f in sorted(self.fields.items())
                if n != EXISTENCE_FIELD_NAME]

    # -- shards ------------------------------------------------------------

    def available_shards(self) -> set[int]:
        """Union over all fields (index.go:292 AvailableShards); empty
        indexes still answer shard 0 queries."""
        out: set[int] = set()
        for f in self.fields.values():
            out |= f.available_shards()
        return out or {0}

    # -- column existence --------------------------------------------------

    def add_existence(self, cols: np.ndarray):
        ef = self.existence_field()
        if ef is not None and len(cols):
            cols = np.asarray(cols, dtype=np.int64)
            ef.import_bits(np.zeros(cols.size, dtype=np.int64), cols)

    def existence_row(self) -> dict[int, np.ndarray]:
        ef = self.existence_field()
        if ef is None:
            return {}
        return ef.row(0, VIEW_STANDARD)
