"""Field: a row-space within an index (field.go:65-96).

Types (field.go:56-62): set, int (BSI), time, mutex, bool.  A field owns
views: "standard" for set bits, time-quantum views for timestamped bits, and
"bsig_<field>" for integer values.  Integer values are stored base-offset
(field.go:1551 bsiBase: stored = value - base) with an auto-growing bit depth
(field.go:1088-1105).

Port copy of the JAX package's ``storage/field.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime

import numpy as np

from ..core import (
    SHARD_WIDTH,
    VIEW_BSI_GROUP_PREFIX,
    VIEW_STANDARD,
)
from ..ops import bsi
from ..utils.locks import make_rlock
from .attrs import AttrStore
from . import time_quantum as tq
from .view import View

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

DEFAULT_CACHE_SIZE = 50000


class FieldError(ValueError):
    pass


def bsi_base(min_v: int, max_v: int) -> int:
    """Default base for an int field (field.go:1554 bsiBase)."""
    if min_v > 0:
        return min_v
    if max_v < 0:
        return max_v
    return 0


def bit_depth(v: int) -> int:
    """Bits required to store abs(v) (field.go:1665 bitDepth)."""
    v = abs(v)
    for i in range(63):
        if v < (1 << i):
            return i
    return 63


@dataclass
class FieldOptions:
    """(field.go:1421 FieldOptions)

    ``min``/``max`` default to None; for int fields an omitted bound
    resolves to the full int64 range (the reference defaults omitted
    min/max to MinInt64/MaxInt64, http/handler.go:781) so a bare
    {"type": "int"} field accepts every value instead of rejecting all
    non-zero writes against a 0/0 declared range."""
    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int | None = None
    max: int | None = None
    base: int = 0
    bit_depth: int = 0
    time_quantum: str = ""
    keys: bool = False

    def __post_init__(self):
        # Reject bad cache options AT FIELD CREATION (a 400 through the
        # API) instead of silently persisting an arbitrary cacheType
        # string into the schema where every later TopN would have to
        # guess at it (field.go:1462 validates the same way).
        if self.cache_type not in (CACHE_TYPE_RANKED, CACHE_TYPE_LRU,
                                   CACHE_TYPE_NONE):
            raise FieldError(
                f"invalid cacheType {self.cache_type!r} (expected one of "
                f"'ranked', 'lru', 'none')")
        if not isinstance(self.cache_size, int) \
                or isinstance(self.cache_size, bool) or self.cache_size < 0:
            raise FieldError(
                f"invalid cacheSize {self.cache_size!r} (expected a "
                f"non-negative integer)")
        if self.type == FIELD_TYPE_INT:
            # Magnitude is stored sign+magnitude in 63 BSI rows, so the
            # representable floor is -(2^63-1), not MinInt64; defaulting to
            # MinInt64 would let set_value(-2**63) silently truncate to 0.
            if self.min is None:
                self.min = -((1 << 63) - 1)
            if self.max is None:
                self.max = (1 << 63) - 1
        else:
            if self.min is None:
                self.min = 0
            if self.max is None:
                self.max = 0

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "base": self.base,
            "bitDepth": self.bit_depth,
            "timeQuantum": self.time_quantum,
            "keys": self.keys,
        }

    @classmethod
    def from_dict(cls, d: dict, lenient: bool = False) -> "FieldOptions":
        """``lenient=True`` for the DISK LOAD path: schemas persisted
        before cache-option validation existed may carry arbitrary
        cacheType strings / bad sizes, and a node must not refuse to
        start over them.  Unknown types coerce to 'none' — exactly the
        pre-validation behavior, where an unrecognized cacheType meant no
        cache was ever consulted.  API field creation stays strict
        (400)."""
        cache_type = d.get("cacheType", CACHE_TYPE_RANKED)
        cache_size = d.get("cacheSize", DEFAULT_CACHE_SIZE)
        if lenient:
            if cache_type not in (CACHE_TYPE_RANKED, CACHE_TYPE_LRU,
                                  CACHE_TYPE_NONE):
                cache_type = CACHE_TYPE_NONE
            if not isinstance(cache_size, int) \
                    or isinstance(cache_size, bool) or cache_size < 0:
                cache_size = DEFAULT_CACHE_SIZE
        return cls(
            type=d.get("type", FIELD_TYPE_SET),
            cache_type=cache_type,
            cache_size=cache_size,
            min=d.get("min"),
            max=d.get("max"),
            base=d.get("base", 0),
            bit_depth=d.get("bitDepth", 0),
            time_quantum=d.get("timeQuantum", ""),
            keys=d.get("keys", False),
        )


class Field:
    def __init__(self, path: str | None, index: str, name: str,
                 options: FieldOptions | None = None,
                 max_op_n: int | None = None,
                 row_id_cap: int | None = None):
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.max_op_n = max_op_n
        self.row_id_cap = row_id_cap
        self.views: dict[str, View] = {}
        self.row_attrs = AttrStore(
            None if path is None else os.path.join(path, ".row_attrs"))
        self._lock = make_rlock("field")
        # shards known to have data on remote nodes (field.go:263)
        self.remote_available_shards: set[int] = set()
        # row-key translation (field.go: per-field TranslateStore)
        self.translate_factory = None
        self._translate_store = None

        if self.options.type == FIELD_TYPE_INT:
            if self.options.base == 0:
                self.options.base = bsi_base(self.options.min, self.options.max)
            # bit_depth intentionally starts at 0 and grows with the values
            # actually written (field.go:1088-1105), NOT with the declared
            # min/max: BSI range scans are O(bit_depth), so a field declared
            # wide but used narrow stays cheap.  Declared-range enforcement
            # on writes (_check_value) keeps options.min/max sound for the
            # planner's shortcut paths.
        if self.options.type == FIELD_TYPE_TIME:
            tq.validate_quantum(self.options.time_quantum)

    # -- persistence -------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def save_meta(self):
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        with open(self._meta_path(), "w") as f:
            json.dump(self.options.to_dict(), f)

    def open(self):
        if self.path is None:
            return
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                self.options = FieldOptions.from_dict(json.load(f),
                                                      lenient=True)
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for vname in os.listdir(views_dir):
                self._create_view_if_not_exists(vname).open()

    def close(self):
        with self._lock:
            for v in self.views.values():
                v.close()
            if self._translate_store is not None:
                self._translate_store.close()
                self._translate_store = None

    def translate_store(self):
        """Row-key store for this field (keys live in <field>/.row_keys)."""
        with self._lock:
            if self._translate_store is None:
                from .translate import TranslateStore
                path = None if self.path is None \
                    else os.path.join(self.path, ".row_keys")
                if self.translate_factory is not None:
                    self._translate_store = self.translate_factory(
                        path, self.index, self.name)
                else:
                    self._translate_store = TranslateStore(path)
            return self._translate_store

    # -- views -------------------------------------------------------------

    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def _create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                vpath = None
                if self.path is not None:
                    vpath = os.path.join(self.path, "views", name)
                v = View(vpath, self.index, self.name, name,
                         max_op_n=self.max_op_n, row_id_cap=self.row_id_cap,
                         cache_type=self.options.cache_type,
                         cache_size=self.options.cache_size)
                self.views[name] = v
            return v

    def bsi_view_name(self) -> str:
        return VIEW_BSI_GROUP_PREFIX + self.name

    def available_shards(self) -> set[int]:
        """Union of local fragment shards + remote-known shards
        (field.go:300 AvailableShards)."""
        out = set(self.remote_available_shards)
        for v in self.views.values():
            out |= v.available_shards()
        return out

    # -- bit mutation ------------------------------------------------------

    def _check_row(self, row: int):
        if self.options.type == FIELD_TYPE_BOOL and row not in (0, 1):
            raise FieldError("bool field rows must be 0 (false) or 1 (true)")

    def set_bit(self, row: int, col: int, ts: datetime | None = None) -> bool:
        """Set (row, col); fans out to standard + time views
        (field.go:929 SetBit)."""
        self._check_row(row)
        shard = col // SHARD_WIDTH
        shard_col = col % SHARD_WIDTH
        changed = False

        view_names = [VIEW_STANDARD]
        if ts is not None:
            if not self.options.time_quantum:
                raise FieldError(
                    f"cannot set timed bit on field {self.name!r} with no "
                    f"time quantum")
            view_names += tq.views_by_time(
                VIEW_STANDARD, ts, self.options.time_quantum)

        for vname in view_names:
            frag = self._create_view_if_not_exists(vname) \
                .create_fragment_if_not_exists(shard)
            if self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL):
                changed |= self._mutex_set(frag, row, shard_col)
            else:
                changed |= frag.set_bit(row, shard_col)
        return changed

    @staticmethod
    def _mutex_set(frag, row: int, shard_col: int) -> bool:
        """Mutex semantics: at most one row per column
        (fragment.go setBit mutex handling / :2106 bulkImportMutex)."""
        changed = False
        for r in frag.rows_with_bit(shard_col):
            if int(r) != row:
                changed |= frag.clear_bit(int(r), shard_col)
        changed |= frag.set_bit(row, shard_col)
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        """(field.go:1000 ClearBit) — clears from standard and all time
        views."""
        self._check_row(row)
        shard = col // SHARD_WIDTH
        shard_col = col % SHARD_WIDTH
        changed = False
        for vname, v in list(self.views.items()):
            if vname.startswith(VIEW_BSI_GROUP_PREFIX):
                continue
            frag = v.fragment(shard)
            if frag is not None:
                changed |= frag.clear_bit(row, shard_col)
        return changed

    def row(self, row_id: int, view_name: str = VIEW_STANDARD):
        """All shards' segments for a row: {shard: np.uint32[W]}
        (field.go:917 Row)."""
        v = self.views.get(view_name)
        if v is None:
            return {}
        return {shard: frag.row(row_id)
                for shard, frag in v.fragments.items()}

    # -- integer values ----------------------------------------------------

    def _require_int(self):
        if self.options.type != FIELD_TYPE_INT:
            raise FieldError(f"field {self.name!r} is not an int field")

    def _check_value(self, value: int):
        """Declared-range enforcement (field.go:1082-1086
        ErrBSIGroupValueTooLow/High).  This is what makes options.min/max
        true invariants of the stored data, which the planner's
        full-encompass shortcuts rely on (plan.py _resolve_bsi)."""
        if value < self.options.min:
            raise FieldError(
                f"bsigroup value too low: {value} < min {self.options.min}")
        if value > self.options.max:
            raise FieldError(
                f"bsigroup value too high: {value} > max {self.options.max}")

    def set_value(self, col: int, value: int) -> bool:
        """(field.go:1077 SetValue): store value-base; grow bit depth as
        needed (field.go:1088-1105)."""
        self._require_int()
        self._check_value(value)
        base_value = value - self.options.base
        with self._lock:
            required = max(bit_depth(base_value), 1)
            if required > self.options.bit_depth:
                self.options.bit_depth = required
                from ..core import bump_schema_epoch
                bump_schema_epoch()
                self.save_meta()
            depth = self.options.bit_depth
        shard = col // SHARD_WIDTH
        frag = self._create_view_if_not_exists(self.bsi_view_name()) \
            .create_fragment_if_not_exists(shard)
        return frag.set_value(col % SHARD_WIDTH, depth, base_value)

    def value(self, col: int):
        """(field.go:1060 Value) -> (value, exists)."""
        self._require_int()
        v = self.views.get(self.bsi_view_name())
        if v is None:
            return 0, False
        frag = v.fragment(col // SHARD_WIDTH)
        if frag is None:
            return 0, False
        shard_col = col % SHARD_WIDTH
        rows = set(int(r) for r in frag.rows_with_bit(shard_col))
        if bsi.EXISTS_ROW not in rows:
            return 0, False
        mag = 0
        for r in rows:
            if r >= bsi.OFFSET_ROW:
                mag |= 1 << (r - bsi.OFFSET_ROW)
        if bsi.SIGN_ROW in rows:
            mag = -mag
        return mag + self.options.base, True

    # -- import ------------------------------------------------------------

    def import_bits(self, rows: np.ndarray, cols: np.ndarray,
                    timestamps=None, clear: bool = False) -> None:
        """Bulk import of (row, col[, ts]) triples, shard-grouping inside
        (field.go:1206 Import)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        view_bits: dict[str, tuple[list, list]] = {}

        if timestamps is None:
            view_bits[VIEW_STANDARD] = (rows, cols)
        else:
            std_r, std_c = [], []
            timed: dict[str, tuple[list, list]] = {}
            for r, c, ts in zip(rows, cols, timestamps):
                std_r.append(r)
                std_c.append(c)
                if ts is not None:
                    for vn in tq.views_by_time(
                            VIEW_STANDARD, ts, self.options.time_quantum):
                        timed.setdefault(vn, ([], []))
                        timed[vn][0].append(r)
                        timed[vn][1].append(c)
            view_bits[VIEW_STANDARD] = (np.array(std_r), np.array(std_c))
            for vn, (tr, tc) in timed.items():
                view_bits[vn] = (np.array(tr), np.array(tc))

        for vname, (vr, vc) in view_bits.items():
            vr = np.asarray(vr, dtype=np.int64)
            vc = np.asarray(vc, dtype=np.int64)
            view = self._create_view_if_not_exists(vname)
            shards = vc // SHARD_WIDTH
            for shard in np.unique(shards):
                sel = shards == shard
                frag = view.create_fragment_if_not_exists(int(shard))
                if self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL) \
                        and not clear:
                    frag.mutex_import(vr[sel], vc[sel] % SHARD_WIDTH)
                else:
                    frag.bulk_import(vr[sel], vc[sel] % SHARD_WIDTH,
                                     clear=clear)

    def ingest_import(self, rows: np.ndarray, cols: np.ndarray,
                      timestamps=None) -> int:
        """Group-commit import for the streaming ingest path
        (docs/ingest.md): same view fan-out as ``import_bits`` but each
        fragment takes its batch through ``Fragment.ingest_apply`` — one
        WAL frame, one gen bump, one rank-cache touch per FLUSH, with
        the new bits riding the device delta overlay instead of
        invalidating resident device state.  Mutex/bool fields fall back
        to ``mutex_import`` (their implied clears cannot overlay); the
        flush is still one batch per fragment.  Returns changed bits."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        view_bits: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        if timestamps is None:
            view_bits[VIEW_STANDARD] = (rows, cols)
        else:
            timed: dict[str, tuple[list, list]] = {}
            for r, c, ts in zip(rows, cols, timestamps):
                if ts is not None:
                    for vn in tq.views_by_time(
                            VIEW_STANDARD, ts, self.options.time_quantum):
                        timed.setdefault(vn, ([], []))
                        timed[vn][0].append(r)
                        timed[vn][1].append(c)
            view_bits[VIEW_STANDARD] = (rows, cols)
            for vn, (tr, tc) in timed.items():
                view_bits[vn] = (np.asarray(tr, dtype=np.int64),
                                 np.asarray(tc, dtype=np.int64))
        changed = 0
        for vname, (vr, vc) in view_bits.items():
            view = self._create_view_if_not_exists(vname)
            shards = vc // SHARD_WIDTH
            for shard in np.unique(shards):
                sel = shards == shard
                frag = view.create_fragment_if_not_exists(int(shard))
                if self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL):
                    changed += frag.mutex_import(vr[sel],
                                                 vc[sel] % SHARD_WIDTH)
                else:
                    changed += frag.ingest_apply(vr[sel],
                                                 vc[sel] % SHARD_WIDTH)
        return changed

    def import_values(self, cols: np.ndarray, values: np.ndarray,
                      clear: bool = False) -> None:
        """Bulk BSI import (field.go:1287 importValue); ``clear`` removes
        the columns' values instead."""
        self._require_int()
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        if clear:
            view = self.views.get(self.bsi_view_name())
            if view is None:
                return
            shards = cols // SHARD_WIDTH
            for shard in np.unique(shards):
                frag = view.fragment(int(shard))
                if frag is not None:
                    frag.clear_values(cols[shards == shard] % SHARD_WIDTH)
            return
        self._check_value(int(values.min()))
        self._check_value(int(values.max()))
        base_values = values - self.options.base
        with self._lock:
            required = max(
                bit_depth(int(base_values.min())),
                bit_depth(int(base_values.max())), 1)
            if required > self.options.bit_depth:
                self.options.bit_depth = required
                from ..core import bump_schema_epoch
                bump_schema_epoch()
                self.save_meta()
            depth = self.options.bit_depth
        view = self._create_view_if_not_exists(self.bsi_view_name())
        shards = cols // SHARD_WIDTH
        for shard in np.unique(shards):
            sel = shards == shard
            frag = view.create_fragment_if_not_exists(int(shard))
            # merge with existing values in the fragment
            frag.import_values(cols[sel] % SHARD_WIDTH, base_values[sel],
                               depth)
