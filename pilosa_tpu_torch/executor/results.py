"""Query result types (reference row.go Row, executor.go ValCount/Pairs/
GroupCount/RowIdentifiers).

Port copy of the JAX package's ``executor/results.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
One change: the port's executors hand over segments as host numpy
``uint32`` arrays, so counts use the numpy popcount
(``bitset.count_np``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..core import SHARD_WIDTH
from ..ops import bitset


class RowResult:
    """A query-result bitmap: per-shard segments merged late (row.go:26 Row,
    :332 rowSegment).  Segments are host numpy uint32 words."""

    def __init__(self, segments: dict[int, Any] | None = None,
                 keys: list[str] | None = None, attrs: dict | None = None):
        self.segments = segments or {}   # shard -> np.uint32[W]
        self.keys = keys or []
        self.attrs = attrs or {}         # row attrs (row.go Row.Attrs)
        # [{"id", "attrs"}] filled by Options(columnAttrs=true); lifted to
        # the response's top-level "columnAttrs" by the HTTP layer
        self.column_attrs: list = []

    # -- algebra (row.go:67-260) ------------------------------------------

    def _binary(self, other: "RowResult", fn, union_domain: bool):
        out = {}
        shards = set(self.segments) | set(other.segments) if union_domain \
            else set(self.segments) & set(other.segments)
        for s in shards:
            a = self.segments.get(s)
            b = other.segments.get(s)
            if a is None:
                a = np.zeros_like(np.asarray(b))
            if b is None:
                b = np.zeros_like(np.asarray(a))
            out[s] = fn(a, b)
        return RowResult(out)

    def intersect(self, other):
        return self._binary(other, bitset.intersect, union_domain=False)

    def union(self, other):
        return self._binary(other, bitset.union, union_domain=True)

    def difference(self, other):
        out = {}
        for s, a in self.segments.items():
            b = other.segments.get(s)
            out[s] = a if b is None else bitset.difference(a, b)
        return RowResult(out)

    def xor(self, other):
        return self._binary(other, bitset.xor, union_domain=True)

    # -- materialisation ---------------------------------------------------

    def count(self) -> int:
        return sum(bitset.count_np(seg) for seg in self.segments.values())

    def columns(self) -> np.ndarray:
        """Absolute sorted column ids across shards (row.go Columns)."""
        parts = []
        for shard in sorted(self.segments):
            cols = bitset.unpack_columns(np.asarray(self.segments[shard]))
            parts.append(cols + shard * SHARD_WIDTH)
        if not parts:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(parts)

    def shard_counts(self) -> dict[int, int]:
        return {s: bitset.count_np(seg) for s, seg in self.segments.items()}

    def is_empty(self) -> bool:
        return self.count() == 0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"columns": self.columns().tolist()}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.keys:
            d["keys"] = self.keys
        return d


@dataclass
class ValCount:
    """Sum/Min/Max result (executor.go:2995 ValCount)."""
    val: int = 0
    count: int = 0

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        if other.count == 0:
            return self
        if self.count == 0 or other.val < self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count)
        return self

    def larger(self, other: "ValCount") -> "ValCount":
        if other.count == 0:
            return self
        if self.count == 0 or other.val > self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count)
        return self

    def to_dict(self) -> dict:
        return {"value": self.val, "count": self.count}


@dataclass
class Pair:
    """TopN entry (pilosa.go Pair)."""
    id: int
    count: int
    key: str = ""

    def to_dict(self) -> dict:
        d = {"id": self.id, "count": self.count}
        if self.key:
            d["key"] = self.key
        return d


def acc_counts(acc, counts):
    """Sum two count arrays whose LAST axis lengths differ (row capacities
    vary across shards/groups; leading axes must match).  Mutates and
    returns the longer one."""
    import numpy as np
    counts = np.asarray(counts, dtype=np.int64)
    if counts.shape[-1] > acc.shape[-1]:
        counts = counts.copy()
        counts[..., : acc.shape[-1]] += acc
        return counts
    acc[..., : counts.shape[-1]] += counts
    return acc


def merge_pairs(pair_lists: list[list[Pair]]) -> list[Pair]:
    """Sum counts by id (executor.go:912 Pairs.Add reduce)."""
    acc: dict[int, int] = {}
    for pairs in pair_lists:
        for p in pairs:
            acc[p.id] = acc.get(p.id, 0) + p.count
    return [Pair(i, c) for i, c in acc.items()]


def sort_pairs(pairs: list[Pair], n: int | None = None) -> list[Pair]:
    """Descending by count, ascending id tiebreak (pilosa.go Pairs.Sort)."""
    out = sorted(pairs, key=lambda p: (-p.count, p.id))
    return out[:n] if n else out


def rank_counts(counts, n: int | None = None, ids=None) -> list[Pair]:
    """Vectorized TopN ranking over a per-row count vector: nonzero (or
    ``ids``-selected) rows sorted by (-count, id), materializing Pair
    objects only for the returned n — the fragment.top/rankCache
    replacement must not build a Python object per nonzero row at 50k-row
    cache scale (fragment.go:1570, cache.go:136)."""
    import numpy as np
    counts = np.asarray(counts)
    if ids:  # empty ids list = no filter (fragment.go:1618 len check)
        sel = np.asarray([i for i in ids if 0 <= i < counts.size],
                         dtype=np.int64)
        vals = counts[sel] if sel.size else np.zeros(0, counts.dtype)
        keep = vals > 0
        nz, vals = sel[keep], vals[keep]
    else:
        nz = np.nonzero(counts)[0]
        vals = counts[nz]
    order = np.lexsort((nz, -vals))
    if n:
        order = order[:n]
    return [Pair(int(i), int(c)) for i, c in zip(nz[order], vals[order])]


@dataclass
class FieldRow:
    """One (field, row) of a GroupBy group (executor.go FieldRow)."""
    field: str
    row_id: int
    row_key: str = ""

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"field": self.field, "rowID": self.row_id}
        if self.row_key:
            d["rowKey"] = self.row_key
        return d


@dataclass
class GroupCount:
    group: list[FieldRow]
    count: int

    def to_dict(self) -> dict:
        return {"group": [g.to_dict() for g in self.group],
                "count": self.count}


@dataclass
class RowIdentifiers:
    """Rows() result (executor.go RowIdentifiers)."""
    rows: list[int] = field(default_factory=list)
    keys: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"rows": self.rows} if not self.keys else {"keys": self.keys}
