"""Attribute storage: arbitrary key/value metadata on rows and columns
(reference attr.go:34-44 AttrStore, boltdb/attrstore.go).

The reference uses BoltDB; here a JSON-file-backed store with in-memory maps
(attrs are metadata, never on the query hot path).  Block checksums for
anti-entropy diffing mirror attrBlocks (attr.go:86-120).

Port copy of the JAX package's ``storage/attrs.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..utils.durable import durable_replace, fsync_file
from ..utils.locks import make_rlock

_BLOCK_SIZE = 100  # ids per checksum block (attr.go attrBlockSize)


class AttrStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._attrs: dict[int, dict] = {}
        # non-None = the store file was corrupt at open; the bad bytes
        # were moved aside and the store started empty (anti-entropy attr
        # sync pulls the content back from peers — attrs are repairable
        # metadata, so startup must not die on them)
        self.corrupt: str | None = None
        self._lock = make_rlock("attrs")
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    self._attrs = {int(k): v
                                   for k, v in json.load(f).items()}
            except (ValueError, OSError) as e:
                self.corrupt = str(e)
                from .fragment import _bump
                _bump("attr_corrupt")
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    pass

    def _save(self):
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._attrs.items()}, f)
            # fsync before the rename + dir fsync after: a crash right
            # after os.replace must not lose an acknowledged attr write
            fsync_file(f)
        durable_replace(tmp, self.path)

    def attrs(self, id_: int) -> dict:
        with self._lock:
            return dict(self._attrs.get(id_, {}))

    def set_attrs(self, id_: int, attrs: dict):
        """Merge semantics; a None value deletes the key
        (attr.go SetAttrs)."""
        from ..core import bump_attr_epoch
        with self._lock:
            cur = self._attrs.setdefault(id_, {})
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            if not cur:
                self._attrs.pop(id_, None)
            self._save()
        bump_attr_epoch()

    def set_bulk_attrs(self, items: dict[int, dict]):
        from ..core import bump_attr_epoch
        with self._lock:
            for id_, attrs in items.items():
                cur = self._attrs.setdefault(id_, {})
                cur.update({k: v for k, v in attrs.items() if v is not None})
            self._save()
        bump_attr_epoch()

    def all(self) -> dict[int, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._attrs.items()}

    def blocks(self) -> dict[int, bytes]:
        """Checksum per 100-id block for anti-entropy diff
        (attr.go:86 attrBlocks)."""
        with self._lock:
            out: dict[int, bytes] = {}
            by_block: dict[int, list] = {}
            for id_ in sorted(self._attrs):
                by_block.setdefault(id_ // _BLOCK_SIZE, []).append(id_)
            for blk, ids in by_block.items():
                h = hashlib.blake2b(digest_size=16)
                for id_ in ids:
                    h.update(json.dumps(
                        [id_, self._attrs[id_]], sort_keys=True).encode())
                out[blk] = h.digest()
            return out

    def block_data(self, block_id: int) -> dict[int, dict]:
        with self._lock:
            lo = block_id * _BLOCK_SIZE
            hi = lo + _BLOCK_SIZE
            return {i: dict(a) for i, a in self._attrs.items()
                    if lo <= i < hi}


# -- executor glue ---------------------------------------------------------

def _attr_args(call) -> dict:
    return {k: v for k, v in call.args.items() if not k.startswith("_")}


def set_attrs_from_call(holder, index_name: str, call):
    """SetRowAttrs/SetColumnAttrs dispatch (executor.go:2207-2412)."""
    idx = holder.index(index_name)
    if idx is None:
        raise ValueError(f"index not found: {index_name}")
    attrs = _attr_args(call)
    if call.name == "SetColumnAttrs":
        col = call.args.get("_col")
        if isinstance(col, bool) or not isinstance(col, int):
            raise ValueError("SetColumnAttrs requires an integer column id")
        idx.column_attrs.set_attrs(col, attrs)
        return None
    field_name = call.args.get("_field")
    f = idx.field(field_name) if field_name else None
    if f is None:
        raise ValueError(f"field not found: {field_name}")
    row = call.args.get("_row")
    if isinstance(row, bool) or not isinstance(row, int):
        raise ValueError("SetRowAttrs requires an integer row id")
    f.row_attrs.set_attrs(row, attrs)
    return None
