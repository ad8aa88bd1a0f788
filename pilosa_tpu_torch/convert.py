"""Build a port ``Holder`` from plain arrays — the state hand-over between
the JAX package and the port without either seeing the other's objects.

``schema`` is a plain dict of indexes and field options::

    {"<index>": {"keys": False, "trackExistence": True,
                 "fields": {"<field>": {<FieldOptions.to_dict() keys>}}}}

``fragments`` maps ``(index, field, view, shard)`` to the fragment's
sparse word store as numpy arrays: ``(idx, val)`` — sorted flat word
indices ``row * SHARD_WORDS + word`` (int64) and their non-zero words
(uint32), the in-memory form of the snapshot format — optionally with
the row capacity as a third element.
"""

from __future__ import annotations

import numpy as np

from .core import SHARD_WORDS
from .storage import FieldOptions, Holder


def holder_from_arrays(schema: dict, fragments: dict, device=None) -> Holder:
    """An in-memory port ``Holder`` holding exactly the given schema and
    fragments.  With a ``device`` (a torch device), every fragment's dense
    device mirror is staged there before returning; ``None`` stages
    nothing (mirrors then upload on first use)."""
    h = Holder(None)
    for iname, ispec in schema.items():
        idx = h.create_index(iname, keys=bool(ispec.get("keys", False)),
                             track_existence=bool(
                                 ispec.get("trackExistence", True)))
        for fname, fopts in ispec.get("fields", {}).items():
            if idx.field(fname) is None:
                idx.create_field(fname, FieldOptions.from_dict(fopts))
    for (iname, fname, vname, shard), arrs in fragments.items():
        f = h.field(iname, fname)
        if f is None:
            raise KeyError(f"fragment of unknown field {iname}/{fname}")
        idx_arr = np.asarray(arrs[0], dtype=np.int64)
        val_arr = np.asarray(arrs[1], dtype=np.uint32)
        if idx_arr.shape != val_arr.shape or idx_arr.ndim != 1:
            raise ValueError(f"{iname}/{fname}/{vname}/{shard}: idx and val "
                             f"must be equal-length 1-D arrays")
        if idx_arr.size and (np.any(np.diff(idx_arr) <= 0)
                             or np.any(val_arr == 0) or idx_arr[0] < 0):
            raise ValueError(f"{iname}/{fname}/{vname}/{shard}: idx must be "
                             f"sorted, unique, non-negative with non-zero "
                             f"words")
        frag = f._create_view_if_not_exists(vname) \
            .create_fragment_if_not_exists(int(shard))
        with frag._lock:
            if idx_arr.size:
                frag._ensure_rows(int(idx_arr[-1] // SHARD_WORDS))
            if len(arrs) > 2:
                frag._cap_rows = max(frag._cap_rows, int(arrs[2]))
            frag._idx, frag._val = idx_arr.copy(), val_arr.copy()
            frag._mark_device_dirty()
            frag._rank_invalidate()
    if device is not None:
        for _i, _f, _v, _s, frag in h.iter_fragments():
            frag.device(device)
    return h
