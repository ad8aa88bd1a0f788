"""BASELINE config 4 — "BSI Range/Sum + GroupBy across 64 shards" — of the
JAX package's ``bench.py``, copied for the port's smoke run and tests,
with a numpy oracle for every query shape.

The corpus is ``build``'s part of bench.py:164-172: index ``bsi64``
(no existence tracking), int field ``v`` with min 0 and max 1,000,000
(base 0, bit depth 20, so its BSI view ``bsig_v`` holds 22 rows) and set
field ``seg`` with 8 rows, over 64 shards:
``cols = unique(rng.integers(0, 64 * 2^20, 1_000_000))`` (about 992k
columns, about 15.5k a shard), values uniform in ``[0, 1e6)``, one
``seg`` row per column.  The queries are bench.py:368-391: a request of
64 ``Sum(Row(v > X), field=v)`` calls with X uniform in ``[0, 1e6)``,
and ``GroupBy(Rows(seg), Rows(seg), Row(v > X))``.  Nothing is cut: 64
shards and depth 20, as the configuration defines.

``build`` fills a holder of either package (they share the storage API;
pass that package's ``FieldOptions``) and returns the columns, values
and ``seg`` rows the oracle answers from.
"""

from __future__ import annotations

import numpy as np

from .core import SHARD_WIDTH

INDEX = "bsi64"
N_SHARDS = 64
N_VALUES = 1_000_000
V_MAX = 1_000_000
SEG_ROWS = 8
SUMS_PER_REQUEST = 64


def build(holder, rng, field_options=None, n_shards: int = N_SHARDS,
          n_values: int = N_VALUES, group=None):
    """Fill ``holder`` with the config-4 index; returns (cols, vals,
    segs), each int64 ``[n]``, sorted by column.  ``group``: a process
    group this holder is one rank of (parallel/multihost.py): only the
    rank's slice of the shards is imported, the others are empty
    fragments, and the returned arrays still cover every shard."""
    if field_options is None:
        from .storage import FieldOptions as field_options
    idx = holder.create_index(INDEX, track_existence=False)
    v = idx.create_field("v", field_options(type="int", min=0, max=V_MAX))
    seg = idx.create_field("seg")
    cols = np.unique(rng.integers(0, n_shards * SHARD_WIDTH, size=n_values))
    vals = rng.integers(0, V_MAX, size=cols.size)
    segs = rng.integers(0, SEG_ROWS, size=cols.size)
    if group is None:
        v.import_values(cols, vals)
        seg.import_bits(segs, cols)
    else:
        from .parallel import multihost
        multihost.import_process_values(v, cols, vals, n_shards,
                                        V_MAX.bit_length(), group)
        multihost.import_process_slice(seg, segs, cols, n_shards,
                                       SEG_ROWS - 1, group)
    return cols, vals.astype(np.int64), segs.astype(np.int64)


def sum_request(xs) -> str:
    """One bench request: a ``Sum(Row(v > X), field=v)`` per X."""
    return " ".join(f"Sum(Row(v > {int(x)}), field=v)" for x in xs)


def group_by_query(x: int) -> str:
    return f"GroupBy(Rows(seg), Rows(seg), Row(v > {int(x)}))"


# -- the numpy oracle --------------------------------------------------------

def oracle_sum(vals, x: int) -> tuple[int, int]:
    """(sum, count) of the values above ``x``."""
    sel = vals > x
    return int(vals[sel].sum()), int(sel.sum())


def oracle_min_max(vals, x: int, want_max: bool) -> tuple[int, int]:
    """(extremum, columns holding it) of the values above ``x``; (0, 0)
    when none is."""
    sel = vals[vals > x]
    if sel.size == 0:
        return 0, 0
    m = int(sel.max() if want_max else sel.min())
    return m, int((sel == m).sum())


def oracle_group_by(vals, segs, x: int) -> list:
    """The GroupBy grid as ``[((seg, a), (seg, b), count), ...]`` in the
    executor's order: each column holds one ``seg`` row, so only a == b
    groups are non-empty."""
    counts = np.bincount(segs[vals > x], minlength=SEG_ROWS)
    return [(("seg", a), ("seg", a), int(c))
            for a, c in enumerate(counts) if c > 0]


def normalize(results) -> list:
    """Executor results as plain tuples: ``(val, count)`` for Sum / Min /
    Max, the grid tuples of ``oracle_group_by`` for GroupBy, ``(id,
    count)`` pairs for TopN, ints as they are."""
    out = []
    for r in results:
        if isinstance(r, list):
            out.append([tuple((fr.field, fr.row_id) for fr in g.group)
                        + (g.count,) if hasattr(g, "group")
                        else (g.id, g.count) for g in r])
        elif hasattr(r, "val"):
            out.append((r.val, r.count))
        else:
            out.append(r)
    return out
