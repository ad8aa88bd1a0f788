"""The SSB star-schema workload of the JAX package's ``bench.py``
(``build_ssb``, ``_ssb_batch``, ``oracle_ssb_topn``), copied for the
port's smoke run and tests, with its numpy oracle extended from TopN to
all three query shapes.

The corpus is a wide denormalized lineorder fact index: one column per
fact, every dimension attribute a selective Row — ``year`` (7 rows),
``region`` (5), ``category`` (12) and an 8-bucket revenue measure
``rev``.  Every column belongs to exactly one row per field, assigned in
32-column blocks (whole words), so a word-level histogram of the stored
words answers every query exactly.  At the default 256 shards it holds
2^28 (268M) fact columns — SSB at scale factor about 45 — and its dense
form is 256 x 32 rows x 128 KiB = 1 GiB.

``build_ssb`` fills a holder of either package (they share the storage
API) and draws from ``rng`` in the same order as ``bench.build_ssb``, so
one seed gives one corpus.
"""

from __future__ import annotations

import numpy as np

from .core import SHARD_WORDS, VIEW_STANDARD

N_SHARDS_SSB = 256
SSB_FIELDS = (("year", 7), ("region", 5), ("category", 12), ("rev", 8))
SSB_INDEX = "ssb"


def build_ssb(holder, rng, n_shards: int = N_SHARDS_SSB,
              sparse: bool = True, keep=None) -> np.ndarray:
    """Fill ``holder`` with the SSB fact index and return the oracle
    histogram ``int64[n_shards, 7, 5, 12, 8]``: per shard, the number of
    live words whose columns carry each (year, region, category, rev)
    combination — read back from the very words stored.

    ``sparse=True`` keeps about 1.5% of fact words plus one contiguous
    fully-populated 512-word region per shard: the scattered + clustered
    mix that packs into array AND run containers.

    ``keep``: a range of shards to store (one rank's slice of a
    multi-process engine, parallel/multihost.py).  Every shard is still
    drawn, so the corpus and the histogram are the seed's; the other
    shards get empty fragments at each field's row count, as
    ``multihost.import_process_slice`` leaves them."""
    idx = holder.create_index(SSB_INDEX, track_existence=False)
    views = {}
    for name, _rows in SSB_FIELDS:
        f = idx.create_field(name)
        views[name] = f._create_view_if_not_exists(VIEW_STANDARD)
    dims = tuple(r for _, r in SSB_FIELDS)
    hist = np.zeros((n_shards,) + dims, dtype=np.int64)
    for shard in range(n_shards):
        if sparse:
            live = (rng.random(SHARD_WORDS) < 0.015).astype(np.uint32)
            live *= np.uint32(0xFFFFFFFF)
            start = int(rng.integers(0, SHARD_WORDS - 512))
            live[start: start + 512] = 0xFFFFFFFF
        else:
            live = np.full(SHARD_WORDS, 0xFFFFFFFF, dtype=np.uint32)
        row_of = []
        for name, n_rows in SSB_FIELDS:
            assign = rng.integers(0, n_rows, size=SHARD_WORDS)
            words = np.zeros((n_rows, SHARD_WORDS), dtype=np.uint32)
            for r in range(n_rows):
                words[r, assign == r] = 0xFFFFFFFF
            words &= live[None, :]
            fr = views[name].create_fragment_if_not_exists(shard)
            if keep is None or shard in keep:
                for r in range(n_rows):
                    fr.set_row(r, words[r])
            else:
                fr.set_row(n_rows - 1, None)  # capacity only, no bits
            row_of.append(words.argmax(axis=0))
        on = live != 0
        np.add.at(hist[shard], tuple(r[on] for r in row_of), 1)
    return hist


def ssb_calls(rng, B: int) -> list[tuple]:
    """B calls cycling the three SSB shapes as (kind, year, region,
    category) tuples, drawn as ``bench._ssb_batch`` draws them: kind 0 a
    Q1-style restricted Count, 1 a Q2-style TopN of the revenue measure
    under a dimension filter, 2 a Q3-style two-dimension GroupBy."""
    out = []
    for kind in rng.integers(0, 3, size=B):
        y = int(rng.integers(0, 7))
        rg = int(rng.integers(0, 5))
        c = int(rng.integers(0, 12))
        out.append((int(kind), y, rg, c))
    return out


def ssb_query(call: tuple) -> str:
    kind, y, rg, c = call
    if kind == 0:
        return f"Count(Intersect(Row(year={y}), Row(region={rg})))"
    if kind == 1:
        return (f"TopN(rev, Intersect(Row(region={rg}), "
                f"Row(category={c})), n=5)")
    return f"GroupBy(Rows(year), Rows(region), Row(category={c}))"


def ssb_batch(calls) -> str:
    return " ".join(ssb_query(c) for c in calls)


def oracle(hist: np.ndarray, shards, call: tuple):
    """Exact answer of one SSB call over ``shards``, in the form of the
    executor's result ``to_dict()`` (a Count is a plain int)."""
    h = hist[list(shards)].sum(axis=0) * 32   # bits per (y, rg, c, m)
    kind, y, rg, c = call
    if kind == 0:
        return int(h[y, rg].sum())
    if kind == 1:
        counts = h[:, rg, c, :].sum(axis=0)
        order = sorted(range(counts.size), key=lambda m: (-counts[m], m))
        return [{"id": m, "count": int(counts[m])}
                for m in order[:5] if counts[m] > 0]
    grid = h[:, :, c, :].sum(axis=2)
    return [{"group": [{"field": "year", "rowID": yy},
                       {"field": "region", "rowID": rr}],
             "count": int(grid[yy, rr])}
            for yy in range(grid.shape[0]) for rr in range(grid.shape[1])
            if grid[yy, rr] > 0]


def normalize(results) -> list:
    """Executor results -> plain values comparable with ``oracle``."""
    return [[p.to_dict() for p in r] if isinstance(r, list) else r
            for r in results]
