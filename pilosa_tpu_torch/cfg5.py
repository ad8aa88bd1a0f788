"""BASELINE config 5 — "Intersect + TopN over ~1B columns", in-process
under a device budget and as a 4-node cluster — of the JAX package's
``bench.py``, copied for the port's smoke run and tests, with its numpy
oracle.

The corpus is ``build_config5`` (bench.py:178-230): index ``ssb1b`` (no
existence tracking), set fields ``seg`` (4 rows, about 25% fill) and
``metric`` (8 rows, about 12.5% fill) over ``N_SHARDS5`` = 954 shards
(1,000,341,504 columns), rows written word-wise with ``set_row``.
``sparse=True`` keeps about 1.5% of the words plus one contiguous fully
set run of 256 words a row: the compressed-residency variant.  The
request is ``_cfg5_batch`` (bench.py:405-412): B distinct
``TopN(metric, Intersect(Row(seg=a), Row(seg=b)), n=5)`` calls, and
``oracle_topn5`` (bench.py:251-261) answers one call from the same
words.  The cluster corpus (``dist_words``, bench.py:893-905) is the
dense variant at ``N_SHARDS5D`` = 256 shards, drawn shard by shard for
the ``import-roaring`` load of index ``dist``.  Nothing is cut: the
shard counts, row counts and densities are the configuration's.

``build_config5`` fills a holder of either package (they share the
storage API) and returns the oracle words: ``words[shard]`` is the
``[12, SHARD_WORDS]`` uint32 block (``seg`` rows 0-3, then ``metric``
rows 0-7) the engine and the oracle both read.
"""

from __future__ import annotations

import numpy as np

from .core import SHARD_WORDS, VIEW_STANDARD

INDEX = "ssb1b"
N_SHARDS5 = 954      # ~1B columns (954 * 2^20)
N_SHARDS5D = 256     # ~268M columns over 4 nodes
SEG_ROWS = 4
METRIC_ROWS = 8


def _shard_words(rng, sparse: bool) -> np.ndarray:
    """One shard's ``[12, SHARD_WORDS]`` block, drawn as bench.py
    draws it (the same rng calls in the same order)."""
    a = rng.integers(0, 1 << 32, size=(12, SHARD_WORDS), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(12, SHARD_WORDS), dtype=np.uint32)
    words = a & b                               # ~25% fill
    words[4:] &= np.roll(b[4:], 7, axis=1)      # metric rows ~12.5%
    if sparse:
        keep = rng.random((12, SHARD_WORDS)) < 0.015
        words *= keep
        starts = rng.integers(0, SHARD_WORDS - 256, size=12)
        for r in range(12):
            words[r, starts[r]: starts[r] + 256] = 0xFFFFFFFF
    return words


def build_config5(holder, rng, n_shards: int = N_SHARDS5,
                  sparse: bool = False) -> dict[int, np.ndarray]:
    """Fill ``holder`` with the config-5 index; returns the oracle
    words per shard."""
    idx = holder.create_index(INDEX, track_existence=False)
    seg = idx.create_field("seg")
    metric = idx.create_field("metric")
    seg_view = seg._create_view_if_not_exists(VIEW_STANDARD)
    met_view = metric._create_view_if_not_exists(VIEW_STANDARD)
    oracle_words: dict[int, np.ndarray] = {}
    for shard in range(n_shards):
        words = _shard_words(rng, sparse)
        sf = seg_view.create_fragment_if_not_exists(shard)
        mf = met_view.create_fragment_if_not_exists(shard)
        for r in range(SEG_ROWS):
            sf.set_row(r, words[r])
        for r in range(METRIC_ROWS):
            mf.set_row(r, words[SEG_ROWS + r])
        oracle_words[shard] = words
    return oracle_words


def dist_words(rng, n_shards: int = N_SHARDS5D):
    """The cluster leg's dense corpus, one ``(shard, words)`` at a time
    in load order (bench.py:893-905)."""
    for shard in range(n_shards):
        yield shard, _shard_words(rng, sparse=False)


def sparse_words(rng, n_shards: int):
    """The sparse corpus of ``build_config5(sparse=True)``, one
    ``(shard, words)`` at a time in load order, for a served cluster to
    load over HTTP."""
    for shard in range(n_shards):
        yield shard, _shard_words(rng, sparse=True)


def oracle_topn5(oracle_words, shards, a: int, b: int, n: int = 5):
    """Exact answer of ``TopN(metric, Intersect(Row(seg=a),
    Row(seg=b)), n=n)``: [(metric row, count)]."""
    counts = np.zeros(METRIC_ROWS, dtype=np.int64)
    for s in shards:
        w = oracle_words[s]
        mask = w[a] & w[b]
        for m in range(METRIC_ROWS):
            counts[m] += int(np.bitwise_count(w[SEG_ROWS + m] & mask).sum())
    order = sorted(range(METRIC_ROWS), key=lambda m: (-counts[m], m))
    return [(m, int(counts[m])) for m in order[:n] if counts[m] > 0]


def table(oracle_words) -> np.ndarray:
    """``int64[shard, a, b, m]``: bits of metric row m under seg rows a
    and b in each shard, counted from the oracle words once, so a TopN
    over any shard subset is a sum (``oracle_topn5`` by table)."""
    n = len(oracle_words)
    tab = np.zeros((n, SEG_ROWS, SEG_ROWS, METRIC_ROWS), np.int64)
    for s in range(n):
        w = oracle_words[s]
        for a in range(SEG_ROWS):
            for b in range(a + 1, SEG_ROWS):
                mask = w[a] & w[b]
                for m in range(METRIC_ROWS):
                    tab[s, a, b, m] = tab[s, b, a, m] = int(
                        np.bitwise_count(w[SEG_ROWS + m] & mask).sum())
    return tab


def rank(tab, shards, a: int, b: int, n: int = 5) -> list:
    """``oracle_topn5``'s answer from ``table``: [(metric row, count)]."""
    counts = tab[list(shards), a, b].sum(axis=0)
    order = sorted(range(counts.size), key=lambda m: (-counts[m], m))
    return [(m, int(counts[m])) for m in order[:n] if counts[m] > 0]


def batch_pairs(rng, B: int) -> list[tuple[int, int]]:
    """The (a, b) filter pairs of one ``_cfg5_batch`` draw."""
    aa = rng.integers(0, SEG_ROWS, size=B)
    bb = (aa + 1 + rng.integers(0, 3, size=B)) % SEG_ROWS
    return [(int(a), int(b)) for a, b in zip(aa, bb)]


def batch_query(pairs) -> str:
    """B distinct Intersect+TopN calls (bench.py ``_cfg5_batch``)."""
    return " ".join(
        f"TopN(metric, Intersect(Row(seg={a}), Row(seg={b})), n=5)"
        for a, b in pairs)


def _cfg5_batch(rng, B: int) -> str:
    return batch_query(batch_pairs(rng, B))
