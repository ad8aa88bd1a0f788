"""BASELINE configs 1-3 and the ``grid4`` GroupBy grid of the JAX
package's ``bench.py``, copied for the port's bench and tests, with
numpy oracles for every query shape.

The corpus is ``build_indexes`` (bench.py:129-176), drawn from one
``rng`` in the same order, so one seed gives one corpus in both
packages:

- ``startrace`` (configs 1-2): one shard, set field ``stargazer`` of 64
  rows, 200,000 uniform bits a row (Star-Trace shaped);
- ``lang10m`` (config 3): 10 shards (10M columns), 2,000,000 columns
  each carrying one ``language`` row of 50 and one ``stars`` row of 16;
- ``grid4``: 4 shards, 400,000 columns each carrying one row of ``a``
  and one of ``b``, 128 rows each: the 128 x 128 GroupBy grid;
- ``bsi64`` (config 4): ``bsi64.build``, the same draws as bench.py's.

None of the indexes tracks existence.  The sizes are arguments so the
tests can shrink them; the defaults are the configuration's, and
nothing is cut at them.

The timed CPU baselines ``cpu_config1-4`` are bench.py:2031-2093 (the
single-thread reference algorithm the ``vs_cpu`` ratio divides by).
``Oracle`` answers every query of the bench's requests exactly from the
stored words, by a different route from the port's (numpy over the host
words, or sorted value prefix sums for the Sums).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import bsi64
from .core import SHARD_WIDTH, VIEW_STANDARD

STAR_INDEX = "startrace"
STAR_ROWS = 64
LANG_INDEX = "lang10m"
LANG_ROWS = 50
STARS_ROWS = 16
GRID_INDEX = "grid4"
GRID_ROWS = 128
TOPN_N = 50


@dataclass(frozen=True)
class Sizes:
    """The corpus's scale: bench.py's at the defaults."""
    star_per_row: int = 200_000
    lang_shards: int = 10
    lang_bits: int = 2_000_000
    grid_shards: int = 4
    grid_bits: int = 400_000
    bsi_shards: int = bsi64.N_SHARDS
    bsi_values: int = bsi64.N_VALUES


def build_indexes(holder, rng, sizes: Sizes = Sizes(),
                  field_options=None) -> dict:
    """Fill ``holder`` (either package's; they share the storage API)
    with the four indexes; returns the config-4 draws ``cols4``,
    ``vals4``, ``segs4`` and ``star_rows``."""
    star = holder.create_index(STAR_INDEX, track_existence=False)
    stargazer = star.create_field("stargazer")
    stargazer.import_bits(
        np.repeat(np.arange(STAR_ROWS), sizes.star_per_row),
        rng.integers(0, SHARD_WIDTH, size=STAR_ROWS * sizes.star_per_row))

    lang = holder.create_index(LANG_INDEX, track_existence=False)
    language = lang.create_field("language")
    stars = lang.create_field("stars")
    cols3 = rng.integers(0, sizes.lang_shards * SHARD_WIDTH,
                         size=sizes.lang_bits)
    language.import_bits(rng.integers(0, LANG_ROWS, size=sizes.lang_bits),
                         cols3)
    stars.import_bits(rng.integers(0, STARS_ROWS, size=sizes.lang_bits),
                      cols3)

    grid = holder.create_index(GRID_INDEX, track_existence=False)
    ga = grid.create_field("a")
    gb = grid.create_field("b")
    gcols = rng.integers(0, sizes.grid_shards * SHARD_WIDTH,
                         size=sizes.grid_bits)
    ga.import_bits(rng.integers(0, GRID_ROWS, size=sizes.grid_bits), gcols)
    gb.import_bits(rng.integers(0, GRID_ROWS, size=sizes.grid_bits), gcols)

    cols4, vals4, segs4 = bsi64.build(holder, rng, field_options,
                                      n_shards=sizes.bsi_shards,
                                      n_values=sizes.bsi_values)
    return {"star_rows": STAR_ROWS, "cols4": cols4, "vals4": vals4,
            "segs4": segs4}


def frag_words(holder, index: str, field: str,
               view: str = VIEW_STANDARD) -> dict[int, np.ndarray]:
    """shard -> the fragment's dense ``uint32[rows, SHARD_WORDS]``."""
    v = holder.field(index, field).view(view)
    return {s: fr.words for s, fr in sorted(v.fragments.items())}


# -- the request shapes (bench.py:302-403) ----------------------------------

def rand_rows(rng, n_rows: int, k: int) -> np.ndarray:
    """k sets of 8 distinct rows (bench.py ``_rand_rows``)."""
    return rng.permuted(np.tile(np.arange(n_rows), (k, 1)), axis=1)[:, :8]


def count_row_query(rows) -> str:
    return " ".join(f"Count(Row(stargazer={int(r)}))" for r in rows)


def intersect8_query(sets) -> str:
    return " ".join("Count(Intersect(" + ", ".join(
        f"Row(stargazer={int(r)})" for r in q) + "))" for q in sets)


def topn_query(rs) -> str:
    return " ".join(f"TopN(language, Row(stars={int(r)}), n={TOPN_N})"
                    for r in rs)


def grid_query(b: int) -> str:
    return f"GroupBy(Rows(a), Rows(b), Row(b={int(b)}))"


# -- timed CPU baselines (bench.py:2031-2093) -------------------------------

def cpu_config1(holder, rng, n: int = 64) -> float:
    frag = frag_words(holder, STAR_INDEX, "stargazer")[0]
    rows = rng.integers(0, STAR_ROWS, size=n)
    t0 = time.perf_counter()
    for r in rows:
        int(np.bitwise_count(frag[r]).sum())
    return n / (time.perf_counter() - t0)


def cpu_config2(holder, rng, n: int = 64) -> float:
    frag = frag_words(holder, STAR_INDEX, "stargazer")[0]
    sets = rand_rows(rng, STAR_ROWS, n)
    t0 = time.perf_counter()
    for q in sets:
        seg = frag[q[0]]
        for i in range(1, 8):
            seg = seg & frag[q[i]]
        int(np.bitwise_count(seg).sum())
    return n / (time.perf_counter() - t0)


def cpu_config3(holder, rng, n: int = 2) -> float:
    lang = frag_words(holder, LANG_INDEX, "language")
    stars = frag_words(holder, LANG_INDEX, "stars")
    rs = rng.integers(0, STARS_ROWS, size=n)
    t0 = time.perf_counter()
    for r in rs:
        counts = np.zeros(64, dtype=np.int64)
        for s, frag in lang.items():
            masked = frag & stars[s][r][None, :]
            c = np.bitwise_count(masked).sum(axis=1).astype(np.int64)
            counts[: c.size] += c
        nz = np.nonzero(counts)[0]
        sorted(((int(counts[i]), -int(i)) for i in nz), reverse=True)[:50]
    return n / (time.perf_counter() - t0)


def cpu_config4(holder, rng, n: int = 2) -> float:
    """Bit-sliced range + sum scan over numpy words (fragment.go:1111
    sum, :1436 rangeGT) on the config-4 BSI view."""
    frags = frag_words(holder, bsi64.INDEX, "v", "bsig_v")
    xs = rng.integers(0, bsi64.V_MAX, size=n)
    t0 = time.perf_counter()
    for x in xs:
        total = 0
        for w in frags.values():
            depth = w.shape[0] - 2
            eq = w[0].copy()
            gt = np.zeros_like(eq)
            for i in range(depth - 1, -1, -1):
                bit = w[2 + i]
                if (int(x) >> i) & 1:
                    eq &= bit
                else:
                    gt |= eq & bit
                    eq &= ~bit
            for i in range(depth):
                total += int(np.bitwise_count(w[2 + i] & gt).sum()) << i
    return n / (time.perf_counter() - t0)


# -- exact answers -----------------------------------------------------------

def _rank(counts: np.ndarray, n: int) -> list[dict]:
    """TopN order: count descending, then row id; zero counts dropped."""
    order = sorted(range(counts.size), key=lambda m: (-counts[m], m))
    return [{"id": m, "count": int(counts[m])}
            for m in order[:n] if counts[m] > 0]


class Oracle:
    """Exact answers of every bench query, from the stored words (and
    config 4's drawn values), in the form of the executor results'
    ``to_dict()`` (a Count or a Sum's fields as plain values)."""

    def __init__(self, holder, meta: dict):
        self.star = frag_words(holder, STAR_INDEX, "stargazer")[0]
        self.star_counts = np.bitwise_count(self.star).sum(
            axis=1, dtype=np.int64)
        lang = frag_words(holder, LANG_INDEX, "language")
        stars = frag_words(holder, LANG_INDEX, "stars")
        # TopN(language, Row(stars=r)) for each of the 16 filter rows
        tab = np.zeros((STARS_ROWS, LANG_ROWS), np.int64)
        for s, words in lang.items():
            for r in range(min(STARS_ROWS, stars[s].shape[0])):
                c = np.bitwise_count(words & stars[s][r][None, :]).sum(
                    axis=1, dtype=np.int64)
                tab[r, : c.size] += c[:LANG_ROWS]
        self.topn = [_rank(tab[r], TOPN_N) for r in range(STARS_ROWS)]
        self.grid_a = frag_words(holder, GRID_INDEX, "a")
        self.grid_b = frag_words(holder, GRID_INDEX, "b")
        vals = np.sort(meta["vals4"])
        self.vals4 = meta["vals4"]
        self.segs4 = meta["segs4"]
        self.sorted_vals = vals
        # suffix sums: sum of vals[i:] for every i
        self.suffix = np.concatenate(
            [np.cumsum(vals[::-1])[::-1], [0]]).astype(np.int64)

    def count_row(self, r: int) -> int:
        return int(self.star_counts[r])

    def count_intersect(self, sets, chunk: int = 128) -> list[int]:
        """Count(Intersect(...)) of each row set (``int[k, width]``),
        over chunks of sets at a time: whole-array numpy operations,
        which release the interpreter lock, so checker threads run in
        parallel."""
        sets = np.asarray(sets)
        out = np.empty(len(sets), np.int64)
        for lo in range(0, len(sets), chunk):
            q = sets[lo: lo + chunk]
            acc = self.star[q[:, 0]]
            for i in range(1, q.shape[1]):
                np.bitwise_and(acc, self.star[q[:, i]], out=acc)
            out[lo: lo + chunk] = np.bitwise_count(acc).sum(
                axis=1, dtype=np.int64)
        return out.tolist()

    def topn_filtered(self, r: int) -> list[dict]:
        return self.topn[r]

    def sum_gt(self, x: int) -> dict:
        i = int(np.searchsorted(self.sorted_vals, x, side="right"))
        return {"value": int(self.suffix[i]),
                "count": int(self.sorted_vals.size - i)}

    def group_by_seg(self, x: int) -> list[dict]:
        return [{"group": [{"field": "seg", "rowID": a},
                           {"field": "seg", "rowID": b}], "count": c}
                for (_f, a), (_g, b), c in
                bsi64.oracle_group_by(self.vals4, self.segs4, x)]

    def grid_count(self, field: str, row: int) -> int:
        """Count(Row(a=row)) or Count(Row(b=row)) over ``grid4``."""
        words = self.grid_a if field == "a" else self.grid_b
        return sum(int(np.bitwise_count(w[row]).sum())
                   for w in words.values() if row < w.shape[0])

    def grid(self, k: int) -> list[dict]:
        """GroupBy(Rows(a), Rows(b), Row(b=k)): for every (a, b) row
        pair, the columns in a, b and b=k; only b=k's columns matter,
        so the grid is a product of their row-membership bits."""
        grid = np.zeros((GRID_ROWS, GRID_ROWS), np.int64)
        for s, bw in self.grid_b.items():
            if k >= bw.shape[0]:
                continue
            cols = np.flatnonzero(np.unpackbits(
                bw[k].view(np.uint8), bitorder="little"))
            if cols.size == 0:
                continue
            word, bit = cols >> 5, (cols & 31).astype(np.uint32)

            def member(w):
                m = np.zeros((GRID_ROWS, cols.size), np.int64)
                m[: w.shape[0]] = (w[:, word] >> bit) & 1
                return m

            grid += member(self.grid_a[s]) @ member(bw).T
        return [{"group": [{"field": "a", "rowID": int(i)},
                           {"field": "b", "rowID": int(j)}],
                 "count": int(grid[i, j])}
                for i, j in zip(*np.nonzero(grid))]


def normalize(results) -> list:
    """Executor results as plain values comparable with ``Oracle``."""
    out = []
    for r in results:
        if isinstance(r, list):
            out.append([p.to_dict() for p in r])
        elif hasattr(r, "to_dict"):
            out.append(r.to_dict())
        else:
            out.append(r)
    return out
