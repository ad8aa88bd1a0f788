"""The port's benchmark: the engine path of the BASELINE configs on one
NVIDIA GPU — the counterpart of the JAX package's ``bench.py``.

    python -m pilosa_tpu_torch.bench [--device cuda] [--seed 7] [--smoke]
        [--leg NAME ...] [--profile]

Every number drives ``Executor.execute`` (fingerprint, prepared plan,
whole-query program, stacked dispatch, reduce) or the port's HTTP
server: the paths a user calls.  Legs, each copied from ``bench.py``
at its full size (``--smoke`` runs every leg at a few shards and small
requests):

- ``corpus``: ``build_indexes`` (bench.py:129-176) through
  ``baseline.build_indexes`` — ``startrace``, ``lang10m``, ``grid4``,
  ``bsi64`` from one seed — and one query of each shape against its
  oracle.  Run whenever a leg needs the corpus.
- ``config1`` -> ``1_count_row_1shard``: requests of 32,768
  ``Count(Row(stargazer=r))``, 16 a run from 8 clients (bench.py
  ``bench_config1`` :302-323).
- ``config2`` -> ``2_intersect8_1M_cols``, the headline: requests of
  4,096 ``Count(Intersect(8 rows))``, 32 from 32 clients (:325-346).
- ``config3`` -> ``3_topn_filtered_10M_cols``: 128
  ``TopN(language, Row(stars=r), n=50)``, 32 from 16 clients
  (:348-366); their ``[B, rows, W]`` temporary exceeds
  ``BATCH_TEMP_BYTES``, so the request runs in batch chunks.
- ``config4`` -> ``4_bsi_sum_gt_64shards``: 64 ``Sum(Row(v > X),
  field=v)``, 24 from 12 clients, the 8 x 8 GroupBy and the 128 x 128
  ``grid4`` GroupBy (:368-403).
- ``config5`` -> ``5_topn_1B_cols_resident`` / ``_budgeted``: config 5's
  dense corpus at 954 shards under 6144 and 768 MiB (:415-484).
- ``config7`` -> ``7_topn_1B_cols_sparse_compressed``: the sparse corpus
  resident, dense over the 768 MiB budget and compressed under it
  (:485-594).
- ``ssb`` -> ``14_ssb_star_schema``: 256 shards, dense-resident against
  compressed under 96 MB (:684-767).
- ``wholequery`` -> ``9_whole_query``: the program path on against off
  on the config 2-4 corpora (:2675-2746).
- ``http`` -> ``2_http_path`` and ``6_http_dynamic_batching``: the
  port's ``Server`` on ``localhost:0`` (:2096-2136, :2188-2244).
- ``ingest`` -> ``8_streaming_ingest``: binary-frame ingest alone and
  under the intersect8 read load (:2485-2561).

The cluster and robustness legs (``bench_config5_distributed``,
``bench_routing``, ``bench_chaos``, ``bench_slo``, ``bench_wire``,
``bench_tenant`` and the smoke-only ones) are not ported yet.

On the card the compressed config-5 and SSB legs also hold both
container kernels bit-exact against their plain versions on the stacks
the leg's requests use, timed beside their bound (``kernels``).

Every leg is a closed loop: each of its stated clients sends its next
request when the previous one returns.  Each reports calls/s (the
median run's; ``qps`` is bench.py's best of the runs), the request
median and the highest percentile with at least ten samples beyond it,
with the sample count, the run-to-run spread, failures against
attempts, resident and compressed MB, a ``device`` record (capture and
launch-ledger deltas, container-kernel launches a request), ``gbps``
from the bytes of the stacks the executor actually holds against the
H100's 3.35 TB/s, and ``vs_cpu`` against the single-thread numpy
oracle on this host.  Every answer of every request is checked against
an exact oracle; a leg that raises or answers wrong ends the run with
a non-zero exit and the leg's name on stderr.  Nothing falls back to
the CPU: ``--device cuda`` (the default) needs a card.

Progress lines come first; the last line is one JSON object shaped like
bench.py's: ``{"metric": "engine_intersect8_count_qps_1M_cols",
"value", "unit", "vs_baseline", "configs": {...}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from . import baseline, bsi64, cfg5, ssb
from .core import SHARD_WIDTH, SHARD_WORDS

SEED = 7
HBM_PEAK_GBS = 3350.0       # H100 SXM HBM3 (NVIDIA data sheet)
TAIL_SAMPLES = 10           # samples beyond the reported tail percentile


@dataclass(frozen=True)
class Shape:
    """One closed-loop run: ``requests`` requests of ``calls`` calls
    from ``clients`` clients."""
    calls: int
    requests: int
    clients: int


@dataclass(frozen=True)
class Plan:
    """Every leg's size; the defaults are bench.py's."""
    corpus: baseline.Sizes = baseline.Sizes()
    repeats: int = 3
    config1: Shape = Shape(32768, 16, 8)
    config2: Shape = Shape(4096, 32, 32)
    config3: Shape = Shape(128, 32, 16)
    config4: Shape = Shape(bsi64.SUMS_PER_REQUEST, 24, 12)
    cfg5_shards: int = cfg5.N_SHARDS5
    cfg5_resident: Shape = Shape(64, 24, 8)
    cfg5_budgeted: Shape = Shape(32, 12, 1)
    cfg5_resident_mb: int = 6144
    cfg5_budget_mb: int = 768
    ssb_shards: int = ssb.N_SHARDS_SSB
    ssb_run: Shape = Shape(24, 8, 1)
    ssb_budget_mb: int = 96
    wq_intersect8: Shape = Shape(1024, 16, 8)
    wq_sum: Shape = Shape(32, 8, 4)
    wq_topn: Shape = Shape(32, 8, 4)
    http: Shape = Shape(256, 24, 8)
    dyn_clients: int = 16
    dyn_per_client: int = 120
    dyn_warm_per_client: int = 20
    dyn_solo: int = 64
    ingest_read: Shape = Shape(4096, 8, 8)
    ingest_records: int = 2_000_000
    ingest_batch: int = 50_000


FULL = Plan()
SMOKE = Plan(
    corpus=baseline.Sizes(star_per_row=4000, lang_shards=2,
                          lang_bits=20_000, grid_shards=1, grid_bits=6000,
                          bsi_shards=2, bsi_values=8000),
    repeats=2,
    config1=Shape(512, 3, 2), config2=Shape(64, 3, 2),
    config3=Shape(8, 3, 2), config4=Shape(8, 3, 2),
    cfg5_shards=8, cfg5_resident=Shape(8, 4, 2),
    cfg5_budgeted=Shape(8, 4, 1), cfg5_resident_mb=64, cfg5_budget_mb=4,
    ssb_shards=4, ssb_run=Shape(12, 4, 1),
    wq_intersect8=Shape(32, 2, 2), wq_sum=Shape(4, 2, 2),
    wq_topn=Shape(4, 2, 2), http=Shape(16, 3, 2), dyn_clients=4,
    dyn_per_client=6, dyn_warm_per_client=2, dyn_solo=4,
    ingest_read=Shape(32, 2, 2), ingest_records=20_000, ingest_batch=5000)

# --leg name -> the configs keys it reports (bench.py's own)
LEGS = {
    "config1": ("1_count_row_1shard",),
    "config2": ("2_intersect8_1M_cols",),
    "config3": ("3_topn_filtered_10M_cols",),
    "config4": ("4_bsi_sum_gt_64shards",),
    "wholequery": ("9_whole_query",),
    "http": ("2_http_path", "6_http_dynamic_batching"),
    "ingest": ("8_streaming_ingest",),
    "config5": ("5_topn_1B_cols_resident", "5_topn_1B_cols_budgeted"),
    "config7": ("7_topn_1B_cols_sparse_compressed",),
    "ssb": ("14_ssb_star_schema",),
}
BASE_LEGS = ("config1", "config2", "config3", "config4", "wholequery",
             "http", "ingest")


def say(tag: str, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


class LegFailed(AssertionError):
    """A leg's gate did not hold."""


def require(cond: bool, leg: str, what: str):
    if not cond:
        raise LegFailed(f"{leg}: {what}")


# -- measurement ---------------------------------------------------------------

def latency_record(lat_s: list) -> dict:
    """The request median and the highest percentile with at least
    TAIL_SAMPLES samples beyond it, with the sample count; the tail is
    null until it lies above the median (more than 2 x TAIL_SAMPLES
    samples)."""
    lat = sorted(lat_s)
    n = len(lat)
    rec = {"samples": n, "p50_ms": statistics.median(lat) * 1e3,
           "tail_pct": None, "tail_ms": None}
    if n > 2 * TAIL_SAMPLES:
        rec["tail_pct"] = 100.0 * (n - TAIL_SAMPLES) / n
        rec["tail_ms"] = lat[n - TAIL_SAMPLES - 1] * 1e3
    return rec


def closed_loop(fn, n: int, clients: int) -> tuple[float, list, list]:
    """``fn(i)`` for i in range(n) from ``clients`` threads, each taking
    the next index when its previous call returns.  Returns (wall s,
    per-call s, per-call results); any call's exception propagates."""
    lat = [0.0] * n
    out: list = [None] * n

    def one(i):
        t0 = time.perf_counter()
        out[i] = fn(i)
        lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(one, range(n)))
    return time.perf_counter() - t0, lat, out


def runs_record(runs: list, calls_per_request: int, clients: int) -> dict:
    """One leg's timing record over its runs [(wall, lat, ...)]."""
    rates = [calls_per_request * len(r[1]) / r[0] for r in runs]
    rec = {"load": f"closed loop, {clients} clients",
           "calls_per_request": calls_per_request,
           "runs": len(runs),
           "calls_per_s": statistics.median(rates),
           "qps": max(rates),
           "spread": (max(rates) - min(rates)) / max(rates),
           "run_calls_per_s": rates}
    rec.update(latency_record([x for r in runs for x in r[1]]))
    return rec


def device_snapshot() -> dict:
    """Cumulative device-runtime counters (bench.py
    ``_device_telemetry`` :75-94); also restarts the decode peak so each
    leg reports its own."""
    from .ops import kernels
    from .utils import devobs
    c, led = devobs.COMPILES, devobs.LEDGER
    out = {"compiles": c.compiles_total, "retraces": c.retraces_total,
           "compile_s": c.compile_seconds_total,
           "launches": led.launches_total,
           "rows": led.rows_actual_total, "padded": led.rows_padded_total,
           "decode_bytes": led.decode_bytes_total,
           "kernel_launches": dict(kernels.LAUNCHES)}
    led.reset_decode_peak()
    return out


def device_delta(before: dict, requests: int) -> dict:
    """bench.py ``_device_delta`` (:97-121) over the port's counters,
    plus each container kernel's launches a request."""
    from .utils import devobs
    peak = devobs.LEDGER.decode_peak_bytes
    after = device_snapshot()
    rows = after["rows"] - before["rows"]
    padded = after["padded"] - before["padded"]
    kl = {k: n - before["kernel_launches"][k]
          for k, n in after["kernel_launches"].items()}
    return {"compiles": after["compiles"] - before["compiles"],
            "retraces": after["retraces"] - before["retraces"],
            "compile_s": after["compile_s"] - before["compile_s"],
            "launches": after["launches"] - before["launches"],
            "padding_waste_ratio": padded / (rows + padded)
            if rows + padded else 0.0,
            "decode_mb": (after["decode_bytes"]
                          - before["decode_bytes"]) / 2**20,
            "decode_peak_mb": peak / 2**20,
            "kernel_launches": kl,
            "kernel_launches_per_request": {
                k: n / requests for k, n in kl.items()} if requests
            else None}


def budget_record() -> dict:
    from .storage.membudget import DEFAULT_BUDGET
    st = DEFAULT_BUDGET.stats()
    return {"resident_mb": st["residentBytes"] / 2**20,
            "compressed_mb": st["compressedBytes"] / 2**20,
            "peak_mb": st["peakBytes"] / 2**20}


def stack_read_bytes(ex, index: str, reads: dict) -> int:
    """Bytes one call reads from the stacks ``ex`` holds for ``index``:
    ``reads`` maps (field, view) to the rows a call reads (None: every
    row) of that dense stack."""
    held = ex.stacked.stacked_bytes(index)
    total = 0
    for key, rows in reads.items():
        h = held.get(key)
        if h is None or not h["rows"]:
            raise LegFailed(f"no dense stack of {key} held for {index}")
        dense = h["bytes"] - h["packed_bytes"]
        total += dense if rows is None else dense * rows // h["rows"]
    return total


def check_all(leg: str, pairs, workers: int = 8) -> dict:
    """``pairs``: [(label, got, want_fn)] — every answer against its
    oracle, computed on ``workers`` threads (numpy releases the GIL).
    Raises on any difference; returns failures against attempts."""
    def one(p):
        label, got, want_fn = p
        want = want_fn()
        if got == want:
            return 0, len(got)
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        return 1, (label, bad, got[bad] if bad < len(got) else None,
                   want[bad] if bad < len(want) else None)

    with ThreadPoolExecutor(workers) as pool:
        res = list(pool.map(one, pairs))
    failures = [r[1] for r in res if r[0]]
    if failures:
        label, i, g, w = failures[0]
        raise LegFailed(f"{leg}: {len(failures)} of {len(res)} requests "
                        f"differ from the oracle; first: {label} call "
                        f"{i} -> {g}, oracle {w}")
    return {"failures": 0, "attempts": len(res),
            "calls_checked": sum(r[1] for r in res)}


@contextmanager
def knobs():
    """Save and restore the process-wide knobs the legs set: the device
    budget's limit, the compressed-residency flag and the decode
    workspace."""
    from .parallel import stacked
    from .storage import fragment
    from .storage.membudget import DEFAULT_BUDGET
    saved = (DEFAULT_BUDGET.limit_bytes, fragment.COMPRESSED_RESIDENT,
             stacked.DECODE_WORKSPACE_BYTES)
    try:
        yield
    finally:
        DEFAULT_BUDGET.limit_bytes = saved[0]
        fragment.COMPRESSED_RESIDENT = saved[1]
        stacked.DECODE_WORKSPACE_BYTES = saved[2]


def set_residency(compressed: bool, limit_mb):
    """Flush every stack and mirror, then set the residency form and the
    budget (bench.py :515-523)."""
    from .storage import fragment
    from .storage.membudget import DEFAULT_BUDGET
    fragment.COMPRESSED_RESIDENT = compressed
    DEFAULT_BUDGET.limit_bytes = 1
    DEFAULT_BUDGET.shrink_to_limit()
    DEFAULT_BUDGET.limit_bytes = None if limit_mb is None \
        else limit_mb << 20
    DEFAULT_BUDGET.reset_peak()


# -- the bench -----------------------------------------------------------------

@dataclass
class Bench:
    device: torch.device
    plan: Plan
    seed: int
    profile: bool = False
    base: dict | None = None
    profiles: dict = field(default_factory=dict)

    def rng(self, offset: int):
        """The query / corpus stream of one leg: ``seed + offset``, as
        bench.py offsets ``SEED`` per leg."""
        return np.random.default_rng(self.seed + offset)

    def executor(self, holder, **kw):
        from .executor import Executor
        return Executor(holder, device=self.device, **kw)

    def maybe_profile(self, leg: str, run):
        if self.profile:
            from .utils import devobs
            rec = devobs.profile_request(run)
            self.profiles[leg] = rec
            say("profile", leg=leg, **{k: json.dumps(v) if isinstance(
                v, list) else v for k, v in rec.items()})

    def cuda_gate(self, cond: bool, leg: str, what: str) -> str:
        """A gate that only the card can show (kernel launches, graph
        replays): checked on cuda, recorded as skipped on the CPU."""
        if self.device.type != "cuda":
            return "skipped on cpu"
        require(cond, leg, what)
        return "pass"

    def kernel_shapes(self, leg, ex, holder, index, keys, shards,
                      filters):
        """On the card: both container kernels on the packed stacks
        ``ex`` holds for ``keys`` over ``shards`` (the leg's request
        shape), the filter the AND of ``filters`` rows, each held
        bit-exact against its plain version and timed beside its bound
        (ops/kernel_timing.py).  None on the CPU."""
        if self.device.type != "cuda":
            return None
        from .ops import kernel_timing as kt
        groups = ex.stacked._placed_groups(keys, holder, index, shards)
        dec, fus = kt.new_rec(), kt.new_rec()
        for shard_list, placed, sig in groups:
            kt.measure_filtered(placed, sig, len(shard_list), dec, fus,
                                filters, iters=10, plain_iters=2)
        out = {}
        for name, rec in (("decode_block", dec), ("fused_row_counts", fus)):
            require(rec["err"] == 0, leg, f"{name} differs from its plain "
                    f"version by {rec['err']}")
            b_ms, b_by = kt.bound(rec)
            out[name] = {"ms": rec["ms"], "plain_ms": rec["plain_ms"],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": rec["err"], "bytes": rec["bytes"],
                         "shards": len(shards), "groups": len(groups),
                         "library_ms": None}
        say(leg, kernels=json.dumps(out))
        return out

    def close(self):
        if self.base is not None:
            self.base["ex"].close()
            self.base = None

    # -- leg: corpus -------------------------------------------------------

    def corpus(self) -> dict:
        """Build the four indexes and check one query of each shape."""
        from .storage import Holder
        t0 = time.perf_counter()
        holder = Holder(None)
        meta = baseline.build_indexes(holder, np.random.default_rng(
            self.seed), self.plan.corpus)
        build_s = time.perf_counter() - t0
        oracle = baseline.Oracle(holder, meta)
        ex = self.executor(holder)
        self.base = {"holder": holder, "meta": meta, "oracle": oracle,
                     "ex": ex}
        probes = [
            ("startrace", "Count(Row(stargazer=14))",
             lambda: [oracle.count_row(14)]),
            ("startrace", baseline.intersect8_query([range(8)]),
             lambda: oracle.count_intersect([range(8)])),
            ("lang10m", baseline.topn_query([3]),
             lambda: [oracle.topn_filtered(3)]),
            ("bsi64", bsi64.sum_request([500_000]),
             lambda: [oracle.sum_gt(500_000)]),
            ("bsi64", bsi64.group_by_query(1),
             lambda: [oracle.group_by_seg(1)]),
            ("grid4", "Count(Row(a=1)) Count(Row(b=127))",
             lambda: [oracle.grid_count("a", 1),
                      oracle.grid_count("b", 127)])]
        t1 = time.perf_counter()
        gate = check_all("corpus", [
            (q, baseline.normalize(ex.execute(i, q)), w)
            for i, q, w in probes])
        rec = {"build_s": build_s, "first_queries_s":
               time.perf_counter() - t1, "gate": "pass", **gate,
               "indexes": {
                   "startrace": {"shards": 1, "rows": baseline.STAR_ROWS,
                                 "bits_per_row":
                                     self.plan.corpus.star_per_row},
                   "lang10m": {"shards": self.plan.corpus.lang_shards,
                               "bits": self.plan.corpus.lang_bits},
                   "grid4": {"shards": self.plan.corpus.grid_shards,
                             "bits": self.plan.corpus.grid_bits,
                             "rows": baseline.GRID_ROWS},
                   "bsi64": {"shards": self.plan.corpus.bsi_shards,
                             "columns": int(meta["cols4"].size)}}}
        say("corpus", build_s=build_s, checked=gate["attempts"])
        return rec

    # -- legs: configs 1-4 (bench.py:302-403) -------------------------------

    def base_leg(self, leg: str, index: str, shape: Shape, rng, draw,
                 query, expect, reads: dict, cpu_fn) -> dict:
        """Warm once, then ``repeats`` closed-loop runs of fresh draws;
        every answer checked after each run."""
        ex = self.base["ex"]
        fb0, chunks0 = ex.wq_fallbacks, ex.stacked.batch_chunks
        snap0 = ex.wholequery.snapshot()
        warm = draw(rng, shape.calls)
        check_all(leg, [("warm", baseline.normalize(
            ex.execute(index, query(warm))), lambda: expect(warm))])
        d0 = device_snapshot()
        runs, gate = [], {"failures": 0, "attempts": 0, "calls_checked": 0}
        for _ in range(self.plan.repeats):
            specs = [draw(rng, shape.calls) for _ in range(shape.requests)]
            pqls = [query(s) for s in specs]
            wall, lat, out = closed_loop(
                lambda i: ex.execute(index, pqls[i]), shape.requests,
                shape.clients)
            runs.append((wall, lat))
            say(leg, run=len(runs), seconds=wall)
            g = check_all(leg, [
                (f"request {i}", baseline.normalize(out[i]),
                 lambda s=s: expect(s)) for i, s in enumerate(specs)])
            for k in gate:
                gate[k] += g[k]
        requests = self.plan.repeats * shape.requests
        rec = runs_record(runs, shape.calls, shape.clients)
        rec["device"] = device_delta(d0, requests)
        rec.update(gate)
        rec["answers"] = "pass"
        # the warm request and the timed ones: whole-query fallbacks (by
        # the last node named), graphs and the grouped path's chunks
        snap = ex.wholequery.snapshot()
        rec["wq_fallbacks"] = ex.wq_fallbacks - fb0
        rec["wq_last_fallback"] = ex.wq_last_fallback
        rec["graphs_captured"] = snap["captures"] - snap0["captures"]
        rec["replays"] = snap["replays"] - snap0["replays"]
        rec["eager_runs"] = snap["eagerRuns"] - snap0["eagerRuns"]
        rec["capture_ms"] = (snap["captureS"] - snap0["captureS"]) * 1e3
        rec["graphs_held"] = snap["graphs"]
        pool = ex.wholequery.pool_reserved_bytes() \
            if self.device.type == "cuda" else None
        rec["pool_mb"] = None if pool is None else pool / 2**20
        rec["batch_chunks_per_request"] = \
            (ex.stacked.batch_chunks - chunks0) / (requests + 1)
        bpc = stack_read_bytes(ex, index, reads)
        rec["bytes_per_call"] = bpc
        rec["gbps"] = rec["calls_per_s"] * bpc / 1e9
        rec["hbm_frac"] = rec["gbps"] / HBM_PEAK_GBS
        cpu = [cpu_fn(self.base["holder"], rng)
               for _ in range(self.plan.repeats)]
        rec["cpu_qps"] = statistics.median(cpu)
        rec["vs_cpu"] = rec["calls_per_s"] / rec["cpu_qps"]
        rec.update(budget_record())
        pql = query(draw(rng, shape.calls))
        self.maybe_profile(leg, lambda: ex.execute(index, pql))
        say(leg, calls_per_s=rec["calls_per_s"], p50_ms=rec["p50_ms"],
            tail=f"p{rec['tail_pct']}={rec['tail_ms']}",
            samples=rec["samples"], spread=rec["spread"],
            vs_cpu=rec["vs_cpu"], gbps=rec["gbps"],
            wq_fallbacks=ex.wq_fallbacks)
        return rec

    def config1(self) -> dict:
        o = self.base["oracle"]
        rec = self.base_leg(
            "config1", baseline.STAR_INDEX, self.plan.config1, self.rng(1),
            lambda rng, B: rng.integers(0, baseline.STAR_ROWS, size=B),
            baseline.count_row_query,
            lambda rows: [o.count_row(r) for r in rows],
            {("stargazer", "standard"): 1}, baseline.cpu_config1)
        return {"1_count_row_1shard": rec}

    def config2(self) -> dict:
        o = self.base["oracle"]
        rec = self.base_leg(
            "config2", baseline.STAR_INDEX, self.plan.config2, self.rng(2),
            lambda rng, B: baseline.rand_rows(rng, baseline.STAR_ROWS, B),
            baseline.intersect8_query,
            o.count_intersect,
            {("stargazer", "standard"): 8}, baseline.cpu_config2)
        return {"2_intersect8_1M_cols": rec}

    def config3(self) -> dict:
        o = self.base["oracle"]
        rec = self.base_leg(
            "config3", baseline.LANG_INDEX, self.plan.config3, self.rng(3),
            lambda rng, B: rng.integers(0, baseline.STARS_ROWS, size=B),
            baseline.topn_query,
            lambda rs: [o.topn_filtered(r) for r in rs],
            {("language", "standard"): None, ("stars", "standard"): 1},
            baseline.cpu_config3)
        return {"3_topn_filtered_10M_cols": rec}

    def config4(self) -> dict:
        o = self.base["oracle"]
        ex = self.base["ex"]
        rng = self.rng(4)
        rec = self.base_leg(
            "config4", bsi64.INDEX, self.plan.config4, rng,
            lambda rng, B: rng.integers(0, bsi64.V_MAX, size=B),
            bsi64.sum_request, lambda xs: [o.sum_gt(x) for x in xs],
            {("v", "bsig_v"): None}, baseline.cpu_config4)
        # the 8 x 8 GroupBy under a BSI filter, warmed on another literal
        # (bench.py :389-393), and the 128 x 128 grid4 GroupBy (:398-401)
        gb = []
        for index, warm_q, q, want in (
                (bsi64.INDEX, bsi64.group_by_query(1),
                 bsi64.group_by_query(500_000),
                 lambda: [o.group_by_seg(500_000)]),
                (baseline.GRID_INDEX, baseline.grid_query(1),
                 baseline.grid_query(7), lambda: [o.grid(7)])):
            ex.execute(index, warm_q)
            t0 = time.perf_counter()
            got = baseline.normalize(ex.execute(index, q))
            gb.append(time.perf_counter() - t0)
            check_all("config4", [(q, got, want)])
        rec["groupby_ms"], rec["groupby_128x128_ms"] = \
            gb[0] * 1e3, gb[1] * 1e3
        rec["groupby_128x128_groups"] = len(o.grid(7))
        say("config4", groupby_ms=rec["groupby_ms"],
            groupby_128x128_ms=rec["groupby_128x128_ms"])
        return {"4_bsi_sum_gt_64shards": rec}

    # -- leg: 9_whole_query (bench.py:2675-2746) ----------------------------

    def wholequery(self) -> dict:
        """The program path on (the default executor) against off, on
        identical requests; answers identical and equal to the oracle."""
        from .utils import devobs
        o, on = self.base["oracle"], self.base["ex"]
        off = self.executor(self.base["holder"], whole_query=False)
        rng = self.rng(9)
        p = self.plan
        legs = {
            "intersect8": (baseline.STAR_INDEX, p.wq_intersect8,
                           lambda B: baseline.rand_rows(
                               rng, baseline.STAR_ROWS, B),
                           baseline.intersect8_query,
                           o.count_intersect),
            "bsi_sum": (bsi64.INDEX, p.wq_sum,
                        lambda B: rng.integers(0, bsi64.V_MAX, size=B),
                        bsi64.sum_request,
                        lambda s: [o.sum_gt(x) for x in s]),
            "topn": (baseline.LANG_INDEX, p.wq_topn,
                     lambda B: rng.integers(0, baseline.STARS_ROWS, size=B),
                     baseline.topn_query,
                     lambda s: [o.topn_filtered(r) for r in s]),
        }
        out = {}
        try:
            for name, (index, shape, draw, query, expect) in legs.items():
                row = {}
                for ex in (on, off):
                    ex.execute(index, query(draw(shape.calls)))
                runs = {"on": [], "off": []}
                devs = {}
                attempts = 0
                for _ in range(p.repeats):
                    specs = [draw(shape.calls)
                             for _ in range(shape.requests)]
                    pqls = [query(s) for s in specs]
                    answers = {}
                    for label, ex in (("on", on), ("off", off)):
                        snap0 = ex.wholequery.snapshot() \
                            if ex.wholequery else None
                        d0 = device_snapshot()
                        wall, lat, got = closed_loop(
                            lambda i, ex=ex: ex.execute(index, pqls[i]),
                            shape.requests, shape.clients)
                        runs[label].append((wall, lat))
                        devs.setdefault(label, []).append(
                            device_delta(d0, shape.requests))
                        answers[label] = [baseline.normalize(g)
                                          for g in got]
                        if snap0 is not None:
                            snap1 = ex.wholequery.snapshot()
                            row["replays_on"] = row.get("replays_on", 0) \
                                + snap1["replays"] - snap0["replays"]
                    require(answers["on"] == answers["off"], "wholequery",
                            f"{name}: answers differ on and off")
                    check_all("wholequery", [
                        (f"{name} request {i}", answers["on"][i],
                         lambda s=s: expect(s))
                        for i, s in enumerate(specs)])
                    attempts += shape.requests
                for label in ("on", "off"):
                    r = runs_record(runs[label], shape.calls, shape.clients)
                    row[f"calls_per_s_{label}"] = r["calls_per_s"]
                    row[f"qps_{label}"] = r["qps"]
                    row[f"spread_{label}"] = r["spread"]
                    row[f"p50_ms_{label}"] = r["p50_ms"]
                    row[f"tail_{label}"] = {k: r[k] for k in (
                        "tail_pct", "tail_ms", "samples")}
                row["device_on"] = devs["on"][-1]
                row["ratio"] = row["calls_per_s_on"] / row["calls_per_s_off"]
                row.update(failures=0, attempts=attempts,
                           answers="identical on and off, oracle pass")
                out[name] = row
                say("wholequery", leg=name, on=row["calls_per_s_on"],
                    off=row["calls_per_s_off"], ratio=row["ratio"],
                    replays_on=row.get("replays_on"))
            # a Count(Intersect)-class request is ONE ledger launch
            on.execute(baseline.STAR_INDEX, "Count(Intersect("
                       "Row(stargazer=1), Row(stargazer=2)))")
            before = devobs.LEDGER.launches_total
            on.execute(baseline.STAR_INDEX, "Count(Intersect("
                       "Row(stargazer=3), Row(stargazer=4)))")
            single = devobs.LEDGER.launches_total - before == 1
            entry = devobs.LEDGER.snapshot()["entries"][-1]
            out["single_launch"] = bool(single
                                        and entry["kind"] == "wholequery")
            require(out["single_launch"], "wholequery",
                    "a Count(Intersect) request was not one launch")
            out["wq_requests"] = on.wq_requests
            out["wq_fallbacks"] = on.wq_fallbacks
            replays = sum(out[n].get("replays_on", 0) for n in legs)
            out["replays_gate"] = self.cuda_gate(
                replays > 0, "wholequery", "no graph replayed")
        finally:
            off.close()
        return {"9_whole_query": out}

    # -- legs: 2_http_path, 6_http_dynamic_batching ------------------------

    def start_server(self, **kw):
        from .server.server import Config, Server
        srv = Server(Config(data_dir=tempfile.mkdtemp(prefix="ptt_bench_"),
                            bind="localhost:0", device=str(self.device),
                            anti_entropy_interval=0, metric_poll_interval=0,
                            **kw))
        srv.open()
        return srv

    def load_startrace(self, srv, extra_fields=()):
        """``startrace`` over HTTP: the index, its field and the corpus's
        one fragment through ``import-roaring``."""
        from .storage.roaring_io import pack_roaring
        post(srv.port, "/index/startrace",
             json.dumps({"options": {"trackExistence": False}}).encode())
        for f in ("stargazer",) + tuple(extra_fields):
            post(srv.port, f"/index/startrace/field/{f}", b"{}")
        fr = self.base["holder"].fragment(baseline.STAR_INDEX, "stargazer",
                                          "standard", 0)
        post(srv.port, "/index/startrace/field/stargazer/import-roaring/0",
             pack_roaring(*fr.pairs()), "application/octet-stream")

    def http(self) -> dict:
        """Config 2 through the server against the in-process answers,
        then single-Count clients with the dispatch batcher on and off."""
        o, ex = self.base["oracle"], self.base["ex"]
        rng = self.rng(10)
        p = self.plan
        srv = self.start_server()
        try:
            self.load_startrace(srv)
            conns = Conns(srv.port)
            draw = lambda: baseline.intersect8_query(  # noqa: E731
                baseline.rand_rows(rng, baseline.STAR_ROWS, p.http.calls))
            conns.query("startrace", draw())
            runs, attempts = [], 0
            for _ in range(p.repeats):
                pqls = [draw() for _ in range(p.http.requests)]
                wall, lat, bodies = closed_loop(
                    lambda i: conns.query("startrace", pqls[i]),
                    p.http.requests, p.http.clients)
                runs.append((wall, lat))
                check_all("http", [
                    (f"request {i}", json.loads(bodies[i])["results"],
                     lambda q=pqls[i]: baseline.normalize(
                         ex.execute("startrace", q)))
                    for i in range(len(pqls))])
                attempts += len(pqls)
            rec2 = runs_record(runs, p.http.calls, p.http.clients)
            rec2.update(failures=0, attempts=attempts,
                        answers="status 200, body equal to in-process")
        finally:
            srv.close()
        say("http", calls_per_s=rec2["calls_per_s"], p50_ms=rec2["p50_ms"])

        dyn = {}
        for mode in ("on", "off"):
            srv = self.start_server(dispatch_batch=(mode == "on"))
            try:
                self.load_startrace(srv)
                conns = Conns(srv.port)

                def load(clients, per_client):
                    rows = rng.integers(0, baseline.STAR_ROWS,
                                        size=clients * per_client)
                    wall, lat, bodies = closed_loop(
                        lambda i: conns.query(
                            "startrace", f"Count(Row(stargazer={rows[i]}))"),
                        rows.size, clients)
                    check_all("http", [
                        (f"single {i}", json.loads(b)["results"],
                         lambda r=rows[i]: [o.count_row(r)])
                        for i, b in enumerate(bodies)])
                    return wall, lat

                load(p.dyn_clients, p.dyn_warm_per_client)
                runs = [load(p.dyn_clients, p.dyn_per_client)
                        for _ in range(p.repeats)]
                r = runs_record(runs, 1, p.dyn_clients)
                solo = runs_record([load(1, p.dyn_solo)
                                    for _ in range(p.repeats)], 1, 1)
                dyn[f"calls_per_s_{mode}"] = r["calls_per_s"]
                dyn[f"qps_{mode}"] = r["qps"]
                dyn[f"spread_{mode}"] = r["spread"]
                dyn[f"p50_ms_{mode}"] = r["p50_ms"]
                dyn[f"tail_{mode}"] = {k: r[k] for k in (
                    "tail_pct", "tail_ms", "samples")}
                dyn[f"solo_p50_ms_{mode}"] = solo["p50_ms"]
                dyn[f"attempts_{mode}"] = r["samples"] + solo["samples"]
                if mode == "on":
                    b = json.loads(get(srv.port, "/debug/vars")).get(
                        "dispatchBatcher", {})
                    dyn["batch_size_hist"] = b.get("batchSize")
                    dyn["window_wait"] = b.get("windowWaitS")
                    dyn["fused_launches"] = b.get("fusedLaunches")
            finally:
                srv.close()
            say("http", dynamic_batching=mode,
                calls_per_s=dyn[f"calls_per_s_{mode}"],
                solo_p50_ms=dyn[f"solo_p50_ms_{mode}"])
        dyn["load"] = (f"closed loop, {p.dyn_clients} clients of one "
                       f"Count a request; solo: 1 client")
        dyn["speedup"] = dyn["calls_per_s_on"] / dyn["calls_per_s_off"]
        dyn.update(failures=0, answers="status 200, oracle pass")
        return {"2_http_path": rec2, "6_http_dynamic_batching": dyn}

    # -- leg: 8_streaming_ingest (bench.py:2485-2561) -----------------------

    def ingest(self) -> dict:
        """Binary-frame ingest alone, then under the intersect8 read load
        (in-process on the server's executor); the streamed field must
        answer like its twin bulk-imported from the same acked records."""
        from .ingest import wire
        from .storage.roaring_io import pack_roaring
        o = self.base["oracle"]
        rng = self.rng(8)
        p = self.plan
        srv = self.start_server()
        try:
            self.load_startrace(srv, extra_fields=("ingested", "bulk"))
            sex = srv.api.executor
            shape = p.ingest_read
            acked: list = []
            lock = threading.Lock()

            def stream(n_records, stop=None):
                sent = nbytes = retries = 0
                t0 = time.perf_counter()
                while (stop is not None and not stop.is_set()) or \
                        (stop is None and sent < n_records):
                    n = p.ingest_batch if stop is not None else \
                        min(p.ingest_batch, n_records - sent)
                    rows = rng.integers(0, baseline.STAR_ROWS, size=n)
                    cols = rng.integers(0, SHARD_WIDTH, size=n)
                    body = wire.encode_records(rows, cols)
                    retries += post_retry(
                        srv.port, "/index/startrace/field/ingested/ingest",
                        body)
                    with lock:
                        acked.append((rows, cols))
                    sent += n
                    nbytes += len(body)
                return {"records": sent, "bytes": nbytes, "retries": retries,
                        "seconds": time.perf_counter() - t0}

            def read_run():
                sets = [baseline.rand_rows(rng, baseline.STAR_ROWS,
                                           shape.calls)
                        for _ in range(shape.requests)]
                wall, lat, out = closed_loop(
                    lambda i: sex.execute(
                        "startrace", baseline.intersect8_query(sets[i])),
                    shape.requests, shape.clients)
                check_all("ingest", [
                    (f"read {i}", baseline.normalize(out[i]),
                     lambda s=sets[i]: o.count_intersect(s))
                    for i in range(len(sets))])
                return wall, lat

            marks = [time.perf_counter()]
            read_run()                                       # warm
            marks.append(time.perf_counter())
            idle = [read_run() for _ in range(2)]
            marks.append(time.perf_counter())
            alone = stream(p.ingest_records)
            marks.append(time.perf_counter())
            stop = threading.Event()
            conc: dict = {}
            t = threading.Thread(target=lambda: conc.update(stream(0, stop)))
            t.start()
            try:
                loaded = [read_run() for _ in range(2)]
            finally:
                stop.set()
                t.join(timeout=600)
            marks.append(time.perf_counter())
            require(not t.is_alive() and conc, "ingest",
                    "the concurrent stream did not finish")
            ing = srv.committer.snapshot()
            # the twin: every acked record through one bulk import
            rows = np.concatenate([a[0] for a in acked])
            cols = np.concatenate([a[1] for a in acked])
            post(srv.port, "/index/startrace/field/bulk/import-roaring/0",
                 pack_roaring(rows, cols), "application/octet-stream")
            uniq = np.unique(rows.astype(np.int64) * SHARD_WIDTH + cols)
            want = np.bincount(uniq // SHARD_WIDTH,
                               minlength=baseline.STAR_ROWS)
            answers = {}
            for f in ("ingested", "bulk"):
                q = " ".join(f"Count(Row({f}={r}))"
                             for r in range(baseline.STAR_ROWS))
                q += f" TopN({f}, n={baseline.STAR_ROWS})"
                answers[f] = json.loads(post(srv.port, "/index/startrace/"
                                             "query", q.encode()))["results"]
            require(answers["ingested"] == answers["bulk"], "ingest",
                    "the streamed field answers unlike its bulk twin")
            require(answers["ingested"][:baseline.STAR_ROWS]
                    == [int(c) for c in want], "ingest",
                    "the streamed counts differ from the acked records")
            marks.append(time.perf_counter())
            ri = runs_record(idle, shape.calls, shape.clients)
            rl = runs_record(loaded, shape.calls, shape.clients)
            rec = {
                "load": f"closed loop, {shape.clients} read clients; one "
                        f"ingest stream of {p.ingest_batch}-record POSTs",
                "ingest_records_per_s": alone["records"] / alone["seconds"],
                "ingest_mb_per_s": alone["bytes"] / alone["seconds"] / 1e6,
                "ingest_records": alone["records"],
                "ingest_retries": alone["retries"] + conc["retries"],
                "concurrent_ingest_records_per_s":
                    conc["records"] / conc["seconds"],
                "read_calls_per_s_idle": ri["calls_per_s"],
                "read_calls_per_s_under_ingest": rl["calls_per_s"],
                "read_retention": rl["calls_per_s"] / ri["calls_per_s"],
                "read_p50_ms_idle": ri["p50_ms"],
                "read_p50_ms_under_ingest": rl["p50_ms"],
                "flushes": ing["flushes"], "delta_folds": ing["folds"],
                "acked_records": int(rows.size),
                "phase_s": dict(zip(
                    ("warm_read", "reads_idle", "stream_alone",
                     "under_ingest", "twin"),
                    np.diff(marks).tolist())),
                "failures": 0, "attempts": len(acked),
                "answers": "streamed equal to bulk twin and oracle"}
        finally:
            srv.close()
        say("ingest", records_per_s=rec["ingest_records_per_s"],
            retention=rec["read_retention"], acked=rec["acked_records"])
        return {"8_streaming_ingest": rec}

    # -- legs: config 5 (bench.py:415-594) ---------------------------------

    def cfg5_leg(self, leg, ex, tab, shape: Shape, order, subsets, rng,
                 reps: int) -> dict:
        """Warm each subset, then ``reps`` closed-loop runs of
        ``_cfg5_batch`` requests over ``order``; every TopN against the
        table oracle."""
        def req(pairs, sub):
            return ex.execute(cfg5.INDEX, cfg5.batch_query(pairs),
                              shards=sub)

        for sub in subsets:
            pairs = cfg5.batch_pairs(rng, shape.calls)
            check_all(leg, [("warm", [[(q.id, q.count) for q in r]
                                      for r in req(pairs, sub)],
                             lambda: [cfg5.rank(tab, sub, a, b)
                                      for a, b in pairs])])
        from .storage.membudget import DEFAULT_BUDGET
        ev0 = DEFAULT_BUDGET.evictions
        d0 = device_snapshot()
        runs, attempts = [], 0
        for _ in range(reps):
            draws = [cfg5.batch_pairs(rng, shape.calls) for _ in order]
            wall, lat, out = closed_loop(
                lambda i: req(draws[i], order[i]), len(order), shape.clients)
            runs.append((wall, lat))
            check_all(leg, [
                (f"request {i}", [[(q.id, q.count) for q in r]
                                  for r in out[i]],
                 lambda i=i: [cfg5.rank(tab, order[i], a, b)
                              for a, b in draws[i]])
                for i in range(len(order))])
            attempts += len(order)
        rec = runs_record(runs, shape.calls, shape.clients)
        rec["device"] = device_delta(d0, attempts)
        rec["evictions"] = DEFAULT_BUDGET.evictions - ev0
        rec.update(budget_record())
        rec.update(failures=0, attempts=attempts, answers="pass",
                   wq_fallbacks=ex.wq_fallbacks,
                   wq_last_fallback=ex.wq_last_fallback)
        return rec

    def config5(self) -> dict:
        """The dense corpus: resident under 6144 MiB over rotating
        quarter subsets, then under 768 MiB with a hot quarter
        alternating with cold ones, where LRU eviction must fire."""
        from .storage import Holder
        p = self.plan
        rng = self.rng(5)
        t0 = time.perf_counter()
        holder = Holder(None)
        words = cfg5.build_config5(holder, rng, n_shards=p.cfg5_shards)
        tab = cfg5.table(words)
        del words
        build_s = time.perf_counter() - t0
        subsets = [list(map(int, s)) for s in
                   np.array_split(np.arange(p.cfg5_shards), 4)]
        ex = self.executor(holder)
        out = {}
        try:
            with knobs():
                set_residency(False, p.cfg5_resident_mb)
                order = [subsets[i % 4]
                         for i in range(p.cfg5_resident.requests)]
                rec = self.cfg5_leg("config5", ex, tab, p.cfg5_resident,
                                    order, subsets, rng, p.repeats)
                rec["budget_mb"] = p.cfg5_resident_mb
                rec["budget_held"] = rec["peak_mb"] <= p.cfg5_resident_mb
                rec["bytes_per_call"] = stack_read_bytes(
                    ex, cfg5.INDEX, {("metric", "standard"): None,
                                     ("seg", "standard"): None})
                rec["gbps"] = rec["calls_per_s"] * rec["bytes_per_call"] \
                    / 1e9
                rec["hbm_frac"] = rec["gbps"] / HBM_PEAK_GBS
                rec["columns"] = p.cfg5_shards * SHARD_WIDTH
                rec["build_s"] = build_s
                cpu = [cfg5_cpu(holder, subsets[0], rng)
                       for _ in range(2)]
                rec["cpu_qps"] = statistics.median(cpu)
                rec["vs_cpu"] = rec["calls_per_s"] / rec["cpu_qps"]
                self.maybe_profile("config5", lambda: ex.execute(
                    cfg5.INDEX, cfg5._cfg5_batch(rng, p.cfg5_resident.calls),
                    shards=subsets[0]))
                out["5_topn_1B_cols_resident"] = rec
                say("config5", leg="resident",
                    calls_per_s=rec["calls_per_s"], p50_ms=rec["p50_ms"],
                    vs_cpu=rec["vs_cpu"])

                set_residency(False, p.cfg5_budget_mb)
                order = [subsets[0] if i % 2 == 0
                         else subsets[1 + (i // 2) % 3]
                         for i in range(p.cfg5_budgeted.requests)]
                rec = self.cfg5_leg("config5", ex, tab, p.cfg5_budgeted,
                                    order, subsets, rng, 1)
                rec["budget_mb"] = p.cfg5_budget_mb
                rec["budget_held"] = rec["peak_mb"] <= p.cfg5_budget_mb
                require(rec["evictions"] > 0, "config5",
                        "no eviction over the budget")
                require(rec["budget_held"], "config5",
                        f"peak {rec['peak_mb']} MiB over the budget")
                rec["columns"] = p.cfg5_shards * SHARD_WIDTH
                out["5_topn_1B_cols_budgeted"] = rec
                say("config5", leg="budgeted",
                    calls_per_s=rec["calls_per_s"], p50_ms=rec["p50_ms"],
                    evictions=rec["evictions"], peak_mb=rec["peak_mb"])
        finally:
            ex.close()
        return out

    def config7(self) -> dict:
        """The sparse corpus: resident (dense, no budget), dense over the
        budget, and compressed under it — the compressed sub-leg must
        launch both container kernels."""
        from .ops import kernels
        from .storage import Holder
        p = self.plan
        rng = self.rng(7)
        t0 = time.perf_counter()
        holder = Holder(None)
        words = cfg5.build_config5(holder, rng, n_shards=p.cfg5_shards,
                                   sparse=True)
        tab = cfg5.table(words)
        del words
        build_s = time.perf_counter() - t0
        subsets = [list(map(int, s)) for s in
                   np.array_split(np.arange(p.cfg5_shards), 4)]
        order = [subsets[0] if i % 2 == 0 else subsets[1 + (i // 2) % 3]
                 for i in range(p.cfg5_budgeted.requests)]
        dense_mb = (p.cfg5_shards * 12 * SHARD_WORDS * 4) >> 20
        out = {"columns": p.cfg5_shards * SHARD_WIDTH,
               "budget_mb": p.cfg5_budget_mb,
               "dense_working_set_mb": dense_mb, "sparse": True,
               "build_s": build_s}
        ex = self.executor(holder)
        try:
            with knobs():
                for name, compressed, limit in (
                        ("resident", False, None),
                        ("dense", False, p.cfg5_budget_mb),
                        ("compressed", True, p.cfg5_budget_mb)):
                    set_residency(compressed, limit)
                    kernels.reset_launches()
                    rec = self.cfg5_leg("config7", ex, tab, p.cfg5_budgeted,
                                        order, subsets, rng, 1)
                    rec["kernel_launches_leg"] = dict(kernels.LAUNCHES)
                    rec["budget_held"] = limit is None or \
                        rec["peak_mb"] <= limit
                    require(rec["budget_held"], "config7",
                            f"{name}: peak {rec['peak_mb']} MiB over "
                            f"the budget")
                    if compressed:
                        rec["kernels_gate"] = self.cuda_gate(
                            min(kernels.LAUNCHES.values()) > 0, "config7",
                            f"compressed launches {kernels.LAUNCHES}")
                        rec["kernels"] = self.kernel_shapes(
                            "config7", ex, holder, cfg5.INDEX,
                            [("metric", "standard"), ("seg", "standard")],
                            subsets[0], [(1, 0), (1, 2)])
                        self.maybe_profile("config7", lambda: ex.execute(
                            cfg5.INDEX, cfg5._cfg5_batch(
                                rng, p.cfg5_budgeted.calls),
                            shards=subsets[0]))
                    out[name] = rec
                    say("config7", leg=name,
                        calls_per_s=rec["calls_per_s"],
                        p50_ms=rec["p50_ms"], evictions=rec["evictions"],
                        compressed_mb=rec["compressed_mb"],
                        launches=json.dumps(rec["kernel_launches_leg"]))
        finally:
            ex.close()
        anchor = out["resident"]["calls_per_s"]
        for name in ("dense", "compressed"):
            out[name]["cliff_vs_resident"] = \
                anchor / out[name]["calls_per_s"]
        if out["compressed"]["compressed_mb"] > 0:
            out["effective_capacity_ratio"] = \
                dense_mb / out["compressed"]["compressed_mb"]
        return {"7_topn_1B_cols_sparse_compressed": out}

    # -- leg: 14_ssb_star_schema (bench.py:684-767) -------------------------

    def ssb(self) -> dict:
        from .ops import kernels
        from .storage import Holder
        p = self.plan
        rng = self.rng(15)
        t0 = time.perf_counter()
        holder = Holder(None)
        hist = ssb.build_ssb(holder, rng, n_shards=p.ssb_shards)
        build_s = time.perf_counter() - t0
        n_rows = sum(r for _, r in ssb.SSB_FIELDS)
        dense_mb = (p.ssb_shards * n_rows * SHARD_WORDS * 4) >> 20
        subsets = [list(map(int, s)) for s in
                   np.array_split(np.arange(p.ssb_shards), 4)]
        out = {"columns": p.ssb_shards * SHARD_WIDTH,
               "budget_mb": p.ssb_budget_mb,
               "dense_working_set_mb": dense_mb,
               "fields": dict(ssb.SSB_FIELDS), "build_s": build_s}
        ex = self.executor(holder)
        shape = p.ssb_run

        def check(label, shards, calls, got):
            check_all("ssb", [(label, ssb.normalize(got), lambda: [
                ssb.oracle(hist, shards, c) for c in calls])])

        try:
            with knobs():
                for name, compressed, limit in (
                        ("resident", False, None),
                        ("compressed", True, p.ssb_budget_mb)):
                    set_residency(compressed, limit)
                    gate = [(1, 0, 1, 3)]    # bench.py :741
                    check("gate", range(p.ssb_shards), gate,
                          ex.execute(ssb.SSB_INDEX, ssb.ssb_batch(gate)))
                    for sub in subsets:
                        calls = ssb.ssb_calls(rng, shape.calls)
                        check("warm", sub, calls, ex.execute(
                            ssb.SSB_INDEX, ssb.ssb_batch(calls), shards=sub))
                    kernels.reset_launches()
                    d0 = device_snapshot()
                    order = [subsets[i % 4] for i in range(shape.requests)]
                    draws = [ssb.ssb_calls(rng, shape.calls) for _ in order]
                    wall, lat, got = closed_loop(
                        lambda i: ex.execute(ssb.SSB_INDEX,
                                             ssb.ssb_batch(draws[i]),
                                             shards=order[i]),
                        shape.requests, shape.clients)
                    for i in range(shape.requests):
                        check(f"request {i}", order[i], draws[i], got[i])
                    rec = runs_record([(wall, lat)], shape.calls,
                                      shape.clients)
                    rec["device"] = device_delta(d0, shape.requests)
                    rec["kernel_launches_leg"] = dict(kernels.LAUNCHES)
                    rec.update(budget_record())
                    rec["budget_held"] = limit is None or \
                        rec["peak_mb"] <= limit
                    require(rec["budget_held"], "ssb",
                            f"{name}: peak {rec['peak_mb']} MiB over the "
                            f"budget")
                    rec.update(failures=0, attempts=shape.requests,
                               answers="pass", wq_fallbacks=ex.wq_fallbacks)
                    if compressed:
                        rec["kernels_gate"] = self.cuda_gate(
                            min(kernels.LAUNCHES.values()) > 0, "ssb",
                            f"compressed launches {kernels.LAUNCHES}")
                        rec["kernels"] = self.kernel_shapes(
                            "ssb", ex, holder, ssb.SSB_INDEX,
                            [("rev", "standard"), ("region", "standard"),
                             ("category", "standard")],
                            subsets[0], [(1, 1), (2, 3)])
                    self.maybe_profile(f"ssb_{name}", lambda: ex.execute(
                        ssb.SSB_INDEX, ssb.ssb_batch(
                            ssb.ssb_calls(rng, shape.calls)),
                        shards=subsets[0]))
                    out[name] = rec
                    say("ssb", leg=name, calls_per_s=rec["calls_per_s"],
                        p50_ms=rec["p50_ms"],
                        compressed_mb=rec["compressed_mb"],
                        launches=json.dumps(rec["kernel_launches_leg"]))
        finally:
            ex.close()
        out["compressed"]["cliff_vs_resident"] = \
            out["resident"]["calls_per_s"] / out["compressed"]["calls_per_s"]
        if out["compressed"]["compressed_mb"] > 0:
            out["effective_capacity_ratio"] = \
                dense_mb / out["compressed"]["compressed_mb"]
        return {"14_ssb_star_schema": out}


def cfg5_cpu(holder, shards, rng, n: int = 2) -> float:
    """bench.py ``cpu_config5`` (:233-248): single-thread word-wise
    Intersect + TopN over one subset's stored words."""
    seg = {s: fr.words for s, fr in holder.field(
        cfg5.INDEX, "seg").view("standard").fragments.items()}
    met = {s: fr.words for s, fr in holder.field(
        cfg5.INDEX, "metric").view("standard").fragments.items()}
    pairs = cfg5.batch_pairs(rng, n)
    t0 = time.perf_counter()
    for a, b in pairs:
        counts = np.zeros(cfg5.METRIC_ROWS, dtype=np.int64)
        for s in shards:
            mask = seg[s][a] & seg[s][b]
            for m in range(cfg5.METRIC_ROWS):
                counts[m] += int(np.bitwise_count(met[s][m] & mask).sum())
        sorted(((int(counts[m]), -m) for m in range(cfg5.METRIC_ROWS)),
               reverse=True)[:5]
    return n / (time.perf_counter() - t0)


# -- HTTP helpers ----------------------------------------------------------------

def _request(port: int, method: str, path: str, body=None,
             ctype: str = "application/json") -> bytes:
    req = urllib.request.Request(f"http://localhost:{port}{path}",
                                 data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.read()


def post(port: int, path: str, body: bytes,
         ctype: str = "application/json") -> bytes:
    """POST; any status but 200 raises."""
    return _request(port, "POST", path, body, ctype)


def get(port: int, path: str) -> bytes:
    return _request(port, "GET", path)


def post_retry(port: int, path: str, body: bytes) -> int:
    """POST a binary ingest body, resending after a 503 (the server's
    backpressure); returns the retries."""
    import urllib.error
    retries = 0
    while True:
        try:
            post(port, path, body, "application/octet-stream")
            return retries
        except urllib.error.HTTPError as e:
            e.read()
            if e.code != 503:
                raise
            retries += 1
            time.sleep(0.05)


class Conns:
    """One keep-alive connection per client thread; ``query`` returns
    the body and raises on any status but 200."""

    def __init__(self, port: int):
        self.port = port
        self.local = threading.local()

    def query(self, index: str, pql: str) -> bytes:
        conn = getattr(self.local, "conn", None)
        if conn is None:
            conn = self.local.conn = http.client.HTTPConnection(
                "localhost", self.port, timeout=600)
        try:
            conn.request("POST", f"/index/{index}/query", body=pql.encode())
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            conn.close()
            self.local.conn = None
            raise
        if resp.status != 200:
            raise LegFailed(f"POST /index/{index}/query: {resp.status} "
                            f"{data[:200]!r}")
        return data


# -- entry point -------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m pilosa_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions and measures nothing of a card)")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--smoke", action="store_true",
                    help="every leg at a few shards and small requests")
    ap.add_argument("--leg", action="append", choices=list(LEGS),
                    help="run only this leg (repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="one profiled request per leg (card only)")
    args = ap.parse_args(argv)
    if args.profile and torch.device(args.device).type != "cuda":
        ap.error("--profile needs a cuda device")
    return args


def run(argv) -> dict:
    """Run the selected legs; returns the result object.  A leg that
    raises ends the run: its name goes to stderr and the error
    propagates."""
    args = parse_args(argv)
    from .executor.executor import resolve_device
    device = resolve_device(args.device)
    legs = [name for name in LEGS if args.leg is None or name in args.leg]
    card = None
    t_all = time.perf_counter()
    info = {"device": str(device), "torch": torch.__version__,
            "seed": args.seed, "smoke": args.smoke, "legs": legs}
    if device.type == "cuda":
        from .ops import kernels
        card = card_line()
        t0 = time.perf_counter()
        kernels.build()
        info.update(card=card, kind=torch.cuda.get_device_name(device),
                    cuda=torch.version.cuda,
                    kernel_build_s=time.perf_counter() - t0)
    say("bench", **{k: repr(v) if isinstance(v, str) else v
                    for k, v in info.items()})
    bench = Bench(device, SMOKE if args.smoke else FULL, args.seed,
                  args.profile)
    configs: dict = {}
    seconds: dict = {}
    corpus = None
    try:
        for name in legs:
            t0 = time.perf_counter()
            try:
                if name in BASE_LEGS and bench.base is None:
                    corpus = bench.corpus()
                    seconds["corpus"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                configs.update(getattr(bench, name)())
            except BaseException:
                print(f"bench: leg {name} failed", file=sys.stderr,
                      flush=True)
                raise
            seconds[name] = time.perf_counter() - t0
            say("bench", leg=name, seconds=seconds[name])
    finally:
        bench.close()
    c2 = configs.get("2_intersect8_1M_cols")
    out = {"metric": "engine_intersect8_count_qps_1M_cols",
           "value": None if c2 is None else c2["calls_per_s"],
           "unit": "queries/sec",
           "vs_baseline": None if c2 is None else c2["vs_cpu"],
           "configs": configs, "corpus": corpus, "seconds": seconds,
           "total_s": time.perf_counter() - t_all,
           "hbm_peak_gbs": HBM_PEAK_GBS, **info}
    if bench.profiles:
        out["profiles"] = bench.profiles
    if card is not None:
        print(card, flush=True)
    return out


def main(argv=None) -> int:
    out = run(sys.argv[1:] if argv is None else argv)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
