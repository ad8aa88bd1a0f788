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

- ``config5d`` -> ``5d_intersect_topn_4node_cluster``: BASELINE config
  5 on four port servers in this process sharing the card, 256 dense
  shards loaded by ``import-roaring``; a mixed workload recorded by the
  slow logs and replayed from 8 clients to every node (:833-1042).
- ``routing`` -> ``10_elastic_routing``: three nodes, ``replica_n=2``,
  a skewed corpus under ``read-routing`` primary then loaded
  (:1045-1194).
- ``chaos`` -> ``11_tail_tolerance_chaos``: a straggler replica behind
  a ChaosProxy, hedging on against off (:1197-1346).
- ``slo`` -> ``20_slo_alerting``: the latency SLO pages, bundles and
  resolves; evaluation on against off (:1349-1576).
- ``wire`` -> ``12_internal_wire``: the binary internal wire against
  JSON on a pure remote fan-out (:1579-1840).
- ``tenant`` -> ``13_tenant_isolation``: a polite tenant under a
  hostile flood, weighted-fair admission on against off (:1843-2020).
- ``cache``, ``overload``, ``observability``, ``restart``: bench.py's
  smoke-only legs (:2912, :2836, :2315, :3095), one size in both modes.

Each leg's docstring names its source in ``bench.py``.  Their answer
and behaviour gates hold on every device; their timing gates (chaos,
SLO overhead, cache, observability, restart) only on the card, and on
the CPU they read "skipped on cpu".

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
import os
import re
import shutil
import socket
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
    # config 5d (bench.py :830, :912): shards, why fewer than
    # N_SHARDS5D (None: none cut), calls of each node's warm batch,
    # replay clients
    cfg5d_shards: int = cfg5.N_SHARDS5D
    cfg5d_reduced: str | None = None
    cfg5d_warm_calls: int = 64
    cfg5d_clients: int = 8
    # the robustness legs: bench.py's keyword arguments of each leg at
    # its main-bench call (bench_routing :1180, bench_chaos :1330,
    # bench_slo :1554, bench_wire :1823, bench_tenant :1995) over the
    # defaults of ``_routing_leg`` and the rest
    routing: dict = field(default_factory=lambda: dict(
        waves=6, wave_q=64, threads=8, hot_bits=6000, cold_bits=4000,
        n_cold_shards=6))
    chaos: dict = field(default_factory=lambda: dict(
        n_shards=8, n_base=40, n_fault=16, min_delay_s=0.3))
    slo: dict = field(default_factory=lambda: dict(
        n_shards=6, fault_delay_s=0.5, overhead_q=240, overhead_runs=3))
    wire: dict = field(default_factory=lambda: dict(
        waves=5, wave_q=48, threads=8, n_shards=4, dense_rows=6,
        dense_bits=320_000, sparse_rows=6, sparse_run=3000,
        fallback_check=False))
    tenant: dict = field(default_factory=lambda: dict(
        n_polite=40, flood_threads=8, flood_iters=2000, n_shards=4))


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
    ingest_read=Shape(32, 2, 2), ingest_records=20_000, ingest_batch=5000,
    cfg5d_shards=8, cfg5d_reduced="smoke size",
    # the run_*_smoke calls of bench.py (:1186-1841, :2004-2020)
    routing=dict(waves=3, wave_q=24, threads=8, hot_bits=2500,
                 cold_bits=1500, n_cold_shards=4),
    chaos=dict(n_shards=8, n_base=20, n_fault=8, min_delay_s=0.3),
    # the evaluation on / off story at bench_slo's size: at
    # run_slo_smoke's (100 requests, 2 runs) the qps ratio read 0.81 to
    # 1.04 between calls on an H100 host
    slo=dict(n_shards=6, fault_delay_s=0.5, overhead_q=240,
             overhead_runs=3),
    wire=dict(waves=2, wave_q=16, threads=6, n_shards=4, dense_rows=4,
              dense_bits=240_000, sparse_rows=6, sparse_run=1500,
              fallback_check=True),
    tenant=dict(n_polite=12, flood_threads=6, flood_iters=1000,
                n_shards=4))

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
    "config5d": ("5d_intersect_topn_4node_cluster",),
    "routing": ("10_elastic_routing",),
    "chaos": ("11_tail_tolerance_chaos",),
    "slo": ("20_slo_alerting",),
    "wire": ("12_internal_wire",),
    "tenant": ("13_tenant_isolation",),
    "cache": ("cache",),
    "overload": ("overload",),
    "observability": ("observability",),
    "restart": ("restart",),
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
                seg, met = holder_words(holder, "seg"), \
                    holder_words(holder, "metric")
                cpu = [cfg5_cpu(seg, met, subsets[0], rng)
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

    # -- the cluster and robustness legs (bench.py :833-2020, :2315-2432,
    #    :2836-3165) ----------------------------------------------------------

    @contextmanager
    def nodes(self, n: int, proxied=(), **kw):
        """``n`` port servers in this process on free localhost ports, one
        cluster (``node0`` .. ``node{n-1}``); peers dial each node in
        ``proxied`` through a ``ChaosProxy`` (utils/netchaos.py).  Yields
        (servers, proxies by node id); closes every server and proxy on
        the way out."""
        from .server.server import Config, Server
        from .utils.netchaos import ChaosProxy
        binds = free_ports(n)
        proxies: dict = {}
        servers: list = []
        root = tempfile.mkdtemp(prefix="ptt_bench_nodes_")
        try:
            hosts = []
            for i, port in enumerate(binds):
                if i in proxied:
                    proxies[f"node{i}"] = ChaosProxy("localhost", port)
                    hosts.append(proxies[f"node{i}"].address)
                else:
                    hosts.append(f"localhost:{port}")
            for i, port in enumerate(binds):
                srv = Server(Config(
                    data_dir=f"{root}/node{i}", bind=f"localhost:{port}",
                    device=str(self.device), node_id=f"node{i}",
                    cluster_hosts=hosts, anti_entropy_interval=0,
                    metric_poll_interval=0, **kw))
                servers.append(srv)     # before open: finally closes it
                srv.open()
            yield servers, proxies
        finally:
            for srv in servers:
                try:
                    srv.close()
                # lint: allow(swallowed-exception) — bench teardown: the
                # server may already be down and the leg's numbers are in
                except Exception:
                    pass
            for proxy in proxies.values():
                proxy.close()
            shutil.rmtree(root, ignore_errors=True)

    def config5d(self) -> dict:
        """BASELINE config 5's cluster half (bench.py
        ``bench_config5_distributed`` :833-1042): four port servers in
        this process on localhost ports, sharing the one card, the dense
        config-5 corpus at ``cfg5d_shards`` loaded through node0's
        ``import-roaring`` (each body forwarded to its shard's owner).
        A mixed workload (``mixed5d``: 4-call TopN batches,
        ``Count(Intersect)`` and ``Row``) runs once with every node's
        slow-query threshold at ~0; the queries the slow logs recorded
        are the corpus, replayed from ``cfg5d_clients`` clients, request
        i to node i mod 4.  Every reply of every request is held against
        ``Dist5dOracle``.

        Unlike bench.py the slow-log rings are cleared before the mixed
        phase, so the corpus is that workload alone whatever the warm-up
        took (bench.py's also takes in warm batches that ran past the
        1 s threshold).  Two untimed passes of the corpus precede the
        timed ones, so each node has staged and captured every corpus
        signature it coordinates before the clock runs."""
        p = self.plan
        rng = self.rng(17)
        rec: dict = {"nodes": 4, "shards": p.cfg5d_shards,
                     "columns": p.cfg5d_shards * SHARD_WIDTH,
                     "workload": "recorded_replay"}
        if p.cfg5d_reduced is not None:
            rec["reduced"] = {"shards": p.cfg5d_shards,
                              "why": p.cfg5d_reduced}
        with self.nodes(4, replica_n=1, slow_log_size=2048) as (servers, _):
            ports = [s.port for s in servers]
            p0 = ports[0]
            t0 = time.perf_counter()
            words = dict(cfg5.dist_words(rng, p.cfg5d_shards))
            load_cfg5(p0, "dist", words, p.cfg5d_clients)
            rec["load_s"] = time.perf_counter() - t0
            oracle = Dist5dOracle(words)
            say("config5d", shards=p.cfg5d_shards, load_s=rec["load_s"],
                node_shards=[len(s.holder.index("dist").available_shards())
                             for s in servers])

            def ask(port, pql, label):
                body = post(port, "/index/dist/query", pql.encode())
                oracle.check("config5d", label, pql, body)

            # warm every node, then the answer gate (bench.py :912-941)
            t0 = time.perf_counter()
            for port in ports:
                ask(port, cfg5._cfg5_batch(rng, p.cfg5d_warm_calls), "warm")
            ask(p0, "TopN(metric, Intersect(Row(seg=1), Row(seg=3)), n=5)",
                "gate")
            # record (bench.py :943-976)
            for srv in servers:
                srv.slowlog.clear()
                srv.slowlog.threshold_s = 1e-9
            mixed = mixed5d(rng)
            for i, q in enumerate(mixed):
                ask(ports[i % 4], q, f"mixed {i}")
            wait_for(lambda: sum(s.slowlog.recorded for s in servers)
                     >= len(mixed), "config5d", "the slow logs' records")
            corpus, truncated = [], 0
            for port in ports:
                for e in json.loads(get(port, "/debug/slow"))["entries"]:
                    if e.get("index") != "dist" or not e.get("query"):
                        continue
                    if e.get("textTruncated"):
                        truncated += 1
                        continue
                    corpus.append(e["query"])
            for srv in servers:
                srv.slowlog.threshold_s = 1.0
            require(len(corpus) >= len(mixed) and truncated == 0,
                    "config5d", f"the slow logs recorded {len(corpus)} of "
                    f"{len(mixed)} queries, {truncated} truncated")
            calls = sum(max(q.count("TopN("), 1) for q in corpus)
            rec.update(corpus_queries=len(corpus), corpus_calls=calls,
                       corpus_rows=sum(q.startswith("Row(") for q in corpus))

            def replay(label):
                t1 = time.perf_counter()
                wall, lat, bodies = closed_loop(
                    lambda i: post(ports[i % 4], "/index/dist/query",
                                   corpus[i].encode()),
                    len(corpus), p.cfg5d_clients)
                t2 = time.perf_counter()
                for i, body in enumerate(bodies):
                    oracle.check("config5d", f"{label} request {i}",
                                 corpus[i], body)
                    bodies[i] = None
                say("config5d", run=label, seconds=wall,
                    check_s=time.perf_counter() - t2)
                return (wall, lat), t2 - t1

            warm = [replay(f"warm {k}")[1] for k in range(2)]
            rec["warm_s"] = time.perf_counter() - t0
            rec["warm_pass_s"] = warm
            snaps0 = [s.api.executor.wholequery.snapshot() for s in servers]
            vars0 = json.loads(get(p0, "/debug/vars"))["timings"]
            d0 = device_snapshot()
            runs = [replay(f"timed {k}")[0] for k in range(p.repeats)]
            rec["device"] = device_delta(d0, p.repeats * len(corpus))
            vars1 = json.loads(get(p0, "/debug/vars"))["timings"]
            snaps1 = [s.api.executor.wholequery.snapshot() for s in servers]
        rec.update(runs_record(runs, calls / len(corpus), p.cfg5d_clients))
        for k in ("captures", "replays", "eagerRuns"):
            rec[f"{k}_timed"] = [b[k] - a[k] for a, b in zip(snaps0, snaps1)]
        rec["breakdown_avg_ms"] = {
            name: timing_delta_ms(vars0, vars1, f"cluster.multi.{name}")
            for name in ("peer_exec", "wire_overhead", "local_exec",
                         "reduce")}
        cpu = [cfg5_cpu({s: w[:cfg5.SEG_ROWS] for s, w in words.items()},
                        {s: w[cfg5.SEG_ROWS:] for s, w in words.items()},
                        sorted(words), rng) for _ in range(2)]
        rec["cpu_qps"] = statistics.median(cpu)
        rec["vs_cpu"] = rec["calls_per_s"] / rec["cpu_qps"]
        rec.update(failures=0, attempts=(2 + p.repeats) * len(corpus),
                   answers="pass", gate="pass", truncated_skipped=truncated)
        say("config5d", calls_per_s=rec["calls_per_s"], p50_ms=rec["p50_ms"],
            tail=f"p{rec['tail_pct']}={rec['tail_ms']}",
            vs_cpu=rec["vs_cpu"], captures_timed=rec["captures_timed"],
            breakdown=json.dumps(rec["breakdown_avg_ms"]))
        return {"5d_intersect_topn_4node_cluster": rec}

    # -- leg: 10_elastic_routing (bench.py:1045-1194) -------------------------

    def routing(self) -> dict:
        """bench.py ``_routing_leg`` (:1045-1179) at ``bench_routing``'s
        size (smoke: ``run_routing_smoke``'s): three nodes with
        ``replica_n=2``, a skewed corpus (about 80% of the queries on a
        2-shard hot index) sent to node0 from ``threads`` clients under
        ``read-routing = primary``, then ``loaded``.  The two passes
        answer byte-identically, every answer equals the oracle, and
        under ``loaded`` some hot shard was served by more than one
        node."""
        kw = self.plan.routing
        rng = self.rng(10)
        wave_q = kw["wave_q"]
        with self.nodes(3, replica_n=2) as (servers, _):
            p0 = servers[0].port
            oracles = {}
            for name, n_shards, n_bits in (
                    ("hotidx", 2, kw["hot_bits"]),
                    ("coldidx", kw["n_cold_shards"], kw["cold_bits"])):
                rows, cols = draw_set(rng, n_shards, n_bits, 8)
                load_set(p0, name, "a", rows, cols)
                oracles[name] = BitsOracle(rows, cols)

            corpus = routing_corpus(rng, wave_q)
            for srv in servers:
                for idx, q in corpus[:6]:
                    ask_json("routing", oracles[idx], srv.port, idx, q)
            coord = servers[0].cluster
            n = kw["waves"] * wave_q
            items = [corpus[i % wave_q] for i in range(n)]

            def run(policy):
                for srv in servers:
                    srv.cluster.router.policy = policy
                coord.load_tracker.rotate()
                coord.load_tracker.rotate()
                d0 = device_snapshot()
                wall, lat, bodies = closed_loop(
                    lambda i: post(p0, f"/index/{items[i][0]}/query",
                                   items[i][1].encode()), n, kw["threads"])
                dev = device_delta(d0, n)
                check_all("routing", [
                    (f"{policy} request {i}", json.loads(b)["results"],
                     lambda i=i: oracles[items[i][0]].answer(items[i][1]))
                    for i, b in enumerate(bodies)])
                say("routing", policy=policy, seconds=wall)
                return runs_record([(wall, lat)], 1, kw["threads"]), \
                    bodies, dev

            primary, bodies_p, _ = run("primary")
            loaded, bodies_l, dev = run("loaded")
            require(bodies_p == bodies_l, "routing",
                    "loaded routing diverged from primary-pinned answers")
            snap = coord.load_tracker.snapshot(top=32)
            spread = {e["shard"]: len(e["nodes"]) for e in snap["hottest"]
                      if e["index"] == "hotidx"}
            fallbacks = coord.router.snapshot()["fallbacks"]
        rec = {"answers_identical": True, "answers": "pass", "failures": 0,
               "attempts": 2 * n, "load": f"closed loop, {kw['threads']} "
               f"clients of one call a request to node0",
               "qps_primary": primary["calls_per_s"],
               "qps_loaded": loaded["calls_per_s"],
               "loaded_vs_primary": loaded["calls_per_s"]
               / primary["calls_per_s"],
               "hot_shard_nodes": max(spread.values(), default=0),
               "hot_shard_spread": spread, "fallbacks": fallbacks,
               "primary": primary, "loaded": loaded, "device": dev}
        require(rec["hot_shard_nodes"] > 1, "routing",
                f"hot shards never spread: {spread}")
        say("routing", qps_primary=rec["qps_primary"],
            qps_loaded=rec["qps_loaded"],
            hot_shard_nodes=rec["hot_shard_nodes"])
        return {"10_elastic_routing": rec}

    # -- leg: 11_tail_tolerance_chaos (bench.py:1197-1346) --------------------

    def chaos(self) -> dict:
        """bench.py ``_chaos_leg`` (:1197-1329) at ``bench_chaos``'s size
        (smoke: ``run_chaos_smoke``'s): three nodes whose two replicas
        are dialled through ChaosProxies, routing pinned to ``primary``,
        ``hedge-delay-ms`` 40.  Sequential queries with no fault, then
        with one replica's responses delayed at least 5x the baseline
        p99, hedging on, then off.  The three runs answer
        byte-identically and equal the oracle, and the fault drew hedges;
        on the card the hedged p99 lies under the injected delay, the
        unhedged one at or over 0.8 of it, and hedged under unhedged."""
        kw = self.plan.chaos
        rng = self.rng(11)
        n_shards = kw["n_shards"]
        with self.nodes(3, proxied=(1, 2), replica_n=2,
                        read_routing="primary", hedge_delay_ms=40.0) \
                as (servers, proxies):
            coord = servers[0].cluster

            def remote_owned(name):
                return [s for s in range(n_shards) if "node0" not in
                        coord.placement.shard_nodes(name, s)]

            # node0 owns some but not all replica sets, so the straggler
            # owns primaries node0 must fetch
            index = next(name for name in (f"chaos{i}" for i in range(64))
                         if 0 < len(remote_owned(name)) < n_shards)
            p0 = servers[0].port
            rows, cols = draw_set(rng, n_shards, 5000, 8)
            load_set(p0, index, "a", rows, cols)
            oracle = BitsOracle(rows, cols)
            corpus = ["Count(Intersect(Row(a=1), Row(a=2)))",
                      "TopN(a, n=0)", "Count(Row(a=3))", "Row(a=4)"]
            base = [ask_json("chaos", oracle, p0, index, q) for q in corpus]
            straggler = coord.placement.shard_nodes(
                index, remote_owned(index)[0])[0]
            stats = servers[0].stats

            def run(n, label):
                lats = []
                for i in range(n):
                    t0 = time.perf_counter()
                    body = post(p0, f"/index/{index}/query",
                                corpus[i % len(corpus)].encode())
                    lats.append(time.perf_counter() - t0)
                    require(body == base[i % len(corpus)], "chaos",
                            f"{label} query {i} answered unlike the "
                            f"no-fault baseline")
                s = sorted(lats)
                return s[max(int(len(s) * 0.99) - 1, 0)], lats

            d0 = device_snapshot()
            p99_base, lat_base = run(kw["n_base"], "base")
            delay = max(kw["min_delay_s"], 5 * p99_base)
            h0 = (stats.count_value("cluster.hedges"),
                  stats.count_value("cluster.hedge_wins"))
            proxies[straggler].configure(f"down=latency:{delay}")
            p99_hedged, lat_hedged = run(kw["n_fault"], "hedged")
            coord.hedge_reads = False
            p99_unhedged, lat_unhedged = run(kw["n_fault"], "unhedged")
            coord.hedge_reads = True
            proxies[straggler].heal()
            hedges = stats.count_value("cluster.hedges") - h0[0]
            wins = stats.count_value("cluster.hedge_wins") - h0[1]
            dev = device_delta(d0, kw["n_base"] + 2 * kw["n_fault"])
        require(hedges > 0, "chaos", "the straggler never drew a hedge")
        rec = {"answers_identical": True, "answers": "pass", "failures": 0,
               "attempts": kw["n_base"] + 2 * kw["n_fault"],
               "load": "one client, sequential queries to node0",
               "straggler": straggler, "injected_delay_ms": delay * 1e3,
               "p99_base_ms": p99_base * 1e3,
               "p99_hedged_ms": p99_hedged * 1e3,
               "p99_unhedged_ms": p99_unhedged * 1e3,
               "hedged_vs_base": p99_hedged / p99_base,
               "unhedged_vs_base": p99_unhedged / p99_base,
               "hedges": hedges, "hedge_wins": wins,
               "base": latency_record(lat_base),
               "hedged": latency_record(lat_hedged),
               "unhedged": latency_record(lat_unhedged), "device": dev}
        rec["timing_gates"] = self.cuda_gate(
            rec["p99_hedged_ms"] < rec["injected_delay_ms"]
            and rec["p99_unhedged_ms"] >= 0.8 * rec["injected_delay_ms"]
            and rec["p99_hedged_ms"] < rec["p99_unhedged_ms"], "chaos",
            f"tail not rescued: hedged p99 {rec['p99_hedged_ms']} ms, "
            f"unhedged {rec['p99_unhedged_ms']} ms, injected "
            f"{rec['injected_delay_ms']} ms")
        say("chaos", p99_base_ms=rec["p99_base_ms"],
            p99_hedged_ms=rec["p99_hedged_ms"],
            p99_unhedged_ms=rec["p99_unhedged_ms"], hedges=hedges)
        return {"11_tail_tolerance_chaos": rec}

    # -- leg: 20_slo_alerting (bench.py:1349-1576) ----------------------------

    def slo(self) -> dict:
        """bench.py ``_slo_leg`` (:1349-1553) at ``bench_slo``'s size
        (smoke: ``run_slo_smoke``'s).  (1) Three nodes, the replicas
        behind ChaosProxies: delaying every remote read past the 250 ms
        objective must fire ``slo-latency-burn`` within 2 evaluations
        (the leg forces samples and evaluations itself), land a readable
        flight-recorder bundle inside its budget, and resolve after the
        heal; every answer meanwhile equals the oracle.  (2) The same
        corpus against one node with ``alert-rules`` all, then off:
        byte-identical answers; on the card, qps on at least 0.95 of
        off (best of the runs).  Each mode's server runs in a process of
        its own, as bench.py's runs one server at a time.  Deviation:
        bench.py runs its servers one after the other,
        ``overhead_runs`` each; here both are open and their requests
        alternate one by one, in runs of ``overhead_q`` a mode, twice
        as many runs each."""
        kw = self.plan.slo
        rng = self.rng(16)
        n_shards = kw["n_shards"]
        out: dict = {}
        with self.nodes(3, proxied=(1, 2), replica_n=1,
                        read_routing="primary", hedge_reads=False,
                        slo_latency_ms=250.0, slo_target=0.999,
                        flight_recorder_mb=4, timeseries_interval=60,
                        timeseries_window=1200, trace_sample_rate=0.0) \
                as (servers, proxies):
            srv0 = servers[0]
            coord = srv0.cluster
            index = next(name for name in (f"slo{i}" for i in range(64))
                         if any("node0" not in
                                coord.placement.shard_nodes(name, s)
                                for s in range(n_shards)))
            p0 = srv0.port
            rows, cols = draw_set(rng, n_shards, 3000, 4)
            load_set(p0, index, "a", rows, cols)
            oracle = BitsOracle(rows, cols)
            q = "Count(Row(a=1))"
            ask_json("slo", oracle, p0, index, q)
            eng = srv0.slo
            require(eng is not None and eng.enabled, "slo",
                    "the SLO engine is absent")

            def pulse():
                for _ in range(3):
                    ask_json("slo", oracle, p0, index, q)
                require(srv0.sample_timeseries(force=True), "slo",
                        "a forced time-series sample was refused")
                eng.evaluate()

            srv0.sample_timeseries(force=True)
            eng.evaluate()
            evals_before = eng.evaluations
            for proxy in proxies.values():
                proxy.configure(f"down=latency:{kw['fault_delay_s']}")
            for _ in range(3):
                pulse()
                if "slo-latency-burn" in eng.active:
                    break
            fired = "slo-latency-burn" in eng.active
            evals_to_fire = (
                eng.active["slo-latency-burn"]["firedAtEvaluation"]
                - evals_before) if fired else None
            rec = srv0.flightrec
            bundle_ok, bundle_bytes = False, 0
            if rec is not None and rec.last is not None:
                with open(rec.last["path"]) as f:
                    bundle = json.load(f)
                bundle_ok = "slo-latency-burn" in \
                    (bundle.get("alerts") or {}).get("active", {})
                bundle_bytes = rec.last["bytes"]
            for proxy in proxies.values():
                proxy.heal()
            resolved = False
            for _ in range(10):
                pulse()
                if "slo-latency-burn" not in eng.active:
                    resolved = True
                    break
            out["alert"] = {
                "fired": fired, "evals_to_fire": evals_to_fire,
                "resolved": resolved, "bundle_ok": bundle_ok,
                "bundle_kb": bundle_bytes / 1024,
                "budget_held": rec is not None
                and rec.disk_bytes() <= rec.budget_mb << 20,
                "fired_total": eng.fired_total,
                "resolved_total": eng.resolved_total}
        a = out["alert"]
        require(a["fired"] and a["evals_to_fire"] <= 2, "slo",
                f"the straggler did not page within 2 evaluations: {a}")
        require(a["bundle_ok"] and a["bundle_kb"] > 0 and a["budget_held"],
                "slo", f"no readable bundle inside the budget: {a}")
        require(a["resolved"], "slo", f"the heal did not resolve: {a}")

        # story 2: evaluation overhead on the serving path.  Each mode's
        # server runs in a process of its own (the evaluator's passes
        # over its ring cost background CPU and the interpreter lock,
        # which must fall on the on server alone), both stay open, and
        # their requests alternate one by one (on, off, then off, on), so
        # the host's drift lands on both modes alike: on an H100 host the
        # runs of one mode moved 121-198 calls/s within a call, and
        # whole runs alternating between the two servers read a best-run
        # ratio of 0.90 to 1.08.  A mode's run is its n requests; its
        # seconds are theirs.
        rows, cols = draw_set(rng, 2, 4000, 4)
        oracle = BitsOracle(rows, cols)
        corpus = ["Count(Row(a=1))", "Row(a=2)", "TopN(a, n=3)",
                  "Count(Intersect(Row(a=0), Row(a=3)))"]
        n = kw["overhead_q"]
        rounds = 2 * kw["overhead_runs"]
        runs: dict = {"on": [], "off": []}
        answers: dict = {}
        d0 = device_snapshot()
        modes = {mode: dict(alert_rules=rules, timeseries_interval=0.05,
                            timeseries_window=30, trace_sample_rate=0.0)
                 for mode, rules in (("on", "all"), ("off", "off"))}
        with server_processes("slo", self.device, modes) as servers:
            for mode, sp in servers.items():
                load_set(sp.port, "ov", "a", rows, cols)
                answers[mode] = [ask_json("slo", oracle, sp.port, "ov", qq)
                                 for qq in corpus]
            # one untimed round first: neither mode pays the process's
            # first-sighting costs inside its timed runs
            for k in range(rounds + 1):
                lats: dict = {"on": [], "off": []}
                for i in range(n):
                    q = corpus[i % len(corpus)]
                    for mode in (("on", "off") if (i + k) % 2
                                 else ("off", "on")):
                        t1 = time.perf_counter()
                        body = post(servers[mode].port, "/index/ov/query",
                                    q.encode())
                        lats[mode].append(time.perf_counter() - t1)
                        require(body == answers[mode][i % len(corpus)],
                                "slo", f"{mode} query {i} answered unlike "
                                f"its first")
                if k:
                    for mode, lat in lats.items():
                        runs[mode].append((sum(lat), lat))
            on = servers["on"].stats()["slo_evaluations"]
            off = servers["off"].stats()["slo_evaluations"]
        require(on is not None and on > 0, "slo",
                "the evaluation-on server never evaluated")
        require(off is None, "slo", "alert-rules=off still built an engine")
        out["evaluations_on"] = on
        out["device"] = device_delta(d0, 2 * n * (rounds + 1))
        require(answers["on"] == answers["off"], "slo",
                "answers differ with evaluation on and off")
        for mode in ("on", "off"):
            out[f"overhead_{mode}"] = runs_record(runs[mode], 1, 1)
        out.update(answers_identical=True, answers="pass", failures=0,
                   attempts=2 * n * rounds,
                   qps_on=out["overhead_on"]["qps"],
                   qps_off=out["overhead_off"]["qps"])
        out["qps_ratio"] = out["qps_on"] / out["qps_off"]
        out["qps_gate"] = self.cuda_gate(
            out["qps_ratio"] >= 0.95, "slo",
            f"evaluation costs the serving path: qps ratio "
            f"{out['qps_ratio']}")
        say("slo", evals_to_fire=a["evals_to_fire"],
            bundle_kb=a["bundle_kb"], qps_ratio=out["qps_ratio"])
        return {"20_slo_alerting": out}

    # -- leg: 12_internal_wire (bench.py:1579-1840) ---------------------------

    def wire(self) -> dict:
        """bench.py ``_wire_leg`` (:1579-1822) at ``bench_wire``'s size
        (smoke: ``run_wire_smoke``'s, with the mixed-version check): two
        nodes, the coordinator owning no shard of either index, so every
        query is a remote fan-out.  The recorded dense and sparse corpora
        replay through node0's ``api.query`` in-process over the binary
        wire, then with every node pinned to JSON (flipped in-process as
        bench.py's ``set_wire`` :1630 does): every answer of both passes
        equals the oracle, the wires answer byte-identically, and the
        binary wire carries the sparse results in under 1/1.5 of JSON's
        bytes."""
        from .parallel.cluster import result_to_wire
        from .server.handler import serialize_result
        kw = self.plan.wire
        rng = self.rng(12)
        n_shards = kw["n_shards"]
        dense_rows, sparse_rows = kw["dense_rows"], kw["sparse_rows"]
        with self.nodes(2, replica_n=1, internal_wire="bin1") \
                as (servers, _):
            coord = servers[0].cluster
            p0 = servers[0].port
            owned = [s for name in ("w1", "qx") for s in range(n_shards)
                     if "node0" in coord.placement.shard_nodes(name, s)]
            require(not owned, "wire", f"node0 owns shards {owned}")

            def set_wire(mode):
                for srv in servers:
                    srv.cluster.internal_wire = mode
                    srv.cluster.client.wire_mode = mode
                    srv.cluster.client._wire_down.clear()
                    srv.cluster.client._peer_wire.clear()

            # through the coordinator's api in-process, as bench.py
            # seeds; the import fan-out still routes each shard's batch
            # to its owner
            oracles = {}
            for name, rows in wire_bits(rng, n_shards, dense_rows,
                                        kw["dense_bits"], sparse_rows,
                                        kw["sparse_run"]).items():
                post(p0, f"/index/{name}", b"{}")
                post(p0, f"/index/{name}/field/a", b"{}")
                for r, cols in enumerate(rows):
                    servers[0].api.import_bits(name, "a", [r] * cols.size,
                                               cols.tolist())
                oracles[name] = BitsOracle(
                    np.concatenate([np.full(c.size, r)
                                    for r, c in enumerate(rows)]),
                    np.concatenate(rows))
            corpora = {"dense": wire_dense_corpus(rng, kw["wave_q"],
                                                  dense_rows),
                       "sparse": wire_sparse_corpus(rng, kw["wave_q"],
                                                    sparse_rows)}
            stats = servers[0].stats
            api0 = servers[0].api

            def counters():
                return {
                    "bytes": stats.count_value("cluster.wire_bytes_tx")
                    + stats.count_value("cluster.wire_bytes_rx"),
                    "frames": stats.count_value("cluster.wire_frames"),
                    "fallback": stats.count_value("cluster.wire_fallback"),
                    "wire_s": stats.timing_totals(
                        "cluster.multi.wire_overhead")[1],
                    "reduce_s": stats.timing_totals(
                        "cluster.multi.reduce")[1]}

            def check(label, items, results):
                check_all("wire", [
                    (f"{label} request {i}",
                     [serialize_result(r) for r in res],
                     lambda i=i: oracles[items[i][0]].answer(items[i][1]))
                    for i, res in enumerate(results)])

            def replay(corpus, n, label):
                """An untimed identity pass (each answer in wire form),
                then ``n`` requests timed; every answer of both is
                checked after."""
                ident = [api0.query(idx, q) for idx, q in corpus]
                answers = [json.dumps([result_to_wire(r) for r in res],
                                      sort_keys=True) for res in ident]
                check(f"{label} identity", corpus, ident)
                items = [corpus[i % len(corpus)] for i in range(n)]
                c0 = counters()
                wall, lat, out = closed_loop(
                    lambda i: api0.query(*items[i]), n, kw["threads"])
                c1 = counters()
                check(label, items, out)
                d = {k: c1[k] - c0[k] for k in c0}
                rec = runs_record([(wall, lat)], 2, kw["threads"])
                rec.update(qps=n / wall, bytes_per_q=d["bytes"] / n,
                           frames_per_q=d["frames"] / n,
                           fallback=d["fallback"],
                           wire_ms_per_q=d["wire_s"] / n * 1e3,
                           reduce_ms_per_q=d["reduce_s"] / n * 1e3)
                return rec, answers

            runs, answers = {}, {}
            d0 = device_snapshot()
            for mode in ("bin1", "json"):
                set_wire(mode)
                for idx, q in corpora["dense"][:4] + corpora["sparse"][:4]:
                    api0.query(idx, q)          # warm the wire and graphs
                runs[mode], answers[mode] = {}, {}
                for leg, n in (("dense", kw["waves"] * kw["wave_q"]),
                               ("sparse", kw["wave_q"])):
                    runs[mode][leg], answers[mode][leg] = replay(
                        corpora[leg], n, f"{mode} {leg}")
                    say("wire", mode=mode, leg=leg,
                        qps=runs[mode][leg]["qps"],
                        bytes_per_q=runs[mode][leg]["bytes_per_q"])
            dev = device_delta(d0, 2 * (kw["waves"] + 1) * kw["wave_q"])
            for leg in ("dense", "sparse"):
                require(answers["bin1"][leg] == answers["json"][leg],
                        "wire", f"the binary wire diverged from JSON "
                        f"answers ({leg})")
            out = {
                "answers_identical": True, "answers": "pass",
                "failures": 0, "load": f"closed loop, {kw['threads']} "
                f"clients of node0's api.query, 2 calls a request",
                "attempts": 2 * (kw["waves"] + 1) * kw["wave_q"],
                "qps_bin1": runs["bin1"]["dense"]["qps"],
                "qps_json": runs["json"]["dense"]["qps"],
                "bin1_vs_json": runs["bin1"]["dense"]["qps"]
                / runs["json"]["dense"]["qps"],
                "dense_wire_bytes_per_q": {
                    m: runs[m]["dense"]["bytes_per_q"] for m in runs},
                "sparse_wire_bytes_per_q": {
                    m: runs[m]["sparse"]["bytes_per_q"] for m in runs},
                "sparse_bytes_ratio": runs["json"]["sparse"]["bytes_per_q"]
                / runs["bin1"]["sparse"]["bytes_per_q"],
                "wire_ms_per_q": {
                    m: runs[m]["dense"]["wire_ms_per_q"] for m in runs},
                "reduce_ms_per_q": {
                    m: runs[m]["dense"]["reduce_ms_per_q"] for m in runs},
                "frames_per_q_bin1": runs["bin1"]["dense"]["frames_per_q"],
                "runs": runs, "device": dev}
            if kw["fallback_check"]:
                # mixed versions: node1 pinned to JSON, node0 binary and
                # marked optimistic — the first POST must 415, latch the
                # downgrade, retry as JSON and answer identically
                servers[1].cluster.internal_wire = "json"
                coord.internal_wire = "bin1"
                coord.client.wire_mode = "bin1"
                coord.client._wire_down.clear()
                coord.client._peer_wire[coord.nodes[1].host] = "bin1"
                fb0 = stats.count_value("cluster.wire_fallback")
                idx, q = corpora["sparse"][0]
                got = json.dumps([result_to_wire(r)
                                  for r in api0.query(idx, q)],
                                 sort_keys=True)
                fb = stats.count_value("cluster.wire_fallback") - fb0
                require(fb >= 1, "wire", "the 415 downgrade never fired")
                require(got == answers["bin1"]["sparse"][0], "wire",
                        "the downgraded answer diverged")
                out["fallback"] = {"count": fb, "answers_identical": True}
        require(out["sparse_bytes_ratio"] > 1.5, "wire",
                f"the binary wire did not shrink sparse results: "
                f"{out['sparse_wire_bytes_per_q']}")
        say("wire", bin1_vs_json=out["bin1_vs_json"],
            sparse_bytes_ratio=out["sparse_bytes_ratio"])
        return {"12_internal_wire": out}

    # -- leg: 13_tenant_isolation (bench.py:1843-2020) ------------------------

    def tenant(self) -> dict:
        """bench.py ``_tenant_leg`` (:1843-1994) at ``bench_tenant``'s size
        (smoke: ``run_tenant_smoke``'s): one node with two query slots; a
        hostile tenant floods the gate from ``flood_threads`` client
        processes (bench.py: threads) that ignore Retry-After while a
        polite tenant runs its corpus with bounded retries.  Polite
        alone, then under the flood, with
        weighted-fair admission on, then off (two servers, identical
        data).  Admitted answers are byte-identical across the runs of
        each pass and both passes and equal the oracle; with isolation
        on the sheds land on the hostile tenant (>= 0.95) and never on
        the polite one.  With isolation off a polite query refused 40
        times is counted as starved (``polite_starved``), where bench.py
        ends the leg: starvation is what that pass exists to show.  The
        queue timeout is bench.py's 0.2 s or 4 times the idle run's
        slowest query, whichever is longer (``queue_timeout_s``)."""
        from .utils import tenant as qtenant
        kw = self.plan.tenant
        rng = self.rng(13)
        rows, cols = draw_set(rng, kw["n_shards"], 8000, 8)
        oracle = BitsOracle(rows, cols)
        corpus = ["Count(Intersect(Row(f=1), Row(f=2)))",
                  "TopN(f, n=0)", "Count(Row(f=3))", "Row(f=4)"]
        want = [oracle.answer(q) for q in corpus]

        def run_pass(isolation):
            srv = self.start_server(
                max_queries=2, queue_timeout=0.2,
                tenant_isolation=isolation,
                tenant_weights="polite:4,hostile:1")
            qtenant.REGISTRY.clear()
            try:
                port = srv.port
                load_set(port, "t", "f", rows, cols)
                for q in corpus:
                    query_status(port, "t", q, "polite")

                def polite_run(n):
                    lats, bodies, sheds = [], [], 0
                    for i in range(n):
                        q = corpus[i % len(corpus)]
                        t0 = time.perf_counter()
                        for _ in range(40):
                            st, ra, data = query_status(port, "t", q,
                                                        "polite")
                            if st == 200:
                                break
                            require(st == 503, "tenant",
                                    f"polite query answered {st}: "
                                    f"{data[:200]!r}")
                            sheds += 1
                            time.sleep(min(ra or 0.05, 0.25))
                        else:
                            # starved: refused 40 times (the FIFO gate
                            # under the flood); no answer to check
                            data = None
                        # the wait includes sheds and retries: what the
                        # polite tenant sees
                        lats.append(time.perf_counter() - t0)
                        bodies.append(data)
                    return lats, bodies, sheds

                lat_idle, idle, idle_sheds = polite_run(kw["n_polite"])
                require(idle_sheds == 0, "tenant",
                        "the idle polite run was shed")
                # under fair admission a polite query waits for one of
                # the two running queries, then runs: bench.py's 0.2 s
                # queue timeout holds that on an idle host (the card's
                # idle p99 is 15 ms); where an idle query takes a large
                # share of it (a loaded CPU), the timeout is 4 times the
                # idle run's slowest query, so the gate reads the
                # admission order, not the host's speed
                timeout = max(0.2, 4 * max(lat_idle))
                srv.admission.queue_timeout = timeout
                # the flood: one client process a flood thread, so the
                # clients do not hold the serving process's interpreter
                # lock (bench.py's threads there measured the bench's
                # own contention: a polite query then waited out the
                # 0.2 s queue timeout on the card)
                flood = [subprocess.Popen(
                    [sys.executable, "-c", FLOOD_WORKER, str(port),
                     str(kw["flood_iters"]), qtenant.TENANT_HEADER,
                     corpus[0]], stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)
                    for _ in range(kw["flood_threads"])]
                try:
                    # let the flood fill the slots and the queue
                    def reached():
                        st = srv.admission.snapshot()["tenants"].get(
                            "hostile", {})
                        return sum(st.get(k, 0) for k in (
                            "admitted", "queued", "shed")) \
                            >= 2 * kw["flood_threads"]

                    wait_for(reached, "tenant", "the flood", timeout=30)
                    time.sleep(0.2)
                    lat_flood, flooded, polite_sheds = polite_run(
                        kw["n_polite"])
                finally:
                    for proc in flood:
                        proc.kill()
                    for proc in flood:
                        proc.communicate(timeout=60)
                starved = flooded.count(None)
                require(idle.count(None) == 0 and (starved == 0
                                                   or not isolation),
                        "tenant", f"{starved} polite queries starved with "
                        f"isolation {'on' if isolation else 'off'}")
                check_all("tenant", [
                    (f"polite {label} {i}", json.loads(b)["results"],
                     lambda i=i: want[i % len(corpus)])
                    for label, bodies in (("idle", idle),
                                          ("flood", flooded))
                    for i, b in enumerate(bodies) if b is not None])
                require(all(b is None or b == a
                            for a, b in zip(idle, flooded)), "tenant",
                        "admitted answers diverged under the flood")
                reg = qtenant.REGISTRY.snapshot()
                hostile_shed = reg.get("hostile", {}).get("shed", 0)
                total_shed = hostile_shed + \
                    reg.get("polite", {}).get("shed", 0)
                p99 = [sorted(x)[max(int(len(x) * 0.99) - 1, 0)]
                       for x in (lat_idle, lat_flood)]
                return {
                    "fair": srv.admission.snapshot()["fair"],
                    "queue_timeout_s": timeout,
                    "p99_idle_ms": p99[0] * 1e3,
                    "p99_flood_ms": p99[1] * 1e3,
                    "polite_vs_idle": p99[1] / p99[0],
                    "idle": latency_record(lat_idle),
                    "flood": latency_record(lat_flood),
                    "polite_sheds": polite_sheds,
                    "polite_starved": starved,
                    "hostile_sheds": hostile_shed,
                    "total_sheds": total_shed,
                    "shed_attribution": hostile_shed / total_shed
                    if total_shed else None,
                    "hedge_denied": reg.get("polite", {}).get(
                        "hedgeDenied", 0) + reg.get("hostile", {}).get(
                        "hedgeDenied", 0)}, idle
            finally:
                qtenant.REGISTRY.clear()
                srv.close()

        d0 = device_snapshot()
        on, ans_on = run_pass(True)
        off, ans_off = run_pass(False)
        dev = device_delta(d0, 4 * kw["n_polite"])
        require(ans_on == ans_off, "tenant",
                "answers differ with isolation on and off")
        require(on["fair"] is True and off["fair"] is False, "tenant",
                f"fair admission on {on['fair']}, off {off['fair']}")
        require(on["total_sheds"] > 0, "tenant", "the flood never shed")
        require(on["shed_attribution"] >= 0.95 and on["polite_sheds"] == 0,
                "tenant", f"sheds not on the hostile tenant: {on}")
        rec = {"answers_identical": True, "answers": "pass", "failures": 0,
               "attempts": 4 * kw["n_polite"],
               "load": f"one polite client against {kw['flood_threads']} "
                       f"hostile flood threads, 2 query slots",
               "isolation_on": on, "isolation_off": off, "device": dev}
        say("tenant", attribution=on["shed_attribution"],
            p99_flood_on_ms=on["p99_flood_ms"],
            p99_flood_off_ms=off["p99_flood_ms"])
        return {"13_tenant_isolation": rec}

    # -- the smoke-only legs (bench.py :2315-2432, :2836-3165) ----------------

    def cache(self) -> dict:
        """bench.py ``run_cache_smoke`` (:2912-2970): repeated unfiltered
        TopN / Count on unchanged data, cold (the result and rank caches
        flushed before each run) against warm (result-cache hits).  The
        cached answers equal the cold ones and the oracle, and every
        warm repeat is a hit; on the card warm is at least 5x faster."""
        from .cache.rank import iter_rank_caches
        from .storage import Holder
        rng = self.rng(3)
        h = Holder(None)
        f = h.create_index("cachesmoke", track_existence=False) \
            .create_field("f")
        n_bits = 200_000
        rows = rng.integers(0, 64, size=n_bits)
        cols = rng.integers(0, 4 * SHARD_WIDTH, size=n_bits)
        f.import_bits(rows, cols)
        oracle = BitsOracle(rows, cols)
        ex = self.executor(h)
        ex.result_cache.limit_bytes = 64 << 20
        queries = ["TopN(f, n=10)", "Count(Row(f=7))",
                   "Count(Intersect(Row(f=1), Row(f=2)))"]

        def clear():
            ex.result_cache.clear()
            for _frag, c in iter_rank_caches(ex.holder):
                c.invalidate()

        def once():
            t0 = time.perf_counter()
            out = [ex.execute("cachesmoke", q) for q in queries]
            return time.perf_counter() - t0, out

        try:
            # warm the executables on other literals: the cold runs time
            # execution and cache builds, not first sightings
            ex.execute("cachesmoke", "TopN(f, n=9) Count(Row(f=6)) "
                       "Count(Intersect(Row(f=3), Row(f=4)))")
            d0 = device_snapshot()
            colds = []
            for _ in range(3):
                clear()
                colds.append(once())
            clear()
            once()                                           # fill
            h0, m0 = ex.result_cache.hits, ex.result_cache.misses
            warms = [once() for _ in range(15)]
            hits = ex.result_cache.hits - h0
            misses = ex.result_cache.misses - m0
            resident = ex.result_cache.resident_bytes
            dev = device_delta(d0, len(colds) + len(warms) + 1)
        finally:
            ex.close()
        from .server.handler import serialize_result
        check_all("cache", [
            (f"{kind} run {k}", [serialize_result(x) for r in out for x in r],
             lambda: [a for q in queries for a in oracle.answer(q)])
            for kind, rs in (("cold", colds), ("warm", warms))
            for k, (_s, out) in enumerate(rs)])
        require(hits == 15 * len(queries) and misses == 0, "cache",
                f"warm repeats not served from the cache: {hits} hits, "
                f"{misses} misses")
        cold_s = statistics.median(s for s, _ in colds)
        warm_s = statistics.median(s for s, _ in warms)
        rec = {"cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3,
               "speedup": cold_s / warm_s, "hit_ratio": hits / (hits + misses),
               "resident_bytes": resident, "device": dev,
               "answers": "pass", "failures": 0,
               "attempts": len(colds) + len(warms)}
        rec["speedup_gate"] = self.cuda_gate(
            rec["speedup"] >= 5, "cache",
            f"warm repeats only {rec['speedup']}x faster than cold")
        say("cache", cold_ms=rec["cold_ms"], warm_ms=rec["warm_ms"],
            speedup=rec["speedup"])
        return {"cache": rec}

    def overload(self) -> dict:
        """bench.py ``run_overload_smoke`` (:2836-2899): a burst of 8
        queries against 2 query slots with the ``mesh.slice`` failpoint
        delaying each by 0.15 s yields only 200s and 503s, both present,
        every 200 equal to the oracle; a query under a 50 ms budget
        answers 504."""
        from .utils.faults import FAULTS
        srv = self.start_server(max_queries=2, queue_timeout=0.05)
        try:
            port = srv.port
            post(port, "/index/sm", b"{}")
            post(port, "/index/sm/field/f", b"{}")
            post(port, "/index/sm/query", b"Set(1, f=1) Set(1048579, f=1)")
            FAULTS.arm("mesh.slice", mode="delay", arg=0.15, match="sm")
            try:
                codes, bodies = [], []
                lock = threading.Lock()

                def one():
                    st, _ra, data = query_status(port, "sm",
                                                 "Count(Row(f=1))",
                                                 timeout=30)
                    with lock:
                        codes.append(st)
                        bodies.append((st, data))

                threads = [threading.Thread(target=one) for _ in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                require(not any(t.is_alive() for t in threads),
                        "overload", "the burst did not finish")
                t0 = time.perf_counter()
                code_504, _ra, _data = query_status(
                    port, "sm", "Count(Row(f=1))", params="?timeout=0.05",
                    timeout=30)
                deadline_s = time.perf_counter() - t0
            finally:
                FAULTS.disarm()
        finally:
            srv.close()
        require(set(codes) <= {200, 503} and 200 in codes and 503 in codes,
                "overload", f"burst statuses {codes}")
        require(all(json.loads(d)["results"] == [2]
                    for st, d in bodies if st == 200), "overload",
                "a burst answer differs from the oracle")
        require(code_504 == 504, "overload", f"expected 504, got {code_504}")
        rec = {"burst_200": codes.count(200), "burst_503": codes.count(503),
               "deadline_504_s": deadline_s, "answers": "pass",
               "failures": 0, "attempts": len(codes) + 1}
        say("overload", **rec)
        return {"overload": rec}

    def observability(self) -> dict:
        """bench.py ``run_observability_smoke`` (:2315-2432): with
        tracing, latency histograms and the slow-query log armed,
        ``?profile=true`` returns a populated stage tree whose trace id
        resolves at ``/debug/traces``, the slow log captures a query,
        ``/metrics`` has the query histogram and the device families,
        and the time-series ring wraps its window; on the card the
        capture registry saw captures and the profile-off serving path
        stays within 5% of the batching leg.  The batching leg
        (``run_http_batch_smoke``'s on-mode server) runs here on the same
        data and load, each server in a process of its own, both open
        and their runs alternating (base, observed, then observed,
        base), ``OBS_RUNS`` each, and the 5% is judged on the median
        request
        of all their runs (``overhead_pct``): a closed loop's calls/s is
        its clients over its mean request, and the mean and the best
        run (bench.py's ``qps``, reported as ``qps_overhead_pct``) move
        with the graph captures of the batcher's fused shapes, which
        land in one run or another: the best runs moved 12% either way
        between calls on the card."""
        rng = self.rng(5)
        cols = rng.integers(0, SHARD_WIDTH, size=20_000)
        rws = rng.integers(0, 64, size=20_000)
        oracle = BitsOracle(rws, cols)

        def load(port, per_client):
            rows = rng.integers(0, 64, size=OBS_CLIENTS * per_client)
            queries = [f"Count(Row(f={r}))" for r in rows]
            wall, lat, bodies = process_load(
                "observability", port, "obs",
                [queries[k::OBS_CLIENTS] for k in range(OBS_CLIENTS)])
            order = [q for k in range(OBS_CLIENTS)
                     for q in queries[k::OBS_CLIENTS]]
            check_all("observability", [
                (f"count {i}", json.loads(b)["results"],
                 lambda q=order[i]: oracle.answer(q))
                for i, b in enumerate(bodies)])
            return wall, lat

        modes = {"base": dict(dispatch_batch_window_us=1000,
                              dispatch_batch=True),
                 "obs": dict(dispatch_batch_window_us=1000,
                             slow_query_threshold=0.5, trace_sample_rate=1.0,
                             timeseries_interval=0.05, timeseries_window=1.0)}
        with server_processes("observability", self.device, modes) as sps:
            for sp in sps.values():
                load_set(sp.port, "obs", "f", rws, cols)
            for _ in range(2):                               # warm
                for sp in sps.values():
                    load(sp.port, 8)
            base_runs, obs_runs = [], []
            pair = [(sps["base"], base_runs), (sps["obs"], obs_runs)]
            for _ in range(OBS_RUNS):
                for sp, runs in pair:
                    runs.append(load(sp.port, OBS_PER_CLIENT))
                pair.reverse()          # base, obs, then obs, base
            base = runs_record(base_runs, 1, OBS_CLIENTS)
            obs = runs_record(obs_runs, 1, OBS_CLIENTS)
            port = sps["obs"].port
            prof = json.loads(post(port, "/index/obs/query?profile=true",
                                   b"Count(Row(f=7))"))
            require(prof["results"] == oracle.answer("Count(Row(f=7))"),
                    "observability", "the profiled answer differs")
            require(bool(prof.get("profile", {}).get("children")),
                    "observability", "?profile=true returned an empty tree")
            spans = json.loads(get(
                port, f"/debug/traces?trace={prof['traceID']}"))["spans"]
            require(bool(spans), "observability",
                    "the profile's trace id is unknown to /debug/traces")
            sps["obs"].slow(1e-9)
            post(port, "/index/obs/query", b"Count(Row(f=9))")
            wait_for(lambda: json.loads(get(port, "/debug/slow"))["entries"],
                     "observability", "a slow-log entry")
            slow = json.loads(get(port, "/debug/slow"))
            text = get(port, "/metrics").decode()
            require("pilosa_tpu_http_query_seconds_bucket" in text,
                    "observability", "/metrics lacks the query histogram")
            require(all(f"pilosa_tpu_device_{m}" in text for m in (
                "compiles_total", "padding_waste_ratio",
                "decode_workspace_peak_bytes")), "observability",
                "/metrics lacks the device-runtime families")

            def covered():
                ts = json.loads(get(port, "/debug/timeseries"))
                return ts if ts["coveredS"] >= ts["windowS"] and \
                    ts["samplesTotal"] > ts["capacity"] else None

            ts = wait_for(covered, "observability",
                          "a wrapped time-series window", timeout=10)
            dev = json.loads(get(port, "/debug/vars"))["device"]
        rec = {"calls_per_s": obs["calls_per_s"], "qps": obs["qps"],
               "batching_calls_per_s": base["calls_per_s"],
               "batching_qps": base["qps"],
               "overhead_pct": 100.0 * (1.0 - base["p50_ms"]
                                        / obs["p50_ms"]),
               "qps_overhead_pct": 100.0 * (1.0 - obs["qps"] / base["qps"]),
               "observed": obs, "batching": base,
               "profile_stages": len(prof["profile"]["children"]),
               "trace_spans": len(spans), "slow_recorded": slow["recorded"],
               "timeseries_samples": len(ts["samples"]),
               "device": {"compiles": dev["compiles"]["compiles"],
                          "retraces": dev["compiles"]["retraces"],
                          "compile_s":
                              dev["compiles"]["compileSecondsTotal"],
                          "padding_waste_ratio":
                              dev["launches"]["paddingWasteRatio"]},
               "answers": "pass", "failures": 0,
               "attempts": 2 * OBS_RUNS * OBS_PER_CLIENT * OBS_CLIENTS}
        rec["captures_gate"] = self.cuda_gate(
            rec["device"]["compiles"] > 0, "observability",
            "the capture registry saw no capture")
        rec["overhead_gate"] = self.cuda_gate(
            rec["overhead_pct"] <= 5.0, "observability",
            f"profile-off overhead over 5%: median request "
            f"{obs['p50_ms']} against {base['p50_ms']} ms")
        say("observability", qps=obs["qps"], batching_qps=base["qps"],
            overhead_pct=rec["overhead_pct"])
        return {"observability": rec}

    def restart(self) -> dict:
        """bench.py ``run_restart_smoke`` (:3095-3165): a server process
        seeded with steady traffic is killed with SIGKILL mid-serving,
        then restarted on the same data dir (warm: the durable corpus is
        replayed before READY) and again with the corpus deleted (cold).
        The warm restart replayed the corpus with no error and no
        retrace, the cold one replayed nothing, and each restart's
        answers equal the oracle; on the card the warm first request
        beats the cold one."""
        tmp = tempfile.mkdtemp(prefix="ptt_bench_restart_")
        root, env = worker_env()
        oracle = BitsOracle(np.repeat(np.arange(4), 60),
                            np.tile(np.arange(60), 4))
        want = [a for q in RESTART_QUERIES for a in oracle.answer(q)]

        def worker(mode):
            return subprocess.Popen(
                [sys.executable, "-c", RESTART_WORKER, mode, tmp,
                 str(self.device)], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def restart(label):
            proc = worker("restart")
            try:
                raw, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            require(proc.returncode == 0 and raw.strip(), "restart",
                    f"the {label} restart died: {err[-2000:]}")
            out = json.loads(raw.strip().splitlines()[-1])
            require(out["answers"] == want and out["first"] == want[0],
                    "restart", f"the {label} restart answered "
                    f"{out['first']}, {out['answers']}")
            return out

        try:
            seed = worker("seed")
            try:
                line = seed.stdout.readline().strip()
                if line != "SEEDED":
                    raise LegFailed(f"restart: the seed worker failed: "
                                    f"{seed.stderr.read()[-2000:]}")
            finally:
                seed.kill()      # SIGKILL mid-serving
                seed.wait(timeout=30)
            corpus_file = os.path.join(tmp, "signatures.log")
            require(os.path.exists(corpus_file), "restart",
                    "kill -9 lost the corpus: no flush landed")
            warm = restart("warm")
            wst = warm["warmup"]
            require(wst["replayed"] >= 1 and wst["errors"] == 0
                    and wst["retracesDuringWarm"] == 0, "restart",
                    f"the warm replay: {wst}")
            os.unlink(corpus_file)
            cold = restart("cold")
            require(cold["warmup"]["replayed"] == 0, "restart",
                    f"the cold restart replayed: {cold['warmup']}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rec = {"replayed": wst["replayed"], "planned": wst["planned"],
               "retraces_during_warm": wst["retracesDuringWarm"],
               "saved_compile_s": wst["savedCompileS"],
               "warm_first_ms": warm["first_ms"],
               "cold_first_ms": cold["first_ms"],
               "steady_ms": warm["steady_ms"],
               "warm_vs_cold": cold["first_ms"] / warm["first_ms"],
               "warm_vs_steady": warm["first_ms"] / warm["steady_ms"],
               "answers": "pass", "failures": 0, "attempts": 2}
        rec["first_request_gate"] = self.cuda_gate(
            warm["first_ms"] < cold["first_ms"], "restart",
            f"the warm first request ({warm['first_ms']} ms) is not "
            f"faster than the cold one ({cold['first_ms']} ms)")
        say("restart", warm_first_ms=rec["warm_first_ms"],
            cold_first_ms=rec["cold_first_ms"], replayed=rec["replayed"])
        return {"restart": rec}


def holder_words(holder, field: str) -> dict:
    """Shard -> stored ``[rows, SHARD_WORDS]`` words of one config-5
    field."""
    return {s: fr.words for s, fr in holder.field(
        cfg5.INDEX, field).view("standard").fragments.items()}


def cfg5_cpu(seg: dict, met: dict, shards, rng, n: int = 2) -> float:
    """bench.py ``cpu_config5`` (:233-248): single-thread word-wise
    Intersect + TopN over the ``seg`` and ``metric`` words (shard ->
    rows) of ``shards``."""
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



# -- the cluster and robustness legs' corpora and oracles ------------------------

OBS_CLIENTS = 16        # bench.py ``_http_count_load``'s 16 threads (here processes)
OBS_RUNS = 8            # runs a server; the 5% bound is judged on their median request
# requests a client a run: at 32 the median request moved -15.8 to 9.1%
# between calls on an H100 host with both servers in one process
OBS_PER_CLIENT = 64


def mixed5d(rng) -> list:
    """The config-5d record phase's mixed workload (bench.py :955-961):
    twelve 4-call TopN batches, then eight ``Row`` and eight
    ``Count(Intersect)`` singles, alternating."""
    mixed = [cfg5._cfg5_batch(rng, 4) for _ in range(12)]
    for i in range(16):
        a = int(rng.integers(0, 4))
        b = (a + 1 + int(rng.integers(0, 3))) % 4
        mixed.append(f"Count(Intersect(Row(seg={a}), Row(seg={b})))"
                     if i % 2 else f"Row(seg={a})")
    return mixed


def routing_corpus(rng, n: int) -> list:
    """The routing leg's skewed corpus (bench.py :1107-1123): about 80%
    of the queries on the hot index."""
    out = []
    for _ in range(n):
        a = int(rng.integers(0, 8))
        b = (a + 1 + int(rng.integers(0, 6))) % 8
        hot = rng.random() < 0.8
        idx = "hotidx" if hot else "coldidx"
        kind = int(rng.integers(0, 4))
        if kind == 0:
            q = f"Count(Intersect(Row(a={a}), Row(a={b})))"
        elif kind == 1:
            q = f"Count(Row(a={a}))"
        elif kind == 2:
            q = f"Row(a={a})"
        else:
            q = "TopN(a, n=0)"      # exact cluster reduce
        out.append((idx, q))
    return out


def wire_bits(rng, n_shards: int, dense_rows: int, dense_bits: int,
              sparse_rows: int, sparse_run: int) -> dict:
    """The wire leg's two indexes (bench.py :1662-1674), each a list of
    sorted column arrays by row: ``w1`` scattered random bits, ``qx``
    a short run near the base of each shard."""
    span = n_shards * SHARD_WIDTH
    dense = [np.unique(rng.integers(0, span, size=dense_bits))
             for _ in range(dense_rows)]
    sparse = [np.concatenate([
        np.arange(s * SHARD_WIDTH + r * sparse_run,
                  s * SHARD_WIDTH + (r + 1) * sparse_run)
        for s in range(n_shards)]) for r in range(sparse_rows)]
    return {"w1": dense, "qx": sparse}


def wire_dense_corpus(rng, n: int, dense_rows: int) -> list:
    """The wire leg's dense corpus (bench.py :1676-1687)."""
    out = []
    for _ in range(n):
        a = int(rng.integers(0, dense_rows))
        b = (a + 1 + int(rng.integers(0, dense_rows - 1))) % dense_rows
        kind = int(rng.integers(0, 3))
        if kind == 0:
            q = f"Row(a={a})Row(a={b})"
        elif kind == 1:
            q = f"Union(Row(a={a}), Row(a={b}))Count(Row(a={a}))"
        else:
            q = f"Row(a={a})Intersect(Row(a={a}), Row(a={b}))"
        out.append(("w1", q))
    return out


def wire_sparse_corpus(rng, n: int, sparse_rows: int) -> list:
    """The wire leg's sparse corpus (bench.py :1689-1692)."""
    out = []
    for _ in range(n):
        a = int(rng.integers(0, sparse_rows))
        out.append(("qx", f"Row(a={a})Row(a={(a + 1) % sparse_rows})"))
    return out


def draw_set(rng, n_shards: int, n_bits: int, n_rows: int):
    """One set field's bits as bench.py's cluster legs draw them: unique
    columns over ``n_shards`` shards, then a row each."""
    cols = np.unique(rng.integers(0, n_shards * SHARD_WIDTH, size=n_bits))
    rows = rng.integers(0, n_rows, size=cols.size)
    return rows, cols


def load_set(port: int, index: str, field: str, rows, cols):
    """Create ``index`` / ``field`` and import the bits as JSON."""
    post(port, f"/index/{index}", b"{}")
    post(port, f"/index/{index}/field/{field}", b"{}")
    post(port, f"/index/{index}/field/{field}/import", json.dumps({
        "rowIDs": np.asarray(rows).tolist(),
        "columnIDs": np.asarray(cols).tolist()}).encode())


def ask_json(leg: str, oracle, port: int, index: str, pql: str) -> bytes:
    """POST one query; its results must equal ``oracle.answer``.
    Returns the body."""
    body = post(port, f"/index/{index}/query", pql.encode())
    check_all(leg, [(pql, json.loads(body)["results"],
                     lambda: oracle.answer(pql))])
    return body


def query_status(port: int, index: str, pql: str, tenant=None,
                 params: str = "", timeout: float = 600):
    """POST one query on a fresh connection, optionally as ``tenant``;
    returns (status, Retry-After seconds or None, body) whatever the
    status."""
    from .utils.tenant import TENANT_HEADER
    conn = http.client.HTTPConnection("localhost", port, timeout=timeout)
    try:
        conn.request("POST", f"/index/{index}/query{params}",
                     body=pql.encode(),
                     headers={TENANT_HEADER: tenant} if tenant else {})
        resp = conn.getresponse()
        data = resp.read()
        ra = resp.getheader("Retry-After")
    finally:
        conn.close()
    return resp.status, (float(ra) if ra else None), data


def free_ports(n: int) -> list:
    """``n`` free localhost ports (bench.py's bind-and-close pattern)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("localhost", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def load_cfg5(port: int, index: str, words: dict, clients: int,
              options: dict | None = None):
    """Create ``index`` with config 5's fields ``seg`` and ``metric``
    through ``port`` and import ``words`` (shard -> the shard's
    ``SEG_ROWS`` seg rows, then its metric rows) there, one
    ``import-roaring`` body a field and shard from ``clients`` threads;
    the node forwards each body to its shard's owners."""
    from .storage.roaring_io import pack_roaring_words
    post(port, f"/index/{index}",
         json.dumps({"options": options} if options else {}).encode())
    for f in ("seg", "metric"):
        post(port, f"/index/{index}/field/{f}", b"{}")

    def load(shard):
        w = words[shard]
        for f, part in (("seg", w[:cfg5.SEG_ROWS]),
                        ("metric", w[cfg5.SEG_ROWS:])):
            post(port, f"/index/{index}/field/{f}/import-roaring/{shard}",
                 pack_roaring_words(part), "application/octet-stream")

    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(load, sorted(words)))


def wait_for(cond, leg: str, what: str, timeout: float = 5.0):
    """Poll ``cond`` until it returns something true (returned); the
    leg fails after ``timeout`` seconds."""
    t0 = time.perf_counter()
    while True:
        got = cond()
        if got:
            return got
        if time.perf_counter() - t0 > timeout:
            raise LegFailed(f"{leg}: timed out waiting for {what}")
        time.sleep(0.02)


def timing_delta_ms(before: dict, after: dict, name: str):
    """Mean ms of the ``name`` timings recorded between two
    ``/debug/vars`` ``timings`` snapshots; None if none were."""
    a = before.get(name, {"count": 0, "sum": 0.0})
    b = after.get(name, {"count": 0, "sum": 0.0})
    n = b["count"] - a["count"]
    return (b["sum"] - a["sum"]) / n * 1e3 if n else None


def _split_calls(text: str) -> list:
    """Top-level calls of a PQL batch."""
    calls, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                calls.append(text[start:i + 1].strip())
                start = i + 1
    return calls


def _parse_call(text: str):
    """``Name(arg, arg, ...)`` -> (name, [arg text])."""
    name, inner = text.split("(", 1)
    inner = inner[:-1]
    args, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            args.append(inner[start:i].strip())
            start = i + 1
    if inner.strip():
        args.append(inner[start:].strip())
    return name.strip(), args


class BitsOracle:
    """Exact answers over one set field's bits — ``rows[i]`` set in
    column ``cols[i]`` — to the PQL the cluster and robustness legs
    send (``Row``, ``Intersect``, ``Union``, ``Count``, ``TopN(f,
    n=K)``, batches of them), in the JSON form the server returns:
    ``{"columns": [...]}``, an int, ``[{"id", "count"}]`` by count then
    id (K = 0: every non-empty row)."""

    def __init__(self, rows, cols):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        self.sets = {int(r): np.unique(cols[rows == r])
                     for r in np.unique(rows)}

    def answer(self, pql: str) -> list:
        out = []
        for call in _split_calls(pql):
            v = self._eval(call)
            out.append({"columns": v.tolist()}
                       if isinstance(v, np.ndarray) else v)
        return out

    def _eval(self, call: str):
        name, args = _parse_call(call)
        if name == "Row":
            return self.sets.get(int(args[0].split("=")[1]),
                                 np.zeros(0, np.int64))
        if name in ("Intersect", "Union"):
            op = np.intersect1d if name == "Intersect" else np.union1d
            sets = [self._eval(a) for a in args]
            out = sets[0]
            for s in sets[1:]:
                out = op(out, s)
            return out
        if name == "Count":
            return int(self._eval(args[0]).size)
        if name == "TopN":
            n = int(args[1].split("=")[1])
            pairs = sorted(((int(c.size), r) for r, c in self.sets.items()
                            if c.size), key=lambda p: (-p[0], p[1]))
            return [{"id": r, "count": c}
                    for c, r in (pairs[:n] if n else pairs)]
        raise ValueError(f"no oracle for {call!r}")


_COLUMNS = re.compile(rb'"columns": \[')


def parse_results(body: bytes) -> list:
    """A query response's ``results``, each ``Row``'s column list parsed
    by numpy into an int64 array: a ``Row`` over 256 dense shards holds
    about 67M ids, which as a Python list would take gigabytes."""
    arrays, parts, pos = [], [], 0
    for m in _COLUMNS.finditer(body):
        end = body.index(b"]", m.end())
        text = body[m.end():end]
        arrays.append(np.fromstring(text, dtype=np.int64, sep=",")
                      if text.strip() else np.zeros(0, np.int64))
        parts += [body[pos:m.end() - 1], b"null"]
        pos = end + 1
    parts.append(body[pos:])
    results = json.loads(b"".join(parts))["results"]
    it = iter(arrays)
    for r in results:
        if isinstance(r, dict) and "columns" in r:
            r["columns"] = next(it)
    return results


class Dist5dOracle:
    """Exact replies of the config-5d corpus from the words each shard
    was loaded with (shard -> ``[12, SHARD_WORDS]``, ``cfg5`` rows):
    TopN by ``cfg5.table`` / ``cfg5.rank``, ``Count(Intersect)`` by
    popcount, ``Row`` as the sorted column ids, an int64 array
    (computed once a row, under a lock: checker threads share it)."""

    TOPN = re.compile(r"TopN\(metric, Intersect\(Row\(seg=(\d+)\), "
                      r"Row\(seg=(\d+)\)\), n=5\)")
    COUNT = re.compile(r"Count\(Intersect\(Row\(seg=(\d+)\), "
                       r"Row\(seg=(\d+)\)\)\)")
    ROW = re.compile(r"Row\(seg=(\d+)\)")

    def __init__(self, words: dict):
        self.words = words
        self.shards = sorted(words)
        self.tab = cfg5.table(words)
        self._rows: dict = {}
        self._lock = threading.Lock()

    def topn(self, a: int, b: int) -> list:
        return [{"id": m, "count": c}
                for m, c in cfg5.rank(self.tab, self.shards, a, b)]

    def count(self, a: int, b: int) -> int:
        return sum(int(np.bitwise_count(w[a] & w[b]).sum())
                   for w in self.words.values())

    def row(self, a: int) -> np.ndarray:
        with self._lock:
            if a not in self._rows:
                self._rows[a] = np.concatenate([
                    np.flatnonzero(np.unpackbits(
                        self.words[s][a].view(np.uint8),
                        bitorder="little")) + s * SHARD_WIDTH
                    for s in self.shards])
            return self._rows[a]

    def answer(self, pql: str) -> list:
        """The expected ``results`` of one corpus query."""
        q = pql.strip()
        m = self.COUNT.fullmatch(q)
        if m:
            return [self.count(int(m[1]), int(m[2]))]
        m = self.ROW.fullmatch(q)
        if m:
            return [{"columns": self.row(int(m[1]))}]
        pairs = self.TOPN.findall(q)
        if cfg5.batch_query([(int(a), int(b)) for a, b in pairs]) \
                != q:
            raise ValueError(f"no oracle for {pql!r}")
        return [self.topn(int(a), int(b)) for a, b in pairs]

    def check(self, leg: str, label: str, pql: str, body: bytes):
        got = parse_results(body)
        want = self.answer(pql)
        ok = len(got) == len(want) and all(
            np.array_equal(g["columns"], w["columns"])
            if isinstance(w, dict) else g == w for g, w in zip(got, want))
        if not ok:
            raise LegFailed(f"{leg}: {label} ({pql[:80]}) differs from the "
                            f"oracle")


# One client process of ``process_load``: reads its queries (one line,
# tab-separated), says READY, waits for GO, sends them in order over one
# keep-alive connection and prints each one's seconds and body.
LOAD_WORKER = r'''
import http.client, json, sys, time
port, index = int(sys.argv[1]), sys.argv[2]
queries = sys.stdin.readline().rstrip("\n").split("\t")
conn = http.client.HTTPConnection("localhost", port, timeout=600)
print("READY", flush=True)
sys.stdin.readline()
lat, bodies = [], []
for q in queries:
    t0 = time.perf_counter()
    conn.request("POST", f"/index/{index}/query", body=q.encode())
    resp = conn.getresponse()
    data = resp.read()
    lat.append(time.perf_counter() - t0)
    if resp.status != 200:
        sys.exit(f"{q}: {resp.status} {data[:200]!r}")
    bodies.append(data.decode())
conn.close()
print(json.dumps({"lat": lat, "bodies": bodies}), flush=True)
'''


def process_load(leg: str, port: int, index: str, per_client: list):
    """A closed loop of one client process a list of queries (bench.py's
    ``_http_count_load`` shape, its threads as processes: the clients
    then share no interpreter lock with the server).  Returns (wall s
    from GO to the last reply, per-request s, bodies in list order)."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", LOAD_WORKER, str(port), index],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in per_client]
    try:
        for proc, qs in zip(procs, per_client):
            proc.stdin.write("\t".join(qs) + "\n")
            proc.stdin.flush()
        for proc in procs:
            require(proc.stdout.readline().strip() == "READY", leg,
                    "a load client did not start")
        t0 = time.perf_counter()
        for proc in procs:
            proc.stdin.write("GO\n")
            proc.stdin.flush()
        outs = [proc.communicate(timeout=600) for proc in procs]
        wall = time.perf_counter() - t0
    finally:
        for proc in procs:
            proc.kill()
    lat, bodies = [], []
    for proc, (out, err) in zip(procs, outs):
        require(proc.returncode == 0, leg, f"a load client failed: "
                f"{err[-500:]}")
        rec = json.loads(out)
        lat += rec["lat"]
        bodies += rec["bodies"]
    return wall, lat, bodies


# One flood client of the tenant leg (bench.py ``_tenant_leg``'s
# ``flood`` :1936-1942): up to ITERS queries as the hostile tenant, a
# fresh connection each, rude by design (Retry-After is ignored).
FLOOD_WORKER = r'''
import http.client, sys
port, iters, header, pql = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
for _ in range(iters):
    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    conn.request("POST", "/index/t/query", body=pql.encode(),
                 headers={header: "hostile"})
    conn.getresponse().read()
    conn.close()
'''

RESTART_QUERIES = ("Count(Row(f=1))", "Row(f=2)", "TopN(f, n=3)")

# The restart leg's worker (bench.py ``_RESTART_WORKER`` :3048-3092):
# "seed" serves steady traffic, flushes the warm-start corpus and parks
# until the parent kills it with SIGKILL; "restart" opens the same data
# dir, waits out the warm phase and times the first request.
RESTART_WORKER = r'''
import json, sys, time
mode, data_dir, device = sys.argv[1], sys.argv[2], sys.argv[3]
from pilosa_tpu_torch.bench import RESTART_QUERIES
from pilosa_tpu_torch.server.handler import serialize_result
from pilosa_tpu_torch.server.server import Config, Server
s = Server(Config(data_dir=data_dir, bind="localhost:0", device=device,
                  timeseries_interval=0, metric_poll_interval=0,
                  anti_entropy_interval=0))
s.open()
if mode == "seed":
    s.api.create_index("ri")
    s.api.create_field("ri", "f")
    s.api.query("ri", "".join(f"Set({c}, f={r})"
                              for r in range(4) for c in range(60)))
    for _ in range(3):
        for q in RESTART_QUERIES:
            s.api.query("ri", q)
    s.warmup.recorder.flush(s.warmup.corpus)
    print("SEEDED", flush=True)
    time.sleep(600)
else:
    t0 = time.monotonic()
    while s.warmup.warming() and time.monotonic() - t0 < 120:
        time.sleep(0.01)
    st = s.warmup.status()
    t1 = time.perf_counter()
    first = s.api.query("ri", RESTART_QUERIES[0])
    first_ms = (time.perf_counter() - t1) * 1e3
    steady = []
    for _ in range(5):
        t2 = time.perf_counter()
        s.api.query("ri", RESTART_QUERIES[0])
        steady.append((time.perf_counter() - t2) * 1e3)
    answers = [serialize_result(r) for q in RESTART_QUERIES
               for r in s.api.query("ri", q)]
    s.close()
    print(json.dumps({"warmup": st, "first_ms": first_ms,
                      "first": serialize_result(first[0]),
                      "steady_ms": min(steady), "answers": answers}),
          flush=True)
'''


def worker_env() -> tuple:
    """(the repo root, an environment whose PYTHONPATH starts with it)
    for a worker process of this package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return root, env


# One server of a leg that compares two modes (the SLO leg's evaluation
# on and off, the observability leg's batching and observed servers),
# in a process of its own, so that what a mode costs in background work
# and in the interpreter lock falls on that mode alone.  Opens a Server
# from the Config fields in argv (JSON), prints its port, then answers
# one command a line on stdin: "stats" prints the counters the legs
# read, "slow S" sets the slow-query threshold; end of input closes it.
SERVE_WORKER = r'''
import json, sys, tempfile
from pilosa_tpu_torch.server.server import Config, Server
with tempfile.TemporaryDirectory(prefix="ptt_bench_") as tmp:
    s = Server(Config(data_dir=tmp, bind="localhost:0",
                      **json.loads(sys.argv[1])))
    s.open()
    print(s.port, flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "stats":
            print(json.dumps({"slo_evaluations": None if s.slo is None
                              else s.slo.evaluations}), flush=True)
        elif cmd[0] == "slow":
            s.slowlog.threshold_s = float(cmd[1])
            print("ok", flush=True)
    s.close()
'''


class ServerProcess:
    """A ``SERVE_WORKER`` process: ``port`` once ``wait_open`` returned,
    ``stats()``, ``slow(s)``; ``close()`` ends it."""

    def __init__(self, leg: str, device, **kw):
        self.leg = leg
        root, env = worker_env()
        cfg = dict(device=str(device), anti_entropy_interval=0,
                   metric_poll_interval=0, **kw)
        # the server's log goes to a file: a pipe nobody drains would
        # stall it once full
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVE_WORKER, json.dumps(cfg)],
            cwd=root, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        self.port = None

    def _line(self, what: str) -> str:
        line = self.proc.stdout.readline().strip()
        if not line:
            self.proc.kill()
            self.proc.wait()
            self.log.seek(0)
            raise LegFailed(f"{self.leg}: a server process died at "
                            f"{what}: {self.log.read()[-2000:]}")
        return line

    def wait_open(self):
        self.port = int(self._line("start"))

    def command(self, cmd: str) -> str:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self._line(cmd)

    def stats(self) -> dict:
        return json.loads(self.command("stats"))

    def slow(self, threshold_s: float):
        self.command(f"slow {threshold_s}")

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=60)
        # lint: allow(swallowed-exception) — bench teardown: a worker that
        # will not end is killed below and the leg's numbers are in
        except Exception:
            pass
        finally:
            self.proc.kill()
            self.proc.wait()
            self.proc.stdout.close()
            self.log.close()


@contextmanager
def server_processes(leg: str, device, modes: dict):
    """One ``ServerProcess`` a mode (mode -> Config fields), started
    together; yields them by mode and closes them all."""
    procs: dict = {}
    try:
        for mode, kw in modes.items():
            procs[mode] = ServerProcess(leg, device, **kw)
        for sp in procs.values():
            sp.wait_open()
        yield procs
    finally:
        for sp in procs.values():
            sp.close()


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
