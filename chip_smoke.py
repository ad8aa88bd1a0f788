"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main paths — PQL read requests over the SSB
star-schema corpus at its full 256 shards, BASELINE config 4 (BSI
Sum / range predicates + GroupBy over 64 shards at depth 20), each
dense-resident and compressed-resident, and BASELINE config 5 over 954
shards under a device budget smaller than its working set and on four
cluster nodes, the SSB and config-4 corpora split over two rank
processes of one multi-process engine, a server killed under write
load and restarted, and the port's bench at its smoke size — through
the user entry points
``pilosa_tpu_torch.executor.Executor`` and
``pilosa_tpu_torch.server.Server``, and holds every CUDA kernel of
those paths against its plain PyTorch version.  Phases, each printing
its own lines and its seconds:

1. card   — the device name and power limit; fails without CUDA.
2. build  — compiles ``pilosa_tpu_torch/csrc`` with nvcc (timed), and
   the prepared cache's C fingerprint scanner
   (``pilosa_tpu_torch/native``) with cc, which must build and agree
   with the Python fingerprint.
3. corpus — builds the SSB corpus from a seed (pilosa_tpu_torch/ssb.py).
4. kernels against plain — each kernel's wrapper on card tensors, on the
   boundary container packs (each alone, then all in one ragged stack)
   and on the stacks the stacked executor places for the SSB TopN key
   list (which must form ONE signature group over all 256 shards),
   bit-exact against its plain version; times (CUDA events) beside the
   bound.
5. ssb    — the ``_ssb_batch`` mix (multi-call requests), dense-
   resident (no budget) and compressed-resident (96 MB budget), each
   through the default path — the whole request as one whole-query
   program through the dispatch batcher, captured into a CUDA graph on
   its signature's second sighting and replayed after — and through the
   grouped path (``whole_query=False``), three passes over the same
   requests; every answer equals the numpy oracle and all four runs
   agree.  The default path must take no fallback and replay graphs;
   the compressed runs must launch both kernels, and the compressed
   default run must launch both inside replayed graphs (counts reset
   just before each run, read just after; a replay counts the launches
   its graph recorded at capture).  Printed per run: whole-query
   requests, fallbacks by node, graphs captured and held, replays,
   capture ms, the graph pool's reserved MB, launches per request.
6. bsi64  — config 4 (pilosa_tpu_torch/bsi64.py): the corpus at 64
   shards; ``decode_block`` on the packed ``bsig_v`` stack the stacked
   executor places, bit-exact against its plain version and timed; then
   requests of 64 ``Sum(Row(v > X), field=v)`` calls, the GroupBy and a
   Min / Max / Count / TopN request under the same predicate, dense and
   compressed, on the default path and (one 64-Sum request after the
   warm one) the grouped path, every answer equal to the numpy oracle;
   each 64-Sum request must fall back as ``batch-chunks`` and run the
   number of chunks the ``batch_chunk_size`` rule gives (8 at 64
   shards), and nothing else may fall back; the compressed runs must
   launch both kernels.  Printed: qps, request p50, launches and batch
   chunks per request, prepared hits, the GroupBy time, resident MB and
   the whole-query counters.
6b. multiprocess — the multi-process engine
   (pilosa_tpu_torch/parallel/multihost.py): two rank processes, fresh
   interpreters running this script with ``--rank``, join one process
   group over gloo on ``cuda:0`` (they share the one card, where NCCL
   refuses two ranks; gloo stages each collective through the host, so
   the path runs eagerly, with no CUDA graph).  Each builds its half of
   the SSB corpus (128 of 256 shards) and of config 4's (32 of 64) from
   the seeds and, compressed-resident, runs the SSB mix, config 4's
   requests and the multihost worker's query set (Row, TopN, Rows,
   GroupBy, Sum / Min / Max on ``v``) through ``Executor(...,
   group=...)``.  Every answer of every rank must equal the oracle and
   the single-process port's answers (phases 5 and 6, and the worker set
   run here in one process); both kernels must launch in both ranks
   (counts reset just before each corpus's run, read just after), and
   rank 0 holds both kernels on its own half stacks against their plain
   versions.  A rank that fails or outlives its timeout fails the run.
   Printed per rank: seconds, request p50s and launches, beside the
   card's name and power limit.
7. served — the port's server (``pilosa_tpu_torch.server``) on the card
   in a fresh data dir: ``ssb`` and its four fields created over HTTP,
   the 256-shard corpus loaded through ``import-roaring`` (one POST per
   field and shard), the mix as HTTP POSTs from 1 client and then from
   8 concurrent clients, every answer equal to the oracle; compressed-
   resident (96 MB budget; both kernels must launch, counts reset just
   before the run and read just after), then restarted on the same data
   dir dense-resident, where 1,048,576 new ``rev`` bits stream through
   ``/ingest`` and, after the ack, the mix must equal the updated oracle
   with the dense stacks taking overlays, not re-stages.  The servers
   run their defaults (whole-query programs through the batcher), which
   must take no fallback; before the ingest the dense server also takes
   the fusible leg — 8 clients sending requests of 3 Counts and 1 TopN
   only — which must fuse tickets (a launch with more than one, from
   the batcher's ``snapshot()``) and replay graphs.  After the ingest a
   second server on the same data dir runs the grouped path
   (``whole_query=False``, no batcher) on the same requests, printed
   beside the default path's calls/s and p50.  Last ``python3 -m
   pilosa_tpu_torch server`` as a subprocess (``/status``, one Set +
   Count, SIGTERM, exit 0).  Printed: load seconds, qps and p50 per
   client count, launches per request, ingest records/s, overlays and
   re-stages, the fusible leg's fused launches and batch sizes.
   With ``--profile`` each run of phases 5, 6 and 7 ends with one
   request under torch.profiler: the card's busy and idle share and its
   top kernels.
8. warm_start — over the served data dir after the ingest (its corpus
   removed first): a cold restart (``warmup_top_n = 0``) sending the 8
   one-client requests of the mix twice each, then a warm restart with
   the default ``warmup_top_n`` over the corpus the cold server wrote,
   sending them once more, with ``?explain=true``; compressed (96 MB)
   and then dense.  Gates: ``/status`` WARMING then READY; the warmup
   replayed 2 × its planned entries with 0 errors and 0 skipped; every
   corpus signature held as a graph at READY; after READY no capture,
   every request a replay whose plan says ``compile: warm``, and (when
   compressed) both kernels launched inside replayed graphs; every
   answer equal to the oracle.  Then the SLO leg: a compressed server
   with ``timeseries-interval = 1``, ``timeseries-window = 60`` and
   ``slo-latency-ms = 1`` under about 8 s of the mix must fire
   ``slo-latency-burn``, leave a flight-recorder bundle, answer ``POST
   /debug/bundle`` and resolve after the load stops, with answers
   byte-identical to the compressed cold server's, whose alert rules
   were off; on it,
   ``/debug/compiles`` (0 retraces in the process), ``/debug/launches``
   (the padding waste ratio), the ``/metrics`` device families,
   ``/debug/timeseries`` and the CLI ``top``.  Printed: seconds to
   READY cold and warm, the replay seconds, first- and second-request
   p50, captures, pool MB at READY, the alert's fire and resolve
   times.
9. cfg5_budget — BASELINE config 5 under the device budget (bench.py
   ``bench_config5_compressed``, pilosa_tpu_torch/cfg5.py): the sparse
   corpus of 954 shards (1,000,341,504 columns; 1431 MiB of dense words
   against a 768 MiB budget), the gate ``TopN(metric, Intersect(Row(seg
   =0), Row(seg=2)), n=5)`` over every shard equal to ``oracle_topn5``
   dense- and compressed-resident, both kernels at the first compressed
   slice's shapes against their plain versions, then four legs —
   ``resident`` (dense, no budget), ``dense`` and ``compressed`` (768
   MiB), and ``compressed_ws`` (768 MiB, a 256 MiB decode workspace) —
   of 32-call requests over the rotating hot / cold quarter subsets,
   8-call requests over all shards (which the whole-query precheck must
   refuse as ``streamed-working-set`` exactly when the schedule has
   more than one slice; the slices must equal the byte reckoning: 4
   dense, 1 compressed, whose decoded seg stack is 477 MiB, and 2 at
   the 256 MiB workspace) and one 64-call request over all shards;
   every answer equal to the
   oracle, no pin left after a leg, the dense peak at or under the
   budget, and the compressed leg must launch both kernels.  Printed
   per leg: slices, prefetch hits and misses, pins, evictions, upload
   MB, peak MB, calls/s, p50, launches a request and the fallbacks.
10. cluster — config 5's cluster half (bench.py
   ``bench_config5_distributed``): four port servers in this process,
   sharing the card on localhost ports, the dense corpus at
   CLUSTER_SHARDS shards loaded through node0's ``import-roaring`` (two
   POSTs a shard, forwarded to the owners), 64-call requests to node0
   from 1 and from 8 clients,
   every TopN equal to the oracle, the internal wire ``bin1``.  Printed:
   load seconds, calls/s and p50, the coordinator's fan-out means, each
   node's launches and graph captures, hedges, retry waves and node
   states.
   Then two more legs on the same loaded nodes.  ``balancer``: the
   coordinator's balancer on, routing ``loaded``, the load skewed onto
   one remote shard; one ``balancer.tick()`` must hand it off (every
   node on the same overlay epoch, the overlay owner holding the copied
   fragments), the 64-call requests equal the oracle and the overlay
   owner's executor runs requests.  ``resize``: a fifth port server
   with the same keys, ``POST /cluster/resize/add-node``, NORMAL on all
   five and the holder cleaner done, the 64-call requests equal the
   oracle (warmed twice, then timed from 1 client beside the four-node
   figures), then ``remove-node`` and the answers again.  Printed: the
   handoff seconds and overlay epoch; resize seconds each way, the
   fragments and MiB fetched, shards per node, and each node's resident
   MB, stacks, graphs and pool MB before the resize and after the
   cleaner.
11. replicas — three port servers, ``replica_n`` 2, compressed-resident
   under a 512 MiB device budget, over config 5's sparse corpus cut to
   64 shards, node2 dialed through a ``ChaosProxy``
   (``pilosa_tpu_torch/utils/netchaos.py``): load and warm, a latency on
   node2's responses under which reads must hedge, then a fragment
   deleted on node1 and a row's bits cleared in another fragment on
   node0 (each node's own executor must then differ from the oracle:
   no stale stack), ``sync_holder`` on node1, and after it every node's
   executor over its own shards equal to the oracle, both kernels
   launched and new graphs captured (counts reset just before, read
   just after); both kernels at the repaired node's shapes against
   their plain versions.  Printed: hedges, repair seconds, the
   anti-entropy counters (blocks compared and merged, errors), launches
   and captures after the repair, kernel times beside their bound.
12. parity — crash recovery of the served path on the card, the
   whole-query deadline gate and the cache-clear route: a 32-shard
   index (``f`` with a run row, ``a`` and ``b``, sparse) loaded through
   ``import-roaring``; then two kill cycles of a ``python3 -m
   pilosa_tpu_torch server --device cuda`` writer, compressed-resident
   under 256 MiB, under single-bit ``Set`` load — one killed by the
   ``fragment.wal=kill:25`` failpoint inside a WAL append, one by a
   SIGKILL at a random write index.  After each kill the data dir is
   restarted in this process compressed-resident, then dense: READY,
   ``storage.degraded`` false, every acknowledged write present and at
   most the one in flight extra, and five requests of one signature
   (Counts under a filter and the TopN of ``f`` under ``a & b``) equal
   to the host oracle on the default whole-query path, with graphs
   replayed; the compressed restart must launch both kernels (counts
   reset just before it, read just after), and both are held against
   their plain versions on its own stacks.  The last compressed
   restart also takes ``mesh.slice=delay:0.2@parity`` with
   ``?timeout=0.05`` (504, ``query.deadline_abort`` counted, no
   whole-query fallback; disarmed, the same request answers right) and
   ``POST /internal/cache/clear`` (a repeated request hits the result
   cache, the clear reports the entries, the next request misses and
   equals the oracle).  Printed per restart, beside the card's name and
   power limit: the WAL replay seconds (``Holder.open()`` on a copy of
   the killed dir) and bytes, seconds to READY and the first request's
   ms.
13. bench — the port's bench (``python -m pilosa_tpu_torch.bench
   --smoke --device cuda``, pilosa_tpu_torch/bench.py) as a subprocess:
   every leg at its smoke size (configs 1-5 and the sparse config 5,
   SSB, whole-query on / off, the HTTP legs, ingest, config 5 on four
   nodes, routing, chaos, SLO, wire, tenant, cache, overload,
   observability, restart).  It must exit 0 within BENCH_TIMEOUT_S,
   report every leg with its answer gate passed, launch both kernels
   in its compressed config-5 and SSB legs (counted in that process),
   and pass the cluster and robustness legs' gates (run_bench).
   Printed: its seconds a leg and those gates.
14. the ``kernels`` JSON line, a JSON line of the phases' records, the
   ``served`` and ``warm_start`` JSON lines, the ``cfg5_budget`` /
   ``cluster`` / ``replicas`` JSON line, the ``multiprocess`` JSON line,
   the ``parity`` JSON line, the ``bench`` JSON line, the nvidia-smi
   line, and last the result line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the result line.  It imports
nothing of JAX or the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pilosa_tpu_torch.ops.kernel_timing import (  # noqa: E402
    bound, max_abs_err, measure_filtered, stack_bytes, time_ms)
from pilosa_tpu_torch.ops.kernel_timing import new_rec as _new_rec

SEED = 20261017
N_SHARDS = 256
BUDGET_MB = 96
BATCH = 24            # calls per request, as bench.bench_ssb
N_BATCHES = 8
SHARD_BYTES = 32768 * 4        # one row of a shard's dense words
# Where the replaced Pallas kernels live: the JAX package's directory,
# named here only as a path for the report, never imported.
JAX_KERNELS = "pilosa" + "_tpu/ops/kernels.py"


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 4a: boundary packs ----------------------------------------------

def boundary_packs():
    """(rows, name -> (idx, val)): packs at the container-form boundaries
    (the cases of tests/test_torch_containers.py at the full shard
    width), each alone and mixed in one fragment."""
    from pilosa_tpu_torch.core import CONTAINER_WORDS as CW, SHARD_WORDS
    from pilosa_tpu_torch.ops.containers import ARRAY_WORDS_MAX, RUN_MAX
    rng = np.random.default_rng(SEED)
    rows = 8
    last = rows * SHARD_WORDS // CW - 1

    def array(tile, n):
        slots = np.sort(rng.choice(CW, n, replace=False))
        v = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[0] = 0x80000000
        return (tile * CW + slots).astype(np.int64), v

    def runs(tile, n_runs, edge=False):
        w = (np.arange(n_runs)[:, None] * 4 + np.arange(3)[None, :])
        idx = (tile * CW + w.reshape(-1)).astype(np.int64)
        v = np.full(idx.size, 0xFFFFFFFF, np.uint32)
        if edge:              # runs that start and end mid-word
            v[0], v[-1] = 0xFFFF0000, 0x0000FFFF
        return idx, v

    def merge(*parts):
        idx = np.concatenate([p[0] for p in parts])
        val = np.concatenate([p[1] for p in parts])
        order = np.argsort(idx)
        return idx[order], val[order]

    packs = {"array_1023": array(0, ARRAY_WORDS_MAX),
             "bitmap_1024": array(3, ARRAY_WORDS_MAX + 1),
             "run_64": runs(5, RUN_MAX), "run_65": runs(9, RUN_MAX + 1),
             "run_partial_words": runs(11, 5, edge=True),
             "full_run": (np.arange(CW, dtype=np.int64) + 20 * CW,
                          np.full(CW, 0xFFFFFFFF, np.uint32)),
             "last_tile": array(last, 17),
             "emptied": (np.zeros(0, np.int64), np.zeros(0, np.uint32))}
    packs["mixed"] = merge(*(packs[k] for k in (
        "array_1023", "bitmap_1024", "run_64", "run_65", "full_run",
        "last_tile")))
    return rows, packs


def check_boundary_packs(device):
    """Each boundary pack alone through the 1-D call form, then all of
    them as ONE ragged stack: both kernels against their plain versions
    and the decode against the numpy oracle, exactly."""
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import containers, kernels
    from pilosa_tpu_torch.ops.bitset import from_numpy, to_numpy
    rows, packs = boundary_packs()
    filt_rng = np.random.default_rng(1)

    def check(name, arrs, oracle, filt):
        got = kernels.decode_block(*arrs, rows=rows, words=SHARD_WORDS)
        plain = kernels.decode_block_plain(*arrs, rows=rows,
                                           words=SHARD_WORDS)
        torch.cuda.synchronize()
        if max_abs_err(got, plain) or not np.array_equal(to_numpy(got),
                                                         oracle):
            raise AssertionError(f"decode_block differs on {name}")
        for f in (None, filt):
            k = kernels.fused_row_counts(*arrs, f, rows=rows,
                                         words=SHARD_WORDS)
            q = kernels.fused_row_counts_plain(*arrs, f, rows=rows,
                                               words=SHARD_WORDS)
            torch.cuda.synchronize()
            if max_abs_err(k, q):
                raise AssertionError(
                    f"fused_row_counts differs on {name} "
                    f"(filtered={f is not None})")

    packed = {name: containers.pack_words(*iv) for name, iv in packs.items()}
    oracles = {name: containers.unpack_packed(p, rows, SHARD_WORDS)
               for name, p in packed.items()}
    for name, p in packed.items():
        arrs = [from_numpy(a, device) if a.dtype == np.uint32
                else torch.from_numpy(a).to(device)
                for a in containers.pad_packed(p)]
        filt = from_numpy(filt_rng.integers(
            0, 1 << 32, SHARD_WORDS, dtype=np.uint64).astype(np.uint32),
            device)
        check(name, arrs, oracles[name], filt)
        say("kernels", pack=name, types=p.type_histogram(), exact=True)
    names = list(packed)
    stack = containers.stack_packed(
        [packed[n] for n in names],
        containers.tiles_of(rows, SHARD_WORDS), device)
    filt = from_numpy(filt_rng.integers(
        0, 1 << 32, (len(names), SHARD_WORDS), dtype=np.uint64)
        .astype(np.uint32), device)
    check("the ragged stack of all boundary packs", stack,
          np.stack([oracles[n] for n in names]), filt)
    say("kernels", ragged_stack=len(names), containers=stack.types.numel(),
        payload_words=stack.payload.numel(), exact=True)


# -- phase 4b: the SSB shapes on the main path -------------------------------

def measure_group(placed, sig, S: int, dec: dict, fus: dict,
                  rg: int, c: int, plain_iters: int = 3):
    """Add one stacked group's kernel launches for the TopN filter to
    ``dec`` / ``fus``: decode the region and category stacks, then the
    fused count over the rev stack under region[rg] & category[c].  Each
    kernel is compared with its plain version on the same inputs."""
    measure_filtered(placed, sig, S, dec, fus, [(1, rg), (2, c)],
                     plain_iters=plain_iters)


def check_ssb_shapes(holder, device, rg: int = 1, c: int = 3, group=None,
                     label: str = "kernels"):
    """Each kernel at the shapes the main path gives it for
    ``TopN(rev, Intersect(Row(region=rg), Row(category=c)))`` over every
    shard, on the stacks the stacked executor itself places:
    decode_block over the region and category stacks (the filter's
    operands), fused_row_counts over the rev stack under that filter, for
    every signature group — one for the SSB key list, which is asserted.
    ``group``: one rank of a process group, which stacks its own shards
    only."""
    from pilosa_tpu_torch.parallel.stacked import StackedExecutor
    from pilosa_tpu_torch import ssb
    st = StackedExecutor(device, group=group)
    keys = [("rev", "standard"), ("region", "standard"),
            ("category", "standard")]
    shards = list(range(N_SHARDS))
    groups = st._placed_groups(keys, holder, ssb.SSB_INDEX, shards)
    say(label, ssb_groups=len(groups),
        group_shards=[len(g[0]) for g in groups],
        sigs=[g[2] for g in groups])
    if len(groups) != 1:
        raise AssertionError(f"the SSB TopN key list forms {len(groups)} "
                             f"signature groups, not 1")
    dec, fus = _new_rec(), _new_rec()
    for shard_list, placed, sig in groups:
        measure_group(placed, sig, len(shard_list), dec, fus, rg, c)
    st.close()
    return dec, fus


# -- phase 5: the SSB request mix ------------------------------------------

def profile_request(run, label: str):
    """One request (``run()``) under torch.profiler
    (``pilosa_tpu_torch.utils.devobs.profile_request``): the card's busy
    and idle share of its wall time and its top kernels, printed."""
    from pilosa_tpu_torch.utils import devobs
    rec = devobs.profile_request(run)
    say("profile", run=label, **{k: json.dumps(v) if k == "top" else v
                                 for k, v in rec.items()})


def check_answers(label: str, hist, shards, calls, got):
    from pilosa_tpu_torch import ssb
    want = [ssb.oracle(hist, shards, c) for c in calls]
    if got != want:
        bad = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"{label}: {ssb.ssb_query(calls[bad])} -> "
                             f"{got[bad]}, oracle {want[bad]}")


class FallbackLog:
    """The executor's logger stand-in: counts ``wholequery.fallback``
    events by node."""

    def __init__(self):
        self.nodes: dict = {}

    def event(self, name, **fields):
        if name == "wholequery.fallback":
            self.nodes[fields["node"]] = self.nodes.get(fields["node"], 0) + 1

    def info(self, msg):
        pass

    error = debug = info


def wq_record(ex, log: FallbackLog, requests: int) -> dict:
    """The whole-query counters of one run: requests, fallbacks by node,
    graphs captured and held, replays, capture ms, the graph pool's
    reserved MB, and launches per request with the replayed share
    (a replay counts the launches its graph recorded at capture)."""
    from pilosa_tpu_torch.ops import kernels
    snap = ex.wholequery.snapshot()
    pool = ex.wholequery.pool_reserved_bytes() \
        if torch.device(ex.device).type == "cuda" else None
    return {"wq_requests": ex.wq_requests,
            "wq_fallbacks": dict(log.nodes),
            "graphs_captured": snap["captures"], "graphs_held":
            snap["graphs"], "replays": snap["replays"],
            "eager_runs": snap["eagerRuns"],
            "capture_ms": snap["captureS"] * 1e3,
            "pool_mb": None if pool is None else pool / 2**20,
            "launches_replayed": dict(kernels.REPLAYED),
            "launches_per_request": {k: n / requests for k, n in
                                     kernels.LAUNCHES.items()}}


def run_ssb(holder, hist, device, label: str, profile: bool = False,
            whole_query: bool = True):
    """Warm, then time N_BATCHES requests of BATCH mixed SSB calls over
    all shards, then the same N_BATCHES twice more: on the default path a
    whole-query signature runs eagerly on its first sighting, is captured
    into a CUDA graph and replayed on its second (pass 2) and replays
    after (pass 3); every answer must equal the oracle.  ``whole_query``:
    the default path (whole-query programs through the dispatch batcher)
    or the grouped path.  Each timed request also records the
    milliseconds the Python garbage collector held the host inside it
    (``batch_gc_ms``).  Returns (answers, record)."""
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    shards = list(range(N_SHARDS))
    rng = np.random.default_rng(SEED + 1)
    batches = [ssb.ssb_calls(rng, BATCH) for _ in range(N_BATCHES + 1)]
    ex = Executor(holder, device=device, whole_query=whole_query)
    log = FallbackLog()
    ex.logger = log
    gc_s = [0.0, 0.0]              # [start of the open pause, paused total]
    label = label + ("" if whole_query else "_grouped")

    def on_gc(phase, info):
        if phase == "start":
            gc_s[0] = time.perf_counter()
        else:
            gc_s[1] += time.perf_counter() - gc_s[0]

    def one(calls):
        gc_s[1] = 0.0
        t0 = time.perf_counter()
        got = ssb.normalize(ex.execute(ssb.SSB_INDEX, ssb.ssb_batch(calls)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_answers(label, hist, shards, calls, got)
        return got, dt

    kernels.reset_launches()
    answers, lat, gc_ms, lat_capture, lat_replay = [], [], [], [], []
    gc.callbacks.append(on_gc)
    try:
        for i, calls in enumerate(batches):
            got, dt = one(calls)
            if i:                  # batch 0 warms: stacks staged, cached
                lat.append(dt)
                gc_ms.append(round(gc_s[1] * 1e3, 3))
            answers.append(got)
        for lat_pass in (lat_capture, lat_replay):
            for calls in batches[1:]:
                lat_pass.append(one(calls)[1])
    finally:
        gc.callbacks.remove(on_gc)
    if profile:
        profile_request(lambda: ex.execute(
            ssb.SSB_INDEX, ssb.ssb_batch(batches[-1])), label)
    launches = dict(kernels.LAUNCHES)
    requests = len(batches) + 2 * len(lat_replay) + int(profile)
    stats = DEFAULT_BUDGET.stats()
    chunks = ex.stacked.batch_chunks
    wq = wq_record(ex, log, requests)
    ex.close()
    rec = {"whole_query": whole_query,
           "qps": BATCH * len(lat) / sum(lat),
           "batch_chunks_per_request": chunks / requests,
           "resident_mb": stats["residentBytes"] / 2**20,
           "compressed_mb": stats["compressedBytes"] / 2**20,
           "batch_p50_ms": statistics.median(lat) * 1e3,
           "batch_ms": [round(x * 1e3, 3) for x in lat],
           "capture_pass_p50_ms": statistics.median(lat_capture) * 1e3,
           "replay_qps": BATCH * len(lat_replay) / sum(lat_replay),
           "replay_p50_ms": statistics.median(lat_replay) * 1e3,
           "replay_ms": [round(x * 1e3, 3) for x in lat_replay],
           "batch_gc_ms": gc_ms,
           "launches": launches, "requests": requests, **wq}
    say("ssb", run=label, shards=N_SHARDS, calls_per_batch=BATCH,
        batches=len(lat), qps=rec["qps"], batch_p50_ms=rec["batch_p50_ms"],
        capture_pass_p50_ms=rec["capture_pass_p50_ms"],
        replay_qps=rec["replay_qps"], replay_p50_ms=rec["replay_p50_ms"],
        resident_mb=rec["resident_mb"], compressed_mb=rec["compressed_mb"],
        launches=json.dumps(launches), requests=requests,
        batch_chunks_per_request=rec["batch_chunks_per_request"],
        **{k: (json.dumps(v) if isinstance(v, dict) else v)
           for k, v in wq.items()})
    return answers, rec


# -- phase 6: BASELINE config 4 --------------------------------------------

CFG4_REQUESTS = 4     # timed 64-Sum requests per residency, after one warm
CFG4_REQUESTS_GROUPED = 1     # the same on the grouped path


def cfg4_corpus(n_shards: int, group=None):
    """The config-4 holder at ``n_shards`` (64 on the card; its value
    count scales with the shards, so the density stays the config's).
    ``group``: one rank's slice (bsi64.build)."""
    from pilosa_tpu_torch import bsi64
    from pilosa_tpu_torch.storage import Holder
    holder = Holder(None)
    oracle = bsi64.build(holder, np.random.default_rng(SEED + 4),
                         n_shards=n_shards,
                         n_values=bsi64.N_VALUES * n_shards
                         // bsi64.N_SHARDS, group=group)
    return holder, oracle


def check_bsi_stack(holder, device, n_shards: int, group=None,
                    label: str = "bsi64") -> dict:
    """``decode_block`` at the shape every compressed Sum / Min / Max /
    range predicate gives it: the packed ``bsig_v`` stack the stacked
    executor places over all shards (one signature group, asserted),
    bit-exact against its plain version; timed.  ``group``: one rank of
    a process group, which stacks its own shards only."""
    from pilosa_tpu_torch import bsi64
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import containers, kernels
    from pilosa_tpu_torch.parallel.stacked import StackedExecutor
    st = StackedExecutor(device, group=group)
    groups = st._placed_groups([("v", "bsig_v")], holder, bsi64.INDEX,
                               list(range(n_shards)))
    if len(groups) != 1 or not isinstance(groups[0][1][0],
                                          containers.PackedStack):
        raise AssertionError(f"bsig_v does not stack into one packed "
                             f"group: {[g[2] for g in groups]}")
    shard_list, (pk,), (sig,) = groups[0]
    rows = sig[1]
    n_stacked = len(shard_list)

    def run():
        return kernels.decode_block(*pk, rows=rows, words=SHARD_WORDS)

    def plain():
        return kernels.decode_block_plain(*pk, rows=rows, words=SHARD_WORDS)

    rec = _new_rec()
    got, want = run(), plain()
    torch.cuda.synchronize()
    rec["err"] = max_abs_err(got, want)
    rec["ms"] = time_ms(run, iters=20)
    rec["plain_ms"] = time_ms(plain, iters=3, warmup=1)
    rec["bytes"] = stack_bytes(pk) + n_stacked * rows * SHARD_WORDS * 4
    say(label, bsig_stack_shards=n_stacked, rows=rows,
        containers=pk.types.numel(), payload_words=pk.payload.numel(),
        types=json.dumps({t: int((pk.types == i).sum()) for i, t in
                          enumerate(("array", "bitmap", "run"))}),
        decode_ms=rec["ms"], plain_ms=rec["plain_ms"], exact=not rec["err"])
    st.close()
    return rec


def cfg4_oracle_topn(vals, segs, x: int, n: int) -> list:
    counts = np.bincount(segs[vals > x], minlength=8)
    order = np.lexsort((np.arange(counts.size), -counts))
    return [(int(i), int(counts[i])) for i in order[:n] if counts[i] > 0]


def cfg4_predicted_chunks(n_shards: int) -> int:
    """Dispatch chunks of one 64-Sum request by the JAX package's
    ``batch_chunk_size`` rule (the port's copy): each Sum's filter
    ``Row(v > X)`` takes bsi.MAG_BITS params slots.  More than one chunk
    is the whole-query program's ``batch-chunks`` fallback."""
    from pilosa_tpu_torch import bsi64
    from pilosa_tpu_torch.executor.executor import batch_chunk_size
    from pilosa_tpu_torch.ops import bsi
    chunk = batch_chunk_size(bsi.MAG_BITS, n_shards)
    return -(-bsi64.SUMS_PER_REQUEST // chunk)


def run_cfg4(holder, oracle, device, label: str, n_shards: int,
             profile: bool = False, whole_query: bool = True,
             n_requests: int = CFG4_REQUESTS):
    """Warm, then time ``n_requests`` requests of 64 Sums; then the
    GroupBy (warmed with another literal, as bench.py times it) and one
    request of Min / Max / Count / TopN under a range predicate.  Every
    answer must equal the numpy oracle.  ``whole_query``: the default
    path or the grouped path.  On the default path every 64-Sum request
    must fall back as ``batch-chunks`` exactly when the chunk rule gives
    it more than one chunk, and nothing else may fall back.  Returns
    (answers, record)."""
    from pilosa_tpu_torch import bsi64
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    cols, vals, segs = oracle
    rng = np.random.default_rng(SEED + 5)
    xs_all = [rng.integers(0, bsi64.V_MAX, size=bsi64.SUMS_PER_REQUEST)
              for _ in range(n_requests + 1)]
    ex = Executor(holder, device=device, whole_query=whole_query)
    log = FallbackLog()
    ex.logger = log
    label = label + ("" if whole_query else "_grouped")
    t_phase = time.perf_counter()

    def check(what, got, want):
        if got != want:
            raise AssertionError(f"config 4 {label}: {what} -> {got}, "
                                 f"oracle {want}")

    kernels.reset_launches()
    answers, lat = [], []
    chunks0 = ex.stacked.batch_chunks
    for i, xs in enumerate(xs_all):
        t0 = time.perf_counter()
        got = bsi64.normalize(ex.execute(bsi64.INDEX,
                                         bsi64.sum_request(xs)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:                  # request 0 warms: stacks staged, prepared
            lat.append(dt)
        check("64 Sums", got, [bsi64.oracle_sum(vals, int(x)) for x in xs])
        answers.append(got)
    n_req = len(xs_all)
    sum_launches = dict(kernels.LAUNCHES)
    chunks = (ex.stacked.batch_chunks - chunks0) / n_req
    predicted = cfg4_predicted_chunks(n_shards)
    # one chunk runs inside the whole-query program, several fall back to
    # the grouped path's chunks
    want = predicted if predicted > 1 or not whole_query else 0
    if chunks != want:
        raise AssertionError(f"config 4 {label}: {chunks} batch chunks a "
                             f"64-Sum request, the rule gives {want}")
    if whole_query and log.nodes != (
            {"batch-chunks": n_req} if predicted > 1 else {}):
        raise AssertionError(f"config 4 {label}: 64-Sum fallbacks "
                             f"{log.nodes}, the rule predicts "
                             f"{n_req if predicted > 1 else 0}")
    ex.execute(bsi64.INDEX, bsi64.group_by_query(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bsi64.normalize(ex.execute(bsi64.INDEX,
                                     bsi64.group_by_query(500_000)))
    torch.cuda.synchronize()
    gb_ms = (time.perf_counter() - t0) * 1e3
    check("GroupBy", got, [bsi64.oracle_group_by(vals, segs, 500_000)])
    answers.append(got)
    x = int(xs_all[-1][0])
    got = bsi64.normalize(ex.execute(
        bsi64.INDEX, f"Min(Row(v > {x}), field=v) Max(Row(v > {x}), "
                     f"field=v) Count(Row(v > {x})) "
                     f"TopN(seg, Row(v > {x}), n=5)"))
    check("Min / Max / Count / TopN", got,
          [bsi64.oracle_min_max(vals, x, False),
           bsi64.oracle_min_max(vals, x, True), int((vals > x).sum()),
           cfg4_oracle_topn(vals, segs, x, 5)])
    answers.append(got)
    if whole_query and sum(log.nodes.values()) != n_req * (predicted > 1):
        raise AssertionError(f"config 4 {label}: the GroupBy or the Min / "
                             f"Max / Count / TopN request fell back: "
                             f"{log.nodes}")
    if profile:
        profile_request(lambda: ex.execute(
            bsi64.INDEX, bsi64.sum_request(xs_all[-1])), f"bsi64-{label}")
    launches = dict(kernels.LAUNCHES)
    stats = DEFAULT_BUDGET.stats()
    hits = ex.prepared.hits
    wq = wq_record(ex, log, n_req + 3 + int(profile))
    ex.close()
    rec = {"whole_query": whole_query,
           "predicted_chunks_per_sum_request": predicted,
           "qps": bsi64.SUMS_PER_REQUEST * len(lat) / sum(lat),
           "requests_per_s": len(lat) / sum(lat),
           "request_p50_ms": statistics.median(lat) * 1e3,
           "request_ms": [round(t * 1e3, 3) for t in lat],
           "launches_per_sum_request": {k: n / n_req for k, n in
                                        sum_launches.items()},
           "launches_phase": launches,
           "batch_chunks_per_request": chunks,
           "prepared_hits": hits,
           "group_by_ms": gb_ms,
           "resident_mb": stats["residentBytes"] / 2**20,
           "compressed_mb": stats["compressedBytes"] / 2**20,
           "seconds": time.perf_counter() - t_phase, **wq}
    say("bsi64", run=label, shards=n_shards,
        sums_per_request=bsi64.SUMS_PER_REQUEST, requests=len(lat),
        **{k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
           for k, v in rec.items()})
    return answers, rec


# -- phase 6b: the multi-process engine ---------------------------------------

MP_WORLD = 2                   # rank processes on the one card
MP_RANK_TIMEOUT_S = 240        # each rank's own limit


def mp_worker_queries() -> list:
    """The multihost worker's query set (tests/multihost_worker.py) on
    config 4's fields: ``seg`` (8 rows) and the int field ``v``."""
    return ["Row(seg=3)", "TopN(seg, n=5)", "Rows(seg)",
            "GroupBy(Rows(seg), Rows(seg))", "Sum(field=v)",
            "Min(field=v)", "Max(field=v)", "Count(Row(seg=5))"]


def mp_normalize(results) -> list:
    """Executor results as JSON values; a Row as its column count and
    the sha256 of its sorted column ids."""
    import hashlib
    from pilosa_tpu_torch import bsi64
    out = []
    for r in results:
        if hasattr(r, "columns"):
            cols = np.asarray(sorted(int(c) for c in r.columns()),
                              dtype=np.int64)
            out.append([int(cols.size),
                        hashlib.sha256(cols.tobytes()).hexdigest()])
        elif hasattr(r, "rows"):
            out.append([int(x) for x in r.rows])
        else:
            out.append(bsi64.normalize([r])[0])
    return json.loads(json.dumps(out))


def mp_oracle(oracle) -> list:
    """numpy answers of ``mp_worker_queries`` over the full config-4
    data, in ``mp_normalize``'s form."""
    import hashlib
    from pilosa_tpu_torch import bsi64
    cols, vals, segs = oracle
    row3 = np.sort(cols[segs == 3]).astype(np.int64)
    counts = np.bincount(segs, minlength=bsi64.SEG_ROWS)
    order = np.lexsort((np.arange(counts.size), -counts))
    want = [[int(row3.size), hashlib.sha256(row3.tobytes()).hexdigest()],
            [(int(i), int(counts[i])) for i in order[:5] if counts[i]],
            [int(i) for i in np.nonzero(counts)[0]],
            bsi64.oracle_group_by(vals, segs, -1),
            (int(vals.sum()), int(vals.size)),
            bsi64.oracle_min_max(vals, -1, False),
            bsi64.oracle_min_max(vals, -1, True),
            int(counts[5])]
    return json.loads(json.dumps(want))


def rank_main(argv) -> int:
    """One rank of phase ``multiprocess``: joins the process group over
    gloo on ``cuda:0`` (both ranks share the one card, where NCCL refuses
    two ranks), builds its slice of the SSB corpus (256 shards) and of
    config 4's (64 shards) from the seeds, and runs the SSB mix, config
    4's requests and the multihost worker's set compressed-resident
    through ``Executor(..., group=...)``, counting kernel launches per
    corpus.  Rank 0 then holds both kernels on its own stacks against
    their plain versions.  Prints one ``RANK {...}`` JSON line."""
    from pilosa_tpu_torch import bsi64, ssb
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import multihost
    from pilosa_tpu_torch.storage import Holder
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    rank = int(argv[argv.index("--rank") + 1])
    world = int(argv[argv.index("--world") + 1])
    port = int(argv[argv.index("--port") + 1])
    device = argv[argv.index("--device") + 1]
    n_cfg4 = int(argv[argv.index("--cfg4-shards") + 1])
    t_rank = time.perf_counter()
    # the ranks share the host: split its cores, or their intra-op
    # threads spin against each other while one waits in a collective
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # gloo: the ranks share one card
    group, device = multihost.init_distributed(
        f"localhost:{port}", world, rank, backend="gloo", device=device)
    rec = {"rank": rank, "world": world, "backend": "gloo",
           "device": str(device)}
    t0 = time.perf_counter()
    lo, hi = multihost.shard_range(N_SHARDS, rank, world)
    holder = Holder(None)
    ssb.build_ssb(holder, np.random.default_rng(SEED), n_shards=N_SHARDS,
                  keep=range(lo, hi))
    cfg4, _ = cfg4_corpus(n_cfg4, group)
    rec.update(ssb_shards=[lo, hi], bsi64_shards=list(
        multihost.shard_range(n_cfg4, rank, world)),
        build_s=time.perf_counter() - t0)
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20      # compressed-resident

    # the SSB mix: the batches of run_ssb, one pass
    rng = np.random.default_rng(SEED + 1)
    batches = [ssb.ssb_calls(rng, BATCH) for _ in range(N_BATCHES + 1)]
    ex = Executor(holder, device=device, group=group)
    if ex.wholequery is not None or not ex.multiprocess:
        raise AssertionError("a grouped executor built a whole-query runner")
    kernels.reset_launches()
    answers, lat = [], []
    for i, calls in enumerate(batches):
        t0 = time.perf_counter()
        answers.append(ssb.normalize(ex.execute(ssb.SSB_INDEX,
                                                ssb.ssb_batch(calls))))
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
    rec["ssb"] = {"launches": dict(kernels.LAUNCHES),
                  "batch_p50_ms": statistics.median(lat) * 1e3,
                  "batch_ms": [round(x * 1e3, 3) for x in lat],
                  "fused_calls": ex.stacked.fused_calls,
                  "answers": answers}
    ex.close()

    # config 4: the 64-Sum requests, the GroupBy, Min / Max / Count /
    # TopN, then the multihost worker's set
    rng = np.random.default_rng(SEED + 5)
    xs_all = [rng.integers(0, bsi64.V_MAX, size=bsi64.SUMS_PER_REQUEST)
              for _ in range(CFG4_REQUESTS + 1)]
    ex = Executor(cfg4, device=device, group=group)
    kernels.reset_launches()
    answers, lat = [], []
    for i, xs in enumerate(xs_all):
        t0 = time.perf_counter()
        answers.append(bsi64.normalize(ex.execute(
            bsi64.INDEX, bsi64.sum_request(xs))))
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
    ex.execute(bsi64.INDEX, bsi64.group_by_query(1))
    t0 = time.perf_counter()
    answers.append(bsi64.normalize(ex.execute(
        bsi64.INDEX, bsi64.group_by_query(500_000))))
    gb_ms = (time.perf_counter() - t0) * 1e3
    x = int(xs_all[-1][0])
    answers.append(bsi64.normalize(ex.execute(
        bsi64.INDEX, f"Min(Row(v > {x}), field=v) Max(Row(v > {x}), "
                     f"field=v) Count(Row(v > {x})) "
                     f"TopN(seg, Row(v > {x}), n=5)")))
    worker = [mp_normalize(ex.execute(bsi64.INDEX, q))[0]
              for q in mp_worker_queries()]
    rec["bsi64"] = {"launches": dict(kernels.LAUNCHES),
                    "request_p50_ms": statistics.median(lat) * 1e3,
                    "request_ms": [round(t * 1e3, 3) for t in lat],
                    "group_by_ms": gb_ms,
                    "answers": json.loads(json.dumps(answers)),
                    "worker": worker}
    ex.close()

    if rank == 0:
        # both kernels on this rank's own stacks against their plain
        # versions (launches here are not the main path's)
        dec, fus = check_ssb_shapes(holder, device, group=group,
                                    label="multiprocess")
        bsi_dec = check_bsi_stack(cfg4, device, n_cfg4,
                                  group=group, label="multiprocess")
        rec["kernel_recs"] = {"decode_block": dec, "fused_row_counts": fus,
                              "decode_block_bsig_v": bsi_dec}
    import torch.distributed as dist
    dist.barrier()
    multihost.close_distributed()
    rec["seconds"] = time.perf_counter() - t_rank
    print("RANK " + json.dumps(rec), flush=True)
    return 0


def run_multiprocess(device, card: str, hist, ssb_answers, cfg4, oracle,
                     c4_answers, n_cfg4: int) -> dict:
    """Phase ``multiprocess``: MP_WORLD rank processes (fresh
    interpreters running ``rank_main``) on the one card.  Every rank's
    answers must equal the oracle and the single-process port's answers
    on the same data (the ``ssb`` and ``bsi64`` phases, and the worker
    set run here on the single-process config-4 holder); both kernels
    must launch in every rank.  Returns the phase's record."""
    import tempfile
    from pilosa_tpu_torch import bsi64, ssb
    from pilosa_tpu_torch.executor import Executor
    # the worker set on one process, compressed-resident as the ranks
    ex = Executor(cfg4, device=device)
    single = [mp_normalize(ex.execute(bsi64.INDEX, q))[0]
              for q in mp_worker_queries()]
    ex.close()
    want_worker = mp_oracle(oracle)
    if single != want_worker:
        raise AssertionError(f"multihost worker set on one process: "
                             f"{single} != oracle {want_worker}")
    # free the parent's cached device memory for the ranks' contexts
    gc.collect()
    torch.cuda.empty_cache()
    from pilosa_tpu_torch.bench import free_ports
    (port,) = free_ports(1)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(MP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world",
         str(MP_WORLD), "--port", str(port), "--device", str(device),
         "--cfg4-shards", str(n_cfg4)],
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(MP_WORLD)]
    try:
        for r, p in enumerate(procs):
            left = MP_RANK_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} exceeded "
                                     f"{MP_RANK_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
        for line in out.splitlines():
            if line.startswith("[") and not line.startswith("[RANK"):
                print(f"  rank{r} {line}", flush=True)
        recs.append(json.loads(next(
            x for x in out.splitlines() if x.startswith("RANK "))[5:]))
    shards = list(range(N_SHARDS))
    rng = np.random.default_rng(SEED + 1)
    batches = [ssb.ssb_calls(rng, BATCH) for _ in range(N_BATCHES + 1)]
    want_c4 = json.loads(json.dumps(c4_answers))
    for rec in recs:
        r = rec["rank"]
        got = rec["ssb"].pop("answers")
        for calls, g in zip(batches, got):
            check_answers(f"multiprocess rank {r}", hist, shards, calls, g)
        if got != ssb_answers:
            raise AssertionError(f"rank {r}: the SSB answers differ from "
                                 f"the single-process port's")
        got = rec["bsi64"].pop("answers")
        if got != want_c4:
            raise AssertionError(f"rank {r}: the config-4 answers differ "
                                 f"from the single-process port's")
        got = rec["bsi64"].pop("worker")
        if got != want_worker or got != single:
            raise AssertionError(f"rank {r}: the multihost worker set "
                                 f"{got} != oracle {want_worker}")
        for corpus, names in (("ssb", ("decode_block", "fused_row_counts")),
                              ("bsi64", ("decode_block",))):
            for name in names:
                if rec[corpus]["launches"].get(name, 0) <= 0:
                    raise AssertionError(f"rank {r} never launched {name} "
                                         f"on the {corpus} corpus")
        say("multiprocess", rank=r, card=repr(card),
            seconds=rec["seconds"], build_s=rec["build_s"],
            ssb_shards=rec["ssb_shards"],
            ssb_batch_p50_ms=rec["ssb"]["batch_p50_ms"],
            ssb_launches=json.dumps(rec["ssb"]["launches"]),
            bsi64_shards=rec["bsi64_shards"],
            bsi64_request_p50_ms=rec["bsi64"]["request_p50_ms"],
            bsi64_group_by_ms=rec["bsi64"]["group_by_ms"],
            bsi64_launches=json.dumps(rec["bsi64"]["launches"]))
    kr = recs[0].pop("kernel_recs")
    for name, k in kr.items():
        if k["err"]:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on rank 0's stacks: {k['err']}")
    return {"world": MP_WORLD, "backend": "gloo", "card": card,
            "wall_s": wall, "ranks": recs, "kernel_recs": kr}


# -- phase 7: the served path -------------------------------------------------

SERVED_CLIENTS = 8
SERVED_REQUESTS_8 = 2          # requests per client of the 8-client run
INGEST_BITS = 1 << 20          # new rev bits streamed through /ingest
INGEST_POSTS = 16


def http(port: int, method: str, path: str, body=None,
         ctype: str = "application/json", timeout: float = 600):
    """One request to the served API; returns the parsed JSON body and
    raises on any status other than 200."""
    import urllib.request
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = urllib.request.Request(f"http://localhost:{port}{path}",
                                 data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        data = resp.read()
    return json.loads(data) if data.strip() else {}


def start_server(data_dir: str, device, **kw):
    from pilosa_tpu_torch.server.server import Config, Server
    srv = Server(Config(data_dir=data_dir, bind="localhost:0",
                        device=str(device), metric_poll_interval=0, **kw))
    srv.open()
    return srv


def roaring_bodies(holder, n_shards: int) -> list:
    """The client's side of the load: every (field, shard) fragment of
    the in-memory corpus as a pilosa-roaring body."""
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.storage.roaring_io import pack_roaring
    return [(name, shard, pack_roaring(*holder.fragment(
                ssb.SSB_INDEX, name, "standard", shard).pairs()))
            for shard in range(n_shards) for name, _ in ssb.SSB_FIELDS]


def load_served(srv, bodies) -> float:
    """Create ``ssb`` and its four fields over HTTP and POST every
    roaring body to ``import-roaring``, one POST per (field, shard),
    from 8 client threads.  Returns the load's seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from pilosa_tpu_torch import ssb
    t0 = time.perf_counter()
    http(srv.port, "POST", f"/index/{ssb.SSB_INDEX}",
         {"options": {"trackExistence": False}})
    for name, _rows in ssb.SSB_FIELDS:
        http(srv.port, "POST", f"/index/{ssb.SSB_INDEX}/field/{name}", {})

    def post(job):
        name, shard, body = job
        http(srv.port, "POST", f"/index/{ssb.SSB_INDEX}/field/{name}/"
             f"import-roaring/{shard}", body,
             ctype="application/octet-stream")

    with ThreadPoolExecutor(SERVED_CLIENTS) as pool:
        list(pool.map(post, bodies))
    return time.perf_counter() - t0


def topn_table(holder, n_shards: int) -> np.ndarray:
    """``int64[region, category, rev]``: bits of each rev row under each
    (region, category) pair over every shard, counted from the stored
    words — the TopN oracle that stays exact when ingest adds rev bits
    to columns that already carry one."""
    from pilosa_tpu_torch import ssb
    tab = np.zeros((5, 12, 8), dtype=np.int64)
    for shard in range(n_shards):
        dense = {name: holder.fragment(ssb.SSB_INDEX, name, "standard",
                                       shard).to_dense()[:rows]
                 for name, rows in ssb.SSB_FIELDS[1:]}
        on = dense["region"].any(axis=0)
        reg = dense["region"].argmax(axis=0)[on]
        cat = dense["category"].argmax(axis=0)[on]
        for m in range(8):
            np.add.at(tab[:, :, m], (reg, cat),
                      np.bitwise_count(dense["rev"][m][on]).astype(np.int64))
    return tab


def served_oracle(hist, tab, shards, call):
    """``ssb.oracle``, with TopN answered from ``tab`` when given."""
    from pilosa_tpu_torch import ssb
    if call[0] != 1 or tab is None:
        return ssb.oracle(hist, shards, call)
    counts = tab[call[2], call[3]]
    order = sorted(range(counts.size), key=lambda m: (-counts[m], m))
    return [{"id": m, "count": int(counts[m])}
            for m in order[:5] if counts[m] > 0]


def served_batches() -> list:
    """The requests of ``run_ssb`` (one warm, then N_BATCHES timed, from
    the same seed), then SERVED_REQUESTS_8 more for each of
    SERVED_CLIENTS clients: the 1-client numbers compare with the
    in-process ones request for request."""
    from pilosa_tpu_torch import ssb
    rng = np.random.default_rng(SEED + 1)
    return [ssb.ssb_calls(rng, BATCH) for _ in range(
        1 + N_BATCHES + SERVED_CLIENTS * SERVED_REQUESTS_8)]


def served_mix(srv, hist, tab, n_shards: int, label: str):
    """The SSB mix as HTTP POSTs of 24 calls (``served_batches``): one
    warm request, then N_BATCHES from one client, then
    SERVED_REQUESTS_8 from each of SERVED_CLIENTS concurrent clients;
    every answer equal to the oracle.  Returns the record."""
    from concurrent.futures import ThreadPoolExecutor
    from pilosa_tpu_torch import ssb
    shards = list(range(n_shards))
    n8 = SERVED_CLIENTS * SERVED_REQUESTS_8
    batches = served_batches()
    want = [[served_oracle(hist, tab, shards, c) for c in b]
            for b in batches]

    def one(i):
        t0 = time.perf_counter()
        got = http(srv.port, "POST", f"/index/{ssb.SSB_INDEX}/query",
                   ssb.ssb_batch(batches[i]).encode())["results"]
        dt = time.perf_counter() - t0
        if got != want[i]:
            bad = next(j for j, (a, b) in enumerate(zip(got, want[i]))
                       if a != b)
            raise AssertionError(
                f"served {label}: {ssb.ssb_query(batches[i][bad])} -> "
                f"{got[bad]}, oracle {want[i][bad]}")
        return dt

    one(0)                                   # warm: stacks staged
    lat1 = [one(i) for i in range(1, 1 + N_BATCHES)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVED_CLIENTS) as pool:
        lat8 = list(pool.map(one, range(1 + N_BATCHES, len(batches))))
    wall8 = time.perf_counter() - t0
    rec = {"qps_1": BATCH * len(lat1) / sum(lat1),
           "p50_ms_1": statistics.median(lat1) * 1e3,
           "ms_1": [round(x * 1e3, 3) for x in lat1],
           "qps_8": BATCH * n8 / wall8,
           "p50_ms_8": statistics.median(lat8) * 1e3,
           "requests": len(batches)}
    say("served", run=label, clients=1, requests=len(lat1),
        qps=rec["qps_1"], p50_ms=rec["p50_ms_1"])
    say("served", run=label, clients=SERVED_CLIENTS, requests=len(lat8),
        qps=rec["qps_8"], p50_ms=rec["p50_ms_8"])
    return rec


FUSIBLE_REQUESTS = 4           # requests per client of the fusible leg


def fusible_calls(rng) -> list:
    """One request of the fusible leg: three Q1-style Counts and one
    Q2-style TopN, in that order, so every request lowers to the same
    whole-query program (a count node of 3 rows, a row_counts node of
    1) — no GroupBy, whose group_counts node never fuses."""
    return [(0, int(rng.integers(0, 7)), int(rng.integers(0, 5)), 0)
            for _ in range(3)] + \
        [(1, 0, int(rng.integers(0, 5)), int(rng.integers(0, 12)))]


def served_fusible(srv, hist, n_shards: int) -> dict:
    """SERVED_CLIENTS concurrent clients, each sending FUSIBLE_REQUESTS
    requests of ``fusible_calls``: the dispatch batcher must fuse their
    whole-query tickets — some launch with more than 1 ticket, from its
    ``snapshot()`` — and every answer must equal the oracle."""
    from concurrent.futures import ThreadPoolExecutor
    from pilosa_tpu_torch import ssb
    shards = list(range(n_shards))
    rng = np.random.default_rng(SEED + 7)
    reqs = [fusible_calls(rng)
            for _ in range(SERVED_CLIENTS * FUSIBLE_REQUESTS)]
    b = srv.api.executor.batcher
    f0, s0 = b.fused_launches, b.single_launches

    def client(k):
        lat = []
        for calls in reqs[k::SERVED_CLIENTS]:
            t0 = time.perf_counter()
            got = http(srv.port, "POST", f"/index/{ssb.SSB_INDEX}/query",
                       ssb.ssb_batch(calls).encode())["results"]
            lat.append(time.perf_counter() - t0)
            want = [ssb.oracle(hist, shards, c) for c in calls]
            if got != want:
                raise AssertionError(f"fusible leg: {ssb.ssb_batch(calls)}"
                                     f" -> {got}, oracle {want}")
        return lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVED_CLIENTS) as pool:
        lat = [x for ls in pool.map(client, range(SERVED_CLIENTS))
               for x in ls]
    wall = time.perf_counter() - t0
    snap = b.snapshot()
    rec = {"requests": len(reqs),
           "calls_per_s": sum(len(r) for r in reqs) / wall,
           "p50_ms": statistics.median(lat) * 1e3,
           "fused_launches": b.fused_launches - f0,
           "single_launches": b.single_launches - s0,
           "batch_size": snap["batchSize"]}
    say("served", run="fusible", clients=SERVED_CLIENTS,
        **{k: (json.dumps(v) if isinstance(v, dict) else v)
           for k, v in rec.items()})
    if rec["fused_launches"] <= 0 or \
            snap["batchSize"]["count"] <= snap["batchSize"]["le_1"]:
        raise AssertionError(f"the fusible leg never fused a launch: {snap}")
    return rec


def ingest_served(srv, holder, n_shards: int, seed: int) -> dict:
    """Stream INGEST_BITS new rev bits over every shard through /ingest
    (INGEST_POSTS framed POSTs, each acked after its group commit) into
    columns of live facts, and apply the same bits to ``holder``, the
    oracle's state.  Returns the record."""
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.core import SHARD_WIDTH, SHARD_WORDS
    from pilosa_tpu_torch.ingest import wire
    rng = np.random.default_rng(seed)
    per = INGEST_BITS // n_shards
    rows, cols = [], []
    for shard in range(n_shards):
        live = np.unique(holder.fragment(ssb.SSB_INDEX, "year", "standard",
                                         shard)._idx % SHARD_WORDS)
        w = rng.choice(live, size=per)
        cols.append(shard * SHARD_WIDTH + w * 32 + rng.integers(0, 32, per))
        rows.append(rng.integers(0, 8, per))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = rng.permutation(rows.size)
    rows, cols = rows[order], cols[order]
    posts = [wire.encode_records(r, c) for r, c in
             zip(np.array_split(rows, INGEST_POSTS),
                 np.array_split(cols, INGEST_POSTS))]
    t0 = time.perf_counter()
    acked = 0
    for body in posts:
        ack = http(srv.port, "POST",
                   f"/index/{ssb.SSB_INDEX}/field/rev/ingest", body,
                   ctype="application/octet-stream")
        acked += ack["records"]
    secs = time.perf_counter() - t0
    if acked != rows.size:
        raise AssertionError(f"ingest acked {acked} of {rows.size} records")
    holder.index(ssb.SSB_INDEX).field("rev").import_bits(rows, cols)
    rec = {"records": int(rows.size), "posts": INGEST_POSTS,
           "seconds": secs, "records_per_s": rows.size / secs}
    say("served", run="ingest", **rec)
    return rec


def cli_server_roundtrip(device) -> dict:
    """``python3 -m pilosa_tpu_torch server`` as a subprocess: /status,
    one Set + Count, SIGTERM, exit 0."""
    import os
    import signal
    import socket
    import tempfile
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "pilosa_tpu_torch", "server",
               "-d", d, "-b", f"localhost:{port}"]
        if torch.device(device).type != "cuda":
            cmd += ["--device", str(device)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 120
            while True:
                try:
                    st = http(port, "GET", "/status", timeout=5)
                    break
                except OSError:
                    if proc.poll() is not None or \
                            time.monotonic() > deadline:
                        raise AssertionError(
                            "the CLI server did not come up: "
                            + proc.stdout.read().decode()[-2000:])
                    time.sleep(0.2)
            up = time.perf_counter() - t0
            http(port, "POST", "/index/cli", {})
            http(port, "POST", "/index/cli/field/f", {})
            http(port, "POST", "/index/cli/query", b"Set(7, f=3)")
            got = http(port, "POST", "/index/cli/query",
                       b"Count(Row(f=3))")["results"]
            if got != [1] or st["state"] != "NORMAL":
                raise AssertionError(f"CLI server answered {got}, {st}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = proc.stdout.read().decode()
        if rc != 0:
            raise AssertionError(f"the CLI server exited {rc}: {out[-2000:]}")
    rec = {"up_s": up, "seconds": time.perf_counter() - t0, "exit": rc,
           "pid_gone": not os.path.exists(f"/proc/{proc.pid}")}
    say("served", run="cli", **rec)
    return rec


def served_wq(srv, label: str, replays: bool) -> dict:
    """A served run's whole-query record: no request may fall back, and
    with ``replays`` (a run that repeats a signature) the card must have
    replayed captured graphs."""
    ex = srv.api.executor
    rec = {"wq_requests": ex.wq_requests, "wq_fallbacks": ex.wq_fallbacks,
           **ex.wholequery.snapshot()}
    say("served", run=f"{label}_wholequery",
        **{k: json.dumps(v) if isinstance(v, dict) else v
           for k, v in rec.items()})
    if ex.wq_fallbacks or not ex.wq_requests or (
            replays and torch.device(ex.device).type == "cuda"
            and not rec["replays"]):
        raise AssertionError(f"served {label}: whole-query {rec}")
    return rec


# -- phase 8: warm start and the device-runtime observability -------------

WARM_SIGNATURES = 4            # requests of the warm-start mix, each its own
#                                signature, sent twice from one client
SLO_LOAD_S = 5.0               # seconds of compressed mix in the SLO leg
# The warm restart's replay budget.  The compressed replay re-packs every
# fragment on the host first and took 24.6-33.3 s between calls on the
# card (one host against another), around the server's 30 s default,
# past which the replayer skips the rest by design; the phase checks
# that the whole corpus replays, so it gives the replay room.
WARM_BUDGET_S = 120.0
PR5_DENSE_PAD_PCT = 19.5       # dense replay p50 over eager, PR 5 (PERF.md)


def warm_batches() -> list:
    """The warm-start mix: the first WARM_SIGNATURES one-client
    requests of ``served_batches``."""
    return served_batches()[1:1 + WARM_SIGNATURES]


def wait_ready(srv, t0: float, timeout: float = 120.0) -> tuple:
    """Poll ``/status`` every 50 ms from just after ``open()`` until it
    says READY; returns (seconds from ``t0``, the phases seen in order)."""
    seen = []
    deadline = time.monotonic() + timeout
    while True:
        st = http(srv.port, "GET", "/status", timeout=30)
        state = st["nodes"][0]["state"]
        if not seen or seen[-1] != state:
            seen.append(state)
        if state == "READY" and not st["warming"]:
            return time.perf_counter() - t0, seen
        if time.monotonic() > deadline:
            raise AssertionError(f"no READY after {timeout} s: {st}")
        time.sleep(0.05)


def warm_request(srv, batch, want, label: str):
    """One mix request with ``?explain=true``; returns (seconds, raw
    body, the whole-query plan entries)."""
    import urllib.request
    from pilosa_tpu_torch import ssb
    req = urllib.request.Request(
        f"http://localhost:{srv.port}/index/{ssb.SSB_INDEX}/query"
        f"?explain=true", data=ssb.ssb_batch(batch).encode(),
        method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
    dt = time.perf_counter() - t0
    out = json.loads(raw)
    if out["results"] != want:
        raise AssertionError(f"warm_start {label}: {out['results'][:3]} "
                             f"!= oracle {want[:3]}")
    plan = [e for e in out.get("explain", {}).get("plan", [])
            if e.get("mode") == "wholequery"]
    return dt, plan


def post_raw(port: int, body: bytes) -> bytes:
    """One mix request; returns the raw response body."""
    import urllib.request
    from pilosa_tpu_torch import ssb
    req = urllib.request.Request(
        f"http://localhost:{port}/index/{ssb.SSB_INDEX}/query", data=body,
        method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.read()


def warm_leg(data_dir: str, hist, tab, device, n_shards: int,
             label: str, cold_kw=None, **kw) -> tuple:
    """A cold restart (``warmup_top_n = 0``, no corpus; ``cold_kw`` on
    top of ``kw``) sending the warm mix twice from one client and then
    once more without explain, then a warm restart with the default
    ``warmup_top_n`` over the corpus the cold server wrote, sending it
    once more.  Returns the leg's record and the cold server's raw
    bodies of the last round; raises on a failed gate."""
    import os
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils import devobs
    from pilosa_tpu_torch.warmup import SignatureCorpus
    corpus = os.path.join(data_dir, "signatures.log")
    if os.path.exists(corpus):
        os.remove(corpus)        # the cold restart starts with no corpus
    shards = list(range(n_shards))
    batches = warm_batches()
    want = [[served_oracle(hist, tab, shards, c) for c in b]
            for b in batches]
    rec = {}

    t0 = time.perf_counter()
    srv = start_server(data_dir, device, warmup_top_n=0,
                       **{**kw, **(cold_kw or {})})
    try:
        ready_s, seen = wait_ready(srv, t0)
        wq = srv.api.executor.wholequery
        c0, w0 = devobs.COMPILES.totals(), wq.snapshot()
        first = [warm_request(srv, b, w, f"{label} cold")[0]
                 for b, w in zip(batches, want)]
        second = [warm_request(srv, b, w, f"{label} cold")[0]
                  for b, w in zip(batches, want)]
        c1, w1 = devobs.COMPILES.totals(), wq.snapshot()
        from pilosa_tpu_torch import ssb
        raw = [post_raw(srv.port, ssb.ssb_batch(b).encode())
               for b in batches]
        if [json.loads(r)["results"] for r in raw] != want:
            raise AssertionError(f"warm_start {label}: cold answers")
        rec["cold_slo_engine"] = srv.slo is not None
        rec["cold"] = {
            "ready_s": ready_s, "phases": seen,
            "first_p50_ms": statistics.median(first) * 1e3,
            "second_p50_ms": statistics.median(second) * 1e3,
            "first_ms": [round(x * 1e3, 3) for x in first],
            "second_ms": [round(x * 1e3, 3) for x in second],
            "captures": c1["compiles"] - c0["compiles"],
            "capture_s": round(c1["compileSecondsTotal"]
                               - c0["compileSecondsTotal"], 6),
            "replays": w1["replays"] - w0["replays"],
            "pool_mb": (wq.pool_reserved_bytes() or 0) / 2**20}
    finally:
        srv.close()
    folded = SignatureCorpus.load(corpus)
    corpus_sigs = {r["sig"] for r in folded.values() if r.get("sig")}
    rec["corpus_entries"] = len(folded)

    t0 = time.perf_counter()
    srv = start_server(data_dir, device, warmup_budget_s=WARM_BUDGET_S,
                       **kw)
    try:
        ready_s, seen = wait_ready(srv, t0)
        wq = srv.api.executor.wholequery
        st = srv.warmup.status()
        held = wq.held_sigs()
        pool_mb = (wq.pool_reserved_bytes() or 0) / 2**20
        c0, w0 = devobs.COMPILES.totals(), wq.snapshot()
        kernels.reset_launches()
        firsts, plans = [], []
        for b, w in zip(batches, want):
            dt, plan = warm_request(srv, b, w, f"{label} warm")
            firsts.append(dt)
            plans.extend(plan)
        replayed = dict(kernels.REPLAYED)
        c1, w1 = devobs.COMPILES.totals(), wq.snapshot()
        rec["warm"] = {
            "ready_s": ready_s, "phases": seen,
            "planned": st["planned"], "replayed": st["replayed"],
            "errors": st["errors"], "skipped": st["skipped"],
            "replay_s": st["elapsedS"], "replay_capture_s": st["compileS"],
            "retraces_during_warm": st["retracesDuringWarm"],
            "corpus_signatures": len(corpus_sigs),
            "held_at_ready": len(corpus_sigs & held),
            "graphs_at_ready": len(held),
            "pool_mb_at_ready": pool_mb,
            "first_p50_ms": statistics.median(firsts) * 1e3,
            "first_ms": [round(x * 1e3, 3) for x in firsts],
            "captures_after_ready": c1["compiles"] - c0["compiles"],
            "replays_after_ready": w1["replays"] - w0["replays"],
            "compile_cold_plans": sum(1 for e in plans
                                      if e["compile"] != "warm"),
            "launches_replayed": replayed}
    finally:
        srv.close()
    w = rec["warm"]
    say("warm_start", leg=label, **{
        k: json.dumps(v) if isinstance(v, (dict, list)) else v
        for k, v in {**{f"cold_{k}": v for k, v in rec["cold"].items()
                        if not k.endswith("_ms")},
                     **{k: v for k, v in w.items()
                        if k != "first_ms"}}.items()})
    say("warm_start", leg=label, ready_s_cold=rec["cold"]["ready_s"],
        ready_s_warm=w["ready_s"], replay_s=w["replay_s"],
        first_p50_ms_cold=rec["cold"]["first_p50_ms"],
        second_p50_ms_cold=rec["cold"]["second_p50_ms"],
        first_p50_ms_warm=w["first_p50_ms"])
    if w["phases"][0] != "WARMING" or w["phases"][-1] != "READY":
        raise AssertionError(f"warm_start {label}: /status went "
                             f"{w['phases']}, not WARMING then READY")
    if rec["cold"]["phases"] != ["READY"]:
        raise AssertionError(f"warm_start {label}: the cold restart went "
                             f"{rec['cold']['phases']}")
    if w["planned"] != rec["corpus_entries"] or \
            w["replayed"] != 2 * w["planned"] or w["errors"] or \
            w["skipped"]:
        raise AssertionError(f"warm_start {label}: warmup {w}")
    if w["held_at_ready"] != w["corpus_signatures"] or \
            not w["corpus_signatures"]:
        raise AssertionError(f"warm_start {label}: {w['held_at_ready']} "
                             f"of {w['corpus_signatures']} corpus "
                             f"signatures held as graphs at READY")
    if w["captures_after_ready"] or w["compile_cold_plans"] or \
            w["replays_after_ready"] < len(batches):
        raise AssertionError(f"warm_start {label}: after READY {w}")
    if kw.get("device_budget_mb") and torch.device(device).type == "cuda":
        for name, n in w["launches_replayed"].items():
            if n <= 0:
                raise AssertionError(f"warm_start {label}: no replayed "
                                     f"graph launched {name}")
    return rec, raw


def observe_server(srv) -> dict:
    """The device-runtime surfaces of a live server: /debug/compiles,
    /debug/launches, /metrics (device families), /debug/timeseries and
    the CLI ``top``."""
    import contextlib
    import io
    from pilosa_tpu_torch import cli
    comp = http(srv.port, "GET", "/debug/compiles")
    lau = http(srv.port, "GET", "/debug/launches")
    import urllib.request
    with urllib.request.urlopen(
            f"http://localhost:{srv.port}/metrics", timeout=60) as r:
        text = r.read().decode()
    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE pilosa_tpu_device_"):
            _, _, name, typ = line.split()
            fams[name] = typ
        elif line.startswith("pilosa_tpu_device_"):
            float(line.rpartition(" ")[2])      # every sample parses
    ts = http(srv.port, "GET", "/debug/timeseries")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["top", "-host", f"localhost:{srv.port}",
                       "--count", "1", "--interval", "0.1"])
    top = buf.getvalue()
    by_sig = sorted(({"sig": e["sig"], "captures": e["compiles"],
                      "capture_s": round(e["totalCompileS"], 6),
                      "retraces": e["retraces"]}
                     for e in comp["entries"]),
                    key=lambda e: -e["capture_s"])
    rec = {"captures": comp["compiles"], "retraces": comp["retraces"],
           "capture_s": comp["compileSecondsTotal"],
           "signatures": comp["executables"], "top_by_capture_s":
           by_sig[:5], "launches": lau["launches"],
           "padding_waste_ratio": lau["paddingWasteRatio"],
           "pr5_dense_pad_pct": PR5_DENSE_PAD_PCT,
           "kernel_launches": lau["kernelLaunches"],
           "decode_peak_mb": lau["decodePeakBytes"] / 2**20,
           "device_families": len(fams), "timeseries_samples":
           len(ts["samples"]), "top_rc": rc, "top_lines": top.count("\n")}
    say("warm_start", leg="observe", **{
        k: json.dumps(v) if isinstance(v, (dict, list)) else v
        for k, v in rec.items()})
    for fam in ("pilosa_tpu_device_compiles_total",
                "pilosa_tpu_device_retraces_total",
                "pilosa_tpu_device_launches_total",
                "pilosa_tpu_device_padding_waste_ratio"):
        if fams.get(fam) != "gauge":
            raise AssertionError(f"/metrics lacks {fam}: {fams}")
    if fams.get("pilosa_tpu_device_launch_seconds") != "histogram":
        raise AssertionError(f"/metrics lacks the launch histogram")
    if rec["retraces"]:
        raise AssertionError(f"retraces in this process: {by_sig}")
    if not rec["captures"] or not rec["timeseries_samples"] or rc != 0 \
            or "pilosa-tpu top @" not in top or "kernels: backend cuda" \
            not in top and torch.device(srv.device).type == "cuda":
        raise AssertionError(f"device-runtime surfaces: {rec}\n{top}")
    return rec


def slo_leg(data_dir: str, hist, tab, device, n_shards: int,
            raw_off: list) -> dict:
    """A compressed server with ``timeseries-interval = 1``,
    ``timeseries-window = 60`` (SLO windows of 3 and 15 samples) and
    ``slo-latency-ms = 1``: SLO_LOAD_S of the warm mix from one client
    must fire ``slo-latency-burn``, leave a flight-recorder bundle (and
    ``POST /debug/bundle`` must return one), and resolve after the load
    stops; its answers must be byte-identical to ``raw_off``, those of
    the compressed cold server, whose alert rules were off.  The
    observability surfaces are read on the live server."""
    import os
    from pilosa_tpu_torch import ssb
    shards = list(range(n_shards))
    batches = warm_batches()
    want = [[served_oracle(hist, tab, shards, c) for c in b]
            for b in batches]
    bodies = [ssb.ssb_batch(b).encode() for b in batches]

    def post(port, i):
        raw = post_raw(port, bodies[i])
        if json.loads(raw)["results"] != want[i]:
            raise AssertionError(f"slo leg: request {i} != oracle")
        return raw

    common = dict(device_budget_mb=BUDGET_MB, warmup_top_n=0,
                  timeseries_interval=1, timeseries_window=60,
                  slo_latency_ms=1, flight_recorder_mb=64)
    rec = {}
    srv = start_server(data_dir, device, **common)
    try:
        eng = srv.slo
        raw_on = [post(srv.port, i) for i in range(len(batches))]
        t0 = time.perf_counter()
        n = 0
        fired_after = None
        while time.perf_counter() - t0 < SLO_LOAD_S:
            post(srv.port, n % len(batches))
            n += 1
            if fired_after is None and "slo-latency-burn" in eng.active:
                fired_after = time.perf_counter() - t0
        rec["requests"] = n + len(batches)
        rec["fired_after_s"] = fired_after
        alerts = http(srv.port, "GET", "/debug/alerts")
        rec["fired"] = "slo-latency-burn" in alerts["active"] or \
            any(h["id"] == "slo-latency-burn" and h["action"] == "fire"
                for h in alerts["history"])
        rec["windows"] = alerts["windows"]
        rec["on_fire_bundles"] = srv.flightrec.captures
        bdir = os.path.join(data_dir, "flightrec")
        rec["bundle_files"] = len([f for f in os.listdir(bdir)
                                   if f.startswith("bundle-")]) \
            if os.path.isdir(bdir) else 0
        out = http(srv.port, "POST", "/debug/bundle",
                   {"reason": "chip-smoke"})
        rec["bundle_endpoint"] = os.path.isfile(out["path"])
        rec["observe"] = observe_server(srv)
        t1 = time.perf_counter()
        while "slo-latency-burn" in eng.active and \
                time.perf_counter() - t1 < 30:
            time.sleep(0.2)
        rec["resolved_after_s"] = time.perf_counter() - t1
        rec["resolved"] = "slo-latency-burn" not in eng.active and \
            eng.resolved_total >= 1
    finally:
        srv.close()
    rec["byte_identical"] = raw_on == raw_off
    say("warm_start", leg="slo", **{
        k: json.dumps(v) if isinstance(v, (dict, list)) else v
        for k, v in rec.items() if k != "observe"})
    if not (rec["fired"] and rec["on_fire_bundles"] >= 1
            and rec["bundle_files"] >= 1 and rec["bundle_endpoint"]
            and rec["resolved"] and rec["byte_identical"]):
        raise AssertionError(f"slo leg: {rec}")
    if (rec["windows"]["fastN"], rec["windows"]["slowN"]) != (3, 15):
        raise AssertionError(f"slo leg windows {rec['windows']}")
    return rec


def run_warm_start(data_dir: str, hist, tab, device,
                   n_shards: int) -> dict:
    """Phase ``warm_start`` over the served data dir (after the ingest):
    the cold and warm restarts compressed (96 MB) and dense, then the
    SLO leg with the observability surfaces."""
    rec = {}
    # the compressed cold server runs with its alert rules off: its
    # answers are the SLO leg's reference
    rec["compressed"], raw_off = warm_leg(
        data_dir, hist, tab, device, n_shards, "compressed",
        cold_kw={"alert_rules": "off"}, device_budget_mb=BUDGET_MB)
    if rec["compressed"]["cold_slo_engine"]:
        raise AssertionError("alert_rules off left an SLO engine")
    rec["dense"], _ = warm_leg(data_dir, hist, tab, device, n_shards,
                               "dense", compressed_resident=False)
    rec["slo"] = slo_leg(data_dir, hist, tab, device, n_shards, raw_off)
    return rec


def run_served(holder, hist, device, n_shards: int = N_SHARDS,
               profile: bool = False) -> dict:
    """The port's server on ``device`` over the SSB corpus loaded through
    HTTP: the mix compressed-resident (96 MB budget; both kernels must
    launch), then on the same data dir dense-resident (no budget, as the
    in-process dense run) with a streamed ingest of new rev bits, whose
    dense stacks must take overlays; last the CLI server."""
    import tempfile
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.ops import kernels
    rec = {}
    t0 = time.perf_counter()
    bodies = roaring_bodies(holder, n_shards)
    rec["pack_s"] = time.perf_counter() - t0
    # the in-process run's profiled request, for a like-for-like profile
    prof_body = ssb.ssb_batch(served_batches()[N_BATCHES]).encode()
    query_path = f"/index/{ssb.SSB_INDEX}/query"
    with tempfile.TemporaryDirectory() as data_dir:
        srv = start_server(data_dir, device, device_budget_mb=BUDGET_MB)
        try:
            rec["load_s"] = load_served(srv, bodies)
            say("served", run="load", shards=n_shards, posts=len(bodies),
                body_mb=sum(len(b[2]) for b in bodies) / 2**20,
                pack_seconds=rec["pack_s"], seconds=rec["load_s"])
            kernels.reset_launches()
            rec["compressed"] = served_mix(srv, hist, None, n_shards,
                                           "compressed")
            launches = dict(kernels.LAUNCHES)
            rec["compressed"]["launches"] = launches
            rec["compressed"]["launches_per_request"] = {
                k: n / rec["compressed"]["requests"]
                for k, n in launches.items()}
            for name, n in launches.items():
                if n <= 0 and torch.device(device).type == "cuda":
                    raise AssertionError(f"the compressed served run never "
                                         f"launched {name}")
            say("served", run="compressed", launches=json.dumps(launches))
            rec["compressed_wholequery"] = served_wq(srv, "compressed",
                                                     False)
            if profile:
                profile_request(lambda: http(
                    srv.port, "POST", query_path, prof_body),
                    "served_compressed")
        finally:
            srv.close()
        srv = start_server(data_dir, device, compressed_resident=False)
        try:
            rec["dense"] = served_mix(srv, hist, None, n_shards, "dense")
            if profile:
                profile_request(lambda: http(
                    srv.port, "POST", query_path, prof_body),
                    "served_dense")
            rec["fusible"] = served_fusible(srv, hist, n_shards)
            st = srv.api.executor.stacked
            b0, o0 = st.stack_builds, st.overlays
            rec["ingest"] = ingest_served(srv, holder, n_shards, SEED + 6)
            tab = topn_table(holder, n_shards)
            rec["after_ingest"] = served_mix(srv, hist, tab, n_shards,
                                             "dense_after_ingest")
            rec["ingest"]["overlays"] = st.overlays - o0
            rec["ingest"]["restages"] = st.stack_builds - b0
            say("served", run="ingest", overlays=rec["ingest"]["overlays"],
                restages=rec["ingest"]["restages"])
            if rec["ingest"]["overlays"] <= 0:
                raise AssertionError("the dense served run took no ingest "
                                     "overlay")
            rec["dense_wholequery"] = served_wq(srv, "dense", True)
        finally:
            srv.close()
        # a second server over the same data dir: the grouped path with
        # no batcher, against the same updated oracle
        srv = start_server(data_dir, device, compressed_resident=False,
                           whole_query=False, dispatch_batch=False)
        try:
            rec["grouped_after_ingest"] = served_mix(
                srv, hist, tab, n_shards, "dense_grouped_after_ingest")
        finally:
            srv.close()
        for n in ("1", "8"):
            say("served", clients=n, dense_after_ingest_qps=rec[
                "after_ingest"][f"qps_{n}"], grouped_qps=rec[
                "grouped_after_ingest"][f"qps_{n}"],
                dense_after_ingest_p50_ms=rec["after_ingest"][f"p50_ms_{n}"],
                grouped_p50_ms=rec["grouped_after_ingest"][f"p50_ms_{n}"])
        # phase warm_start runs over this data dir before it goes
        t0 = time.perf_counter()
        warm = run_warm_start(data_dir, hist, tab, device, n_shards)
        warm["seconds"] = time.perf_counter() - t0
    rec["cli"] = cli_server_roundtrip(device)
    return rec, warm


# -- phase 9: BASELINE config 5 under the device budget ----------------------

CFG5_BUDGET_MB = 768
CFG5_B = 32                    # calls per rotation request (bench.py)
CFG5_NB = 12                   # timed rotation requests per leg
CFG5_ALL_B = 8                 # calls per all-shard request on the default
CFG5_ALL_REQUESTS = 2          # path, which its precheck must refuse
CFG5_WIDE_B = 64               # calls per wide all-shard request
CFG5_KEYS = [("metric", "standard"), ("seg", "standard")]
# the TopN's key list leaves its primary to fused_row_counts: metric
# occupies the budget but is never decoded
CFG5_FUSED_ONLY = [frozenset(CFG5_KEYS[:1])]
CFG5_WORKSPACE_MB = 256        # the decode workspace of leg compressed_ws


def cfg5_table(words) -> np.ndarray:
    """``int64[shard, a, b, m]``: bits of metric row m under seg rows a
    and b in each shard, counted from the oracle words once, so a
    TopN over any shard subset is a sum (bench.py ``oracle_topn5``)."""
    from pilosa_tpu_torch import cfg5
    n = len(words)
    tab = np.zeros((n, cfg5.SEG_ROWS, cfg5.SEG_ROWS, cfg5.METRIC_ROWS),
                   np.int64)
    for s in range(n):
        w = words[s]
        for a in range(cfg5.SEG_ROWS):
            for b in range(a + 1, cfg5.SEG_ROWS):
                mask = w[a] & w[b]
                for m in range(cfg5.METRIC_ROWS):
                    tab[s, a, b, m] = tab[s, b, a, m] = int(np.bitwise_count(
                        w[cfg5.SEG_ROWS + m] & mask).sum())
    return tab


def cfg5_rank(tab, shards, a: int, b: int, n: int = 5) -> list:
    counts = tab[shards, a, b].sum(axis=0)
    order = sorted(range(counts.size), key=lambda m: (-counts[m], m))
    return [(m, int(counts[m])) for m in order[:n] if counts[m] > 0]


def cfg5_check(label: str, tab, shards, pairs, got):
    """Every TopN of one request against the table oracle."""
    pairs_got = [[(p.id, p.count) for p in r] for r in got]
    for (a, b), g in zip(pairs, pairs_got):
        want = cfg5_rank(tab, shards, a, b)
        if g != want:
            raise AssertionError(f"cfg5 {label}: seg={a},{b} -> {g}, "
                                 f"oracle {want}")


def check_cfg5_shapes(holder, device, shard_slice, a: int = 0,
                      b: int = 2, phase: str = "cfg5_budget"
                      ) -> tuple[dict, dict]:
    """Both kernels at the shapes the first slice of the compressed
    schedule gives them: decode_block over the slice's packed seg stack (the
    filter's operand) and fused_row_counts over its packed metric stack
    under seg[a] & seg[b], on the stacks the stacked executor places,
    each against its plain version."""
    from pilosa_tpu_torch import cfg5
    from pilosa_tpu_torch.parallel.stacked import StackedExecutor
    st = StackedExecutor(device)
    groups = st._placed_groups(CFG5_KEYS, holder, cfg5.INDEX, shard_slice)
    dec, fus = _new_rec(), _new_rec()
    for shard_list, placed, sig in groups:
        measure_filtered(placed, sig, len(shard_list), dec, fus,
                         [(1, a), (1, b)], iters=10, plain_iters=2)
    say(phase, kernel_groups=len(groups),
        group_shards=[len(g[0]) for g in groups],
        decode_err=dec["err"], fused_err=fus["err"])
    st.close()
    return dec, fus


def run_cfg5_leg(holder, tab, device, label: str, compressed: bool,
                 budget_mb, workspace_mb=None):
    """One leg of ``bench_config5_compressed`` on the port: CFG5_NB
    requests of CFG5_B calls over the rotating hot / cold quarter
    subsets (bench.py:528-530), then all-shard requests on the default
    path — CFG5_ALL_REQUESTS of CFG5_ALL_B calls, which a multi-slice
    schedule must refuse as ``streamed-working-set`` and run on the
    grouped path slice by slice, and one of CFG5_WIDE_B calls — every
    answer equal to the oracle.  ``workspace_mb`` sets the decode
    workspace for the leg (default: left as it is).  Kernel launches
    are counted from just before the leg to just after it."""
    from pilosa_tpu_torch import cfg5
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import stacked as port_stacked
    from pilosa_tpu_torch.storage import fragment as port_fragment
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    n = len(tab)
    shards = list(range(n))
    ws0 = port_stacked.DECODE_WORKSPACE_BYTES
    if workspace_mb is not None:
        port_stacked.DECODE_WORKSPACE_BYTES = workspace_mb << 20
    port_fragment.COMPRESSED_RESIDENT = compressed
    # flush the previous leg's residency so this leg's gauges are its own
    DEFAULT_BUDGET.limit_bytes = 1
    DEFAULT_BUDGET.shrink_to_limit()
    DEFAULT_BUDGET.limit_bytes = None if budget_mb is None \
        else budget_mb << 20
    DEFAULT_BUDGET.reset_peak()
    b0 = DEFAULT_BUDGET.stats()
    rng = np.random.default_rng(SEED + 50)
    subsets = [list(map(int, x)) for x in np.array_split(np.arange(n), 4)]
    order = [subsets[0] if i % 2 == 0 else subsets[1 + (i // 2) % 3]
             for i in range(CFG5_NB)]
    ex = Executor(holder, device=device)
    log = FallbackLog()
    ex.logger = log
    kernels.reset_launches()

    def one(sub, B):
        pairs = cfg5.batch_pairs(rng, B)
        t0 = time.perf_counter()
        got = ex.execute(cfg5.INDEX, cfg5.batch_query(pairs), shards=sub)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cfg5_check(label, tab, shards if sub is None else sub, pairs, got)
        return dt

    t_leg = time.perf_counter()
    for sub in subsets:                    # warm: stage, capture
        one(sub, CFG5_B)
    lat = [one(sub, CFG5_B) for sub in order]
    sched = ex.stacked.shard_schedule(holder, cfg5.INDEX, [CFG5_KEYS],
                                      shards, CFG5_FUSED_ONLY)
    slices = [len(sl) for sl in sched.slices]
    del sched
    p0 = DEFAULT_BUDGET.stats()
    fb0 = dict(log.nodes)
    all_lat = [one(None, CFG5_ALL_B) for _ in range(CFG5_ALL_REQUESTS)]
    fb_all = {k: v - fb0.get(k, 0) for k, v in log.nodes.items()
              if v - fb0.get(k, 0)}
    wide_ms = one(None, CFG5_WIDE_B) * 1e3
    p1 = DEFAULT_BUDGET.stats()
    launches = dict(kernels.LAUNCHES)
    requests = len(subsets) + len(order) + CFG5_ALL_REQUESTS + 1
    snap = ex.wholequery.snapshot()
    rec = {"compressed": compressed, "budget_mb": budget_mb,
           "decode_workspace_mb": port_stacked.DECODE_WORKSPACE_BYTES >> 20,
           "slices_all_shards": slices,
           "prefetch_hits": p1["prefetchHits"] - p0["prefetchHits"],
           "prefetch_misses": p1["prefetchMisses"] - p0["prefetchMisses"],
           "pinned_bytes_end": p1["pinnedBytes"],
           "evictions": p1["evictions"] - b0["evictions"],
           "upload_mb": (p1["uploadBytes"] - b0["uploadBytes"]) / 2**20,
           "peak_resident_mb": p1["peakBytes"] / 2**20,
           "compressed_mb": p1["compressedBytes"] / 2**20,
           "calls_per_s": CFG5_B * len(lat) / sum(lat),
           "p50_ms": statistics.median(lat) * 1e3,
           "ms": [round(x * 1e3, 3) for x in lat],
           "all_shard_ms": [round(x * 1e3, 3) for x in all_lat],
           "wide_all_shard_ms": wide_ms,
           "fallbacks": dict(log.nodes),
           "fallbacks_all_shard": fb_all,
           "wq_fallbacks": ex.wq_fallbacks,
           "batcher_stream_fallbacks": ex.batcher.stream_fallbacks,
           "wq_requests": ex.wq_requests,
           "graphs_captured": snap["captures"], "replays": snap["replays"],
           "launches": launches,
           "launches_per_request": {k: v / requests
                                    for k, v in launches.items()},
           "requests": requests,
           "seconds": time.perf_counter() - t_leg}
    ex.close()
    port_stacked.DECODE_WORKSPACE_BYTES = ws0
    say("cfg5_budget", leg=label, **{k: (json.dumps(v) if isinstance(
        v, (dict, list)) else v) for k, v in rec.items()})
    if rec["pinned_bytes_end"]:
        raise AssertionError(f"cfg5 {label}: {rec['pinned_bytes_end']} "
                             f"pinned bytes outlived the leg")
    if budget_mb is not None and p1["peakBytes"] > budget_mb << 20:
        raise AssertionError(f"cfg5 {label}: peak {rec['peak_resident_mb']}"
                             f" MiB over the {budget_mb} MiB budget")
    streamed = fb_all.get("streamed-working-set", 0)
    if len(slices) > 1:
        if streamed != CFG5_ALL_REQUESTS:
            raise AssertionError(f"cfg5 {label}: {len(slices)} slices but "
                                 f"all-shard fallbacks {fb_all}")
        if rec["prefetch_hits"] + rec["prefetch_misses"] <= 0:
            raise AssertionError(f"cfg5 {label}: the all-shard requests "
                                 f"never streamed")
    elif streamed:
        raise AssertionError(f"cfg5 {label}: one slice but {streamed} "
                             f"streamed-working-set fallbacks")
    return rec


def cfg5_cuts(n: int, per_shard: int, ceiling: int) -> list:
    """Slice lengths of ``n`` shards of ``per_shard`` bytes each cut
    contiguously at ``ceiling`` bytes (shard_schedule's rule, one
    device)."""
    per = max(1, ceiling // per_shard)
    return [n] if n * per_shard <= ceiling else \
        [min(per, n - i) for i in range(0, n, per)]


def run_cfg5_budget(device, n_shards: int) -> tuple[dict, dict, dict]:
    """Phase cfg5_budget: the sparse config-5 corpus, the answer gate in
    both forms under the budget, the kernels at a compressed slice's
    shapes, and the resident / dense / compressed legs."""
    from pilosa_tpu_torch import cfg5
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel import stacked as port_stacked
    from pilosa_tpu_torch.storage import Holder
    from pilosa_tpu_torch.storage import fragment as port_fragment
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    rec = {}
    t0 = time.perf_counter()
    holder = Holder(None)
    words = cfg5.build_config5(holder, np.random.default_rng(SEED + 40),
                               n_shards=n_shards, sparse=True)
    rec["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab = cfg5_table(words)
    rec["oracle_s"] = time.perf_counter() - t0
    dense_mb = n_shards * 12 * SHARD_BYTES / 2**20
    say("cfg5_budget", shards=n_shards, columns=n_shards << 20,
        dense_working_set_mb=dense_mb, budget_mb=CFG5_BUDGET_MB,
        decode_workspace_mb=port_stacked.DECODE_WORKSPACE_BYTES >> 20,
        corpus_seconds=rec["corpus_s"], oracle_seconds=rec["oracle_s"])
    # the answer gate in both forms under the budget, before any timing
    q = "TopN(metric, Intersect(Row(seg=0), Row(seg=2)), n=5)"
    want = cfg5.oracle_topn5(words, range(n_shards), 0, 2)
    if cfg5_rank(tab, list(range(n_shards)), 0, 2) != want:
        raise AssertionError("the config-5 table oracle disagrees with "
                             "oracle_topn5")
    del words
    ex = Executor(holder, device=device)
    for form in (False, True):
        port_fragment.COMPRESSED_RESIDENT = form
        DEFAULT_BUDGET.limit_bytes = CFG5_BUDGET_MB << 20
        DEFAULT_BUDGET.shrink_to_limit()
        got = [(p.id, p.count) for p in ex.execute(cfg5.INDEX, q)[0]]
        if got != want:
            raise AssertionError(f"cfg5 gate (compressed={form}): {got} "
                                 f"!= {want}")
    ex.close()
    say("cfg5_budget", gate=json.dumps(want))
    # the kernels at the first compressed slice's shapes
    port_fragment.COMPRESSED_RESIDENT = True
    probe = Executor(holder, device=device)
    first = probe.stacked.shard_schedule(
        holder, cfg5.INDEX, [CFG5_KEYS], list(range(n_shards)),
        CFG5_FUSED_ONLY).slices[0]
    probe.close()
    dec, fus = check_cfg5_shapes(holder, device, first)
    for name, r in (("decode_block", dec), ("fused_row_counts", fus)):
        if r["err"]:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at the config-5 slice: {r['err']}")
    rec["kernel_slice_shards"] = len(first)
    rec["resident"] = run_cfg5_leg(holder, tab, device, "resident", False,
                                   None)
    rec["dense"] = run_cfg5_leg(holder, tab, device, "dense", False,
                                CFG5_BUDGET_MB)
    rec["compressed"] = run_cfg5_leg(holder, tab, device, "compressed",
                                     True, CFG5_BUDGET_MB)
    rec["compressed_ws"] = run_cfg5_leg(
        holder, tab, device, "compressed_ws", True, CFG5_BUDGET_MB,
        workspace_mb=CFG5_WORKSPACE_MB)
    # the reckoning: the dense form's 12 rows a shard against half the
    # budget; the compressed form's decoded seg stack (4 rows a shard)
    # against the decode workspace of each leg
    want = {"dense": cfg5_cuts(n_shards, 12 * SHARD_BYTES,
                               (CFG5_BUDGET_MB << 20) // 2),
            "compressed": cfg5_cuts(
                n_shards, 4 * SHARD_BYTES,
                port_stacked.DECODE_WORKSPACE_BYTES),
            "compressed_ws": cfg5_cuts(n_shards, 4 * SHARD_BYTES,
                                       CFG5_WORKSPACE_MB << 20)}
    for leg, cuts in want.items():
        if rec[leg]["slices_all_shards"] != cuts:
            raise AssertionError(f"cfg5 {leg}: slices "
                                 f"{rec[leg]['slices_all_shards']}, the "
                                 f"byte reckoning gives {cuts}")
    if len(want["compressed_ws"]) < 2:
        raise AssertionError("the decode workspace did not slice the "
                             "compressed config-5 set")
    for name, nl in rec["compressed"]["launches"].items():
        if nl <= 0:
            raise AssertionError(f"the compressed config-5 leg never "
                                 f"launched {name}")
    port_fragment.COMPRESSED_RESIDENT = True
    DEFAULT_BUDGET.limit_bytes = None
    del holder
    gc.collect()
    return rec, dec, fus


# -- phase 10: the cluster read plane, four port nodes on the one card ------

CLUSTER_NODES = 4
CLUSTER_B = 64                 # calls per request (bench.py)
CLUSTER_REQUESTS_1 = 4
CLUSTER_CLIENTS = 8
# Cut from config 5d's 256 shards: the bench's config5d leg runs the
# full 256 (python -m pilosa_tpu_torch.bench --leg config5d); here the
# phase checks the cluster plane (fan-out, balancer, resize), and at
# 256 its load alone took 91-150 s between calls.
CLUSTER_SHARDS = 128
CLUSTER_REQUESTS_8 = 2         # requests per client of the 8-client run


def cluster_request(port, index: str, pairs, tab, shards) -> float:
    """One request of ``len(pairs)`` Intersect + TopN calls to a node;
    every TopN must equal the oracle.  Returns its seconds."""
    from pilosa_tpu_torch import cfg5
    t1 = time.perf_counter()
    got = http(port, "POST", f"/index/{index}/query",
               cfg5.batch_query(pairs).encode())["results"]
    dt = time.perf_counter() - t1
    for (a, b), g in zip(pairs, got):
        have = [(x["id"], x["count"]) for x in g]
        want = cfg5_rank(tab, shards, a, b)
        if have != want:
            raise AssertionError(f"{index} seg={a},{b}: {have} != {want}")
    return dt


def wait_until(cond, what: str, timeout: float = 120.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)
    return time.perf_counter() - t0


def node_shards(srv, index: str) -> list:
    idx = srv.holder.index(index)
    v = idx.field("seg").view("standard") if idx is not None else None
    return sorted(v.fragments) if v is not None else []


def node_memory(servers, index: str) -> list:
    """Each node's device-side holdings: the process-wide budget's
    resident bytes (what its ``/debug/vars`` ``deviceBudget`` reports),
    its stacks and graphs held, its graph pool, and its shards."""
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    out = []
    for s in servers:
        ex = s.api.executor
        out.append({
            "node": s.cluster.node_id,
            "resident_mb": DEFAULT_BUDGET.stats()["residentBytes"] / 2**20,
            "stacks": len(ex.stacked._stack_cache),
            "graphs": ex.wholequery.snapshot()["graphs"],
            "pool_mb": (ex.wholequery.pool_reserved_bytes() or 0) / 2**20,
            "shards": len(node_shards(s, index))})
    return out


def run_cluster(device, n_shards: int) -> dict:
    """Phase cluster (``bench_config5_distributed`` on the port): four
    port servers in this process on localhost ports, sharing the card
    (the bench's ``Bench.nodes``); the dense config-5 corpus at
    ``n_shards`` loaded through node0's ``import-roaring`` (forwarded to
    owners, the bench's ``load_cfg5``); 64-call requests to node0 from 1
    and from 8 clients, every TopN equal to the oracle.  Then the same
    loaded nodes take the ``balancer`` leg and the ``resize`` leg
    (cluster_balancer_leg, cluster_resize_leg)."""
    from concurrent.futures import ThreadPoolExecutor
    from pilosa_tpu_torch import bench, cfg5
    rec = {}
    nodes = bench.Bench(torch.device(device), bench.FULL, SEED).nodes(
        CLUSTER_NODES, replica_n=1)
    with nodes as (servers, _):
        ports = [s.port for s in servers]
        p0 = ports[0]
        t0 = time.perf_counter()
        words = dict(cfg5.dist_words(np.random.default_rng(SEED + 60),
                                     n_shards))
        bench.load_cfg5(p0, "dist", words, CLUSTER_CLIENTS)
        rec["load_s"] = time.perf_counter() - t0
        tab = cfg5_table(words)
        del words
        say("cluster", nodes=CLUSTER_NODES, shards=n_shards,
            posts=2 * n_shards, load_seconds=rec["load_s"],
            node_shards=[len(s.holder.index("dist").available_shards())
                         for s in servers])
        shards = list(range(n_shards))
        rng = np.random.default_rng(SEED + 61)
        n_req = 2 * CLUSTER_NODES + CLUSTER_REQUESTS_1 + \
            CLUSTER_CLIENTS * CLUSTER_REQUESTS_8
        draws = iter([cfg5.batch_pairs(rng, CLUSTER_B)
                      for _ in range(n_req)])

        def one(port, pairs):
            return cluster_request(port, "dist", pairs, tab, shards)

        # warm every node twice: stage, then capture its graph
        t0 = time.perf_counter()
        for _ in range(2):
            for p in ports:
                one(p, next(draws))
        rec["warm_s"] = time.perf_counter() - t0
        gate = http(p0, "POST", "/index/dist/query",
                    b"TopN(metric, Intersect(Row(seg=1), Row(seg=3)),"
                    b" n=5)")["results"][0]
        if [(x["id"], x["count"]) for x in gate] != \
                cfg5_rank(tab, shards, 1, 3):
            raise AssertionError(f"cluster gate: {gate}")
        snap0 = http(p0, "GET", "/debug/vars")
        lat1 = [one(p0, next(draws))
                for _ in range(CLUSTER_REQUESTS_1)]
        batch8 = [next(draws)
                  for _ in range(CLUSTER_CLIENTS * CLUSTER_REQUESTS_8)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLUSTER_CLIENTS) as pool:
            lat8 = list(pool.map(lambda pr: one(p0, pr), batch8))
        wall8 = time.perf_counter() - t0
        snap1 = http(p0, "GET", "/debug/vars")
        coord = servers[0].cluster
        means = {}
        for name in ("peer_exec", "wire_overhead", "local_exec",
                     "reduce"):
            k = f"cluster.multi.{name}"
            a = snap0["timings"].get(k, {"count": 0, "sum": 0.0})
            b = snap1["timings"].get(k, {"count": 0, "sum": 0.0})
            dn = b["count"] - a["count"]
            means[name + "_ms"] = (b["sum"] - a["sum"]) / dn * 1e3 \
                if dn else None
        counts = snap1.get("counts", {})
        rec.update({
            "calls_per_s_1": CLUSTER_B * len(lat1) / sum(lat1),
            "p50_ms_1": statistics.median(lat1) * 1e3,
            "ms_1": [round(x * 1e3, 3) for x in lat1],
            "calls_per_s_8": CLUSTER_B * len(lat8) / wall8,
            "p50_ms_8": statistics.median(lat8) * 1e3,
            "wire": {n.id: coord.client.peer_wire_mode(n.host)
                     for n in coord.peers()},
            "coordinator_means": means,
            "hedges": counts.get("cluster.hedges", 0),
            "hedge_wins": counts.get("cluster.hedge_wins", 0),
            "retry_waves": counts.get("cluster.retry_waves", 0),
            "node_states": {n.id: n.state for n in coord.nodes},
            "nodes": [{
                "wq_requests": s.api.executor.wq_requests,
                "wq_fallbacks": s.api.executor.wq_fallbacks,
                "launches_single": s.api.executor.batcher
                .single_launches,
                "launches_fused": s.api.executor.batcher
                .fused_launches,
                **{k: s.api.executor.wholequery.snapshot()[k]
                   for k in ("captures", "replays", "eagerRuns")}}
                for s in servers],
            "pool_mb": [(s.api.executor.wholequery
                         .pool_reserved_bytes() or 0) / 2**20
                        for s in servers],
        })
        say("cluster", **{k: (json.dumps(v)
                              if isinstance(v, (dict, list)) else v)
                          for k, v in rec.items()})
        t0 = time.perf_counter()
        rec["balancer"] = cluster_balancer_leg(servers, tab, shards)
        say("cluster", leg="balancer",
            seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec["resize"] = cluster_resize_leg(servers, device, tab, shards,
                                           rec)
        say("cluster", leg="resize", seconds=time.perf_counter() - t0)
    if set(rec["wire"].values()) != {"bin1"}:
        raise AssertionError(f"cluster wire: {rec['wire']}")
    return rec


BALANCER_REQUESTS = 4          # 64-call requests after the handoff
RESIZE_REQUESTS = 4            # timed 64-call requests on five nodes


def cluster_balancer_leg(servers, tab, shards) -> dict:
    """Leg ``balancer`` of phase cluster: the coordinator's balancer on
    (routing policy ``loaded``), the load skewed onto one shard whose
    owner is remote (as tests/test_routing.py does), and ONE
    ``balancer.tick()``, which must hand the shard off: every node then
    holds the same overlay epoch and owner list, the overlay owner holds
    the copied fragments, the 64-call requests equal the oracle, and the
    overlay owner's executor ran requests on the card."""
    from pilosa_tpu_torch import cfg5
    coord = servers[0].cluster
    for s in servers:
        s.cluster.router.policy = "loaded"
    coord.balancer_on = True
    coord.balancer.threshold = 2.0
    tracker = coord.load_tracker
    tracker.rotate()
    tracker.rotate()
    hot = next(x for x in shards if coord.placement.primary("dist", x)
               != coord.node_id)
    primary = coord.placement.primary("dist", hot)
    for _ in range(40):
        tracker.note("dist", [hot], primary)
    for x in shards:
        tracker.note("dist", [x], coord.placement.primary("dist", x))
    owners0 = coord.shard_owner_nodes("dist", hot)
    t0 = time.perf_counter()
    handed = coord.balancer.tick()
    handoff_s = time.perf_counter() - t0
    owners1 = coord.shard_owner_nodes("dist", hot)
    if handed != 1 or len(owners1) != len(owners0) + 1:
        raise AssertionError(f"balancer: tick handed off {handed}, "
                             f"owners {owners0} -> {owners1}, "
                             f"{coord.balancer.snapshot()}")
    extra = owners1[-1]
    for s in servers:
        if (s.cluster.overlay_epoch != coord.overlay_epoch
                or s.cluster.shard_owner_nodes("dist", hot) != owners1):
            raise AssertionError(f"balancer: {s.cluster.node_id} holds "
                                 f"overlay epoch {s.cluster.overlay_epoch}")
    extra_srv = next(s for s in servers if s.cluster.node_id == extra)
    for field in ("seg", "metric"):
        frag = extra_srv.holder.fragment("dist", field, "standard", hot)
        if frag is None or frag.n_rows == 0:
            raise AssertionError(f"balancer: {extra} lacks {field}/{hot}")
    ex = extra_srv.api.executor
    runs0 = ex.wq_requests
    rng = np.random.default_rng(SEED + 62)
    lat = [cluster_request(servers[0].port, "dist",
                           cfg5.batch_pairs(rng, CLUSTER_B), tab, shards)
           for _ in range(BALANCER_REQUESTS)]
    runs = ex.wq_requests - runs0
    if runs <= 0:
        raise AssertionError(f"balancer: the overlay owner {extra} ran "
                             f"no request")
    served_by = sorted({n for e in tracker.snapshot(top=512)["hottest"]
                        if e["index"] == "dist" and e["shard"] == hot
                        for n in e["nodes"]})
    out = {"hot_shard": hot, "owners_before": owners0,
           "owners_after": owners1, "handoff_s": handoff_s,
           "overlay_epoch": coord.overlay_epoch,
           "overlay_owner_requests": runs,
           "hot_shard_served_by": served_by,
           "p50_ms": statistics.median(lat) * 1e3,
           "calls_per_s": CLUSTER_B * len(lat) / sum(lat)}
    say("cluster", leg="balancer", card=card_line(),
        **{k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
           for k, v in out.items()})
    return out


def cluster_resize_leg(servers, device, tab, shards, rec) -> dict:
    """Leg ``resize`` of phase cluster: a fifth port server on the card
    with the four's keys, ``POST /cluster/resize/add-node``, NORMAL on
    all five and the holder cleaner done; 64-call requests to node0 equal
    the oracle (warm twice so graphs are captured, then RESIZE_REQUESTS
    timed from 1 client); then ``remove-node`` of the fifth and the
    answers again.  One client reads from node0 throughout each resize;
    every read equals the oracle.  Each node's resident MB, stacks,
    graphs and pool MB before the resize and after the cleaner."""
    import threading
    from pilosa_tpu_torch import bench, cfg5
    from pilosa_tpu_torch.server.server import Config, Server
    p0 = servers[0].port
    hosts = list(servers[0].config.cluster_hosts)
    root = os.path.dirname(servers[0].config.data_dir)
    host5 = f"localhost:{bench.free_ports(1)[0]}"
    fetched = {"fragments": 0, "bytes": 0, "shards": set()}
    lock = threading.Lock()

    def count_fetches(client):
        orig = client.fragment_data

        def fetch(host, index, field, view, shard):
            blob = orig(host, index, field, view, shard)
            with lock:
                fetched["fragments"] += 1
                fetched["bytes"] += len(blob)
                fetched["shards"].add(shard)
            return blob

        client.fragment_data = fetch

    def resize(path: str, body: dict, label: str):
        """POST a resize while one client keeps reading from node0:
        every read taken during it must equal the oracle."""
        fetched.update(fragments=0, bytes=0, shards=set())
        stop = threading.Event()
        reads, errors = [], []
        read_rng = np.random.default_rng(SEED + 64)

        def reader():
            while not stop.is_set():
                try:
                    reads.append(cluster_request(
                        p0, "dist", cfg5.batch_pairs(read_rng, CLUSTER_B),
                        tab, shards))
                except Exception as e:
                    errors.append(e)
                    return

        t = threading.Thread(target=reader)
        t.start()
        try:
            t0 = time.perf_counter()
            http(p0, "POST", path, body)
            out[f"{label}_s"] = time.perf_counter() - t0
        finally:
            stop.set()
            t.join(timeout=900)
        if t.is_alive():
            raise AssertionError(f"resize {label}: the reader hung")
        if errors:
            raise AssertionError(f"resize {label}: a read during it "
                                 f"failed: {errors[0]!r}")
        out[f"{label}_reads_during"] = len(reads)
        out[f"{label}_read_p50_ms"] = statistics.median(reads) * 1e3 \
            if reads else None
        out[f"{label}_fetched_shards"] = len(fetched["shards"])
        out[f"{label}_fetched_fragments"] = fetched["fragments"]
        out[f"{label}_fetched_mib"] = fetched["bytes"] / 2**20

    rng = np.random.default_rng(SEED + 63)
    out = {"memory_before": node_memory(servers, "dist")}
    fifth = Server(Config(
        data_dir=f"{root}/node{CLUSTER_NODES}", bind=host5,
        device=str(device), node_id=f"node{CLUSTER_NODES}",
        cluster_hosts=hosts + [host5], replica_n=1,
        anti_entropy_interval=0, metric_poll_interval=0))
    try:
        fifth.open()
        five = servers + [fifth]
        for s in five:
            count_fetches(s.cluster.client)
        out["shards_before"] = {s.cluster.node_id: len(node_shards(s, "dist"))
                                for s in servers}
        resize("/cluster/resize/add-node",
               {"id": fifth.cluster.node_id, "host": host5}, "add")
        wait_until(lambda: all(s.cluster.state == "NORMAL"
                               and len(s.cluster.nodes) == 5
                               for s in five), "NORMAL on five nodes")

        def cleaned():
            return all(s.cluster.owns_shard(s.cluster.node_id, "dist", x)
                       for s in five for x in node_shards(s, "dist"))

        out["cleaner_wait_s"] = wait_until(cleaned, "the holder cleaner")
        out["shards_after"] = {s.cluster.node_id: len(node_shards(s, "dist"))
                               for s in five}
        if sum(out["shards_after"].values()) != len(shards) or \
                not out["shards_after"][fifth.cluster.node_id]:
            raise AssertionError(f"resize: shards {out['shards_after']}")
        for _ in range(2):
            cluster_request(p0, "dist", cfg5.batch_pairs(rng, CLUSTER_B),
                            tab, shards)
        out["memory_after_cleaner"] = node_memory(five, "dist")
        lat = [cluster_request(p0, "dist", cfg5.batch_pairs(rng, CLUSTER_B),
                               tab, shards)
               for _ in range(RESIZE_REQUESTS)]
        out["p50_ms_5"] = statistics.median(lat) * 1e3
        out["calls_per_s_5"] = CLUSTER_B * len(lat) / sum(lat)
        out["p50_ms_4"] = rec["p50_ms_1"]
        out["calls_per_s_4"] = rec["calls_per_s_1"]
        out["captures_5"] = [s.api.executor.wholequery.snapshot()["captures"]
                             for s in five]
        resize("/cluster/resize/remove-node",
               {"id": fifth.cluster.node_id}, "remove")
        wait_until(lambda: all(s.cluster.state == "NORMAL"
                               and len(s.cluster.nodes) == 4
                               for s in servers), "NORMAL on four nodes")
        out["shards_removed"] = {s.cluster.node_id:
                                 len(node_shards(s, "dist"))
                                 for s in servers}
        for _ in range(3):
            cluster_request(p0, "dist", cfg5.batch_pairs(rng, CLUSTER_B),
                            tab, shards)
        out["epoch"] = servers[0].cluster.epoch
    finally:
        fifth.close()
    say("cluster", leg="resize", card=card_line(),
        **{k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
           for k, v in out.items()})
    return out


# -- phase 11: replicas, anti-entropy with repair, on the one card ----------

REPLICA_NODES = 3
REPLICA_SHARDS = 64            # config 5's sparse corpus, cut from 954
REPLICA_BUDGET_MB = 512        # a device budget: compressed residency
REPLICA_B = 64                 # calls per request
REPLICA_LATENCY_S = 0.5        # the straggler's delay on its responses
REPLICA_HEDGE_MS = 50.0        # the coordinator's hedge delay meanwhile


def run_replicas(device, n_shards: int = REPLICA_SHARDS) -> dict:
    """Phase replicas: three port servers in this process, ``replica_n``
    2, compressed-resident under a device budget, over config 5's sparse
    corpus at ``n_shards``; node2 is dialed by its peers through a
    ``ChaosProxy`` (pilosa_tpu_torch/utils/netchaos.py).  Legs: load and
    warm (stage, then capture), every answer equal to the oracle; a
    latency on node2's responses, under which reads routed to it must
    hedge and still equal the oracle; then the replicas diverge (a
    fragment deleted on node1, a row's bits cleared in another fragment
    on node0), ``sync_holder`` on node1 repairs both, and each node's
    own executor over the shards it owns answers the oracle again, with
    both kernels launched and new graphs captured after the repair."""
    from pilosa_tpu_torch import bench, cfg5
    from pilosa_tpu_torch.ops import kernels
    index = cfg5.INDEX
    rec = {"shards": n_shards, "replica_n": 2,
           "budget_mb": REPLICA_BUDGET_MB}
    rng = np.random.default_rng(SEED + 70)
    nodes = bench.Bench(torch.device(device), bench.FULL, SEED).nodes(
        REPLICA_NODES, proxied=(2,), replica_n=2,
        device_budget_mb=REPLICA_BUDGET_MB, read_routing="round-robin")
    with nodes as (servers, proxies):
        proxy = proxies["node2"]
        p0 = servers[0].port
        t0 = time.perf_counter()
        words = dict(cfg5.sparse_words(rng, n_shards))
        bench.load_cfg5(p0, index, words, 8,
                        options={"trackExistence": False})
        rec["load_s"] = time.perf_counter() - t0
        tab = cfg5_table(words)
        shards = list(range(n_shards))
        del words
        pl = servers[0].cluster.placement

        def owned(s):
            return [x for x in shards if s.cluster.node_id
                    in s.cluster.shard_owner_nodes(index, x)]

        # warm: stage, then capture, on every node's share
        warm = [cfg5.batch_pairs(rng, REPLICA_B) for _ in range(2)]
        t0 = time.perf_counter()
        for pairs in warm + warm:
            cluster_request(p0, index, pairs, tab, shards)
        rec["warm_s"] = time.perf_counter() - t0
        forms = {s.holder.fragment(index, f, "standard", x)
                 .device_form() for s in servers for x in owned(s)
                 for f in ("seg", "metric")}
        rec["device_forms"] = sorted(forms)
        if forms != {"compressed"}:
            raise AssertionError(f"replicas: forms {forms}")

        # leg hedge: node2 straggles behind its proxy
        def counts():
            return http(p0, "GET", "/debug/vars").get("counts", {})

        coord = servers[0].cluster
        # round-robin routing rotates each shard among its READY
        # owners, so node2 takes reads of the shards node0 lacks
        strag = [x for x in shards if coord.node_id not in
                 coord.shard_owner_nodes(index, x)]
        if not strag:
            raise AssertionError("replicas: node0 owns every shard")
        rec["remote_only_shards"] = len(strag)
        c0 = counts()
        # a fixed hedge delay, far under the straggler's (as
        # tests/test_churn.py arms it)
        delay0 = coord.hedge_delay_ms
        coord.hedge_delay_ms = REPLICA_HEDGE_MS
        proxy.configure(f"down=latency:{REPLICA_LATENCY_S}")
        try:
            t0 = time.perf_counter()
            lat = [cluster_request(p0, index, pairs, tab, shards)
                   for pairs in warm]
            rec["hedge_leg_s"] = time.perf_counter() - t0
        finally:
            proxy.heal()
            coord.hedge_delay_ms = delay0
        c1 = counts()
        rec["hedges"] = c1.get("cluster.hedges", 0) - \
            c0.get("cluster.hedges", 0)
        rec["hedge_wins"] = c1.get("cluster.hedge_wins", 0) - \
            c0.get("cluster.hedge_wins", 0)
        rec["hedged_p50_ms"] = statistics.median(lat) * 1e3
        if rec["hedges"] <= 0:
            raise AssertionError("replicas: no read hedged off the "
                                 "straggling node2")

        # leg repair: diverge, sync on node1, check on the card
        # the divergence must show in the probe's answers: delete
        # the node1-primary seg fragment that feeds the probe most,
        # and clear the metric row of another shared fragment that
        # feeds a probe pair's top 5 most
        probe = cfg5.batch_pairs(rng, 8)
        victim = servers[1]
        feed = {x: sum(int(tab[x, a, b].sum()) for a, b in probe)
                for x in shards}
        d = max((x for x in shards if pl.primary(index, x) == "node1"),
                key=lambda x: (feed[x], -x))
        both = [x for x in shards if x != d
                and "node1" in pl.shard_nodes(index, x)]
        c0 = [x for x in both if "node0" in pl.shard_nodes(index, x)]
        peer_id = "node0" if c0 else next(
            n for n in pl.shard_nodes(index, both[0]) if n != "node1")
        peer = next(s for s in servers if s.cluster.node_id == peer_id)
        mine = owned(peer)
        weight, c, m = max(
            (int(tab[x, a, b, mm]), x, mm)
            for x in (c0 or both) if peer_id in pl.shard_nodes(index, x)
            for a, b in probe for mm, _ in cfg5_rank(tab, mine, a, b))
        if not feed[d] or not weight:
            raise AssertionError("replicas: the probe reads nothing of "
                                 "the diverged fragments")
        rec["diverged"] = {"deleted": ["node1", "seg", d],
                           "cleared": [peer_id, "metric", c, m]}
        del victim.holder.index(index).field("seg") \
            .view("standard").fragments[d]
        frag = peer.holder.fragment(index, "metric", "standard", c)
        cols = frag.row_columns(m)
        frag.bulk_import(np.full(cols.size, m, dtype=np.int64),
                         cols.astype(np.int64), clear=True)

        def own_check(s, expect_equal: bool):
            mine = owned(s)
            got = s.api.executor.execute(
                index, cfg5.batch_query(probe), shards=mine)
            same = all([(p.id, p.count) for p in g] ==
                       cfg5_rank(tab, mine, a, b)
                       for (a, b), g in zip(probe, got))
            if same != expect_equal:
                raise AssertionError(
                    f"replicas: {s.cluster.node_id} over its shards "
                    f"{'differs from' if expect_equal else 'equals'} "
                    f"the oracle")

        # the divergence is real: neither node serves a stale stack
        own_check(victim, False)
        own_check(peer, False)
        snap0 = http(victim.port, "GET", "/debug/vars")
        caps0 = sum(s.api.executor.wholequery.snapshot()["captures"]
                    for s in servers)
        t0 = time.perf_counter()
        victim.cluster.sync_holder()
        rec["repair_s"] = time.perf_counter() - t0
        snap1 = http(victim.port, "GET", "/debug/vars")
        ae = {k: snap1["counts"].get(f"antientropy.{k}", 0)
              - snap0["counts"].get(f"antientropy.{k}", 0)
              for k in ("blocks_compared", "blocks_merged", "errors",
                        "runs", "repairs")}
        ae["snapshot"] = snap1["storage"]["antiEntropy"]
        rec["antientropy"] = ae
        if ae["errors"] or not ae["blocks_merged"]:
            raise AssertionError(f"replicas: anti-entropy {ae}")
        if victim.holder.fragment(index, "seg", "standard", d) is None:
            raise AssertionError("replicas: the deleted fragment was "
                                 "not copied back")
        kernels.reset_launches()
        for pairs in warm + warm:
            cluster_request(p0, index, pairs, tab, shards)
        for s in servers:
            own_check(s, True)
        with kernels._launches_lock:
            rec["launches_after_repair"] = dict(kernels.LAUNCHES)
        caps1 = sum(s.api.executor.wholequery.snapshot()["captures"]
                    for s in servers)
        rec["captures_before_repair"] = caps0
        rec["captures_after_repair"] = caps1
        for name, n in rec["launches_after_repair"].items():
            if n <= 0:
                raise AssertionError(f"replicas: {name} did not launch "
                                     f"after the repair")
        if caps1 <= caps0:
            raise AssertionError("replicas: no graph was captured "
                                 "after the repair")
        dec, fus = check_cfg5_shapes(victim.holder, device,
                                     owned(victim), phase="replicas")
        for name, r in (("decode_block", dec),
                        ("fused_row_counts", fus)):
            if r["err"]:
                raise AssertionError(f"replicas: {name} differs from "
                                     f"its plain version: {r['err']}")
            b_ms, b_by = bound(r)
            rec[name] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": r["err"]}
        rec["kernel_recs"] = {"decode_block": dec,
                              "fused_row_counts": fus}
        rec["proxy"] = proxy.snapshot()
    say("replicas", card=card_line(),
        **{k: (json.dumps(v) if isinstance(v, (dict, list)) else v)
           for k, v in rec.items() if k != "kernel_recs"})
    return rec


# -- phase 12: parity (crash recovery, deadline gate, cache clear) --------

PARITY_INDEX = "parity"
PARITY_SHARDS = 32
PARITY_BUDGET_MB = 256         # a device budget: compressed residency
PARITY_MAX_OP_N = 12           # snapshot every ~12 ops of a fragment
PARITY_WRITE_ROWS = range(8, 14)   # f's rows the Set load writes
PARITY_MAX_WRITES = 250
# (field, rows, density of each row's bits in a shard): sparse enough
# that every fragment is compressed-resident under the budget (fewer
# than a quarter of its words nonzero); f's row 0 holds runs, its rows
# 8-13 start empty and take the Set load
PARITY_FIELDS = (("f", 8, 0.005), ("a", 4, 0.005), ("b", 8, 0.005))
# the two kill cycles: a kill-mode failpoint inside the WAL append (as
# tests/test_torch_crash.py arms it), then a manual SIGKILL
PARITY_SPECS = ("fragment.wal=kill:25", "")
# (x, y, rg, c) of ``parity_pql``: read requests of one signature (so
# the second is captured and the rest replay), each with its own row
# ids so that the result cache never answers one for another
PARITY_REQUESTS = ((2, 1, 1, 3), (1, 0, 2, 5), (8, 3, 1, 3), (0, 2, 3, 7),
                   (9, 1, 0, 1))


def parity_corpus(rng) -> dict:
    """``{field: {row: int64[columns]}}`` over PARITY_SHARDS shards, from
    the seed: sparse rows (array containers) and f's row 0 as runs of
    300 bits every 4096 columns (run containers)."""
    width = 1 << 20
    out = {}
    for name, rows, p in PARITY_FIELDS:
        out[name] = {}
        for r in range(rows):
            cols = []
            for shard in range(PARITY_SHARDS):
                if name == "f" and r == 0:
                    starts = np.arange(0, width, 4096) + rng.integers(
                        0, 3796, width // 4096)
                    c = (starts[:, None] + np.arange(300)).ravel()
                else:
                    n = int(rng.binomial(width, p))
                    c = np.unique(rng.integers(0, width, n))
                cols.append(c + shard * width)
            out[name][r] = np.sort(np.concatenate(cols)).astype(np.int64)
    for r in PARITY_WRITE_ROWS:
        out["f"][r] = np.zeros(0, dtype=np.int64)
    return out


def parity_bodies(corpus) -> list:
    """One pilosa-roaring body per (field, shard)."""
    from pilosa_tpu_torch.storage.roaring_io import pack_roaring
    width = 1 << 20
    out = []
    for name, rows in corpus.items():
        r_all = np.concatenate([np.full(c.size, r) for r, c in rows.items()])
        c_all = np.concatenate(list(rows.values()))
        shard_of = c_all // width
        for shard in range(PARITY_SHARDS):
            m = shard_of == shard
            out.append((name, shard,
                        pack_roaring(r_all[m], c_all[m] % width)))
    return out


def parity_pql(req) -> str:
    """A Count under a filter, the TopN of f under ``a[rg] & b[c]`` and
    an unfiltered Count."""
    x, y, rg, c = req
    return (f"Count(Intersect(Row(f={x}), Row(a={y}))) "
            f"TopN(f, Intersect(Row(a={rg}), Row(b={c})), n=5) "
            f"Count(Row(f=0))")


def parity_oracle(state, req) -> list:
    """The host's answers to ``parity_pql(req)`` from ``state``."""
    x, y, rg, c = req
    f = state["f"]
    filt = np.intersect1d(state["a"][rg], state["b"][c])
    counts = {r: np.intersect1d(cols, filt).size for r, cols in f.items()}
    top = sorted((r for r in counts if counts[r] > 0),
                 key=lambda r: (-counts[r], r))[:5]
    return [int(np.intersect1d(f[x], state["a"][y]).size),
            [{"id": r, "count": counts[r]} for r in top],
            int(f[0].size)]


def parity_writer(data_dir: str, spec: str, device, root: str):
    """``python3 -m pilosa_tpu_torch server --device ...`` over the data
    dir, compressed-resident under PARITY_BUDGET_MB, with ``spec`` armed
    (the server arms config failpoints before it opens the holder).
    Returns (process, port) once it serves."""
    import socket
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    cfg = os.path.join(root, "writer.toml")
    with open(cfg, "w") as f:
        f.write(f'data-dir = "{data_dir}"\n'
                f'bind = "localhost:{port}"\n'
                f"max-op-n = {PARITY_MAX_OP_N}\n"
                f"device-budget-mb = {PARITY_BUDGET_MB}\n"
                f'failpoints = "{spec}"\n'
                "warmup-top-n = 0\n"
                "repair-interval = 0\n"
                "[anti-entropy]\ninterval = 0\n")
    # the writer's log goes to a file: a pipe nobody reads could fill
    # and stall it mid-load
    log = os.path.join(root, "writer.log")
    with open(log, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server", "-c", cfg,
             "--device", str(device)],
            stdout=out, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while True:
        try:
            http(port, "GET", "/status", timeout=5)
            return proc, port
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                proc.wait(timeout=30)
                with open(log, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                raise AssertionError(
                    f"the parity writer did not come up: {tail}")
            time.sleep(0.2)


def parity_write_load(proc, port: int, rng, acked: dict, filt) -> dict:
    """Single-bit ``Set`` load until the writer dies at its failpoint;
    a writer that outlives a random write index (every one, with no
    failpoint armed) is SIGKILLed there.  Half the columns fall in the
    ``a[1] & b[3]`` filter, so the recovered writes move the TopN.
    Returns the cycle's record; ``acked`` gains the acknowledged writes
    and the record's ``maybe`` holds the one in flight, if any."""
    import http.client as httplib
    import signal
    width = PARITY_SHARDS << 20
    manual_at = int(rng.integers(20, PARITY_MAX_WRITES))
    used = set().union(*acked.values())
    maybe = None
    n_acked = 0
    t0 = time.perf_counter()
    for i in range(PARITY_MAX_WRITES):
        row = int(rng.choice(list(PARITY_WRITE_ROWS)))
        while True:
            col = int(filt[rng.integers(0, filt.size)]) if i % 2 \
                else int(rng.integers(0, width))
            if col not in used:
                break
        used.add(col)
        maybe = (row, col)
        try:
            http(port, "POST", f"/index/{PARITY_INDEX}/query",
                 f"Set({col}, f={row})".encode(), timeout=30)
        except (OSError, httplib.HTTPException):
            rc = proc.wait(timeout=30)
            if rc != -signal.SIGKILL:
                raise AssertionError(f"the parity writer died rc={rc} "
                                     f"under write load")
            break
        acked[row].add(col)
        n_acked += 1
        maybe = None
        if i >= manual_at:
            break
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    return {"writes_acked": n_acked, "maybe": maybe,
            "killed_by": "failpoint" if maybe is not None else "manual",
            "load_s": time.perf_counter() - t0}


def parity_replay_s(data_dir: str, root: str) -> tuple:
    """Seconds ``Holder.open()`` takes on a copy of the killed data dir
    (every snapshot loaded, every WAL frame replayed, the torn tail
    truncated), and the WAL bytes it found."""
    import shutil
    from pilosa_tpu_torch.storage import Holder
    copy = os.path.join(root, "replay-copy")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(data_dir, copy)
    wal = sum(os.path.getsize(os.path.join(d, fn))
              for d, _, fns in os.walk(copy) for fn in fns
              if fn.endswith(".wal"))
    t0 = time.perf_counter()
    h = Holder(copy)
    h.open()
    dt = time.perf_counter() - t0
    h.close()
    shutil.rmtree(copy)
    return dt, wal


def parity_restart(data_dir: str, device, label: str, state, acked,
                   maybe, budget_mb: int) -> tuple:
    """Restart on ``device`` over the killed data dir, in this process,
    and hold it to the durability contract: READY, ``storage.degraded``
    false, every acknowledged write present and at most the in-flight
    one extra; then the read requests on the default whole-query path
    (eager, captured, replayed) equal the host oracle.  Returns (the
    server, left open, its record, the in-flight write if it landed)."""
    from pilosa_tpu_torch.ops import kernels
    kernels.reset_launches()
    t0 = time.perf_counter()
    srv = start_server(data_dir, device, max_op_n=PARITY_MAX_OP_N,
                       device_budget_mb=budget_mb, warmup_top_n=0,
                       anti_entropy_interval=0, result_cache_mb=16)
    ready_s, seen = wait_ready(srv, t0)
    try:
        st = http(srv.port, "GET", "/status")
        if st["storage"]["degraded"] is not False:
            raise AssertionError(f"parity {label}: degraded after a "
                                 f"kill: {st['storage']}")
        landed = None
        for row in PARITY_WRITE_ROWS:
            [res] = http(srv.port, "POST", f"/index/{PARITY_INDEX}/query",
                         f"Row(f={row})".encode())["results"]
            got = set(res["columns"])
            lost = acked[row] - got
            extra = got - acked[row]
            if lost:
                raise AssertionError(f"parity {label}: row {row} lost "
                                     f"{len(lost)} acknowledged writes, "
                                     f"e.g. {sorted(lost)[:5]}")
            if extra and (maybe is None or extra != {maybe[1]}
                          or maybe[0] != row):
                raise AssertionError(f"parity {label}: row {row} holds "
                                     f"invented columns {sorted(extra)[:5]}")
            if extra:
                landed = maybe
        # the oracle's write rows: what was acknowledged, and the write
        # in flight if it landed
        for row in PARITY_WRITE_ROWS:
            cols = set(acked[row])
            if landed is not None and landed[0] == row:
                cols.add(landed[1])
            state["f"][row] = np.array(sorted(cols), dtype=np.int64)
        lat = []
        for req in PARITY_REQUESTS:
            t1 = time.perf_counter()
            got = http(srv.port, "POST", f"/index/{PARITY_INDEX}/query",
                       parity_pql(req).encode())["results"]
            lat.append((time.perf_counter() - t1) * 1e3)
            want = parity_oracle(state, req)
            if got != want:
                raise AssertionError(f"parity {label}: {parity_pql(req)} "
                                     f"-> {got}, oracle {want}")
        dv = http(srv.port, "GET", "/debug/vars")
        graphs = dv["device"]["graphs"]
        rec = {"ready_s": ready_s, "states": seen,
               "first_request_ms": lat[0], "request_ms": lat[1:],
               "budget_mb": budget_mb, "landed_in_flight": landed
               is not None, "wq_fallbacks": dv["wholeQuery"]["fallbacks"],
               "captures": graphs["captures"], "replays": graphs["replays"],
               "launches": dict(dv["device"]["kernelLaunches"])}
        if rec["wq_fallbacks"] or (torch.device(device).type == "cuda"
                                   and not rec["replays"]):
            raise AssertionError(f"parity {label}: whole-query {rec}")
        return srv, rec, landed
    except BaseException:
        srv.close()
        raise


def parity_kernels(srv) -> tuple:
    """Both kernels on the restarted server's own stacks for the TopN of
    ``PARITY_REQUESTS[0]``, against their plain versions; returns
    their records."""
    dec, fus = _new_rec(), _new_rec()
    _x, _y, rg, c = PARITY_REQUESTS[0]
    st = srv.api.executor.stacked
    keys = [("f", "standard"), ("a", "standard"), ("b", "standard")]
    groups = st._placed_groups(keys, srv.holder, PARITY_INDEX,
                               list(range(PARITY_SHARDS)))
    for shard_list, placed, sig in groups:
        measure_group(placed, sig, len(shard_list), dec, fus, rg, c)
    for name, k in (("decode_block", dec), ("fused_row_counts", fus)):
        if k["err"]:
            raise AssertionError(f"parity: {name} differs from its plain "
                                 f"version on the restarted server's "
                                 f"stacks: {k['err']}")
    return dec, fus


def parity_deadline(srv, state) -> dict:
    """``mesh.slice=delay:0.2@<index>`` armed: a whole-query request
    with ``?timeout=0.05`` answers 504 with ``query.deadline_abort``
    counted and no whole-query fallback; disarmed, the same request
    answers the oracle."""
    import urllib.error
    from pilosa_tpu_torch.utils.faults import FAULTS
    req = (3, 2, 2, 6)
    before = http(srv.port, "GET", "/debug/vars")
    FAULTS.configure(f"mesh.slice=delay:0.2@{PARITY_INDEX}")
    t0 = time.perf_counter()
    try:
        http(srv.port, "POST", f"/index/{PARITY_INDEX}/query?timeout=0.05",
             parity_pql(req).encode())
        code, body = 200, {}
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    finally:
        FAULTS.disarm()
    ms = (time.perf_counter() - t0) * 1e3
    after = http(srv.port, "GET", "/debug/vars")
    aborts = after["counts"].get("query.deadline_abort", 0) - \
        before["counts"].get("query.deadline_abort", 0)
    fallbacks = after["wholeQuery"]["fallbacks"] - \
        before["wholeQuery"]["fallbacks"]
    if code != 504 or aborts < 1 or fallbacks:
        raise AssertionError(f"parity deadline: {code} {body}, "
                             f"aborts {aborts}, fallbacks {fallbacks}")
    got = http(srv.port, "POST", f"/index/{PARITY_INDEX}/query",
               parity_pql(req).encode())["results"]
    if got != parity_oracle(state, req):
        raise AssertionError(f"parity deadline: disarmed answer {got}")
    return {"code": code, "ms": ms, "budget_s": body.get("budgetS"),
            "deadline_aborts": aborts, "wq_fallbacks": fallbacks}


def parity_cache_clear(srv, state) -> dict:
    """A repeated request hits the result cache; ``POST
    /internal/cache/clear`` reports the entries it dropped; the next
    request misses and equals the oracle."""
    req = PARITY_REQUESTS[-1]
    body = parity_pql(req).encode()
    hits0 = http(srv.port, "GET", "/debug/vars")["resultCache"]["hits"]
    got = http(srv.port, "POST", f"/index/{PARITY_INDEX}/query",
               body)["results"]
    rc = http(srv.port, "GET", "/debug/vars")["resultCache"]
    cleared = http(srv.port, "POST", "/internal/cache/clear", b"")
    got2 = http(srv.port, "POST", f"/index/{PARITY_INDEX}/query",
                body)["results"]
    rc2 = http(srv.port, "GET", "/debug/vars")["resultCache"]
    want = parity_oracle(state, req)
    if rc["hits"] != hits0 + 1 or cleared["resultEntries"] < 1 or \
            rc2["misses"] != rc["misses"] + 1 or got != want or \
            got2 != want:
        raise AssertionError(f"parity cache clear: hits {hits0} -> "
                             f"{rc['hits']}, cleared {cleared}, misses "
                             f"{rc['misses']} -> {rc2['misses']}")
    return {"cleared": cleared, "hits": rc["hits"],
            "misses_after": rc2["misses"]}


def run_parity(device, card: str) -> dict:
    """Phase parity: crash recovery of the served path on the card, the
    whole-query deadline gate and the cache-clear route.  The corpus is
    loaded through ``import-roaring``; then two kill cycles of a CLI
    server on ``device`` (a WAL-append failpoint, then a manual
    SIGKILL), each followed by a compressed-resident restart (both
    kernels must launch, and hold against their plain versions on the
    restarted server's stacks) and a dense-resident restart over the
    same data dir, each held to the durability contract and the oracle.
    The last compressed restart also takes the deadline and cache-clear
    legs."""
    import tempfile
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 90)
    state = parity_corpus(rng)
    filt = np.intersect1d(state["a"][1], state["b"][3])
    acked = {r: set() for r in PARITY_WRITE_ROWS}
    rec = {"shards": PARITY_SHARDS, "budget_mb": PARITY_BUDGET_MB,
           "card": card, "cycles": []}
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        srv = start_server(data_dir, device, max_op_n=PARITY_MAX_OP_N,
                           device_budget_mb=PARITY_BUDGET_MB,
                           anti_entropy_interval=0, warmup_top_n=0)
        try:
            t0 = time.perf_counter()
            http(srv.port, "POST", f"/index/{PARITY_INDEX}",
                 {"options": {"trackExistence": False}})
            for name, _rows, _p in PARITY_FIELDS:
                http(srv.port, "POST",
                     f"/index/{PARITY_INDEX}/field/{name}", {})
            for name, shard, body in parity_bodies(state):
                http(srv.port, "POST", f"/index/{PARITY_INDEX}/field/"
                     f"{name}/import-roaring/{shard}", body,
                     ctype="application/octet-stream")
            rec["load_s"] = time.perf_counter() - t0
        finally:
            srv.close()
        say("parity", leg="load", seconds=rec["load_s"],
            bodies=PARITY_SHARDS * len(PARITY_FIELDS), card=repr(card))
        for cycle, spec in enumerate(PARITY_SPECS):
            proc, port = parity_writer(data_dir, spec, device, root)
            try:
                cyc = parity_write_load(proc, port, rng, acked, filt)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=30)
            cyc["spec"] = spec
            cyc["replay_s"], cyc["wal_bytes"] = parity_replay_s(data_dir,
                                                                root)
            maybe = cyc.pop("maybe")
            for label, budget in (("compressed", PARITY_BUDGET_MB),
                                  ("dense", 0)):
                srv, r, landed = parity_restart(
                    data_dir, device, f"{label}{cycle}", state, acked,
                    maybe, budget)
                try:
                    if landed is not None:
                        acked[landed[0]].add(landed[1])
                        maybe = None
                    if label == "compressed":
                        if torch.device(device).type == "cuda":
                            for name, n in r["launches"].items():
                                if n <= 0:
                                    raise AssertionError(
                                        f"parity: the restarted compressed "
                                        f"server never launched {name}")
                        # both kernels at every restart; the last
                        # restart's records go to the kernels line
                        dec, fus = parity_kernels(srv)
                        if cycle == len(PARITY_SPECS) - 1:
                            rec["deadline"] = parity_deadline(srv, state)
                            rec["cache_clear"] = parity_cache_clear(
                                srv, state)
                finally:
                    srv.close()
                cyc[label] = r
                say("parity", cycle=cycle, run=label, spec=repr(spec),
                    killed_by=cyc["killed_by"], acked=cyc["writes_acked"],
                    replay_s=cyc["replay_s"], wal_bytes=cyc["wal_bytes"],
                    ready_s=r["ready_s"],
                    first_request_ms=r["first_request_ms"],
                    replays=r["replays"], launches=json.dumps(r["launches"]),
                    card=repr(card))
            rec["cycles"].append(cyc)
    say("parity", leg="kernels", **{
        f"{n}_{k}": r[k] for n, r in (("decode_block", dec),
                                      ("fused_row_counts", fus))
        for k in ("err", "ms", "plain_ms")}, card=repr(card))
    say("parity", leg="deadline", **rec["deadline"], card=repr(card))
    say("parity", leg="cache_clear", **rec["cache_clear"])
    rec["kernel_recs"] = {"decode_block": dec, "fused_row_counts": fus}
    rec["acked_total"] = sum(len(v) for v in acked.values())
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


# -- phase 13: the port's bench at its smoke size ---------------------------

# The smoke took 145.8-192.4 s on an H100 host; its SLO and
# observability timing windows were then lengthened (about 60 s more
# there), and a host 30% slower than most takes about 300 s.
BENCH_TIMEOUT_S = 420


def run_bench(device) -> dict:
    """``python -m pilosa_tpu_torch.bench --smoke --device cuda`` as a
    subprocess: it must exit 0 and report every leg, each leg's answers
    equal to its oracle, both container kernels launched in its
    compressed legs (config 5 sparse and SSB), and the cluster and
    robustness legs' gates: config 5d's answers, a hot shard served by
    more than one node, hedges under the straggler, the SLO page, the
    binary wire's sparse bytes under 1/1.5 of JSON's and the flood's
    sheds on the hostile tenant.  Returns its per-leg seconds, headline
    figures and those gates."""
    from pilosa_tpu_torch import bench
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.bench", "--smoke",
         "--device", str(device)], cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench --smoke exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    configs = out["configs"]
    want = [k for ks in bench.LEGS.values() for k in ks]
    missing = [k for k in want if k not in configs]
    if missing or out["corpus"]["gate"] != "pass":
        raise AssertionError(f"bench --smoke: legs missing {missing}, "
                             f"corpus gate {out['corpus']['gate']}")
    launches = {}
    for key in ("7_topn_1B_cols_sparse_compressed", "14_ssb_star_schema"):
        comp = configs[key]["compressed"]
        launches[key] = comp["kernel_launches_leg"]
        if comp["kernels_gate"] != "pass" or \
                min(launches[key].values()) <= 0:
            raise AssertionError(f"bench --smoke: {key} compressed "
                                 f"launched {launches[key]}")
    # the cluster and robustness legs' answer and behaviour gates
    c5d = configs["5d_intersect_topn_4node_cluster"]
    ten = configs["13_tenant_isolation"]["isolation_on"]
    gates = {
        "5d_answers": c5d["gate"] == "pass" and c5d["answers"] == "pass",
        "5d_captures_timed": c5d["captures_timed"],
        "routing_hot_shard_nodes":
            configs["10_elastic_routing"]["hot_shard_nodes"],
        "chaos_hedges": configs["11_tail_tolerance_chaos"]["hedges"],
        "chaos_timing": configs["11_tail_tolerance_chaos"]["timing_gates"],
        "slo_fired": configs["20_slo_alerting"]["alert"]["fired"],
        "slo_qps_ratio": configs["20_slo_alerting"]["qps_ratio"],
        "wire_sparse_bytes_ratio":
            configs["12_internal_wire"]["sparse_bytes_ratio"],
        "tenant_attribution": ten["shed_attribution"],
        "tenant_polite_sheds": ten["polite_sheds"]}
    if not (gates["5d_answers"] and gates["routing_hot_shard_nodes"] > 1
            and gates["chaos_hedges"] > 0 and gates["slo_fired"]
            and gates["wire_sparse_bytes_ratio"] > 1.5
            and (gates["tenant_attribution"] or 0) >= 0.95
            and gates["tenant_polite_sheds"] == 0):
        raise AssertionError(f"bench --smoke: cluster and robustness "
                             f"gates {gates}")
    rec = {"seconds": seconds, "legs_s": out["seconds"],
           "intersect8_calls_per_s": out["value"],
           "launches_compressed": launches, "gates": gates,
           "legs": sorted(configs)}
    say("bench", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                    for k, v in rec.items()})
    return rec


def main(argv) -> int:
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if "--rank" in argv:          # one rank of phase multiprocess
        return rank_main(argv)
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage import Holder
    from pilosa_tpu_torch.storage import fragment as port_fragment
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET

    device = torch.device("cuda", 0)
    card = card_line()
    say("card", name=torch.cuda.get_device_name(0), nvidia_smi=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = kernels.build()
    say("build", seconds=time.perf_counter() - t0, library=lib.name)
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "bytes smem" in line or "Compiling" in line:
            say("build", ptxas=line.strip())
    # the prepared cache's C fingerprint scanner (a host helper, built
    # with cc at first use) must build on the card's machine
    from pilosa_tpu_torch.executor.prepared import _fingerprint_py
    from pilosa_tpu_torch.native import fingerprint_native
    probe = "Count(Row(f=3)) TopN(g, Row(h=-12), n=5)"
    nat = fingerprint_native(probe)
    if nat is None or (nat[0], nat[1].tolist()) != _fingerprint_py(probe):
        raise AssertionError(f"the native fingerprint scanner did not "
                             f"build or disagrees: {nat}")
    say("build", native_fingerprint=nat[0])

    t0 = time.perf_counter()
    holder = Holder(None)
    hist = ssb.build_ssb(holder, np.random.default_rng(SEED),
                         n_shards=N_SHARDS)
    say("corpus", shards=N_SHARDS, columns=N_SHARDS << 20,
        fields=dict(ssb.SSB_FIELDS), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    check_boundary_packs(device)
    port_fragment.COMPRESSED_RESIDENT = True
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    dec, fus = check_ssb_shapes(holder, device)
    for name, rec in (("decode_block", dec), ("fused_row_counts", fus)):
        if rec["err"]:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at the SSB shapes: {rec['err']}")
    say("kernels", seconds=time.perf_counter() - t0)

    # dense-resident: no budget, so every fragment stays dense; each
    # residency through the default path (whole-query programs through
    # the batcher) and the grouped path
    t0 = time.perf_counter()
    DEFAULT_BUDGET.limit_bytes = None
    dense_ans, dense_rec = run_ssb(holder, hist, device, "dense", profile)
    dense_g_ans, dense_g_rec = run_ssb(holder, hist, device, "dense",
                                       whole_query=False)
    # compressed-resident: the 96 MB budget packs the sparse fragments
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    DEFAULT_BUDGET.shrink_to_limit()
    comp_ans, comp_rec = run_ssb(holder, hist, device, "compressed",
                                 profile)
    comp_g_ans, comp_g_rec = run_ssb(holder, hist, device, "compressed",
                                     whole_query=False)
    if not comp_ans == dense_ans == dense_g_ans == comp_g_ans:
        raise AssertionError("the SSB answers differ between residencies "
                             "or paths")
    for rec in (dense_rec, comp_rec):
        if rec["wq_fallbacks"] or not rec["replays"]:
            raise AssertionError(f"SSB whole-query: fallbacks "
                                 f"{rec['wq_fallbacks']}, replays "
                                 f"{rec['replays']}")
    for rec in (comp_rec, comp_g_rec):
        for name, n in rec["launches"].items():
            if n <= 0:
                raise AssertionError(f"the compressed SSB run never "
                                     f"launched {name}")
    for name, n in comp_rec["launches_replayed"].items():
        if n <= 0:
            raise AssertionError(f"no replayed whole-query graph of the "
                                 f"compressed SSB run launched {name}")
    say("ssb", seconds=time.perf_counter() - t0)

    # config 4: the BSI Sum / range / GroupBy path over 64 shards
    from pilosa_tpu_torch import bsi64
    t0 = time.perf_counter()
    DEFAULT_BUDGET.limit_bytes = None
    cfg4, oracle = cfg4_corpus(bsi64.N_SHARDS)
    say("bsi64", corpus_values=oracle[0].size, shards=bsi64.N_SHARDS,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    c4_dense_ans, c4_dense = run_cfg4(cfg4, oracle, device, "dense",
                                      bsi64.N_SHARDS, profile)
    # the grouped path over fewer 64-Sum requests: on the default path
    # they fall back to it anyway
    c4_dense_g_ans, c4_dense_g = run_cfg4(
        cfg4, oracle, device, "dense", bsi64.N_SHARDS, whole_query=False,
        n_requests=CFG4_REQUESTS_GROUPED)
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    DEFAULT_BUDGET.shrink_to_limit()
    bsi_dec = check_bsi_stack(cfg4, device, bsi64.N_SHARDS)
    if bsi_dec["err"]:
        raise AssertionError(f"decode_block differs from its plain "
                             f"version on bsig_v: {bsi_dec['err']}")
    c4_comp_ans, c4_comp = run_cfg4(cfg4, oracle, device, "compressed",
                                    bsi64.N_SHARDS, profile)
    c4_comp_g_ans, c4_comp_g = run_cfg4(
        cfg4, oracle, device, "compressed", bsi64.N_SHARDS,
        whole_query=False, n_requests=CFG4_REQUESTS_GROUPED)
    if c4_comp_ans != c4_dense_ans:
        raise AssertionError("config 4: dense and compressed answers "
                             "differ")
    k = CFG4_REQUESTS_GROUPED + 1      # the 64-Sum requests both ran
    for g_ans in (c4_dense_g_ans, c4_comp_g_ans):
        if g_ans[:k] != c4_dense_ans[:k] or g_ans[k] != c4_dense_ans[-2]:
            raise AssertionError("config 4: the default and grouped "
                                 "paths' answers differ")
    for rec in (c4_comp, c4_comp_g):
        for name, n in rec["launches_phase"].items():
            if n <= 0:
                raise AssertionError(f"the compressed config-4 run never "
                                     f"launched {name}")
    say("bsi64", seconds=time.perf_counter() - t0)

    # the multi-process engine: two ranks on the card, each with half of
    # the SSB and config-4 corpora
    t0 = time.perf_counter()
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    mp = run_multiprocess(device, card, hist, dense_ans, cfg4, oracle,
                          c4_dense_ans, bsi64.N_SHARDS)
    say("multiprocess", seconds=time.perf_counter() - t0, card=repr(card))

    # the served path: HTTP API, load, concurrent clients, ingest, CLI
    t0 = time.perf_counter()
    served, warm = run_served(holder, hist, device, profile=profile)
    say("served", seconds=time.perf_counter() - t0 - warm["seconds"])
    say("warm_start", seconds=warm["seconds"])
    del cfg4, holder
    gc.collect()

    # config 5 over 954 shards under the 768 MiB budget
    from pilosa_tpu_torch import cfg5
    t0 = time.perf_counter()
    c5, c5_dec, c5_fus = run_cfg5_budget(device, cfg5.N_SHARDS5)
    say("cfg5_budget", seconds=time.perf_counter() - t0)

    # config 5's cluster half: four port nodes on the one card
    t0 = time.perf_counter()
    clus = run_cluster(device, CLUSTER_SHARDS)
    say("cluster", seconds=time.perf_counter() - t0)

    # replicas: anti-entropy with repair over compressed fragments
    t0 = time.perf_counter()
    repl = run_replicas(device)
    say("replicas", seconds=time.perf_counter() - t0)
    repl_recs = repl.pop("kernel_recs")

    # parity: crash recovery on the card, the deadline gate, cache clear
    t0 = time.perf_counter()
    par = run_parity(device, card)
    say("parity", seconds=time.perf_counter() - t0)
    par_recs = par.pop("kernel_recs")

    # the port's bench at its smoke size: every leg, every gate
    bench_rec = run_bench(device)

    src = "pilosa_tpu_torch/csrc/container_kernels.cu"
    lines = []
    served_launches = served["compressed"]["launches_per_request"]
    warm_launches = warm["compressed"]["warm"]["launches_replayed"]
    # launches: the compressed default-path run (whole-query; a replay
    # counts the launches its graph recorded, of which "replayed"), and
    # the grouped run of the same requests
    for name, rec, replaces, shape, run, grouped, per_served in (
            ("decode_block", dec, f"{JAX_KERNELS}:245", "ssb_topn_filter",
             comp_rec, comp_g_rec["launches"],
             served_launches["decode_block"]),
            ("fused_row_counts", fus, f"{JAX_KERNELS}:326",
             "ssb_topn_filter", comp_rec, comp_g_rec["launches"],
             served_launches["fused_row_counts"]),
            ("decode_block", bsi_dec, f"{JAX_KERNELS}:245", "bsi64_bsig_v",
             c4_comp, c4_comp_g["launches_phase"], None),
            ("decode_block", c5_dec, f"{JAX_KERNELS}:245",
             "cfg5_compressed_slice", c5["compressed"], None, None),
            ("fused_row_counts", c5_fus, f"{JAX_KERNELS}:326",
             "cfg5_compressed_slice", c5["compressed"], None, None),
            ("decode_block", repl_recs["decode_block"],
             f"{JAX_KERNELS}:245", "replicas_repaired",
             {"launches": repl["launches_after_repair"]}, None, None),
            ("fused_row_counts", repl_recs["fused_row_counts"],
             f"{JAX_KERNELS}:326", "replicas_repaired",
             {"launches": repl["launches_after_repair"]}, None, None),
            # the compressed restart after the last kill cycle
            ("decode_block", par_recs["decode_block"],
             f"{JAX_KERNELS}:245", "parity_restart",
             {"launches": par["cycles"][-1]["compressed"]["launches"]},
             None, None),
            ("fused_row_counts", par_recs["fused_row_counts"],
             f"{JAX_KERNELS}:326", "parity_restart",
             {"launches": par["cycles"][-1]["compressed"]["launches"]},
             None, None)):
        b_ms, b_by = bound(rec)
        launches = run["launches" if "launches" in run
                       else "launches_phase"][name]
        lines.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "shape": shape,
                      "launches": launches,
                      "launches_replayed": run.get(
                          "launches_replayed", {}).get(name),
                      "launches_per_request": run.get(
                          "launches_per_request", {}).get(name),
                      "launches_grouped_run": None if grouped is None
                      else grouped[name],
                      "launches_per_served_request": per_served,
                      # the compressed warm restart's client requests:
                      # launches inside graphs the warm start captured
                      "launches_warm_restart": warm_launches.get(name)
                      if shape == "ssb_topn_filter" else None,
                      "max_abs_err": rec["err"], "ms": rec["ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    # phase multiprocess: each kernel at rank 0's half shapes; launches
    # are rank 0's main-path run, with every rank's beside them
    for name, key, corpus, shape in (
            ("decode_block", "decode_block", "ssb",
             "multiprocess_rank_ssb_topn_filter"),
            ("fused_row_counts", "fused_row_counts", "ssb",
             "multiprocess_rank_ssb_topn_filter"),
            ("decode_block", "decode_block_bsig_v", "bsi64",
             "multiprocess_rank_bsi64_bsig_v")):
        rec = mp["kernel_recs"][key]
        b_ms, b_by = bound(rec)
        lines.append({"name": name, "route": "cuda", "source": src,
                      "replaces": f"{JAX_KERNELS}:"
                                  f"{245 if name == 'decode_block' else 326}",
                      "shape": shape,
                      "launches": mp["ranks"][0][corpus]["launches"][name],
                      "launches_per_rank": [
                          r[corpus]["launches"][name] for r in mp["ranks"]],
                      "max_abs_err": rec["err"], "ms": rec["ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ssb": {"dense": dense_rec, "compressed": comp_rec,
                              "dense_grouped": dense_g_rec,
                              "compressed_grouped": comp_g_rec,
                              "budget_mb": BUDGET_MB},
                      "bsi64": {"dense": c4_dense, "compressed": c4_comp,
                                "dense_grouped": c4_dense_g,
                                "compressed_grouped": c4_comp_g,
                                "budget_mb": BUDGET_MB}}))
    print(json.dumps({"served": served}))
    print(json.dumps({"warm_start": warm}))
    print(json.dumps({"cfg5_budget": c5, "cluster": clus,
                      "replicas": repl}))
    print(json.dumps({"multiprocess": mp}))
    print(json.dumps({"parity": par}))
    print(json.dumps({"bench": bench_rec}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
