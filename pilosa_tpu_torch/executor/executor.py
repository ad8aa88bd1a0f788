"""Executor: recursive PQL call dispatch over shards (executor.go:44-339) —
the port of the JAX package's ``executor/executor.py`` for one device.

``Executor(holder, device=None, stacked=True)``: ``device`` None means
``cuda`` and raises when no card is present (pass ``device="cpu"`` to run
the plain PyTorch paths on the CPU — nothing switches to the CPU by
itself).  ``stacked=True`` (the JAX package's ``use_mesh=True``, which the
server and the SSB bench build) runs every aggregation over stacked shard
groups through parallel/stacked.py; ``stacked=False`` is the per-shard
branch (the JAX package's ``mesh is None``), evaluating each shard's
device mirrors in turn.

A read request goes through the JAX package's request stages
(``_execute_stages``): the result cache (cache/results.py; off while
``result_cache.limit_bytes`` is 0, as on a bare JAX executor) → the
prepared-statement cache (executor/prepared.py, on when ``stacked``) →
parse → translate → on the stacked branch, the whole-query program
(``_try_whole_query``: the whole read request lowered to reducer nodes
and run as ONE program through the dispatch batcher,
parallel/wholequery.py — one captured CUDA graph per signature on the
card), else, for a shape outside its fallback matrix, the grouped path
for a multi-call read-only request, else call by call → ONE
device-to-host fetch of every pending part → the cache fill.  The
grouped path batches same-shape Count / Sum / TopN calls into one
``[B, P]`` params matrix per group and runs each group in chunks through
the dispatch batcher's batched reducers (``_run_batched_groups``, which
the prepared cache falls back to too).

``whole_query`` (default True) and ``whole_query_fallback`` ("legacy"
reroutes an unsupported shape to the grouped path, counted in
``wq_fallbacks`` and logged as ``wholequery.fallback``; "error" raises)
and ``dispatch_batch``, ``dispatch_batch_max`` and
``dispatch_batch_window_us`` (parallel/batcher.py) take the JAX
package's defaults.  ``whole_query=False`` restores the grouped path
exactly.

Calls: Count, Sum, Min, Max (BSI), Row/Range (incl. BSI conditions),
Intersect, Union, Difference, Xor, Not, Shift, TopN (filtered and
unfiltered, incl. rank-cache answers), Rows, MinRow/MaxRow, GroupBy,
Options and the writes Set, Clear, ClearRow, Store, SetRowAttrs,
SetColumnAttrs.

Deviations from the JAX module:

* On one GPU a batched launch covers every shard of its shard slice
  (the JAX module's ``stacked_per_device(n)`` is ``n``).  A working set
  over the device budget runs slice-major over the shard schedule
  (``_run_batched_groups``, parallel/stacked.py ``shard_schedule``).
* Chunks of a batched group are not padded to a power of two: the
  padding only lets XLA reuse executables, and answers do not depend on
  it.  ``batch_chunk_size`` stays the one sizing rule, and a filter-less
  Sum / TopN group runs as one chunk.  (A captured whole-query graph's
  params are padded: graphs are fixed-shape.)
* Carried over from the JAX module's request stages: the ``ctx``
  deadline (installed as current, checked between per-call dispatches
  and before the one device-to-host fetch), the ``stats`` timers and
  counters, the degraded-answer guard of the cache fill, and the
  tracing span, profile stages and explain notes, and the warm-start
  corpus recorder (``warm_recorder``, warmup/corpus.py): fed the
  whole-query program signature of each launch and every successfully
  served read-only query text.
* Device launches are serialised by ``_device_lock``, the dispatch
  batcher's launch lock: one launch's temporaries at a time (eight
  unserialised dense SSB requests exhausted the 80 GB card), while a
  request waits for its ticket without the lock, so concurrent requests
  can fuse.  The per-shard branch (``stacked=False``, no batcher) runs
  its dispatch through the fetch under the same lock.

Multi-process mode (``Executor(holder, device=..., group=...)``,
parallel/multihost.py): the group goes to the stacked executor, whose
reducers stack this rank's shards and end in collectives.  Every rank
runs the same requests, so the request path may not branch on a rank's
own data: under a group there are no whole-query programs (a CUDA graph
cannot capture a gloo collective; the JAX module keeps multi-process
meshes out of its programs too), the batcher fuses nothing, the result
cache is off, unfiltered TopN skips the per-fragment rank caches, the
GroupBy row grid takes the ranks' largest row counts, and
``Rows(column=)`` gathers the ranks' row ids.  Requests run eagerly on
the grouped path.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any

import numpy as np
import torch

from ..core import SHARD_WIDTH, SHARD_WORDS, VIEW_STANDARD
from ..ops import bitset, bsi
from ..pql import Call, parse
from ..storage.field import FIELD_TYPE_INT, FIELD_TYPE_BOOL
from ..storage import time_quantum as tq
from .plan import PlanCompiler, Resolver, parametrize, plan_inputs
from .results import (
    FieldRow, GroupCount, Pair, RowIdentifiers, RowResult, ValCount,
    acc_counts, rank_counts,
)

BITMAP_CALLS = {"Row", "Range", "Intersect", "Union", "Difference", "Xor",
                "Not", "Shift"}
WRITE_CALLS = {"Set", "Clear", "ClearRow", "Store", "SetRowAttrs",
               "SetColumnAttrs"}


class ExecutionError(ValueError):
    pass


# TopN args that the batched/prepared fast paths cannot express — calls
# carrying any of them take the per-call path.
TOPN_EXTRAS = ("tanimotoThreshold", "attrName", "attrValues")


def topn_extras(c: Call):
    """(tanimotoThreshold, attrName, attrValues) with the reference's
    argument validation (executor.go:930-960)."""
    tan_thresh = c.args.get("tanimotoThreshold")
    attr_name = c.args.get("attrName")
    attr_values = c.args.get("attrValues")
    if attr_name is not None and attr_values is None:
        raise ExecutionError("TopN(attrName=...) requires attrValues")
    if attr_values is not None and attr_name is None:
        raise ExecutionError("TopN(attrValues=...) requires attrName")
    if tan_thresh is not None:
        if not isinstance(tan_thresh, int) or isinstance(tan_thresh, bool) \
                or not 0 < tan_thresh <= 100:
            raise ExecutionError(
                "tanimotoThreshold must be an integer in (0, 100]")
        if not c.children:
            raise ExecutionError("tanimotoThreshold requires a source row")
    return tan_thresh, attr_name, attr_values


class _Pending:
    """A dispatched-but-unresolved call result: ``parts`` are the call's
    unfetched device tensors, ``fin`` maps their host copies to the final
    result.  A request dispatches every call before the first fetch
    (``_resolve_pendings``)."""

    __slots__ = ("parts", "fin")

    def __init__(self, parts, fin):
        self.parts = list(parts)
        self.fin = fin


class _PendingGroup:
    """One pending filling MANY result slots: a batched call group's B
    results resolve with ONE vectorized ``fin`` instead of B per-call
    closures.  Place the same instance at every slot in ``call_idxs``;
    ``fin(hp)`` returns an indexable of per-slot values."""

    __slots__ = ("parts", "pos", "fin", "_vec")

    def __init__(self, parts, call_idxs, fin):
        self.parts = list(parts)
        self.pos = {i: b for b, i in enumerate(call_idxs)}
        self.fin = fin
        self._vec = None

    @classmethod
    def counts(cls, parts, call_idxs):
        """Group of B Counts: per-group [B] vectors summed in one numpy
        op (shared by the grouped executor and the prepared cache)."""
        nB = len(call_idxs)
        return cls(parts, call_idxs,
                   lambda hp: (np.sum(hp, axis=0).tolist()
                               if hp else [0] * nB))


# A batched group materializes roughly one [B, S, SHARD_WORDS] int32
# temporary per params slot over its stacked shards (a BSI predicate's 63
# magnitude-bit slots included), so a group is dispatched in chunks sized
# to keep those temporaries under BATCH_TEMP_BYTES.  Filtered row-count
# (TopN) groups additionally materialize one [B, S, rows, W] masked
# temporary over a dense field: callers pass that rows axis as
# ``row_weight`` so the budget sees the real per-row footprint.
BATCH_TEMP_BYTES = 4 << 30
BATCH_CHUNK_MIN, BATCH_CHUNK_MAX = 8, 32768


def batch_chunk_size(P: int, n_shards: int, row_weight: int = 0) -> int:
    """Pow-2 batch-axis chunk size under the batch-temp workspace — THE
    sizing formula of the batched groups."""
    weight = max(1, P, row_weight) * n_shards * SHARD_WORDS * 4
    chunk = max(BATCH_CHUNK_MIN,
                min(BATCH_CHUNK_MAX, BATCH_TEMP_BYTES // weight))
    return 1 << (chunk.bit_length() - 1)


def _batch_chunks(params_mat: np.ndarray, n_shards: int,
                  row_weight: int = 0):
    """Yield (lo, n, params) covering params_mat[lo:lo+n].  ``n_shards``
    is the stacked-shard count a launch covers; ``n_shards <= 0`` marks a
    filter-less group whose device pass is a B-independent broadcast: it
    dispatches as ONE chunk whatever B (splitting would repeat the full
    fragment pass per chunk).  ``row_weight``: the rows axis of a
    [B, S, rows, W] masked temporary (filtered TopN), 0 for the others.
    Unlike the JAX module, chunks are not padded to a power of two."""
    B, P = params_mat.shape
    chunk = max(1, B) if n_shards <= 0 else \
        batch_chunk_size(P, n_shards, row_weight)
    for lo in range(0, B, chunk):
        sub = params_mat[lo: lo + chunk]
        yield lo, sub.shape[0], sub


def _group_key_list(stacked, kind, slotted, extra):
    """The exact (field, view) key list the stacked dispatch for this
    group will stack (``stacked.batch_keys`` is the single definition),
    so the shard schedule's prefetch stages the stacks the dispatch will
    actually read."""
    if kind == "count":
        return plan_inputs(slotted)
    return stacked.batch_keys((extra["field"], extra["view"]), slotted)


def _run_batched_groups(batcher, holder, index, shards, groups, results):
    """Dispatch batched call groups chunk-wise and fill ``results``.

    ``groups``: iterable of (kind, slotted, params_mat, call_idxs, extra);
    extra carries kind-specific fields — sum: field/view/base, topn:
    field/view/ids_n with one (ids, n) pair per call.  Shared by the
    grouped path and the prepared-statement cache so the chunking policy
    lives in exactly one place.  Every chunk of every group is dispatched
    before any result is fetched.  On a single-slice schedule each chunk
    rides the cross-query batcher as one ticket, so concurrent requests
    replaying the same prepared template fuse into one launch.

    Dispatch order is SLICE-MAJOR over one residency-aware shard schedule
    covering the whole batch (parallel/stacked.py ``shard_schedule``):
    every group's every chunk runs against a shard slice before the
    budget rotates to the next slice, with the next slice prefetching
    while the current one computes.  When the working set fits the
    budget the schedule is one slice and this is the unsliced
    dispatch."""
    from ..parallel.stacked import field_rows
    groups = list(groups)
    if not groups:
        return
    stacked = batcher.stacked

    key_lists: list = []
    fused_only: list = []
    for kind, slotted, _pm, _ci, extra in groups:
        kl = _group_key_list(stacked, kind, slotted, extra)
        fo = stacked.fused_only((extra["field"], extra["view"]), slotted) \
            if kind == "topn" else frozenset()
        if kl not in key_lists:
            key_lists.append(kl)
            fused_only.append(fo)
        else:
            # a block two groups share is decoded if either decodes it
            i = key_lists.index(kl)
            fused_only[i] = fused_only[i] & fo
    sched = stacked.shard_schedule(holder, index, key_lists, shards,
                                   fused_only)
    # the chunk layout must be identical across slices so per-chunk parts
    # can accumulate; size it by the largest slice
    per_dev = stacked.stacked_per_device(sched.max_slice_len)
    # a multi-slice schedule keeps the direct slice-major dispatch:
    # batching a streamed working set would re-stage it whole
    fuse = len(sched.slices) == 1

    def _n_split(kind, slotted):
        # count plans always gather per-row temps; sum/topn without a
        # filter broadcast one pass — single chunk (see _batch_chunks)
        return per_dev if (kind == "count" or slotted is not None) else 0

    def _row_weight(kind, slotted, extra):
        if kind != "topn" or slotted is None:
            return 0
        return field_rows(holder, index, extra["field"], extra["view"])

    group_chunks = [
        list(_batch_chunks(params_mat, _n_split(kind, slotted),
                           _row_weight(kind, slotted, extra)))
        for kind, slotted, params_mat, _ci, extra in groups]
    # the batch axis split to honor the workspace: visible, not silent
    n_splits = sum(len(ch) - 1 for ch in group_chunks if len(ch) > 1)
    if n_splits:
        batcher.stats.count("query.batch_temp_splits", n_splits)

    parts_acc: dict[tuple[int, int], list] = {}
    for shard_slice in sched:
        for gi, (kind, slotted, _pm, _ci, extra) in enumerate(groups):
            for lo, _n, sub in group_chunks[gi]:
                stacked.batch_chunks += 1
                if kind == "count":
                    parts = batcher.count_batch(
                        slotted, sub, holder, index, shard_slice,
                        fuse=fuse)
                elif kind == "sum":
                    parts = batcher.bsi_sum_batch(
                        extra["field"], extra["view"], slotted, sub,
                        holder, index, shard_slice, fuse=fuse)
                else:  # topn
                    parts = batcher.row_counts_batch(
                        extra["field"], extra["view"], slotted, sub,
                        holder, index, shard_slice, fuse=fuse)
                parts_acc.setdefault((gi, lo), []).extend(parts)

    # every part dispatched; the finalizers sum / merge the per-slice
    # parts as they merge per-signature-group parts (every reduction
    # here is additive over shards)
    for gi, (kind, slotted, params_mat, call_idxs, extra) \
            in enumerate(groups):
        for lo, n_c, _sub in group_chunks[gi]:
            parts = parts_acc.get((gi, lo), [])
            if kind == "count":
                grp = _PendingGroup.counts(parts, call_idxs[lo: lo + n_c])
                for i in call_idxs[lo: lo + n_c]:
                    results[i] = grp
            elif kind == "sum":
                for b in range(n_c):
                    results[call_idxs[lo + b]] = _Pending(
                        parts, lambda hp, b=b, base=extra["base"]:
                        _sum_fin(hp, b, base))
            else:  # topn
                for b in range(n_c):
                    ids, n = extra["ids_n"][lo + b]
                    results[call_idxs[lo + b]] = _Pending(
                        parts, lambda hp, b=b, ids=ids, n=n:
                        rank_counts(stacked.merge_counts(
                            [p[b] for p in hp]), n or None, ids))


def _sum_fin(hp, b, base):
    """ValCount of batch row ``b`` from a Sum group's fetched parts."""
    total, cnt = 0, 0
    for p in hp:
        s, c_ = bsi.weighted_sum(p[b])
        total += s
        cnt += c_
    return ValCount(total + cnt * base, cnt)


# -- whole-query host finalizers ---------------------------------------------
# Applied to the fetched device parts of one whole-query launch; each
# mirrors the corresponding grouped-path reduction byte-for-byte.

def _wq_sum_fin(hp, b, base):
    total, cnt = 0, 0
    for p in hp:
        s, c_ = bsi.weighted_sum(np.asarray(p[b]))
        total += s
        cnt += c_
    return ValCount(total + cnt * base, cnt)


def _wq_topn_rank(stacked, hp, b, ids, n):
    counts = stacked.merge_counts([p[b] for p in hp])
    return rank_counts(counts, n or None, ids)


def _wq_seg_result(hp, b, groups, empty, attrs):
    segs: dict[int, np.ndarray] = {}
    zero = np.zeros(SHARD_WORDS, dtype=np.uint32)
    for shard_list, arr in zip(groups, hp):
        for i, shard in enumerate(shard_list):
            segs[shard] = arr[i, b].astype(np.uint32)
    for shard in empty:
        segs[shard] = zero
    return RowResult(segs, attrs=attrs)


def _wq_minmax_fin(hp, groups, base, want_max):
    acc = ValCount()
    j = 0
    for shard_list in groups:
        bits, neg, cnt = hp[j], hp[j + 1], hp[j + 2]
        j += 3
        for i in range(len(shard_list)):
            val, c = bsi.reconstruct_min_max(
                np.asarray(bits[i]), int(neg[i]), int(cnt[i]))
            vc = ValCount(val + base if c else 0, c)
            acc = acc.larger(vc) if want_max else acc.smaller(vc)
    return acc


def _wq_minrow_fin(hp, want_max):
    counts = np.asarray(hp[0][0], dtype=np.int64) if hp \
        else np.zeros(0, dtype=np.int64)
    nz = np.nonzero(counts)[0]
    if nz.size == 0:
        return ValCount(0, 0)
    rid = int(nz[-1] if want_max else nz[0])
    return ValCount(rid, int(counts[rid]))


def _wq_rows_fin(hp, limit, previous):
    row_ids: set[int] = set()
    for p in hp:
        row_ids.update(int(i) for i in np.nonzero(np.asarray(p[0]))[0])
    out = sorted(row_ids)
    if previous is not None:
        out = [r for r in out if r > previous]
    if limit is not None:
        out = out[:limit]
    return RowIdentifiers(rows=out)


def _wq_groupby_fin(hp, combos, last_ids, last_field, prev_ids, limit):
    acc = None
    for p in hp:
        a = np.asarray(p, dtype=np.int64)
        acc = a.copy() if acc is None else acc_counts(acc, a)
    out: list[GroupCount] = []
    for ci, combo in enumerate(combos):
        for rid in last_ids:
            cnt = (int(acc[ci, rid]) if acc is not None
                   and rid < acc.shape[1] else 0)
            if cnt > 0:
                group = [FieldRow(fn, ri) for fn, ri in combo]
                group.append(FieldRow(last_field, rid))
                out.append(GroupCount(group, cnt))
    out.sort(key=lambda g: tuple(
        (fr.field, fr.row_id) for fr in g.group))
    if prev_ids is not None:
        out = [g for g in out
               if tuple(fr.row_id for fr in g.group) > prev_ids]
    if limit is not None:
        out = out[:limit]
    return out


def _host(t) -> np.ndarray:
    return t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _fetch(parts) -> list[np.ndarray]:
    """Host copies of device tensors (int64 counts of any shape) in ONE
    device-to-host transfer: flattened, concatenated, copied, split."""
    if not parts:
        return []
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    host = flat.cpu().numpy()
    out, at = [], 0
    for p in parts:
        n = p.numel()
        out.append(host[at: at + n].reshape(tuple(p.shape)))
        at += n
    return out


def _resolve_pendings(results):
    """Resolve all pending results with a single device->host fetch.
    Parts shared between pendings (batched call groups) fetch once."""
    unique: dict[int, Any] = {}
    for r in results:
        if isinstance(r, (_Pending, _PendingGroup)):
            for p in r.parts:
                unique.setdefault(id(p), p)
    tensors = {k: p for k, p in unique.items()
               if isinstance(p, torch.Tensor)}
    host = dict(zip(tensors, _fetch(list(tensors.values()))))
    for k, p in unique.items():
        if k not in host:
            host[k] = np.asarray(p)
    out = []
    for i, r in enumerate(results):
        if isinstance(r, _Pending):
            out.append(r.fin([host[id(p)] for p in r.parts]))
        elif isinstance(r, _PendingGroup):
            if r._vec is None:
                r._vec = r.fin([host[id(p)] for p in r.parts])
            out.append(r._vec[r.pos[i]])
        else:
            out.append(r)
    return out


def resolve_device(device) -> torch.device:
    """The executor's device: ``None`` means ``cuda``; a CUDA device must
    exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the "
            "plain PyTorch paths on the CPU")
    return device


class Executor:
    # GroupBy row-id grid bounds (see _group_by_grid)
    GROUP_GRID_MAX = 1 << 20
    GROUP_GRID_PREFIX_MAX = 16384

    def __init__(self, holder, device=None, stacked: bool = True,
                 stats=None, dispatch_batch: bool = True,
                 dispatch_batch_max: int = 32,
                 dispatch_batch_window_us: float = 200.0,
                 whole_query: bool = True,
                 whole_query_fallback: str = "legacy", group=None):
        """``stats``: a StatsClient for per-phase timings
        (parse/translate/dispatch/fetch) and cache counters, surfaced at
        /debug/vars; None records nothing.  ``dispatch_batch*``: the
        cross-query dispatch batcher (parallel/batcher.py) — with it off
        the batcher still fronts every stacked dispatch but calls
        directly.  ``whole_query``: run each read request as ONE program
        (parallel/wholequery.py); off restores the grouped per-stage
        path exactly.  ``whole_query_fallback``: "legacy" reroutes
        unsupported shapes to the grouped path (counted + logged);
        "error" raises instead.  ``group``: a ``torch.distributed``
        process group this executor is one rank of (multi-process mode,
        module docstring); needs ``stacked``."""
        if group is not None and not stacked:
            raise ValueError("a process group needs stacked=True")
        self.holder = holder
        self.device = resolve_device(device)
        self.compiler = PlanCompiler(self.device)
        from ..utils.stats import NopStatsClient
        self.stats = stats if stats is not None else NopStatsClient()
        from .translator import Translator
        self.translator = Translator(holder)
        # Generation-keyed result cache (cache/results.py), disabled
        # (limit 0) until the caller sets ``result_cache.limit_bytes``.
        from ..cache.results import ResultCache
        self.result_cache = ResultCache(stats=self.stats)
        self.batcher = None
        self.wholequery = None
        self.stacked = None
        self.prepared = None
        self.whole_query = bool(whole_query)
        self.whole_query_fallback = whole_query_fallback
        # The Server injects its Logger so wholequery.fallback events land
        # in the server log; None (bare executors) stays silent.
        self.logger = None
        # Warm-start corpus recorder (warmup/corpus.py), injected by the
        # Server; None (bare executors) records nothing.
        self.warm_recorder = None
        self.wq_requests = 0
        self.wq_fallbacks = 0
        self.wq_last_fallback = ""
        from ..utils.locks import make_rlock
        self._device_lock = make_rlock("executor-device")
        if stacked:
            from ..parallel.batcher import DispatchBatcher
            from ..parallel.stacked import StackedExecutor
            from ..parallel.wholequery import WholeQueryRunner
            from .prepared import PreparedCache
            self.stacked = StackedExecutor(self.device, group=group)
            self.batcher = DispatchBatcher(
                self.stacked, enabled=dispatch_batch,
                max_batch=dispatch_batch_max,
                window_us=dispatch_batch_window_us, stats=self.stats,
                launch_lock=self._device_lock)
            self.prepared = PreparedCache(self)
            # a process group keeps whole-query programs out of the path
            # (module docstring), as the JAX executor does
            if not self.stacked.multiprocess:
                self.wholequery = WholeQueryRunner(self.stacked)

    @property
    def multiprocess(self) -> bool:
        """Whether this executor is one rank of a process group."""
        return self.stacked is not None and self.stacked.multiprocess

    def close(self):
        if self.batcher is not None:
            self.batcher.close()
        if self.stacked is not None:
            self.stacked.close()

    # -- entry point (executor.go:113 Execute) -----------------------------

    def execute(self, index_name: str, query, shards=None,
                translate: bool = True, ctx=None) -> list[Any]:
        """Run a PQL request (text or parsed) and return one result per
        call.  ``translate=False`` skips key translation (already
        translated requests, executor.go:147).

        ``ctx``: optional QueryContext (utils/deadline.py).  Defaults to
        the caller's active context; installed as current for the whole
        execution, and checked here between per-call dispatches and
        before the blocking fetch."""
        from ..utils.deadline import activate, check_current, current
        if ctx is None:
            ctx = current()
        with activate(ctx):
            return self._execute_ctx(index_name, query, shards, translate,
                                     check_current)

    def _execute_ctx(self, index_name: str, query, shards, translate,
                     check_current) -> list[Any]:
        from ..utils import profile as qprof
        from ..utils.tracing import GLOBAL_TRACER
        check_current("execute")
        with GLOBAL_TRACER.span("executor.execute") as espan:
            espan.set_tag("index", index_name)
            return self._execute_stages(index_name, query, shards,
                                        translate, check_current, qprof)

    def _execute_stages(self, index_name: str, query, shards, translate,
                        check_current, qprof) -> list[Any]:
        from ..utils import degraded
        from ..utils import explain as qexplain
        from ..utils import tenant as qtenant
        stats = self.stats
        # the warm-start corpus records by query text, the only identity
        # a restarted process can replay
        qtext = query if isinstance(query, str) else None
        # Result-cache lookup first (before the parse): the key holds the
        # query text (an AST keys on its repr), the shard set and the
        # index's fragment generation vector, so any mutation misses.
        qkey = ckey = None
        cache = self.result_cache
        # under a process group a hit on one rank and a miss on another
        # would wedge the collectives: no result cache there
        if cache.limit_bytes > 0 and not self.multiprocess:
            idx0 = self.holder.index(index_name)
            if idx0 is not None:
                if shards is None:
                    shards = sorted(idx0.available_shards())
                from ..cache.results import gen_vector
                from ..core import attr_epoch, schema_epoch
                from ..utils.tracing import GLOBAL_TRACER
                qrepr = query if isinstance(query, str) else repr(query)
                qkey = ("local", index_name, qrepr, tuple(shards),
                        bool(translate))
                ckey = qkey + (gen_vector(self.holder, index_name,
                                          set(shards)),
                               schema_epoch(), attr_epoch())
                with GLOBAL_TRACER.span("resultcache.lookup") as span, \
                        qprof.stage("resultcache.lookup") as pnode:
                    out = cache.lookup(ckey)
                    outcome = "hit" if out is not None else "miss"
                    span.set_tag("outcome", outcome)
                    if pnode is not None:
                        pnode.tags["outcome"] = outcome
                qexplain.note("caches", {
                    "cache": "result", "scope": "local",
                    "outcome": outcome,
                    "key": {"index": index_name, "shards": len(shards),
                            "genVector": hash(ckey[5]) & 0xFFFFFFFF,
                            "schemaEpoch": ckey[6],
                            "attrEpoch": ckey[7]}})
                if out is not None:
                    # result-cache entries exist only for read-only
                    # queries (the fill sites gate on it)
                    self._warm_note(index_name, qtext)
                    return out
        if isinstance(query, str):
            if translate and self.prepared is not None:
                with stats.timer("query.prepared"), \
                        qprof.stage("prepared") as pnode:
                    hit, out = self.prepared.attempt(index_name, query,
                                                     shards)
                    if pnode is not None:
                        pnode.tags["outcome"] = "hit" if hit else "miss"
                if hit:
                    stats.count("query.prepared.hit")
                    qexplain.note("plan", {"mode": "prepared",
                                           "shards": len(shards or ())})
                    if ckey is not None and not degraded.is_degraded():
                        # prepared entries exist only for Count/Sum/TopN
                        # templates — read-only by construction; a
                        # quarantined-degraded answer stays uncached
                        cache.fill(qkey, ckey, out,
                                   tenant=qtenant.current_or_none())
                    self._warm_note(index_name, qtext)
                    return out
                stats.count("query.prepared.miss")
                if out is not None:
                    query = out  # the parsed (tagged) AST
            if isinstance(query, str):
                with stats.timer("query.parse"), qprof.stage("parse"):
                    query = parse(query)
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecutionError(f"index not found: {index_name}")
        if translate:
            with stats.timer("query.translate"), qprof.stage("translate"):
                query = self.translator.translate_query(index_name, query)
        if shards is None:
            shards = sorted(idx.available_shards())
        if self.batcher is not None:
            results = self._dispatch_fetch(index_name, query, shards,
                                           check_current, qprof)
        else:
            with self._device_lock:
                results = self._dispatch_fetch(index_name, query, shards,
                                               check_current, qprof)
        if translate and self.translator.needs_translation(index_name):
            results = self.translator.translate_results(
                index_name, query.calls, results)
        if ckey is not None and not degraded.is_degraded():
            # degraded answers (quarantined fragments serving empty rows)
            # are never memoized: a healthy repeat must recompute
            from ..cache.results import query_is_readonly
            if query_is_readonly(query):
                cache.fill(qkey, ckey, results,
                           tenant=qtenant.current_or_none())
        if not any(c.name in WRITE_CALLS for c in query.calls):
            self._warm_note(index_name, qtext)
        return results

    def _warm_note(self, index_name: str, qtext):
        """Feed one successfully served read-only string query to the
        warm-start corpus recorder (no-op on bare executors)."""
        rec = self.warm_recorder
        if rec is not None and qtext is not None:
            rec.note(index_name, qtext)

    def _dispatch_fetch(self, index_name: str, query, shards,
                        check_current, qprof) -> list[Any]:
        """Dispatch every call, then the one device-to-host fetch."""
        from ..utils import explain as qexplain
        stats = self.stats
        # Grouping reorders dispatch, which is only sound when no call
        # mutates state a later call could read: mixed write/read
        # requests run strictly in order, as in the reference.
        with stats.timer("query.dispatch"), \
                qprof.stage("dispatch") as dnode:
            if dnode is not None:
                # device-budget counters bracketing the dispatch: the
                # deltas attribute upload/eviction traffic to THIS query
                # (approximate under concurrency — they are process-wide)
                from ..storage.membudget import DEFAULT_BUDGET
                up0, ev0 = (DEFAULT_BUDGET.upload_bytes,
                            DEFAULT_BUDGET.evictions)
                dnode.tags["calls"] = len(query.calls)
                dnode.tags["shards"] = len(shards)
            read_only = not any(c.name in WRITE_CALLS for c in query.calls)
            results = None
            if self.wholequery is not None and self.whole_query and \
                    read_only:
                # the whole request as ONE program; unsupported shapes
                # fall back below, counted
                results = self._try_whole_query(index_name, query.calls,
                                                shards)
            if results is not None:
                pass
            elif self.stacked is not None and len(query.calls) > 1 \
                    and read_only:
                qexplain.note("plan", {"mode": "legacy-grouped",
                                       "calls": len(query.calls),
                                       "shards": len(shards)})
                results = self._execute_calls_grouped(index_name,
                                                      query.calls, shards)
            else:
                qexplain.note("plan", {"mode": "legacy-per-call",
                                       "calls": len(query.calls),
                                       "readOnly": read_only,
                                       "shards": len(shards)})
                results = []
                for c in query.calls:
                    check_current("call dispatch")
                    results.append(self._execute_call(index_name, c,
                                                      shards))
            if dnode is not None:
                dnode.tags["uploadBytes"] = \
                    DEFAULT_BUDGET.upload_bytes - up0
                dnode.tags["evictions"] = DEFAULT_BUDGET.evictions - ev0
        check_current("result fetch")
        with stats.timer("query.fetch"), qprof.stage("fetch"):
            return _resolve_pendings(results)

    # -- batched multi-call execution --------------------------------------

    _EMPTY_PARAMS = np.zeros(0, dtype=np.int32)

    def _batch_desc(self, index: str, c: Call):
        """(group_key, desc) for calls that can batch into one group with
        per-call params rows; None for everything else."""
        if c.name == "Count" and len(c.children) == 1:
            slotted, params = parametrize(self._resolve(index,
                                                        c.children[0]))
            return (("count", repr(slotted)),
                    {"kind": "count", "slotted": slotted, "params": params})
        if c.name == "Sum":
            f = self._bsi_field(index, c)
            fp = self._filter_plan(index, c)
            slotted, params = (None, self._EMPTY_PARAMS) if fp is None \
                else parametrize(fp)
            return (("sum", f.name, repr(slotted)),
                    {"kind": "sum", "slotted": slotted, "params": params,
                     "field": f.name, "view": f.bsi_view_name(),
                     "base": f.options.base})
        if c.name == "TopN":
            if any(k in c.args for k in TOPN_EXTRAS):
                return None  # extras need extra passes: per-call path
            field_name, ok = c.string_arg("_field")
            if not ok or self.holder.field(index, field_name) is None:
                return None  # per-call path raises the proper error
            fp = self._filter_plan(index, c)
            slotted, params = (None, self._EMPTY_PARAMS) if fp is None \
                else parametrize(fp)
            n, _ = c.uint_arg("n")
            return (("topn", field_name, repr(slotted)),
                    {"kind": "topn", "slotted": slotted, "params": params,
                     "field": field_name, "ids": c.args.get("ids"), "n": n})
        return None

    def _execute_calls_grouped(self, index: str, calls, shards):
        """Group same-shape Count/TopN/Sum calls and execute each group as
        ONE batched device computation over stacked params — the
        worker-pool equivalent for a multi-call request
        (executor.go:80-110).  Singletons and other calls run one by
        one."""
        descs: list = [None] * len(calls)
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(calls):
            kd = self._batch_desc(index, c)
            if kd is not None:
                key, d = kd
                descs[i] = d
                groups.setdefault(key, []).append(i)

        results: list = [None] * len(calls)
        batched: set[int] = set()
        to_run = []
        for key, idxs in groups.items():
            if len(idxs) < 2:
                continue
            ds = [descs[i] for i in idxs]
            kind = ds[0]["kind"]
            params_mat = np.stack([d["params"] for d in ds])
            if kind == "sum":
                extra = {"field": ds[0]["field"], "view": ds[0]["view"],
                         "base": ds[0]["base"]}
            elif kind == "topn":
                extra = {"field": ds[0]["field"], "view": VIEW_STANDARD,
                         "ids_n": [(d["ids"], d["n"]) for d in ds]}
            else:
                extra = None
            to_run.append((kind, ds[0]["slotted"], params_mat, idxs, extra))
            batched.update(idxs)
        _run_batched_groups(self.batcher, self.holder, index, shards,
                            to_run, results)

        for i, c in enumerate(calls):
            if i not in batched:
                results[i] = self._execute_call(index, c, shards)
        return results

    # -- whole-query programs (parallel/wholequery.py) ---------------------
    # A read request lowers to a tuple of plan.ReduceNode reducers plus
    # one params matrix per node, and the WHOLE request runs as one
    # program.  Shapes the program cannot express raise
    # WholeQueryUnsupported and the request reroutes to the grouped
    # per-stage path with ``wholequery.fallback`` counted and a
    # structured log event naming the unsupported node.

    def _try_whole_query(self, index: str, calls, shards):
        from ..parallel.wholequery import WholeQueryUnsupported
        try:
            results = self._wq_execute(index, calls, shards)
        except WholeQueryUnsupported as e:
            self._note_wq_fallback(index, e)
            return None
        self.wq_requests += 1
        self.stats.count("wholequery.requests")
        return results

    def _note_wq_fallback(self, index: str, e):
        self.wq_fallbacks += 1
        self.wq_last_fallback = e.node if not e.detail \
            else f"{e.node}: {e.detail}"
        self.stats.count("wholequery.fallback")
        from ..utils import events, explain as qexplain
        events.emit("wholequery.fallback", index=index, node=e.node,
                    detail=e.detail or None)
        qexplain.note("plan", {"mode": "legacy-fallback", "node": e.node,
                               "detail": e.detail or None})
        log = self.logger
        if log is not None:
            try:
                log.event("wholequery.fallback", index=index, node=e.node,
                          detail=e.detail)
            # lint: allow(swallowed-exception) — a stale/closed log
            # stream costs a log line, never the query; the fallback is
            # still counted in the stats above
            except Exception:
                pass
        if self.whole_query_fallback == "error":
            raise ExecutionError(
                f"whole-query fallback disabled by the 'error' policy: "
                f"{e.node}"
                + (f": {e.detail}" if e.detail else "")) from e

    def _wq_dispatch(self, index: str, shards, program, mats):
        """One program launch through the dispatch batcher (concurrent
        same-shape requests fuse along the params batch axis)."""
        return self.batcher.whole_query(self.wholequery, program, mats,
                                        self.holder, index, shards)

    @staticmethod
    def _wq_chunk_guard(mat: np.ndarray, n_split: int,
                        row_weight: int = 0):
        """A params batch needing more than one dispatch chunk (device
        temp budget) stays on the grouped chunked path — the same
        batch_chunk_size sizing as _batch_chunks."""
        from ..parallel.wholequery import WholeQueryUnsupported
        B, P = mat.shape
        if n_split <= 0:
            return  # broadcast pass: always one chunk
        if B > batch_chunk_size(P, n_split, row_weight):
            raise WholeQueryUnsupported("batch-chunks", f"B={B}")

    def _wq_note_plan(self, out, nodes, **tags):
        if self.warm_recorder is not None:
            self.warm_recorder.note_sig(out.sig)
        from ..utils import explain as qexplain
        qexplain.note("plan", {
            "mode": "wholequery", "program": out.sig,
            "compile": "cold" if out.compiled else "warm",
            "nodes": [n.kind for n in nodes], **tags})

    def _wq_run_batched(self, index: str, shards, groups, results):
        """Whole-query dispatch of standard batched call groups —
        (kind, slotted, params_mat, call_idxs, extra) with kind in
        count/sum/topn, the _run_batched_groups contract — as ONE
        program launch.  Used by the prepared-statement replay so a
        whole template is one launch; raises WholeQueryUnsupported for
        shapes the program can't take (the caller falls back)."""
        from ..parallel.stacked import field_rows
        from .plan import ReduceNode
        groups = list(groups)
        if not groups:
            return
        per_dev = self.stacked.stacked_per_device(len(shards))
        nodes, mats = [], []
        for kind, slotted, params_mat, call_idxs, extra in groups:
            n_split = per_dev if (kind == "count" or slotted is not None) \
                else 0
            row_weight = 0
            if kind == "topn" and slotted is not None:
                row_weight = field_rows(self.holder, index, extra["field"],
                                        extra.get("view", VIEW_STANDARD))
            self._wq_chunk_guard(params_mat, n_split, row_weight)
            if kind == "count":
                nodes.append(ReduceNode("count", slotted))
            elif kind == "sum":
                nodes.append(ReduceNode(
                    "bsi_sum", slotted, (extra["field"], extra["view"])))
            else:  # topn
                nodes.append(ReduceNode(
                    "row_counts", slotted,
                    (extra["field"], extra.get("view", VIEW_STANDARD))))
            mats.append(params_mat)
        out = self._wq_dispatch(index, shards, tuple(nodes), mats)
        self._wq_note_plan(out, nodes, shards=len(shards))
        stacked = self.stacked
        for gi, (kind, slotted, params_mat, call_idxs, extra) \
                in enumerate(groups):
            parts = out.parts[gi]
            if kind == "count":
                grp = _PendingGroup.counts(parts, call_idxs)
                for i in call_idxs:
                    results[i] = grp
            elif kind == "sum":
                base = extra["base"]
                for b, i in enumerate(call_idxs):
                    results[i] = _Pending(
                        parts, lambda hp, b=b, base=base:
                        _wq_sum_fin(hp, b, base))
            else:
                ids_n = extra["ids_n"]
                for b, i in enumerate(call_idxs):
                    ids, n = ids_n[b]
                    results[i] = _Pending(
                        parts, lambda hp, b=b, ids=ids, n=n:
                        _wq_topn_rank(stacked, hp, b, ids, n))

    def _wq_execute(self, index: str, calls, shards):
        """Lower every call of a read request to reducer nodes, launch
        the whole program once, and wire pending results (resolved by
        the caller's single fetch).  Raises WholeQueryUnsupported for
        anything outside the program's fallback matrix; real validation
        errors raise exactly as the grouped path would."""
        from ..parallel.stacked import field_rows
        from .plan import ReduceNode
        idx = self.holder.index(index)
        if idx is None:
            raise ExecutionError(f"index not found: {index}")
        descs = [self._wq_desc(index, c, shards) for c in calls]
        results: list = [None] * len(calls)
        units: list[dict] = []
        by_gkey: dict = {}
        for i, d in enumerate(descs):
            if d["kind"] == "const":
                results[i] = d["result"]
                continue
            gk = d.get("gkey")
            u = by_gkey.get(gk) if gk is not None else None
            if u is None:
                u = {"kind": d["kind"], "descs": [], "idxs": []}
                if gk is not None:
                    by_gkey[gk] = u
                units.append(u)
            u["descs"].append(d)
            u["idxs"].append(i)
        if not units:
            return results

        per_dev = self.stacked.stacked_per_device(len(shards))
        nodes, mats, unit_nodes = [], [], []
        for u in units:
            kind, ds = u["kind"], u["descs"]
            lo = len(nodes)
            d0 = ds[0]
            if kind in ("count", "segments"):
                mat = np.stack([d["params"] for d in ds])
                self._wq_chunk_guard(mat, per_dev)
                nodes.append(ReduceNode(kind, d0["slotted"]))
                mats.append(mat)
            elif kind == "sum":
                mat = np.stack([d["params"] for d in ds])
                self._wq_chunk_guard(
                    mat, per_dev if d0["slotted"] is not None else 0)
                nodes.append(ReduceNode("bsi_sum", d0["slotted"],
                                        (d0["field"], d0["view"])))
                mats.append(mat)
            elif kind == "topn":
                mat = np.stack([d["params"] for d in ds])
                self._wq_chunk_guard(
                    mat, per_dev if d0["slotted"] is not None else 0,
                    row_weight=field_rows(self.holder, index,
                                          d0["field"], VIEW_STANDARD)
                    if d0["slotted"] is not None else 0)
                nodes.append(ReduceNode("row_counts", d0["slotted"],
                                        (d0["field"], VIEW_STANDARD)))
                mats.append(mat)
                if d0["tan"]:
                    # tanimoto rides two extra reducers in the SAME
                    # program: unfiltered row totals + the source count
                    nodes.append(ReduceNode(
                        "row_counts", None, (d0["field"], VIEW_STANDARD)))
                    mats.append(np.zeros((1, 0), dtype=np.int32))
                    nodes.append(ReduceNode("count", d0["slotted"]))
                    mats.append(mat)
            elif kind == "minmax":
                nodes.append(ReduceNode(
                    "bsi_minmax", d0["slotted"],
                    (d0["field"], d0["view"]),
                    ("max" if d0["want_max"] else "min",)))
                mats.append(np.asarray(d0["params"],
                                       dtype=np.int32).reshape(1, -1))
            elif kind == "minrow":
                nodes.append(ReduceNode(
                    "row_counts", None, (d0["field"], VIEW_STANDARD)))
                mats.append(np.zeros((1, 0), dtype=np.int32))
            elif kind == "rows":
                for vname in d0["views"]:
                    nodes.append(ReduceNode(
                        "row_counts", None, (d0["field"], vname)))
                    mats.append(np.zeros((1, 0), dtype=np.int32))
            else:  # groupby
                nodes.append(ReduceNode(
                    "group_counts", d0["slotted"],
                    (d0["last_field"], VIEW_STANDARD),
                    tuple(d0["prefix_keys"]) + (d0["pad_c"],)))
                mats.append((d0["rids"], d0["params"]))
            unit_nodes.append((lo, len(nodes)))

        out = self._wq_dispatch(index, shards, tuple(nodes), mats)
        self._wq_note_plan(out, nodes, calls=len(calls),
                           shards=len(shards))
        for u, (lo, hi) in zip(units, unit_nodes):
            self._wq_wire(u, out, lo, hi, results)
        return results

    def _wq_wire(self, unit, out, lo, hi, results):
        """Attach pending finalizers for one unit's calls over its nodes'
        device parts — each finalizer mirrors the grouped path's host
        reduction exactly (results stay byte-identical)."""
        kind, ds, idxs = unit["kind"], unit["descs"], unit["idxs"]
        stacked = self.stacked
        if kind == "count":
            grp = _PendingGroup.counts(out.parts[lo], idxs)
            for i in idxs:
                results[i] = grp
            return
        if kind == "segments":
            parts, meta = out.parts[lo], out.meta[lo]
            for b, i in enumerate(idxs):
                attrs = ds[b].get("attrs")
                results[i] = _Pending(
                    parts, lambda hp, b=b, groups=meta["groups"],
                    empty=meta["empty"], attrs=attrs:
                    _wq_seg_result(hp, b, groups, empty, attrs))
            return
        if kind == "sum":
            parts = out.parts[lo]
            for b, i in enumerate(idxs):
                base = ds[b]["base"]
                results[i] = _Pending(
                    parts, lambda hp, b=b, base=base:
                    _wq_sum_fin(hp, b, base))
            return
        if kind == "topn":
            d0 = ds[0]
            parts = [p for j in range(lo, hi) for p in out.parts[j]]
            k = len(out.parts[lo])
            ku = len(out.parts[lo + 1]) if d0["tan"] else 0
            f = d0["f"]
            for b, i in enumerate(idxs):
                d = ds[b]
                results[i] = _Pending(
                    parts,
                    lambda hp, b=b, ids=d["ids"], n=d["n"], k=k, ku=ku,
                    tan=d["tan"], an=d["attr_name"], av=d["attr_values"],
                    f=f:
                    self._topn_finalize(
                        stacked.merge_counts([p[b] for p in hp[:k]]),
                        stacked.merge_counts([p[0] for p in hp[k:k + ku]])
                        if tan else None,
                        sum(int(p[0]) for p in hp[k + ku:]) if tan
                        else 0,
                        ids, n, tan, an, av, f))
            return
        if kind == "minmax":
            d0 = ds[0]
            results[idxs[0]] = _Pending(
                out.parts[lo],
                lambda hp, groups=out.meta[lo]["groups"],
                base=d0["base"], want_max=d0["want_max"]:
                _wq_minmax_fin(hp, groups, base, want_max))
            return
        if kind == "minrow":
            results[idxs[0]] = _Pending(
                out.parts[lo],
                lambda hp, want_max=ds[0]["want_max"]:
                _wq_minrow_fin(hp, want_max))
            return
        if kind == "rows":
            d0 = ds[0]
            parts = [p for j in range(lo, hi) for p in out.parts[j]]
            results[idxs[0]] = _Pending(
                parts, lambda hp, limit=d0["limit"],
                previous=d0["previous"]: _wq_rows_fin(hp, limit,
                                                      previous))
            return
        # groupby
        d0 = ds[0]
        results[idxs[0]] = _Pending(
            out.parts[lo],
            lambda hp, combos=d0["combos"], last_ids=d0["last_ids"],
            last_field=d0["last_field"], prev_ids=d0["prev_ids"],
            limit=d0["limit"]:
            _wq_groupby_fin(hp, combos, last_ids, last_field, prev_ids,
                            limit))

    def _wq_desc(self, index: str, c: Call, shards) -> dict:
        """Lower one call to a whole-query unit descriptor, running the
        same validation (and raising the same errors) as the per-call
        path.  Raises WholeQueryUnsupported for call shapes outside the
        program's vocabulary."""
        from ..parallel.wholequery import WholeQueryUnsupported
        name = c.name
        if name == "Count":
            if len(c.children) != 1:
                raise ExecutionError("Count() requires one input")
            slotted, params = parametrize(
                self._resolve(index, c.children[0]))
            return {"kind": "count", "gkey": ("count", repr(slotted)),
                    "slotted": slotted, "params": params}
        if name == "Sum":
            f = self._bsi_field(index, c)
            fp = self._filter_plan(index, c)
            slotted, params = (None, self._EMPTY_PARAMS) if fp is None \
                else parametrize(fp)
            return {"kind": "sum", "gkey": ("sum", f.name, repr(slotted)),
                    "slotted": slotted, "params": params, "field": f.name,
                    "view": f.bsi_view_name(), "base": f.options.base}
        if name in ("Min", "Max"):
            f = self._bsi_field(index, c)
            fp = self._filter_plan(index, c)
            slotted, params = (None, self._EMPTY_PARAMS) if fp is None \
                else parametrize(fp)
            return {"kind": "minmax", "gkey": None, "slotted": slotted,
                    "params": params, "field": f.name,
                    "view": f.bsi_view_name(), "base": f.options.base,
                    "want_max": name == "Max"}
        if name in ("MinRow", "MaxRow"):
            field_name, ok = c.string_arg("field")
            if not ok:
                raise ExecutionError(f"{c.name}(): field required")
            if self.holder.field(index, field_name) is None:
                raise ExecutionError(f"field not found: {field_name}")
            return {"kind": "minrow", "gkey": None, "field": field_name,
                    "want_max": name == "MaxRow"}
        if name == "TopN":
            return self._wq_desc_topn(index, c, shards)
        if name == "Rows":
            return self._wq_desc_rows(index, c)
        if name == "GroupBy":
            return self._wq_desc_group_by(index, c)
        if name in BITMAP_CALLS:
            plan = self._resolve(index, c)
            slotted, params = parametrize(plan)
            attrs = None
            if c.name in ("Row", "Range"):
                fa = c.field_arg()
                if fa is not None and isinstance(fa[1], int) \
                        and not isinstance(fa[1], bool):
                    f = self.holder.field(index, fa[0])
                    if f is not None:
                        attrs = f.row_attrs.attrs(fa[1]) or None
            return {"kind": "segments",
                    "gkey": ("segments", repr(slotted)),
                    "slotted": slotted, "params": params, "attrs": attrs}
        if name == "Options":
            raise WholeQueryUnsupported("options",
                                        "per-call shard overrides")
        raise ExecutionError(f"unknown call: {name}")

    def _wq_desc_topn(self, index: str, c: Call, shards) -> dict:
        field_name, ok = c.string_arg("_field")
        if not ok:
            raise ExecutionError("TopN() requires a field")
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        n, _ = c.uint_arg("n")
        ids = c.args.get("ids")
        tan_thresh, attr_name, attr_values = topn_extras(c)
        if not c.children and ids is None and tan_thresh is None \
                and attr_name is None and not self.multiprocess \
                and f.options.cache_type in ("ranked", "lru"):
            from ..cache.rank import topn_from_rank
            pairs = topn_from_rank(f, shards, n, stats=self.stats)
            if pairs is not None:
                return {"kind": "const", "result": pairs}
        fp = self._filter_plan(index, c)
        slotted, params = (None, self._EMPTY_PARAMS) if fp is None \
            else parametrize(fp)
        extras = tan_thresh is not None or attr_name is not None
        return {"kind": "topn",
                "gkey": None if extras
                else ("topn", field_name, repr(slotted)),
                "slotted": slotted, "params": params,
                "field": field_name, "ids": ids, "n": n,
                "tan": tan_thresh, "attr_name": attr_name,
                "attr_values": attr_values, "f": f}

    def _wq_desc_rows(self, index: str, c: Call) -> dict:
        from ..parallel.wholequery import WholeQueryUnsupported
        field_name, ok = c.string_arg("_field")
        if not ok:
            raise ExecutionError("Rows() requires a field")
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        if c.args.get("column") is not None:
            # a column probe reads one bit per row — the per-shard path
            # owns it (no reduction to express)
            raise WholeQueryUnsupported("rows-column")
        views = [VIEW_STANDARD]
        from_arg, to_arg = c.args.get("from"), c.args.get("to")
        if from_arg or to_arg:
            quantum = f.options.time_quantum
            if not quantum:
                raise ExecutionError(
                    f"field {field_name!r} has no time quantum")
            from_time = tq.parse_time(from_arg) if from_arg \
                else datetime(1, 1, 1)
            to_time = tq.parse_time(to_arg) if to_arg \
                else datetime(9999, 1, 1)
            views = tq.views_by_time_range(VIEW_STANDARD, from_time,
                                           to_time, quantum)
        return {"kind": "rows", "gkey": None, "field": field_name,
                "views": views, "limit": c.args.get("limit"),
                "previous": c.args.get("previous")}

    def _wq_desc_group_by(self, index: str, c: Call) -> dict:
        from ..parallel.stacked import StackedExecutor
        from ..parallel.wholequery import WholeQueryUnsupported
        names, rows_calls, filt_call, limit = self._group_by_parse(index,
                                                                   c)
        fields = self._group_by_grid(index, names, rows_calls)
        if fields is None:
            raise WholeQueryUnsupported(
                "group_counts", "children need Rows execution or the "
                                "grid bounds failed")
        prev_ids = self._group_by_previous(c, fields)
        filter_plan = (self._resolve(index, filt_call)
                       if filt_call is not None else None)
        slotted, params = (None, self._EMPTY_PARAMS) \
            if filter_plan is None else parametrize(filter_plan)
        prefix_fields = fields[:-1]
        last_field, last_ids = fields[-1]
        combos: list[tuple] = [()]
        for fname, ids in prefix_fields:
            combos = [cb + ((fname, rid),) for cb in combos
                      for rid in ids]
        if not combos or not last_ids:
            return {"kind": "const", "result": []}
        if len(combos) > StackedExecutor.GROUP_CHUNK:
            raise WholeQueryUnsupported(
                "group_counts",
                f"{len(combos)} prefix combos exceed one chunk")
        rids = np.asarray([[rid for _, rid in cb] for cb in combos],
                          dtype=np.int32).reshape(len(combos),
                                                  len(prefix_fields))
        pad_c = 1 << max(0, len(combos) - 1).bit_length()
        return {"kind": "groupby", "gkey": None, "slotted": slotted,
                "params": params, "rids": rids, "pad_c": pad_c,
                "prefix_keys": [(fname, VIEW_STANDARD)
                                for fname, _ in prefix_fields],
                "last_field": last_field, "last_ids": last_ids,
                "combos": combos, "prev_ids": prev_ids, "limit": limit}

    # -- dispatch (executor.go:274 executeCall) ----------------------------

    def _execute_call(self, index: str, c: Call, shards: list[int]):
        name = c.name
        if name == "Count":
            return self._execute_count(index, c, shards)
        if name == "Sum":
            return self._execute_sum(index, c, shards)
        if name in ("Min", "Max"):
            return self._execute_min_max(index, c, shards, name == "Max")
        if name in ("MinRow", "MaxRow"):
            return self._execute_min_max_row(index, c, shards,
                                             name == "MaxRow")
        if name == "TopN":
            return self._execute_topn(index, c, shards)
        if name == "Rows":
            return self._execute_rows(index, c, shards)
        if name == "GroupBy":
            return self._execute_group_by(index, c, shards)
        if name == "Options":
            return self._execute_options(index, c, shards)
        if name == "Set":
            return self._execute_set(index, c)
        if name == "Clear":
            return self._execute_clear(index, c)
        if name == "ClearRow":
            return self._execute_clear_row(index, c, shards)
        if name == "Store":
            return self._execute_store(index, c, shards)
        if name in ("SetRowAttrs", "SetColumnAttrs"):
            return self._execute_set_attrs(index, c)
        if name in BITMAP_CALLS:
            return self._execute_bitmap(index, c, shards)
        raise ExecutionError(f"unknown call: {name}")

    # -- bitmap calls ------------------------------------------------------

    def _resolve(self, index: str, c: Call):
        return Resolver(self.holder, index).resolve_bitmap(c)

    def _execute_bitmap(self, index: str, c: Call, shards) -> RowResult:
        plan = self._resolve(index, c)
        attrs = None
        if c.name in ("Row", "Range"):
            # a plain Row() result carries its row's attributes
            # (executor.go:651 executeBitmapCallShard -> row.Attrs)
            fa = c.field_arg()
            if fa is not None and isinstance(fa[1], int) \
                    and not isinstance(fa[1], bool):
                f = self.holder.field(index, fa[0])
                if f is not None:
                    attrs = f.row_attrs.attrs(fa[1]) or None
        segs = {s: bitset.to_numpy(seg) if isinstance(seg, torch.Tensor)
                else seg
                for s, seg in self._plan_segments(plan, index,
                                                  shards).items()}
        return RowResult(segs, attrs=attrs)

    def _plan_segments(self, plan, index: str, shards) -> dict:
        """Per-shard results of a bitmap plan: host numpy words on the
        stacked path, device tensors on the per-shard path."""
        if self.stacked is not None:
            return self.batcher.segments(plan, self.holder, index, shards)
        return {
            shard: self.compiler.execute_shard(plan, self.holder, index,
                                               shard)
            for shard in shards
        }

    # -- aggregations ------------------------------------------------------

    def _execute_count(self, index: str, c: Call, shards) -> int:
        """(executor.go:1790 executeCount)"""
        if len(c.children) != 1:
            raise ExecutionError("Count() requires one input")
        plan = self._resolve(index, c.children[0])
        if self.stacked is not None:
            parts = self.batcher.count_async(plan, self.holder, index,
                                             shards)
            return _Pending(parts, lambda hp: sum(int(x) for x in hp))
        return sum(
            self.compiler.execute_shard(plan, self.holder, index, shard,
                                        reducer="count")
            for shard in shards)

    def _bsi_field(self, index: str, c: Call):
        field_name, _ = c.string_arg("field")
        if not field_name:
            fa = c.field_arg()
            if fa is None:
                raise ExecutionError("field required")
            field_name = fa[0]
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        if f.options.type != FIELD_TYPE_INT:
            raise ExecutionError(f"field {field_name!r} is not an int field")
        return f

    def _filter_segments(self, index: str, c: Call, shards):
        """Evaluate the optional filter child of Sum/Min/Max/TopN
        (per-shard path)."""
        if not c.children:
            return None
        plan = self._resolve(index, c.children[0])
        return self._plan_segments(plan, index, shards)

    def _filter_plan(self, index: str, c: Call):
        """Resolve the optional filter child to a plan (the stacked path
        evaluates it inside the same stacked reducer)."""
        if not c.children:
            return None
        return self._resolve(index, c.children[0])

    def _execute_sum(self, index: str, c: Call, shards):
        """(executor.go:406 executeSum + fragment.go:1111 sum)"""
        f = self._bsi_field(index, c)
        view = f.bsi_view_name()
        base = f.options.base
        if self.stacked is not None:
            parts = self.batcher.bsi_sum_async(
                f.name, view, self._filter_plan(index, c), self.holder,
                index, shards)

            def _fin(hp):
                total, n = 0, 0
                for p in hp:
                    s, cnt = bsi.weighted_sum(p)
                    total += s
                    n += cnt
                return ValCount(total + n * base, n)

            return _Pending(parts, _fin)
        filters = self._filter_segments(index, c, shards)
        total, n = 0, 0
        for shard in shards:
            frag = self.holder.fragment(index, f.name, view, shard)
            if frag is None or frag.n_rows < bsi.OFFSET_ROW + 1:
                continue
            filt = None if filters is None else filters.get(shard)
            counts = _host(bsi.sum_counts(frag.device(self.device), filt))
            s, cnt = bsi.weighted_sum(counts)
            total += s
            n += cnt
        # values are stored base-offset: add base per set column
        # (field.go:1138 Sum: sum + count*base)
        return ValCount(total + n * base, n)

    def _execute_min_max(self, index: str, c: Call, shards,
                         want_max: bool) -> ValCount:
        """(executor.go:437 executeMin/:472 executeMax)"""
        f = self._bsi_field(index, c)
        view = f.bsi_view_name()
        acc = ValCount()
        if self.stacked is not None:
            per_shard = self.batcher.bsi_min_max(
                f.name, view, self._filter_plan(index, c), self.holder,
                index, shards, want_max=want_max)
        else:
            filters = self._filter_segments(index, c, shards)
            per_shard = []
            for shard in shards:
                frag = self.holder.fragment(index, f.name, view, shard)
                if frag is None or frag.n_rows < bsi.OFFSET_ROW + 1:
                    continue
                filt = None if filters is None else filters.get(shard)
                bits, neg, cnt = (_host(x) for x in bsi.min_max_bits(
                    frag.device(self.device), filt, want_max=want_max))
                per_shard.append(bsi.reconstruct_min_max(bits, int(neg),
                                                         int(cnt)))
        for val, cnt in per_shard:
            vc = ValCount(val + f.options.base if cnt else 0, cnt)
            acc = acc.larger(vc) if want_max else acc.smaller(vc)
        return acc

    def _execute_min_max_row(self, index: str, c: Call, shards,
                             want_max: bool) -> ValCount:
        """MinRow/MaxRow: extreme row id with any bit set
        (executor.go:506 executeMinRow)."""
        field_name, ok = c.string_arg("field")
        if not ok:
            raise ExecutionError(f"{c.name}(): field required")
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        if self.stacked is not None:
            counts = self.batcher.row_counts(
                field_name, VIEW_STANDARD, None, self.holder, index, shards)
            nz = np.nonzero(counts)[0]
            if nz.size == 0:
                return ValCount(0, 0)
            rid = int(nz[-1] if want_max else nz[0])
            return ValCount(rid, int(counts[rid]))
        best, best_count = None, 0
        v = f.view(VIEW_STANDARD)
        for shard in shards:
            frag = None if v is None else v.fragment(shard)
            if frag is None or frag.n_rows == 0:
                continue
            counts = _host(bitset.row_counts(frag.device(self.device)))
            nz = np.nonzero(counts)[0]
            if nz.size == 0:
                continue
            rid = int(nz[-1] if want_max else nz[0])
            if best is None or (rid > best if want_max else rid < best):
                best, best_count = rid, int(counts[rid])
            elif rid == best:
                best_count += int(counts[rid])
        return ValCount(best or 0, best_count if best is not None else 0)

    # -- TopN (executor.go:860 executeTopN, fragment.go:1570 top) ----------

    @staticmethod
    def _topn_finalize(counts, row_tot, src_count, ids, n, tan_thresh,
                       attr_name, attr_values, field) -> list[Pair]:
        """Shared tail of TopN: tanimoto/attr row filtering + ranking
        (fragment.go:1704 topBitmapPairs, executor.go:942-995), on global
        counts."""
        if tan_thresh:
            size = max(counts.size, row_tot.size)
            c_ = np.zeros(size, dtype=np.int64)
            c_[: counts.size] = counts
            t_ = np.zeros(size, dtype=np.int64)
            t_[: row_tot.size] = row_tot
            denom = t_ + src_count - c_
            ok = (denom > 0) & (100 * c_ >= tan_thresh * denom)
            counts = np.where(ok, c_, 0)
        if attr_name is None:
            return rank_counts(counts, n or None, ids)
        allowed = set(attr_values)
        pairs = [p for p in rank_counts(counts, None, ids)
                 if field.row_attrs.attrs(p.id).get(attr_name) in allowed]
        return pairs[: n or None]

    def _execute_topn(self, index: str, c: Call, shards) -> list[Pair]:
        field_name, ok = c.string_arg("_field")
        if not ok:
            raise ExecutionError("TopN() requires a field")
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        n, _ = c.uint_arg("n")
        ids = c.args.get("ids")
        tan_thresh, attr_name, attr_values = topn_extras(c)

        # Unfiltered TopN first consults the field's per-fragment rank
        # caches (cache/rank.py); they answer only when they can prove the
        # pruned rows cannot reach the top n, else the full scan runs.
        if not c.children and ids is None and tan_thresh is None \
                and attr_name is None and not self.multiprocess \
                and f.options.cache_type in ("ranked", "lru"):
            from ..cache.rank import topn_from_rank
            pairs = topn_from_rank(f, shards, n, stats=self.stats)
            if pairs is not None:
                return pairs

        if self.stacked is not None:
            # per-row popcounts masked by the filter plan, summed over the
            # stacked shard axis; tanimoto adds an unfiltered pass + the
            # src count, all dispatched before the fetch
            filter_plan = self._filter_plan(index, c)
            parts = self.batcher.row_counts_async(
                field_name, VIEW_STANDARD, filter_plan,
                self.holder, index, shards)
            parts_u, parts_src = [], []
            if tan_thresh:
                parts_u = self.batcher.row_counts_async(
                    field_name, VIEW_STANDARD, None, self.holder, index,
                    shards)
                parts_src = self.batcher.count_async(
                    filter_plan, self.holder, index, shards)
            k, ku = len(parts), len(parts_u)
            merge = self.stacked.merge_counts

            def _fin(hp, ids=ids, n=n):
                counts = merge(hp[:k])
                row_tot = merge(hp[k: k + ku]) if tan_thresh else None
                src = sum(int(x) for x in hp[k + ku:]) if tan_thresh else 0
                return self._topn_finalize(
                    counts, row_tot, src, ids, n, tan_thresh, attr_name,
                    attr_values, f)

            return _Pending(parts + parts_u + parts_src, _fin)

        filters = self._filter_segments(index, c, shards)
        v = f.view(VIEW_STANDARD)
        counts = np.zeros(0, dtype=np.int64)
        row_tot = np.zeros(0, dtype=np.int64)
        src_count = 0
        if tan_thresh and filters is not None:
            # src is counted over ALL shards — including ones where the
            # TopN field has no fragment
            src_count = sum(int(bitset.count(seg))
                            for seg in filters.values())
        for shard in shards:
            frag = None if v is None else v.fragment(shard)
            if frag is None or frag.n_rows == 0:
                continue
            dev = frag.device(self.device)
            filt = None if filters is None else filters.get(shard)
            if filt is not None:
                counts_dev = bitset.row_counts(
                    bitset.intersect(dev, filt[None, :]))
            else:
                counts_dev = bitset.row_counts(dev)
            counts = acc_counts(counts, _host(counts_dev))
            if tan_thresh:
                row_tot = acc_counts(row_tot,
                                     _host(bitset.row_counts(dev)))
        return self._topn_finalize(counts, row_tot, src_count, ids, n,
                                   tan_thresh, attr_name, attr_values, f)

    # -- Rows (executor.go:1274 executeRows) -------------------------------

    def _execute_rows(self, index: str, c: Call, shards) -> RowIdentifiers:
        field_name, ok = c.string_arg("_field")
        if not ok:
            raise ExecutionError("Rows() requires a field")
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        limit = c.args.get("limit")
        previous = c.args.get("previous")
        column = c.args.get("column")

        views = [VIEW_STANDARD]
        from_arg, to_arg = c.args.get("from"), c.args.get("to")
        if from_arg or to_arg:
            quantum = f.options.time_quantum
            if not quantum:
                raise ExecutionError(
                    f"field {field_name!r} has no time quantum")
            from_time = tq.parse_time(from_arg) if from_arg \
                else datetime(1, 1, 1)
            to_time = tq.parse_time(to_arg) if to_arg else datetime(9999, 1, 1)
            views = tq.views_by_time_range(VIEW_STANDARD, from_time, to_time,
                                           quantum)

        row_ids: set[int] = set()
        for vname in views:
            v = f.view(vname)
            # under a process group every rank runs the collective, also
            # one whose shards never wrote this view
            if v is None and not self.multiprocess:
                continue
            if self.stacked is not None and column is None:
                counts = self.batcher.row_counts(
                    field_name, vname, None, self.holder, index, shards)
                row_ids.update(int(i) for i in np.nonzero(counts)[0])
                continue
            if v is None:
                continue
            for shard in shards:
                if column is not None and column // SHARD_WIDTH != shard:
                    continue
                frag = v.fragment(shard)
                if frag is None or frag.n_rows == 0:
                    continue
                dev = frag.device(self.device)
                if column is not None:
                    col_local = column % SHARD_WIDTH
                    w, bit = bitset.word_bit_np(col_local)
                    present = bitset.to_numpy(dev[:, int(w)]) & bit > 0
                    ids = np.nonzero(present)[0]
                else:
                    ids = np.nonzero(_host(bitset.row_counts(dev)))[0]
                row_ids.update(int(i) for i in ids)

        if column is not None and self.multiprocess:
            # only the column's owner holds its bits
            if not self.stacked.owned(self.holder, index,
                                      [column // SHARD_WIDTH]):
                row_ids = set()
            row_ids = set().union(*self.stacked.gather_objects(row_ids))
        out = sorted(row_ids)
        if previous is not None:
            out = [r for r in out if r > previous]
        if limit is not None:
            out = out[:limit]
        return RowIdentifiers(rows=out)

    # -- GroupBy (executor.go:1068 executeGroupBy) -------------------------

    def _group_by_parse(self, index: str, c: Call):
        """(names, rows_calls, filt_call, limit) with the reference's
        argument validation."""
        if not c.children:
            raise ExecutionError("GroupBy requires at least one Rows() child")
        limit = c.args.get("limit")
        filt_call = None
        rows_calls = []
        for ch in c.children:
            if ch.name == "Rows":
                rows_calls.append(ch)
            else:
                filt_call = ch
        if not rows_calls:
            raise ExecutionError("GroupBy requires Rows() children")
        names = []
        for rc in rows_calls:
            fname, ok = rc.string_arg("_field")
            if not ok:
                raise ExecutionError("Rows() requires a field")
            names.append(fname)
        return names, rows_calls, filt_call, limit

    def _group_by_grid(self, index: str, names, rows_calls):
        """Row-id grid fields when every child is a plain Rows(field) and
        the grid bounds hold; None otherwise (the caller executes Rows).
        Every (field, row <= max_row) combo is counted and zero-count
        groups drop out — the same answer without executing Rows first."""
        if not all(set(rc.args) == {"_field"} for rc in rows_calls):
            return None
        caps = []
        for fname in names:
            f = self.holder.field(index, fname)
            if f is None:
                raise ExecutionError(f"field not found: {fname}")
            v = f.view(VIEW_STANDARD)
            cap = 0 if v is None else max(
                (fr.max_row_id() + 1 for fr in v.fragments.values()
                 if fr.host_bytes()), default=0)
            caps.append(cap)
        if self.multiprocess:
            # every rank must lay out the same combos: the largest cap
            caps = self.stacked.agree_max(caps)
        total = 1
        for c_ in caps:
            total *= c_
        prefix_total = 1
        for c_ in caps[:-1]:
            prefix_total *= c_
        if 0 < total <= self.GROUP_GRID_MAX and \
                prefix_total <= self.GROUP_GRID_PREFIX_MAX:
            return [(fname, list(range(c_)))
                    for fname, c_ in zip(names, caps)]
        return None

    @staticmethod
    def _group_by_previous(c: Call, fields):
        """previous=[row per Rows child]: resume pagination strictly
        after that group (executor.go:1403)."""
        previous = c.args.get("previous")
        if previous is None:
            return None
        if not isinstance(previous, list) or \
                len(previous) != len(fields):
            raise ExecutionError(
                "GroupBy previous= must list one row per Rows child")
        return tuple(int(p) for p in previous)

    def _execute_group_by(self, index: str, c: Call,
                          shards) -> list[GroupCount]:
        names, rows_calls, filt_call, limit = self._group_by_parse(index,
                                                                   c)
        fields = []
        if self.stacked is not None:
            fields = self._group_by_grid(index, names, rows_calls) or []
        if not fields:
            for fname, rc in zip(names, rows_calls):
                ids = self._execute_rows(index, rc, shards).rows
                fields.append((fname, ids))

        prev_ids = self._group_by_previous(c, fields)

        def _paginate(groups_out):
            if prev_ids is not None:
                groups_out = [
                    g for g in groups_out
                    if tuple(fr.row_id for fr in g.group) > prev_ids]
            if limit is not None:
                groups_out = groups_out[:limit]
            return groups_out

        results: list[GroupCount] = []
        last_field, last_ids = fields[-1]
        prefix_fields = fields[:-1]

        def prefix_combos(i=0, combo=()):
            if i == len(prefix_fields):
                yield combo
                return
            fname, ids = prefix_fields[i]
            for rid in ids:
                yield from prefix_combos(i + 1, combo + ((fname, rid),))

        if self.stacked is not None:
            filter_plan = (self._resolve(index, filt_call)
                           if filt_call is not None else None)
            prefix_keys = [(fname, VIEW_STANDARD) for fname, _ in
                           prefix_fields]
            combos = list(prefix_combos())
            if not combos:
                return []
            mat = np.asarray(
                [[rid for _, rid in combo] for combo in combos],
                dtype=np.int64).reshape(len(combos), len(prefix_fields))
            chunked = self.batcher.group_counts_batch_async(
                (last_field, VIEW_STANDARD), prefix_keys, mat, filter_plan,
                self.holder, index, shards)
            all_parts = [p for _, _, ps in chunked for p in ps]

            def _fin(hp, combos=combos, last_ids=last_ids):
                out: list[GroupCount] = []
                i = 0
                for lo, hi, ps in chunked:
                    acc = None
                    for p in hp[i: i + len(ps)]:
                        a = np.asarray(p, dtype=np.int64)
                        acc = a.copy() if acc is None else acc_counts(acc, a)
                    i += len(ps)
                    for ci in range(lo, hi):
                        combo = combos[ci]
                        for rid in last_ids:
                            cnt = (int(acc[ci - lo, rid])
                                   if acc is not None
                                   and rid < acc.shape[1] else 0)
                            if cnt > 0:
                                group = [FieldRow(fn, ri)
                                         for fn, ri in combo]
                                group.append(FieldRow(last_field, rid))
                                out.append(GroupCount(group, cnt))
                out.sort(key=lambda g: tuple(
                    (fr.field, fr.row_id) for fr in g.group))
                return _paginate(out)

            return _Pending(all_parts, _fin)

        filter_segs = None
        if filt_call is not None:
            plan = self._resolve(index, filt_call)
            filter_segs = {
                s: self.compiler.execute_shard(plan, self.holder, index, s)
                for s in shards
            }

        last_pos = {r: j for j, r in enumerate(last_ids)}
        for combo in prefix_combos():
            counts_acc = np.zeros(len(last_ids), dtype=np.int64)
            for shard in shards:
                prefix_seg = None
                empty = False
                for fname, rid in combo:
                    frag = self.holder.fragment(index, fname, VIEW_STANDARD,
                                                shard)
                    if frag is None or rid >= frag.n_rows:
                        empty = True
                        break
                    seg = frag.device(self.device)[rid]
                    prefix_seg = seg if prefix_seg is None else \
                        bitset.intersect(prefix_seg, seg)
                if empty:
                    continue
                if filter_segs is not None:
                    fseg = filter_segs[shard]
                    prefix_seg = fseg if prefix_seg is None else \
                        bitset.intersect(prefix_seg, fseg)
                frag = self.holder.fragment(index, last_field, VIEW_STANDARD,
                                            shard)
                if frag is None or frag.n_rows == 0:
                    continue
                dev = frag.device(self.device)
                valid = [r for r in last_ids if r < frag.n_rows]
                if not valid:
                    continue
                sel = dev[torch.as_tensor(valid, device=dev.device)]
                if prefix_seg is None:
                    cnts = _host(bitset.row_counts(sel))
                else:
                    cnts = _host(bitset.row_counts(
                        bitset.intersect(sel, prefix_seg[None, :])))
                for j, r in enumerate(valid):
                    counts_acc[last_pos[r]] += int(cnts[j])
            for j, rid in enumerate(last_ids):
                if counts_acc[j] > 0:
                    group = [FieldRow(fn, ri) for fn, ri in combo]
                    group.append(FieldRow(last_field, rid))
                    results.append(GroupCount(group, int(counts_acc[j])))

        results.sort(key=lambda g: tuple(
            (fr.field, fr.row_id) for fr in g.group))
        return _paginate(results)

    # -- Options (executor.go executeOptionsCall) --------------------------

    @staticmethod
    def _options_bool(c: Call, name: str) -> bool:
        v = c.args.get(name, False)
        if not isinstance(v, bool):
            raise ExecutionError(f"Options() {name} must be a bool")
        return v

    @staticmethod
    def attach_column_attrs(holder, index: str, result):
        """Stash [{"id", "attrs"}] for every result column that has column
        attributes onto the RowResult (executor.go:163-192, :209
        readColumnAttrSets)."""
        if not isinstance(result, RowResult):
            return result
        idx = holder.index(index)
        all_attrs = idx.column_attrs.all()
        if not all_attrs:
            result.column_attrs = []
            return result
        attr_ids = np.fromiter(all_attrs.keys(), dtype=np.int64,
                               count=len(all_attrs))
        have = np.intersect1d(attr_ids, result.columns())
        result.column_attrs = [{"id": int(c), "attrs": all_attrs[int(c)]}
                               for c in np.sort(have)]
        return result

    def _execute_options(self, index: str, c: Call, shards):
        """(executor.go:340-403 executeOptionsCall)"""
        if len(c.children) != 1:
            raise ExecutionError("Options() requires exactly one child")
        if "shards" in c.args:
            arg = c.args["shards"]
            if not isinstance(arg, list):
                raise ExecutionError("Options() shards must be a list")
            shards = [int(s) for s in arg]
        column_attrs = self._options_bool(c, "columnAttrs")
        exclude_row_attrs = self._options_bool(c, "excludeRowAttrs")
        exclude_columns = self._options_bool(c, "excludeColumns")
        result = self._execute_call(index, c.children[0], shards)
        if not (column_attrs or exclude_row_attrs or exclude_columns):
            return result

        def _shape(r):
            if isinstance(r, RowResult):
                if exclude_columns:
                    r.segments = {}
                if column_attrs:
                    self.attach_column_attrs(self.holder, index, r)
                if exclude_row_attrs:
                    r.attrs = {}
            return r

        if isinstance(result, _Pending):
            inner_fin = result.fin
            result.fin = lambda hp: _shape(inner_fin(hp))
            return result
        return _shape(result)

    # -- writes (executor.go:2067 executeSet etc.) -------------------------

    def _require_col(self, c: Call) -> int:
        col = c.args.get("_col")
        if not isinstance(col, int) or isinstance(col, bool):
            raise ExecutionError(
                f"{c.name}() column argument must be an integer id "
                f"(got {col!r})")
        return col

    def _execute_set(self, index: str, c: Call) -> bool:
        idx = self.holder.index(index)
        col = self._require_col(c)
        fa = c.field_arg()
        if fa is None:
            raise ExecutionError("Set() requires a field=<row> argument")
        field_name, row_val = fa
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")

        if f.options.type == FIELD_TYPE_INT:
            if not isinstance(row_val, int):
                raise ExecutionError("Set() int field requires integer value")
            changed = f.set_value(col, row_val)
        else:
            ts = None
            if "_timestamp" in c.args:
                ts = tq.parse_time(c.args["_timestamp"])
            row_val = self._coerce_row(f, row_val)
            changed = f.set_bit(row_val, col, ts=ts)
        idx.add_existence(np.array([col]))
        return changed

    @staticmethod
    def _coerce_row(f, row_val) -> int:
        if isinstance(row_val, bool):
            if f.options.type != FIELD_TYPE_BOOL:
                raise ExecutionError("bool row value on non-bool field")
            return int(row_val)
        if not isinstance(row_val, int):
            raise ExecutionError(
                f"row must be an integer id, got {row_val!r}")
        return row_val

    def _execute_clear(self, index: str, c: Call) -> bool:
        col = self._require_col(c)
        fa = c.field_arg()
        if fa is None:
            raise ExecutionError("Clear() requires a field=<row> argument")
        field_name, row_val = fa
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        return f.clear_bit(self._coerce_row(f, row_val), col)

    def _execute_clear_row(self, index: str, c: Call, shards) -> bool:
        """(executor.go:1825 executeClearRow)"""
        fa = c.field_arg()
        if fa is None:
            raise ExecutionError("ClearRow() requires a field=<row> argument")
        field_name, row_id = fa
        f = self.holder.field(index, field_name)
        if f is None:
            raise ExecutionError(f"field not found: {field_name}")
        changed = False
        for vname, v in list(f.views.items()):
            if vname.startswith("bsig_"):
                continue
            for shard in shards:
                frag = v.fragment(shard)
                if frag is not None and row_id < frag.n_rows:
                    if frag.row(row_id).any():
                        frag.set_row(row_id, None)
                        changed = True
        return changed

    def _execute_store(self, index: str, c: Call, shards) -> bool:
        """Store(Row(...), field=row) (executor.go:1979 executeSetRow)"""
        fa = c.field_arg()
        if fa is None:
            raise ExecutionError("Store() requires a field=<row> argument")
        field_name, row_id = fa
        f = self.holder.field(index, field_name)
        if f is None:
            f = self.holder.index(index).create_field_if_not_exists(field_name)
        if len(c.children) != 1:
            raise ExecutionError("Store() requires exactly one input row")
        src = self._execute_bitmap(index, c.children[0], shards)
        for shard in shards:
            seg = src.segments.get(shard)
            v = f._create_view_if_not_exists(VIEW_STANDARD)
            frag = v.create_fragment_if_not_exists(shard)
            frag.set_row(row_id, None if seg is None else np.asarray(seg))
        return True

    def _execute_set_attrs(self, index: str, c: Call):
        from ..storage.attrs import set_attrs_from_call
        return set_attrs_from_call(self.holder, index, c)
