"""Cross-query dynamic batching of device dispatch — the port of the JAX
package's ``parallel/batcher.py`` for one GPU.

Every stacked reducer call and every whole-query program the executor
makes goes through ``DispatchBatcher``.  With batching on, a call
becomes a ticket keyed by its program shape (reducer kind, slotted-plan
repr, primary field/view, index, shard set, holder) and the request
thread waits on the ticket's future; a dispatcher thread drains the
queue, coalesces compatible tickets — concatenating their params rows
along the batch axis and launching the batched reducer
(``StackedExecutor.*_batch_async``) or the whole-query program
(``_launch_fused_whole``) ONCE — and hands each waiter its slice of the
results, still unfetched on the device.  Launch policy is adaptive:
fire when the queue reaches ``max_batch`` tickets or the oldest ticket
has waited ``window_us``; a pack is also capped by FUSED_ROWS_MAX rows
and by the batch-temp workspace (``executor.BATCH_TEMP_BYTES``) its
filtered row counts would materialise.  A pack of one ticket takes the
un-fused call.  With batching off every wrapper calls the stacked
executor directly.

Device launches are serialised by ``launch_lock`` — the dispatcher
takes it per launch, a direct (un-ticketed) call around its call — so
one launch's temporaries are live at a time, while request threads wait
on their tickets without it and can keep submitting: that is what lets
concurrent requests fuse.  (Eight unserialised dense SSB requests
exhausted the 80 GB card.)

Deadlines: time queued here counts against the query budget — tickets
carry their QueryContext, and an expired ticket is dropped BEFORE launch
(its waiter gets DeadlineExceeded -> HTTP 504).  Background work
(``background()``, the rank-cache rebuild) is counted apart and yields
to queued foreground tickets.

Over-budget working sets: a fused launch whose shard schedule
(parallel/stacked.py) has more than one slice streams each ticket down
its direct path instead, a matrix ticket once per slice of that
schedule (``stream_fallbacks``, ``dispatch.launch.stream_fallback``);
so does a fused whole-query pack whose program raised
``streamed-working-set``.  Each fused launch hits
the ``mesh.slice`` failpoint once, matching the per-slice gate of the
direct path.

Every launch sets the launch-ledger context (``devobs.set_launch_ctx``:
the queued wait, the tickets and the fused rows) where the JAX module
does; the whole-query runner reads it into its ledger entry
(utils/devobs.py).

Under a process group (parallel/multihost.py) no ticket is taken:
every call goes direct, as the JAX module does on a multi-process mesh.

Deviations from the JAX module: no pow2 padding of a fused reducer
batch (the eager reducers reuse no executable; whole-query programs pad
inside the runner).  The
ledger records whole-query runs only: the grouped path's eager reducers
launch no program of their own.
A matrix ticket of a fused launch refused for its slices runs slice by
slice; the JAX module's direct path runs its batched reducer over every
shard at once, staging the over-budget working set whole.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager

import numpy as np

from ..core import SHARD_WORDS
from ..executor.plan import parametrize, plan_inputs
from ..utils import devobs
from ..utils import profile as qprof
from ..utils.deadline import DeadlineExceeded, activate, current
from ..utils.faults import FAULTS
from ..utils.locks import make_condition, make_rlock
from ..utils.stats import BucketHistogram, NopStatsClient, ReservoirTimer
from ..utils.tracing import GLOBAL_TRACER

_EMPTY_PARAMS = np.zeros(0, dtype=np.int32)

# Total fused batch rows per launch: matrix tickets are pre-chunked by
# executor._batch_chunks to keep device temporaries bounded, but fusing k
# of them multiplies those temporaries by k — cap the fused row count so
# a burst of large prepared batches cannot exhaust the device.  A ticket
# that alone exceeds the cap launches un-fused.
FUSED_ROWS_MAX = 4096


class _Ticket:
    __slots__ = ("kind", "key", "params", "scalar", "payload", "ctx",
                 "enq", "future", "background", "trace", "prof",
                 "prof_node", "temp_weight")

    def __init__(self, kind, key, params, scalar, payload, background,
                 temp_weight: int = 0):
        self.kind = kind
        self.key = key
        self.params = params          # [B_local, P] int32
        self.scalar = scalar          # True: un-batched caller, gets p[i]
        self.payload = payload
        # device-temp bytes one fused batch row of this ticket costs (the
        # [B, S, rows, W] masked temporary of a filtered row count; 0 =
        # only the FUSED_ROWS_MAX cap applies)
        self.temp_weight = temp_weight
        self.ctx = current()          # the submitting query's deadline
        # trace + profile context cross the dispatcher-thread boundary
        # with the ticket: spans/stage events recorded at launch parent
        # under the submitting query
        self.trace = GLOBAL_TRACER.capture()
        self.prof, self.prof_node = qprof.capture()
        self.enq = time.monotonic()
        self.future = Future()
        self.background = background


class DispatchBatcher:
    """Front door for every stacked reducer dispatch and whole-query
    program launch.  Request threads call the same-named wrappers below
    instead of the StackedExecutor entry points; results stay unfetched
    device tensors, preserving the executor's dispatch-all-then-fetch-
    once pipeline."""

    def __init__(self, stacked, enabled: bool = True, max_batch: int = 32,
                 window_us: float = 200.0, stats=None, launch_lock=None):
        self.stacked = stacked
        self.enabled = enabled
        self.max_batch = max(int(max_batch), 1)
        self.window_s = max(float(window_us), 0.0) / 1e6
        self.stats = stats if stats is not None else NopStatsClient()
        self.launch_lock = launch_lock if launch_lock is not None \
            else make_rlock("batcher-launch")
        self._cond = make_condition("batcher", rlock=True)
        self._queue: list[_Ticket] = []
        self._thread: threading.Thread | None = None
        self._tid: int | None = None
        self._closed = False
        self._bg_local = threading.local()
        # observability (surfaced at /debug/vars + /metrics)
        self.fused_launches = 0
        self.single_launches = 0
        self.stream_fallbacks = 0
        self.expired_drops = 0
        self.temp_splits = 0  # fusion packs split by the temp workspace
        self.batch_size_hist = BucketHistogram([1, 2, 4, 8, 16, 32, 64])
        self.window_wait = ReservoirTimer(512)

    # -- lifecycle ---------------------------------------------------------

    def _ensure_thread(self):
        if self._thread is None:
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="ptpu-dispatch")
            self._thread = t
            self._tid = None
            t.start()

    def close(self):
        """Stop accepting tickets, drain the queue (remaining tickets
        still launch — their waiters are blocked on the futures), and
        join the dispatcher."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10)

    # -- routing -----------------------------------------------------------

    def _use_ticket(self) -> bool:
        # multi-process: per-rank windows would fuse DIFFERENT batch
        # shapes on different ranks and wedge the collectives;
        # dispatcher re-entrance would deadlock on its own queue
        return (self.enabled and not self.stacked.multiprocess
                and threading.get_ident() != self._tid)

    def _submit(self, kind, key, params, scalar, payload,
                temp_weight: int = 0):
        bg = getattr(self._bg_local, "flag", False)
        t = _Ticket(kind, key, np.ascontiguousarray(params, dtype=np.int32),
                    scalar, payload, bg, temp_weight=temp_weight)
        with self._cond:
            if self._closed:
                return None
            self._ensure_thread()
            self._queue.append(t)
            self._cond.notify_all()
        return t.future.result()

    def _call(self, fn, *args):
        """A direct (un-ticketed) launch, serialised with every other."""
        with self.launch_lock:
            return fn(*args)

    @contextmanager
    def background(self):
        """Mark this thread's submissions as background work (cache
        rebuilds, maintenance): counted separately, and the thread is
        expected to interleave ``yield_to_foreground()`` between units so
        it never starves foreground queries of the dispatcher."""
        self._bg_local.flag = True
        try:
            yield self
        finally:
            self._bg_local.flag = False

    def yield_to_foreground(self, max_wait: float = 0.05):
        """Bounded wait while foreground tickets are queued."""
        deadline = time.monotonic() + max_wait
        while time.monotonic() < deadline:
            with self._cond:
                busy = any(not t.background for t in self._queue)
            if not busy:
                return
            time.sleep(0.001)

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- public reducer surface (executor-facing) --------------------------

    def count_async(self, plan, holder, index, shards) -> list:
        st = self.stacked
        if not self._use_ticket():
            return self._call(st.count_async, plan, holder, index, shards)
        slotted, params = parametrize(plan)
        out = self._submit(
            "count",
            ("count", repr(slotted), index, tuple(shards), id(holder)),
            np.asarray(params, dtype=np.int32).reshape(1, -1), True,
            {"plan": plan, "slotted": slotted, "holder": holder,
             "index": index, "shards": list(shards)})
        if out is None:  # closed mid-flight: direct
            return self._call(st.count_async, plan, holder, index, shards)
        return out

    def segments(self, plan, holder, index, shards) -> dict:
        st = self.stacked
        if not self._use_ticket():
            return self._call(st.segments, plan, holder, index, shards)
        slotted, params = parametrize(plan)
        out = self._submit(
            "segments",
            ("segments", repr(slotted), index, tuple(shards), id(holder)),
            np.asarray(params, dtype=np.int32).reshape(1, -1), True,
            {"plan": plan, "slotted": slotted, "holder": holder,
             "index": index, "shards": list(shards)})
        if out is None:
            return self._call(st.segments, plan, holder, index, shards)
        return out

    def _filter_slotted(self, filter_plan):
        if filter_plan is None:
            return None, _EMPTY_PARAMS
        return parametrize(filter_plan)

    def _rowcount_weight(self, field, view, slotted, holder, index,
                         shards) -> int:
        """Per-fused-row device-temp bytes of a filtered row count
        ([S, rows, W] masked temporary) — the fusion packer's batch-temp
        workspace unit.  0 for the filter-less broadcast pass."""
        if slotted is None:
            return 0
        from .stacked import field_rows
        rows = field_rows(holder, index, field, view)
        return rows * self.stacked.stacked_per_device(len(shards)) \
            * SHARD_WORDS * 4

    def row_counts_async(self, field, view, filter_plan, holder, index,
                         shards) -> list:
        st = self.stacked
        args = (field, view, filter_plan, holder, index, shards)
        if not self._use_ticket():
            return self._call(st.row_counts_async, *args)
        slotted, params = self._filter_slotted(filter_plan)
        out = self._submit(
            "row_counts",
            ("row_counts", field, view, repr(slotted), index,
             tuple(shards), id(holder)),
            np.asarray(params, dtype=np.int32).reshape(1, -1), True,
            {"filter_plan": filter_plan, "slotted": slotted, "field": field,
             "view": view, "holder": holder, "index": index,
             "shards": list(shards)},
            temp_weight=self._rowcount_weight(field, view, slotted,
                                              holder, index, shards))
        if out is None:
            return self._call(st.row_counts_async, *args)
        return out

    def row_counts(self, field, view, filter_plan, holder, index,
                   shards) -> np.ndarray:
        return self.stacked.merge_counts(
            p.cpu().numpy() for p in self.row_counts_async(
                field, view, filter_plan, holder, index, shards))

    def bsi_sum_async(self, field, view, filter_plan, holder, index,
                      shards) -> list:
        st = self.stacked
        args = (field, view, filter_plan, holder, index, shards)
        if not self._use_ticket():
            return self._call(st.bsi_sum_async, *args)
        slotted, params = self._filter_slotted(filter_plan)
        out = self._submit(
            "bsi_sum",
            ("bsi_sum", field, view, repr(slotted), index, tuple(shards),
             id(holder)),
            np.asarray(params, dtype=np.int32).reshape(1, -1), True,
            {"filter_plan": filter_plan, "slotted": slotted, "field": field,
             "view": view, "holder": holder, "index": index,
             "shards": list(shards)})
        if out is None:
            return self._call(st.bsi_sum_async, *args)
        return out

    # reducers fusion does not touch: direct calls, so every dispatch
    # still flows through one front door (and one launch lock)
    def bsi_min_max(self, *args, **kwargs):
        with self.launch_lock:
            return self.stacked.bsi_min_max(*args, **kwargs)

    def group_counts_batch_async(self, *args, **kwargs):
        with self.launch_lock:
            return self.stacked.group_counts_batch_async(*args, **kwargs)

    # -- whole-query programs ----------------------------------------------

    _wq_nofuse = itertools.count()

    def whole_query(self, runner, program, mats, holder, index, shards):
        """One whole-query program launch.  Concurrent requests whose
        programs share a shape (same reducer tuple, index, shard set)
        fuse by concatenating each node's params matrix along the batch
        axis — the batched parameter axis rides the SAME program.
        Programs with non-batchable nodes (bsi_minmax, group_counts)
        launch un-fused."""
        args = (program, mats, holder, index, shards)
        if not self._use_ticket():
            return self._call(runner.run, *args)
        key = ("wholequery", repr(program), index, tuple(shards),
               id(holder))
        if not runner.fusible(program):
            # unique key: never coalesced with another ticket
            key = key + ("nofuse", next(self._wq_nofuse))
        rows = sum(m[0].shape[0] if isinstance(m, tuple) else m.shape[0]
                   for m in mats)
        # batch-temp weight: every FILTERED row_counts node of the
        # program adds a masked temporary per stacked shard — fusing
        # programs multiplies them, so the packer must see it
        from .stacked import field_rows
        weight = 0
        for node in program:
            if node.kind == "row_counts" and node.plan is not None:
                f_name, v_name = node.primary
                weight += (field_rows(holder, index, f_name, v_name)
                           * self.stacked.stacked_per_device(len(shards))
                           * SHARD_WORDS * 4)
        out = self._submit(
            "wholequery", key,
            np.zeros((max(rows, 1), 0), dtype=np.int32), False,
            {"runner": runner, "program": program, "mats": mats,
             "holder": holder, "index": index, "shards": list(shards)},
            temp_weight=weight)
        if out is None:  # closed mid-flight: direct
            return self._call(runner.run, *args)
        return out

    # -- matrix surface (_run_batched_groups / prepared replay) ------------

    def count_batch(self, slotted, params_mat, holder, index,
                    shards, fuse: bool = True) -> list:
        params_mat = np.asarray(params_mat, dtype=np.int32)
        if fuse and self._use_ticket():
            out = self._submit(
                "count",
                ("count", repr(slotted), index, tuple(shards), id(holder)),
                params_mat, False,
                {"slotted": slotted, "holder": holder, "index": index,
                 "shards": list(shards)})
            if out is not None:
                return out
        return self._call(self.stacked.count_batch_async, slotted,
                          params_mat, holder, index, shards)

    def row_counts_batch(self, field, view, slotted, params_mat, holder,
                         index, shards, fuse: bool = True) -> list:
        params_mat = np.asarray(params_mat, dtype=np.int32)
        if fuse and self._use_ticket():
            out = self._submit(
                "row_counts",
                ("row_counts", field, view, repr(slotted), index,
                 tuple(shards), id(holder)),
                params_mat, False,
                {"slotted": slotted, "field": field, "view": view,
                 "holder": holder, "index": index, "shards": list(shards)},
                temp_weight=self._rowcount_weight(field, view, slotted,
                                                  holder, index, shards))
            if out is not None:
                return out
        return self._call(self.stacked.row_counts_batch_async, field, view,
                          slotted, params_mat, holder, index, shards)

    def bsi_sum_batch(self, field, view, slotted, params_mat, holder,
                      index, shards, fuse: bool = True) -> list:
        params_mat = np.asarray(params_mat, dtype=np.int32)
        if fuse and self._use_ticket():
            out = self._submit(
                "bsi_sum",
                ("bsi_sum", field, view, repr(slotted), index,
                 tuple(shards), id(holder)),
                params_mat, False,
                {"slotted": slotted, "field": field, "view": view,
                 "holder": holder, "index": index, "shards": list(shards)})
            if out is not None:
                return out
        return self._call(self.stacked.bsi_sum_batch_async, field, view,
                          slotted, params_mat, holder, index, shards)

    # -- dispatcher --------------------------------------------------------

    def _loop(self):
        self._tid = threading.get_ident()
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return  # closed and drained
                # adaptive window: launch when full OR the oldest ticket
                # has waited its window (new arrivals re-check the gate)
                limit = self._queue[0].enq + self.window_s
                while not self._closed and \
                        len(self._queue) < self.max_batch:
                    now = time.monotonic()
                    if now >= limit:
                        break
                    self._cond.wait(limit - now)
                batch, self._queue = self._queue, []
            try:
                self._dispatch(batch)
            except BaseException as e:  # the loop must survive anything
                err = e if isinstance(e, Exception) else RuntimeError(
                    f"dispatcher aborted: {e!r}")
                for t in batch:
                    if not t.future.done():
                        t.future.set_exception(err)

    def _dispatch(self, batch):
        now = time.monotonic()
        groups: dict[tuple, list[_Ticket]] = {}
        for t in batch:
            self.window_wait.observe(now - t.enq)
            if t.prof is not None:
                # queue + coalesce wait, attributed under the stage the
                # query was in when it submitted (its dispatch node)
                t.prof.event("batcher.queue", now - t.enq,
                             node=t.prof_node, kind=t.kind)
            if t.background:
                self.stats.count("dispatch.background")
            ctx = t.ctx
            if ctx is not None and ctx.expired():
                # queued time counted against the budget: drop BEFORE the
                # launch — the waiter maps this to 504 at the HTTP edge
                try:
                    ctx.check("dispatch batch window")
                except DeadlineExceeded as e:
                    t.future.set_exception(e)
                else:  # pragma: no cover — expired() implies check raises
                    t.future.set_exception(DeadlineExceeded(
                        "query deadline exceeded in dispatch batch window"))
                self.expired_drops += 1
                self.stats.count("dispatch.expired_drop")
                continue
            groups.setdefault(t.key, []).append(t)
        from ..executor import executor as _exec_mod
        for key, tickets in groups.items():
            # foreground first, then pack under the ticket, fused-row,
            # and batch-temp-workspace caps; an over-cap ticket launches
            # alone (un-fused)
            tickets.sort(key=lambda t: t.background)
            pack: list[_Ticket] = []
            rows = 0
            temp = 0
            for t in tickets:
                n = t.params.shape[0]
                cost = n * t.temp_weight
                over_temp = pack and t.temp_weight > 0 and \
                    temp + cost > _exec_mod.BATCH_TEMP_BYTES
                if over_temp:
                    # fusing this ticket would exceed the batch-temp
                    # workspace: split the pack, visibly
                    self.temp_splits += 1
                    self.stats.count("dispatch.fused_temp_split")
                if pack and (len(pack) >= self.max_batch
                             or rows + n > FUSED_ROWS_MAX
                             or over_temp):
                    self._launch(key[0], pack)
                    pack, rows, temp = [], 0, 0
                pack.append(t)
                rows += n
                temp += cost
            if pack:
                self._launch(key[0], pack)

    def _fail_all(self, tickets, exc):
        for t in tickets:
            if not t.future.done():
                t.future.set_exception(exc)

    def _launch(self, kind, tickets, sched=None):
        self.batch_size_hist.observe(len(tickets))
        if len(tickets) == 1:
            t = tickets[0]
            try:
                # the ticket's QueryContext rides into the direct path so
                # deadline checks behave exactly as an un-batched call
                # would; trace + profile context re-attach so events and
                # spans parent under the query
                ltok = devobs.set_launch_ctx(
                    queue_s=max(time.monotonic() - t.enq, 0.0),
                    tickets=1, rows=t.params.shape[0])
                try:
                    with activate(t.ctx), GLOBAL_TRACER.attach(t.trace), \
                            qprof.activate(t.prof), self.launch_lock:
                        t0 = time.perf_counter()
                        result = self._direct(t, sched)
                        if t.prof is not None:
                            t.prof.event("batcher.launch",
                                         time.perf_counter() - t0,
                                         node=t.prof_node, kind=t.kind,
                                         fused=False)
                finally:
                    devobs.reset_launch_ctx(ltok)
            except BaseException as e:
                t.future.set_exception(
                    e if isinstance(e, Exception)
                    else RuntimeError(repr(e)))
                return
            self.single_launches += 1
            self.stats.count("dispatch.launch.single")
            t.future.set_result(result)
            return
        self._launch_fused(kind, tickets)

    def _direct(self, t, sched=None):
        """Un-fused launch: scalar tickets take the un-batched reducers,
        which stream over their own shard schedule; matrix tickets take
        their batched reducer directly, once per slice of ``sched`` (a
        multi-slice schedule the fused launch refused) or over all of
        the ticket's shards, and return every slice's parts."""
        p = t.payload
        st = self.stacked
        if t.kind == "wholequery":
            return p["runner"].run(p["program"], p["mats"], p["holder"],
                                   p["index"], p["shards"])
        if t.scalar:
            if t.kind == "count":
                return st.count_async(p["plan"], p["holder"], p["index"],
                                      p["shards"])
            if t.kind == "segments":
                return st.segments(p["plan"], p["holder"], p["index"],
                                   p["shards"])
            if t.kind == "row_counts":
                return st.row_counts_async(
                    p["field"], p["view"], p["filter_plan"], p["holder"],
                    p["index"], p["shards"])
            return st.bsi_sum_async(
                p["field"], p["view"], p["filter_plan"], p["holder"],
                p["index"], p["shards"])
        parts = []
        for sl in (sched if sched is not None else [p["shards"]]):
            if t.kind == "count":
                parts.extend(st.count_batch_async(
                    p["slotted"], t.params, p["holder"], p["index"], sl))
            elif t.kind == "row_counts":
                parts.extend(st.row_counts_batch_async(
                    p["field"], p["view"], p["slotted"], t.params,
                    p["holder"], p["index"], sl))
            else:
                parts.extend(st.bsi_sum_batch_async(
                    p["field"], p["view"], p["slotted"], t.params,
                    p["holder"], p["index"], sl))
        return parts

    def _note_fused(self, tickets, dur_s, batch_rows=0):
        """Attribute one fused launch back to EVERY participating query:
        a profile event under each ticket's captured node and a
        synthesized span under each sampled trace."""
        for t in tickets:
            if t.prof is not None:
                t.prof.event("batcher.launch", dur_s, node=t.prof_node,
                             kind=t.kind, fused=True,
                             batchTickets=len(tickets),
                             batchRows=batch_rows,
                             ticketRows=t.params.shape[0])
            if t.trace is not None and t.trace.sampled:
                GLOBAL_TRACER.record_span(
                    "dispatch.fused_launch", t.trace.trace_id,
                    t.trace.span_id, dur_s,
                    {"kind": t.kind, "tickets": len(tickets),
                     "batchRows": batch_rows},
                    collect=t.trace.collect)

    def _launch_fused_whole(self, tickets):
        """Fuse same-shape whole-query programs: concatenate each node's
        params matrix along the batch axis and run the shared program
        ONCE; per-ticket results are batch-axis slices
        (WholeOut.slice_batch).  Fusibility (batch-kind nodes only) was
        decided at ticket creation via the key."""
        p0 = tickets[0].payload
        runner = p0["runner"]
        program = p0["program"]
        t_launch0 = time.perf_counter()
        try:
            n_nodes = len(program)
            node_mats, node_lo = [], []
            for ni in range(n_nodes):
                mats_n = [t.payload["mats"][ni] for t in tickets]
                lows, lo = [], 0
                for m in mats_n:
                    lows.append(lo)
                    lo += m.shape[0]
                node_lo.append(lows)
                node_mats.append(np.concatenate(mats_n)
                                 if len(mats_n) > 1 else mats_n[0])
            B = sum(m.shape[0] for m in node_mats)
            queue_s = max(time.monotonic()
                          - min(t.enq for t in tickets), 0.0)
            ltok = devobs.set_launch_ctx(queue_s=queue_s,
                                         tickets=len(tickets), rows=B)
            try:
                with self.launch_lock:
                    out = runner.run(program, node_mats, p0["holder"],
                                     p0["index"], p0["shards"])
            finally:
                devobs.reset_launch_ctx(ltok)
            self._note_fused(tickets, time.perf_counter() - t_launch0,
                             batch_rows=B)
            for ti, t in enumerate(tickets):
                t.future.set_result(out.slice_batch(
                    program,
                    [node_lo[ni][ti] for ni in range(n_nodes)],
                    [t.payload["mats"][ni].shape[0]
                     for ni in range(n_nodes)]))
        except BaseException as e:
            from .wholequery import WholeQueryUnsupported
            if isinstance(e, WholeQueryUnsupported) and \
                    e.node == "streamed-working-set":
                self.stream_fallbacks += 1
                self.stats.count("dispatch.launch.stream_fallback")
            self._fail_all(tickets, e if isinstance(e, Exception)
                           else RuntimeError(repr(e)))
            return
        self.fused_launches += 1
        self.stats.count("dispatch.launch.fused")
        self.stats.count("dispatch.fused_queries", len(tickets))

    def _schedule(self, kind, p):
        """The shard schedule of a reducer ticket's key list."""
        st = self.stacked
        if kind in ("count", "segments"):
            kl, fo = plan_inputs(p["slotted"]), frozenset()
        else:
            primary = (p["field"], p["view"])
            kl = st.batch_keys(primary, p["slotted"])
            fo = st.fused_only(primary, p["slotted"]) \
                if kind == "row_counts" else frozenset()
        return st.shard_schedule(p["holder"], p["index"], [kl],
                                 p["shards"], [fo])

    def _launch_fused(self, kind, tickets):
        if kind == "wholequery":
            return self._launch_fused_whole(tickets)
        p0 = tickets[0].payload
        st = self.stacked
        t_launch0 = time.perf_counter()
        try:
            # an over-budget working set streams in shard slices — the
            # fused single-slice path would stage it whole, so stream
            # each ticket through its direct path instead
            sched = self._schedule(kind, p0)
            if len(sched.slices) > 1:
                self.stream_fallbacks += 1
                self.stats.count("dispatch.launch.stream_fallback")
                for t in tickets:
                    self._launch(kind, [t], sched)
                return
            # one failpoint gate per fused launch, matching the
            # per-slice gate of the direct path
            FAULTS.hit("mesh.slice", key=p0["index"])
            mats = [t.params for t in tickets]
            mat = np.concatenate(mats) if len(mats) > 1 else mats[0]
            B = mat.shape[0]
            queue_s = max(time.monotonic()
                          - min(t.enq for t in tickets), 0.0)
            ltok = devobs.set_launch_ctx(queue_s=queue_s,
                                         tickets=len(tickets), rows=B)
            try:
                with self.launch_lock:
                    if kind == "count":
                        parts = st.count_batch_async(
                            p0["slotted"], mat, p0["holder"], p0["index"],
                            p0["shards"])
                    elif kind == "row_counts":
                        parts = st.row_counts_batch_async(
                            p0["field"], p0["view"], p0["slotted"], mat,
                            p0["holder"], p0["index"], p0["shards"])
                    elif kind == "bsi_sum":
                        parts = st.bsi_sum_batch_async(
                            p0["field"], p0["view"], p0["slotted"], mat,
                            p0["holder"], p0["index"], p0["shards"])
                    else:  # segments
                        by_shard = st.segments_batch(
                            p0["slotted"], mat, p0["holder"], p0["index"],
                            p0["shards"])
            finally:
                devobs.reset_launch_ctx(ltok)
            # attribute the launch BEFORE resolving any future: once a
            # future resolves, its owner thread may serialize the profile
            self._note_fused(tickets, time.perf_counter() - t_launch0,
                             batch_rows=B)
            lo = 0
            for t in tickets:
                n = t.params.shape[0]
                if kind == "segments":   # always scalar (B = 1)
                    t.future.set_result(
                        {shard: arr[lo] for shard, arr in by_shard.items()})
                elif t.scalar:
                    t.future.set_result([part[lo] for part in parts])
                else:
                    t.future.set_result(
                        [part[lo: lo + n] for part in parts])
                lo += n
        except BaseException as e:
            self._fail_all(tickets, e if isinstance(e, Exception)
                           else RuntimeError(repr(e)))
            return
        self.fused_launches += 1
        self.stats.count("dispatch.launch.fused")
        self.stats.count("dispatch.fused_queries", len(tickets))

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "maxBatch": self.max_batch,
            "windowUs": round(self.window_s * 1e6, 1),
            "queued": self.pending(),
            "fusedLaunches": self.fused_launches,
            "singleLaunches": self.single_launches,
            "streamFallbacks": self.stream_fallbacks,
            "expiredDrops": self.expired_drops,
            "tempSplits": self.temp_splits,
            "batchSize": self.batch_size_hist.snapshot(),
            "windowWaitS": self.window_wait.snapshot(),
        }

    def prometheus_text(self) -> str:
        lines = self.batch_size_hist.prometheus_lines(
            "pilosa_tpu_dispatch_batch_size")
        ws = self.window_wait.snapshot()
        lines.append("# TYPE pilosa_tpu_dispatch_window_wait_seconds "
                     "summary")
        for q, v in (("0.5", ws["p50"]), ("0.99", ws["p99"])):
            if v is not None:
                lines.append(
                    f'pilosa_tpu_dispatch_window_wait_seconds'
                    f'{{quantile="{q}"}} {v:.6g}')
        lines.append("pilosa_tpu_dispatch_window_wait_seconds_count "
                     f"{ws['count']}")
        return "\n".join(lines) + "\n"
