"""Group commit for the streaming ingest path (docs/ingest.md).

Every ingest request used to become one ``bulk_import`` per fragment per
HTTP call: one WAL frame, one generation bump, and one rank-cache
recount EACH — at millions of events/sec the per-call bookkeeping, not
the bit merge, is the write ceiling.  The committer accumulates records
across requests (and across concurrent connections) and flushes them in
batches: one flush = one ``Field.ingest_import`` per touched field = ONE
WAL frame + ONE gen bump + ONE rank-cache touch per fragment, riding the
CRC-framed WAL append, which is exactly this group-commit unit
(storage/fragment.py ``_log_ops``).

Acknowledgement contract: ``submit`` only records; the HTTP handler acks
its response AFTER ``wait_flushed`` returns for the last submitted
sequence — i.e. a 200 means every frame of the request hit the WAL (the
kill -9 harness in tests/test_ingest.py holds this to zero acked-frame
loss).  Flushes trigger on pending bytes, pending records, or the
``ingest-flush-ms`` timer, whichever first.

Backpressure: ``wait_capacity`` blocks admission of further frames while
the unflushed backlog exceeds its high-water mark, so a slow device
merge propagates to the socket as a bounded wait and then a 503 +
Retry-After (handler).  The flush loop is also the subsystem's only
cross-fragment journal folder (the "background merge"): it folds
fragments when the process-wide delta budget
(membudget.INGEST_DELTA_LIMIT_BYTES) runs over, and retires journals
that have gone idle for several flushes — in batches, never per bit.

Port copy of the JAX package's ``ingest/committer.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from datetime import datetime, timezone

import numpy as np

from ..core import SHARD_WIDTH, VIEW_STANDARD
from ..storage import membudget as _membudget
from ..utils.faults import FAULTS
from ..utils.locks import make_condition, make_lock


class _Pending:
    __slots__ = ("rows", "cols", "ts", "values", "nbytes")

    def __init__(self):
        self.rows: list = []
        self.cols: list = []
        self.ts: list = []
        self.values: list = []
        self.nbytes = 0


class GroupCommitter:
    """One per server.  ``flush_ms <= 0`` flushes synchronously inside
    ``wait_flushed`` (no background thread — tests and tiny tools)."""

    # flush when the pending batch crosses either threshold, without
    # waiting out the timer
    FLUSH_BYTES = 8 << 20
    FLUSH_RECORDS = 1 << 18
    # backlog high-water: wait_capacity blocks above this
    HIGH_WATER_BYTES = 32 << 20
    # flush cycles a fragment's journal may sit idle before the merge
    # pass folds it (bounds how long queries pay the overlay OR)
    MERGE_IDLE_FLUSHES = 16

    def __init__(self, holder, flush_ms: float = 50.0, stats=None,
                 flush_bytes: int | None = None,
                 flush_records: int | None = None,
                 high_water_bytes: int | None = None):
        self.holder = holder
        self.flush_ms = flush_ms
        self.stats = stats
        if flush_bytes is not None:
            self.FLUSH_BYTES = flush_bytes
        if flush_records is not None:
            self.FLUSH_RECORDS = flush_records
        if high_water_bytes is not None:
            self.HIGH_WATER_BYTES = high_water_bytes
        self._cond = make_condition("committer")
        # Serializes whole flushes (take -> apply -> ack).  Without it,
        # two inline-mode (flush_ms <= 0) callers could interleave: the
        # second takes an EMPTY pending set stamped with the first's
        # covering sequence and advances _flushed_seq before the first
        # has written its WAL frames — acking undurable data.
        self._flush_lock = make_lock("committer-flush")
        self._pend: dict[tuple[str, str], _Pending] = {}
        self._pend_bytes = 0
        self._pend_records = 0
        self._submit_seq = 0     # last sequence handed out
        self._flushed_seq = 0    # last sequence covered by a flush
        self._flush_no = 0
        # covering seq -> (seq the previous flush covered, error): an
        # error is attributed to the (start, end] submission range its
        # flush actually applied, so a producer whose records an EARLIER
        # flush committed never sees a later flush's failure
        self._flush_errors: dict[int, tuple[int, Exception]] = {}
        # fragments with live overlay journals -> last flush_no touched
        self._journal_frags: dict = {}
        self._closing = False
        self._thread = None
        # lifetime counters (snapshot() -> /debug/vars ingest section)
        self.flushes = 0
        self.records_total = 0
        self.folds = 0
        # backpressure episode latch: engage journaled at the first
        # refusal, release at the flush that drains under the mark
        self._backpressure = False

    def _ensure_thread(self):
        if self._thread is None and self.flush_ms > 0:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ptpu-ingest-commit")
            self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, index: str, field: str, rows=None, cols=None,
               ts=None, values=None) -> int:
        """Record a batch for the next flush; returns the sequence the
        caller must ``wait_flushed`` on before acking."""
        cols = np.asarray(cols, dtype=np.int64)
        with self._cond:
            if self._closing:
                raise RuntimeError("ingest committer is closed")
            p = self._pend.setdefault((index, field), _Pending())
            nbytes = int(cols.nbytes)
            p.cols.append(cols)
            if values is not None:
                values = np.asarray(values, dtype=np.int64)
                p.values.append(values)
                nbytes += int(values.nbytes)
            else:
                rows = np.asarray(rows, dtype=np.int64)
                p.rows.append(rows)
                nbytes += int(rows.nbytes)
                # ts always appended (zeros = untimed) so the flush's
                # concatenation stays aligned with rows across batches
                # that mix timed and untimed records
                if ts is not None:
                    ts = np.asarray(ts, dtype=np.int64)
                else:
                    ts = np.zeros(rows.size, dtype=np.int64)
                p.ts.append(ts)
                nbytes += int(ts.nbytes)
            p.nbytes += nbytes
            self._pend_bytes += nbytes
            self._pend_records += int(cols.size)
            self._submit_seq += 1
            seq = self._submit_seq
            if self._pend_bytes >= self.FLUSH_BYTES or \
                    self._pend_records >= self.FLUSH_RECORDS:
                self._cond.notify_all()  # wake the flusher early
            self._ensure_thread()
            return seq

    def wait_flushed(self, seq: int, timeout: float | None = 30.0) -> bool:
        """Block until a flush covering ``seq`` completed; raises the
        flush's error if applying it failed (the producer must NOT ack).
        With no flusher thread (flush_ms <= 0) this flushes inline."""
        if self.flush_ms <= 0:
            self._flush_once()
        with self._cond:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while self._flushed_seq < seq:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.notify_all()
                self._cond.wait(0.05 if left is None else min(left, 0.05))
            err = None
            for fseq, (start, e) in self._flush_errors.items():
                if start < seq <= fseq:
                    err = e
            if err is not None:
                raise err
            return True

    def pending_bytes(self) -> int:
        with self._cond:
            return self._pend_bytes

    def wait_capacity(self, timeout: float = 0.5) -> bool:
        """Backpressure gate: True when the unflushed backlog is under
        the high-water mark (possibly after waiting for a flush), False
        when the producer should be rejected with 503 + Retry-After.
        The ENGAGE transition (first refusal of a backpressure episode)
        is journaled; the matching RELEASE is journaled by the flush
        that drains the backlog back under the mark."""
        deadline = time.monotonic() + timeout
        engaged = False
        with self._cond:
            while self._pend_bytes >= self.HIGH_WATER_BYTES:
                self._cond.notify_all()
                left = deadline - time.monotonic()
                if left <= 0 or self.flush_ms <= 0:
                    if not self._backpressure:
                        self._backpressure = True
                        engaged = True
                    break
                self._cond.wait(min(left, 0.05))
            else:
                return True
        if engaged:
            from ..utils import events
            events.emit("ingest.backpressure_engage",
                        backlogBytes=self._pend_bytes,
                        highWaterBytes=self.HIGH_WATER_BYTES)
        return False

    # -- flusher side ------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                if self._closing and not self._pend:
                    return
                # group window: submits coalesce for up to flush_ms (a
                # threshold crossing or a parked wait_flushed producer
                # notifies early — classic group commit)
                if not (self._closing
                        or self._pend_bytes >= self.FLUSH_BYTES
                        or self._pend_records >= self.FLUSH_RECORDS):
                    self._cond.wait(self.flush_ms / 1e3)
            try:
                self._flush_once()
            # lint: allow(swallowed-exception) — per-flush errors are
            # recorded per covering sequence inside _flush_once and
            # re-raised to every waiter in its submission range
            except Exception:
                pass

    def _take_pending(self):
        with self._cond:
            pend, self._pend = self._pend, {}
            seq = self._submit_seq
            self._pend_bytes = 0
            self._pend_records = 0
        return pend, seq

    def _flush_once(self):
        with self._flush_lock:
            self._flush_once_locked()

    def _flush_once_locked(self):
        t0 = time.perf_counter()
        start_seq = self._flushed_seq
        pend, seq = self._take_pending()
        if pend:
            # crash window BEFORE any WAL append of this flush: a kill
            # here loses only unacked frames (tests/test_ingest.py)
            FAULTS.hit("ingest.flush", key=str(self._flush_no))
        err: Exception | None = None
        n_records = 0
        touched: list = []
        for (index, field), p in pend.items():
            try:
                touched.extend(self._apply(index, field, p))
                n_records += sum(int(c.size) for c in p.cols)
            except Exception as e:  # quarantine, validation, deleted field
                err = e
        if pend:
            # crash window AFTER the WAL appends, BEFORE ackers release:
            # data is durable but never acked — allowed (idempotent)
            FAULTS.hit("ingest.flush.ack", key=str(self._flush_no))
        with self._cond:
            if pend:
                # _flush_no counts DATA flushes only: the merge-idle
                # policy is "N flushes of OTHER data since this journal
                # was touched", not wall-clock timer ticks — an idle
                # server must not fold (and force restacks for)
                # journals nothing has superseded
                self._flush_no += 1
                self.flushes += 1
                self.records_total += n_records
            if err is not None and seq > start_seq:
                self._flush_errors[seq] = (start_seq, err)
                if len(self._flush_errors) > 64:
                    self._flush_errors.pop(next(iter(self._flush_errors)))
            self._flushed_seq = max(self._flushed_seq, seq)
            for frag in touched:
                self._journal_frags[frag] = self._flush_no
            released = self._backpressure \
                and self._pend_bytes < self.HIGH_WATER_BYTES
            if released:
                self._backpressure = False
            self._cond.notify_all()
        if released:
            from ..utils import events
            events.emit("ingest.backpressure_release",
                        backlogBytes=self.pending_bytes())
        if pend and self.stats is not None:
            self.stats.timing("ingest.flush", time.perf_counter() - t0)
            self.stats.count("ingest.flushes")
        self._merge_pass()

    def _apply(self, index: str, field: str, p: _Pending) -> list:
        """One field's flush batch -> one grouped import; returns the
        fragments that now hold overlay journals (merge-pass tracking)."""
        idx = self.holder.index(index)
        f = idx.field(field) if idx is not None else None
        if f is None:
            raise ValueError(f"ingest: unknown field {index}/{field}")
        cols = np.concatenate(p.cols)
        if p.values:
            f.import_values(cols, np.concatenate(p.values))
            idx.add_existence(np.unique(cols))
            return []
        rows = np.concatenate(p.rows)
        ts_list = None
        if p.ts and f.options.time_quantum:
            ts_arr = np.concatenate(p.ts)
            if np.any(ts_arr != 0):
                ts_list = [None if t == 0 else
                           datetime.fromtimestamp(int(t), timezone.utc)
                           .replace(tzinfo=None) for t in ts_arr]
        f.ingest_import(rows, cols, ts_list)
        idx.add_existence(np.unique(cols))
        out = []
        v = f.view(VIEW_STANDARD)
        if v is not None:
            for shard in np.unique(cols // SHARD_WIDTH):
                frag = v.fragment(int(shard))
                if frag is not None and frag.delta_bytes() > 0:
                    out.append(frag)
        return out

    def _merge_pass(self):
        """Background merge, in batches: fold overlay journals when the
        process-wide delta budget runs over (coldest first) or when a
        journal has sat idle for MERGE_IDLE_FLUSHES flushes.  This is
        the ONLY cross-fragment folder — single-threaded, taking one
        fragment lock at a time, so folding can never order fragment
        locks against each other."""
        with self._cond:
            frags = list(self._journal_frags.items())
            flush_no = self._flush_no
        limit = _membudget.INGEST_DELTA_LIMIT_BYTES
        over = limit > 0 and \
            _membudget.INGEST_DELTA_BUDGET.resident_bytes > limit
        folded = []
        for frag, last in sorted(frags, key=lambda kv: kv[1]):
            idle = flush_no - last >= self.MERGE_IDLE_FLUSHES
            if not (over or idle):
                continue
            if frag.fold_delta():
                self.folds += 1
            folded.append(frag)
            if over:
                over = _membudget.INGEST_DELTA_BUDGET.resident_bytes \
                    > limit
        if folded:
            with self._cond:
                for frag in folded:
                    self._journal_frags.pop(frag, None)

    def merge_all(self):
        """Fold every live overlay journal now (tests, drain)."""
        with self._cond:
            frags = list(self._journal_frags)
            self._journal_frags.clear()
        for frag in frags:
            if frag.fold_delta():
                self.folds += 1

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "flushMs": self.flush_ms,
                "pendingBytes": self._pend_bytes,
                "pendingRecords": self._pend_records,
                "flushes": self.flushes,
                "recordsTotal": self.records_total,
                "folds": self.folds,
                "journalFragments": len(self._journal_frags),
                "journalBytes":
                    _membudget.INGEST_DELTA_BUDGET.resident_bytes,
            }

    def close(self):
        """Final flush, then stop.  Journals stay live — fragment close
        folds through the normal snapshot path."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._flush_once()
