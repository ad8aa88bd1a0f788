"""Device-runtime observability: the capture registry and the launch
ledger (docs/observability.md "Device runtime") — the port of the JAX
package's ``utils/devobs.py``.

* ``CompileRegistry`` (process-wide ``COMPILES``): on the card a capture
  is a compile.  ``WholeQueryRunner._capture`` (parallel/wholequery.py)
  notes every CUDA graph capture of a whole-query program with its
  capture seconds and the shape fingerprint of its padded params and
  staged inputs.  Per signature: captures, cumulative/last capture wall
  time, the last fingerprint.  A retrace is a visible red flag
  (structured ``Logger.event`` with the fingerprint diff, a
  ``device.retrace`` span under the active trace, the
  ``device.retraces_total`` gauge).

* ``LaunchLedger`` (process-wide ``LEDGER``): a bounded ring of recent
  device launches — signature, batch/group size, padded vs actual rows
  (the pow2 padding of replayed params becomes a measured ratio), decode
  bytes, slice position, and the queue-vs-dispatch wall split — plus the
  launch/queue-wait histograms exported at /metrics
  (``pilosa_tpu_device_launch_seconds`` etc.) and the aggregates served
  at /debug/launches.  ``record`` is the JAX module's, padding math
  included.

Deviations from the JAX module:

* No trace detector.  JAX runs a traced body only while tracing, so the
  JAX registry's ``begin_call`` / ``mark_traced`` / ``traced`` find a
  compile from inside the body.  A CUDA graph capture is explicit: the
  runner knows when it captures and calls ``note_call`` then.

* The retrace rule.  The port's graph key holds the identity of the
  staged tensors, so an ingest overlay, a re-stage or a resize drops
  graphs and captures them again where the JAX package re-uses its
  executable.  A capture counts as a retrace when its signature was
  captured before and either its shape fingerprint is one this
  signature was never captured with, or the graph it replaces was
  evicted by the runner's LRU (``graphs_max``) while its staged inputs
  stayed the same (``evicted=True``).  A capture with a fingerprint the
  signature already had, over re-staged inputs, is a compile but not a
  retrace.  Two consequences differ from the JAX package: the port does
  not pad the shard axis to mesh buckets, so each distinct shard count
  of one program is a fingerprint of its own (the JAX package's 2 and 9
  shards bucket to 8 and 16); and a signature seen once runs eagerly
  and is captured on its second sighting, so a shape seen once never
  counts.  The fingerprint of a packed stack is its slot map only: the
  kernels take a ragged stack, so its container and payload lengths are
  data, not shape.

Timing discipline: every duration here comes from perf_counter pairs
taken by the instrumented call sites; ``_wall_stamp`` is display-only
correlation, never subtracted.
"""

from __future__ import annotations

import contextvars
import hashlib
import time
from collections import OrderedDict, deque

from .locks import make_lock
from .stats import BucketHistogram


def _wall_stamp() -> float: return time.time()  # display-only wall clock


def fingerprint(args) -> str:
    """Compact argument-shape fingerprint of one program call —
    ``8x4:int32|16x12x32768:int32|...`` — the thing a retrace diffs."""
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is None:
            parts.append(type(a).__name__)
        else:
            dtype = str(getattr(a, "dtype", "?")).removeprefix("torch.")
            parts.append("x".join(str(d) for d in shape) + ":" + dtype)
    return "|".join(parts)


def sig_of(key) -> str:
    """Stable short id for a program cache key: ``<kind>:<10-hex>``."""
    kind = key[0] if isinstance(key, tuple) and key else "exec"
    digest = hashlib.sha1(repr(key).encode()).hexdigest()[:10]
    return f"{kind}:{digest}"


class CompileRegistry:
    """Per-signature capture/retrace telemetry (the module docstring
    states the retrace rule)."""

    MAX_ENTRIES = 512     # bounds /debug/compiles (LRU on capture recency)
    MAX_FINGERPRINTS = 64  # distinct shapes remembered per signature

    def __init__(self):
        self._lock = make_lock("compile-registry")
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._fps: dict[str, OrderedDict] = {}
        self.compiles_total = 0
        self.retraces_total = 0
        self.compile_seconds_total = 0.0
        # Server injects its Logger so retraces land in the server log;
        # None (a standalone executor) keeps the registry silent.
        self.logger = None

    def note_call(self, sig: str, kind: str, dur_s: float, fp: str,
                  detail: str = "", evicted: bool = False) -> bool:
        """Fold one capture.  ``evicted``: the capture replaces a graph
        the LRU evicted over the same staged inputs.  Returns True when
        it is a retrace."""
        retrace = None
        with self._lock:
            e = self._entries.get(sig)
            if e is None:
                while len(self._entries) >= self.MAX_ENTRIES:
                    old, _ = self._entries.popitem(last=False)
                    self._fps.pop(old, None)
                e = {"sig": sig, "kind": kind, "detail": detail,
                     "compiles": 0, "totalCompileS": 0.0,
                     "lastCompileS": 0.0, "lastFingerprint": "",
                     "lastCompileWall": 0.0, "retraces": 0}
                self._entries[sig] = e
            else:
                self._entries.move_to_end(sig)
            fps = self._fps.setdefault(sig, OrderedDict())
            prev_fp = e["lastFingerprint"]
            is_retrace = e["compiles"] > 0 and (evicted or fp not in fps)
            fps[fp] = None
            fps.move_to_end(fp)
            while len(fps) > self.MAX_FINGERPRINTS:
                fps.popitem(last=False)
            e["compiles"] += 1
            e["totalCompileS"] += dur_s
            e["lastCompileS"] = dur_s
            e["lastFingerprint"] = fp
            e["lastCompileWall"] = _wall_stamp()
            self.compiles_total += 1
            self.compile_seconds_total += dur_s
            if is_retrace:
                e["retraces"] += 1
                self.retraces_total += 1
                retrace = (prev_fp, e["compiles"])
        if retrace is None:
            return False
        prev_fp, n = retrace
        # journal the retrace: the fleet timeline is where a retrace
        # burst correlates with the p99 spike it caused; emit() never
        # raises
        from . import events
        events.emit("device.retrace", sig=sig, kind=kind, compiles=n,
                    shapes=fp, evicted=evicted)
        # telemetry sinks must never take the query path down: the
        # injected logger outlives its Server (process-global registry)
        log = self.logger
        if log is not None:
            try:
                log.event("device.retrace", sig=sig, kind=kind,
                          compiles=n, compileS=round(dur_s, 4),
                          prevShapes=prev_fp, shapes=fp)
            # lint: allow(swallowed-exception) — a stale/closed log
            # stream costs a log line, never the launch; the retrace is
            # still counted above
            except Exception:
                pass
        try:
            from .tracing import GLOBAL_TRACER
            ctx = GLOBAL_TRACER.current()
            if ctx is not None and ctx.sampled:
                GLOBAL_TRACER.record_span(
                    "device.retrace", ctx.trace_id, ctx.span_id, dur_s,
                    {"sig": sig, "kind": kind, "compiles": n,
                     "prevShapes": prev_fp, "shapes": fp},
                    collect=ctx.collect)
        # lint: allow(swallowed-exception) — span synthesis is
        # best-effort decoration; tracing must never fail a launch
        except Exception:
            pass
        return True

    def totals(self) -> dict:
        with self._lock:
            return {"compiles": self.compiles_total,
                    "retraces": self.retraces_total,
                    "compileSecondsTotal": round(
                        self.compile_seconds_total, 4),
                    "executables": len(self._entries)}

    def snapshot(self) -> dict:
        """/debug/compiles: totals + per-signature entries, most recent
        capture last."""
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
        out = self.totals()
        out["entries"] = entries
        return out


# -- launch context (batcher -> ledger) -------------------------------------
# The dispatcher thread knows the queue wait and ticket count of the
# launch it is about to make; the runner it calls into reads them here.

_LAUNCH_CTX: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("pilosa_tpu_launch_ctx", default=None)
# Streaming slice position, set by stacked._ShardSchedule around each
# yielded slice: (slice_index, slice_count).
_SLICE: contextvars.ContextVar[tuple | None] = \
    contextvars.ContextVar("pilosa_tpu_launch_slice", default=None)


def set_launch_ctx(queue_s: float = 0.0, tickets: int = 1,
                   rows: int | None = None):
    """Annotate subsequent launches on this thread of execution (the
    batcher's dispatcher sets it per launch); returns a reset token."""
    return _LAUNCH_CTX.set(
        {"queue_s": queue_s, "tickets": tickets, "rows": rows})


def reset_launch_ctx(token):
    _LAUNCH_CTX.reset(token)


def launch_ctx() -> dict | None:
    return _LAUNCH_CTX.get()


def set_slice(idx: int | None, count: int | None = None):
    _SLICE.set(None if idx is None else (idx, count))


def current_slice() -> tuple | None:
    return _SLICE.get()


class LaunchLedger:
    """Bounded ring of recent device launches + always-on aggregates.

    One entry per whole-query run (eager or graph replay) and per
    standalone decode.  ``rows`` are launch units — shard rows x query
    rows — so the pow2 padding of replayed params shows in one waste
    ratio."""

    def __init__(self, size: int = 256):
        self._lock = make_lock("launch-ledger")
        self.size = max(int(size), 1)
        self._ring: deque = deque(maxlen=self.size)
        self.launches_total = 0
        self.rows_actual_total = 0
        self.rows_padded_total = 0
        self.decode_peak_bytes = 0   # high-watermark of per-launch decode
        self.decode_bytes_total = 0
        # container-kernel accounting (ops/kernels.py): kernel launches
        # the runs made and the container tiles those kernels walked
        self.kernel_launches_total = 0
        self.kernel_tiles_total = 0
        self.launch_hist = BucketHistogram(
            [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0])
        self.queue_hist = BucketHistogram(
            [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05,
             0.1, 0.5])

    def resize(self, size: int):
        """Apply launch-ledger-size (most recent Server's config wins);
        keeps the newest entries."""
        size = max(int(size), 1)
        with self._lock:
            if size != self.size:
                self._ring = deque(self._ring, maxlen=size)
                self.size = size

    def record(self, *, sig: str, kind: str, shards: int,
               shards_padded: int, batch_rows: int,
               batch_rows_padded: int, queue_s: float, dispatch_s: float,
               decode_bytes: int, compiled: bool, tickets: int = 1,
               slice_pos: tuple | None = None, kernel_launches: int = 0,
               kernel_tiles: int = 0):
        actual = max(shards, 0) * max(batch_rows, 1)
        total = max(shards_padded, shards) * max(batch_rows_padded,
                                                 batch_rows, 1)
        padded = max(total - actual, 0)
        entry = {
            "wall": _wall_stamp(), "sig": sig, "kind": kind,
            "shards": shards, "shardsPadded": shards_padded,
            "batchRows": batch_rows, "batchRowsPadded": batch_rows_padded,
            "rowsActual": actual, "rowsPadded": padded,
            "queueS": round(queue_s, 6), "dispatchS": round(dispatch_s, 6),
            "decodeBytes": decode_bytes, "compiled": compiled,
            "tickets": tickets,
        }
        if slice_pos is not None:
            entry["slice"] = slice_pos[0]
            entry["slices"] = slice_pos[1]
        if kernel_launches:
            entry["kernelLaunches"] = kernel_launches
            entry["kernelTiles"] = kernel_tiles
        with self._lock:
            self._ring.append(entry)
            self.launches_total += 1
            self.rows_actual_total += actual
            self.rows_padded_total += padded
            self.decode_bytes_total += decode_bytes
            self.decode_peak_bytes = max(self.decode_peak_bytes,
                                         decode_bytes)
            self.kernel_launches_total += kernel_launches
            self.kernel_tiles_total += kernel_tiles
        self.launch_hist.observe(dispatch_s)
        if queue_s > 0:
            self.queue_hist.observe(queue_s)

    def reset_decode_peak(self):
        """Restart the decode high-watermark, so each leg reports its
        own peak."""
        with self._lock:
            self.decode_peak_bytes = 0

    def padding_waste_ratio(self) -> float:
        with self._lock:
            total = self.rows_actual_total + self.rows_padded_total
            return self.rows_padded_total / total if total else 0.0

    def aggregates(self) -> dict:
        with self._lock:
            total = self.rows_actual_total + self.rows_padded_total
            return {
                "launches": self.launches_total,
                "rowsActual": self.rows_actual_total,
                "rowsPadded": self.rows_padded_total,
                "paddingWasteRatio": round(
                    self.rows_padded_total / total, 4) if total else 0.0,
                "decodePeakBytes": self.decode_peak_bytes,
                "decodeBytesTotal": self.decode_bytes_total,
                "kernelLaunches": self.kernel_launches_total,
                "kernelTiles": self.kernel_tiles_total,
                "size": self.size,
            }

    def snapshot(self) -> dict:
        """/debug/launches: aggregates + the ring, newest last."""
        out = self.aggregates()
        with self._lock:
            out["entries"] = list(self._ring)
        out["launchS"] = self.launch_hist.snapshot()
        out["queueS"] = self.queue_hist.snapshot()
        return out

    def prometheus_text(self) -> str:
        lines = self.launch_hist.prometheus_lines(
            "pilosa_tpu_device_launch_seconds")
        lines += self.queue_hist.prometheus_lines(
            "pilosa_tpu_device_launch_queue_seconds")
        return "\n".join(lines) + "\n"


# Process-wide singletons, like DEFAULT_BUDGET: one device runtime per
# process, one telemetry surface.  Tests use deltas or private instances.
COMPILES = CompileRegistry()
LEDGER = LaunchLedger()
