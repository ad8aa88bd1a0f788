"""Tracing: vendor-neutral Tracer/Span facade (reference
tracing/tracing.go:22-72) with an in-process recording tracer — Dapper-
style always-on distributed tracing (docs/observability.md).

HTTP propagation uses a single ``X-Pilosa-Tpu-Trace`` header carrying
``trace_id:parent_span_id`` (plus a ``:0`` suffix for unsampled traces),
so one distributed trace spans coordinator + remote nodes with CORRECT
parent links (reference http/client.go:1043 inject / handler.go:231
extract).  The active context rides a contextvar; worker threads that
cross a pool boundary (cluster fan-out, dispatch batcher, mesh prefetch)
re-install it via ``capture()``/``attach()`` or the ``task()`` wrapper —
a plain threading.local would silently drop it at every pool hop.

Remote nodes piggyback their span summaries on /internal/query responses
(``adopt()`` folds them into the coordinator's ring buffer), so
``GET /debug/traces?trace=<id>`` on the coordinator renders the whole
cluster tree.

A window sink (``add_sink``) receives every finished sampled span beside
the ring, so a caller can keep all the spans of a window longer than the
ring holds.  While ``torch.profiler`` records, a live span also opens a
``pilosa::<name>`` range: the profiler then records it on the same clock
as the kernels.  The range is a host op (function scope), not a
``record_function`` user annotation: the profiler mirrors a user
annotation onto the device's timeline as a CUDA-typed event spanning
the kernels launched inside it, which a reader of the trace's device
events would count as busy time.

Port copy of the JAX package's ``utils/tracing.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import contextvars
import random
import time
import uuid
from contextlib import contextmanager
from typing import NamedTuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _torch_profiler

from .locks import make_lock

TRACE_HEADER = "X-Pilosa-Tpu-Trace"
# Requests tagged with this header are health/status probes: background
# traffic that must never pollute latency histograms or the slow-query
# log (server/handler.py checks it alongside the /status path).
PROBE_HEADER = "X-Pilosa-Tpu-Probe"


class TraceContext(NamedTuple):
    """The propagated part of a trace: ids + sampling decision + an
    optional collector list that finished span dicts are appended to
    (the remote side of the /internal/query span piggyback)."""

    trace_id: str
    span_id: str
    sampled: bool
    collect: list | None


def format_trace_header(trace_id: str, span_id: str,
                        sampled: bool = True) -> str:
    return f"{trace_id}:{span_id}" + ("" if sampled else ":0")


def parse_trace_header(value: str | None):
    """-> (trace_id, parent_span_id, sampled); (None, None, True) when
    absent.  Tolerates the legacy bare-trace-id form."""
    if not value:
        return None, None, True
    parts = value.split(":")
    tid = parts[0] or None
    parent = parts[1] if len(parts) > 1 and parts[1] else None
    sampled = not (len(parts) > 2 and parts[2] == "0")
    return tid, parent, sampled


_CTX: contextvars.ContextVar[TraceContext | None] = \
    contextvars.ContextVar("pilosa_tpu_trace_ctx", default=None)


class Span:
    def __init__(self, tracer, name: str, trace_id: str, parent_id=None,
                 sampled: bool = True, collect: list | None = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:8]
        self.parent_id = parent_id
        self.sampled = sampled
        self._collect = collect
        # wall-clock start for display/correlation; durations come from a
        # perf_counter pair — a wall-clock step (NTP slew, manual set)
        # mid-span must not produce negative/garbage durations in
        # /debug/traces
        # lint: allow(wall-clock) — display-only span start stamp;
        # durations come from the perf_counter pair below
        self.start = time.time()
        self._pc_start = time.perf_counter()
        self.end: float | None = None
        self.duration: float | None = None
        self.tags: dict = {}

    def set_tag(self, key, value):
        self.tags[key] = value

    def finish(self):
        self.duration = time.perf_counter() - self._pc_start
        self.end = self.start + self.duration
        if self.sampled:
            self.tracer._record(self)

    def to_dict(self) -> dict:
        dur = self.duration if self.duration is not None \
            else time.perf_counter() - self._pc_start
        return {
            "name": self.name, "traceID": self.trace_id,
            "spanID": self.span_id, "parentID": self.parent_id,
            "start": self.start,
            "durationMS": dur * 1e3,
            "tags": self.tags,
        }


class Tracer:
    """Records the most recent spans in a ring buffer, exposed at
    /debug/traces.  ``sample_rate`` (the ``trace-sample-rate`` knob)
    decides recording at each trace ROOT; the decision propagates to
    children and across the wire, so a trace is recorded everywhere or
    nowhere."""

    def __init__(self, max_spans: int = 1000):
        self.max_spans = max_spans
        self.sample_rate = 1.0
        self._spans: list = []  # Span objects or adopted remote dicts
        self._sinks: tuple = ()  # replaced whole under the lock
        self._lock = make_lock("tracer")

    def add_sink(self, sink: list):
        """Append every finished sampled span (live, or synthesized by
        ``record_span``; adopted remote spans are not) to ``sink`` as
        its ``to_dict()``, besides the ring, until ``remove_sink``."""
        with self._lock:
            self._sinks = self._sinks + (sink,)

    def remove_sink(self, sink: list):
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not sink)

    def _record(self, span: Span):
        if span._collect is not None:
            span._collect.append(span.to_dict())
        sinks = self._sinks
        if sinks:
            d = span.to_dict()
            for sink in sinks:
                sink.append(d)
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.max_spans:
                self._spans = self._spans[-self.max_spans:]

    def _record_raw(self, d: dict):
        with self._lock:
            self._spans.append(d)
            if len(self._spans) > self.max_spans:
                self._spans = self._spans[-self.max_spans:]

    # -- context -----------------------------------------------------------

    def current(self) -> TraceContext | None:
        return _CTX.get()

    def current_trace_id(self) -> str | None:
        ctx = _CTX.get()
        return ctx.trace_id if ctx is not None else None

    def capture(self) -> TraceContext | None:
        """The propagation context of this thread of execution; hand it
        to a worker thread and re-install with attach()."""
        return _CTX.get()

    @contextmanager
    def attach(self, ctx: TraceContext | None):
        """Install a captured context in the current thread (pool
        workers); attach(None) is a passthrough."""
        if ctx is None:
            yield
            return
        token = _CTX.set(ctx)
        try:
            yield
        finally:
            _CTX.reset(token)

    def task(self, fn, name: str | None = None, **span_tags):
        """Wrap ``fn`` for submission to a thread pool: the wrapper
        re-installs this thread's trace context in the worker and, when
        ``name`` is given, runs fn under a span of that name — so work
        fanned out to pools parents correctly instead of starting orphan
        traces."""
        from . import tenant as qtenant
        ctx = self.capture()
        # the tenant identity rides the same pool boundary: an outbound
        # fan-out RPC in a worker thread must still know WHOSE request
        # it serves (header forwarding, hedge budgets — utils/tenant.py)
        tctx = qtenant.context()
        if ctx is None and tctx is None:
            return fn

        def run(*args, **kwargs):
            with qtenant.activate(*(tctx or (None, False))):
                if ctx is None:
                    return fn(*args, **kwargs)
                with self.attach(ctx):
                    if name is None:
                        return fn(*args, **kwargs)
                    with self.span(name) as s:
                        for k, v in span_tags.items():
                            s.set_tag(k, v)
                        return fn(*args, **kwargs)

        return run

    def inject(self) -> str | None:
        """Header value for an outbound hop, or None when no trace is
        active (http/client.go:1043 inject)."""
        ctx = _CTX.get()
        if ctx is None:
            return None
        return format_trace_header(ctx.trace_id, ctx.span_id, ctx.sampled)

    # -- spans -------------------------------------------------------------

    @contextmanager
    def span(self, name: str, trace_id: str | None = None,
             parent_id: str | None = None, sampled: bool | None = None,
             collect: list | None = None):
        cur = _CTX.get()
        tid = trace_id or (cur.trace_id if cur is not None else None)
        if parent_id is None and trace_id is None and cur is not None:
            parent_id = cur.span_id
        if sampled is None:
            if trace_id is not None or cur is None:
                # trace root (or an explicit remote continuation without
                # a sampled flag): make the sampling decision here
                sampled = (self.sample_rate >= 1.0
                           or random.random() < self.sample_rate)
            else:
                sampled = cur.sampled
        if collect is None and cur is not None:
            collect = cur.collect
        if tid is None:
            tid = uuid.uuid4().hex[:16]
        s = Span(self, name, tid, parent_id, sampled=sampled,
                 collect=collect)
        token = _CTX.set(TraceContext(tid, s.span_id, sampled, collect))
        # one flag read when the profiler is off
        mirror = None
        if _torch_profiler._is_profiler_enabled:
            mirror = _RecordFunctionFast("pilosa::" + name)
            mirror.__enter__()
        try:
            yield s
        finally:
            if mirror is not None:
                mirror.__exit__(None, None, None)
            s.finish()
            _CTX.reset(token)

    def record_span(self, name: str, trace_id: str, parent_id: str | None,
                    duration_s: float, tags: dict | None = None,
                    collect: list | None = None):
        """Synthesize an already-finished span ENDING now (fused batch
        launches, other after-the-fact attributions) without a second
        wall-clock read: the constructor stamps now, then start shifts
        back by the duration.  ``collect`` (usually the captured
        context's) keeps the span riding the /internal/query piggyback
        like live spans do — without it a remote node's synthesized
        spans would be missing from the coordinator's cluster tree."""
        s = Span(self, name, trace_id, parent_id, collect=collect)
        s.start -= duration_s
        s._pc_start -= duration_s
        if tags:
            s.tags.update(tags)
        s.finish()

    def adopt(self, span_dicts):
        """Fold remote span summaries (piggybacked on /internal/query
        responses) into the ring buffer so /debug/traces renders the
        whole cluster tree."""
        if not span_dicts:
            return
        for d in span_dicts:
            if isinstance(d, dict) and "spanID" in d:
                self._record_raw(dict(d, remote=True))

    def spans(self, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            out = [s if isinstance(s, dict) else s.to_dict()
                   for s in self._spans]
        if trace_id:
            out = [s for s in out if s["traceID"] == trace_id]
        return out

    def search(self, index: str | None = None,
               min_duration_s: float | None = None,
               status: int | None = None,
               limit: int = 100) -> list[dict]:
        """Trace summaries over the (bounded) retained ring, filtered by
        the ROOT span's tags — ``index``, minimum duration, final HTTP
        ``status`` (the handler stamps both onto its root span).  The
        drill-down path behind a histogram exemplar: find the spike's
        neighbors by index/duration, then fetch the full tree with
        ``?trace=<id>`` (docs/observability.md "Trace exemplars")."""
        all_spans = self.spans()
        by_trace: dict[str, int] = {}
        for s in all_spans:
            by_trace[s["traceID"]] = by_trace.get(s["traceID"], 0) + 1
        out = []
        for s in all_spans:
            if s.get("parentID") is not None or s.get("remote"):
                continue  # roots only (remote roots summarize elsewhere)
            tags = s.get("tags") or {}
            if index is not None and tags.get("index") != index:
                continue
            if status is not None and tags.get("status") != status:
                continue
            dur = s.get("durationMS")
            if min_duration_s is not None and \
                    (dur is None or dur < min_duration_s * 1e3):
                continue
            out.append({"traceID": s["traceID"], "name": s["name"],
                        "start": s.get("start"), "durationMS": dur,
                        "index": tags.get("index"),
                        "status": tags.get("status"),
                        "spans": by_trace[s["traceID"]]})
        out.sort(key=lambda t: t.get("start") or 0.0, reverse=True)
        return out[:max(limit, 1)]


GLOBAL_TRACER = Tracer()


class NopTracer(Tracer):
    def _record(self, span):
        pass

    def _record_raw(self, d):
        pass
