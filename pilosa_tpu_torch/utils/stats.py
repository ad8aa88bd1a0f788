"""Stats client (reference stats/stats.go:31-161 StatsClient iface).

In-process counters/gauges/timings with tag support; snapshot() feeds both
the expvar-style /debug/vars JSON and the Prometheus text exposition at
/metrics (reference prometheus/prometheus.go).

Timings are fixed LOG-BUCKET histograms (docs/observability.md): O(1)
memory per series over a server's lifetime like the old [count, sum]
aggregation, but able to answer p50/p95/p99 (Monarch/Prometheus-style
bucketed latency distributions) and exported as proper Prometheus
``_bucket``/``_sum``/``_count`` histogram series at /metrics.

Port copy of the JAX package's ``utils/stats.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import time
from collections import defaultdict

from .locks import make_lock

# Inclusive upper edges for timing histograms: 1-2.5-5 per decade from
# 100 µs to 100 s (values above land in +Inf).  Fixed and shared by every
# series so /metrics stays aggregatable across nodes.
TIMING_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


class _Hist:
    """One timing series: count, sum, and per-bucket counters over the
    shared TIMING_BUCKETS edges.  Mutated under the owning client's
    lock.

    Each bucket also keeps its LAST trace-id exemplar (trace_id, value,
    wall) — O(buckets) memory, and exactly the link a p99 investigation
    needs: the `/metrics` exposition emits OpenMetrics-style exemplars
    on the bucket lines, so the trace id behind a latency spike resolves
    directly at ``/debug/traces?trace=<id>`` (docs/observability.md
    "Trace exemplars")."""

    __slots__ = ("count", "total", "buckets", "exemplars")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.buckets = [0] * (len(TIMING_BUCKETS) + 1)
        # per-bucket (trace_id, value, wall) of the last exemplar-tagged
        # observation that landed there; None until one does
        self.exemplars: list = [None] * (len(TIMING_BUCKETS) + 1)

    def observe(self, v: float, exemplar: str | None = None):
        self.count += 1
        self.total += v
        for i, b in enumerate(TIMING_BUCKETS):
            if v <= b:
                self.buckets[i] += 1
                if exemplar is not None:
                    # lint: allow(wall-clock) — exemplar timestamps are
                    # display-only correlation, never subtracted
                    self.exemplars[i] = (exemplar, v, time.time())
                return
        self.buckets[-1] += 1
        if exemplar is not None:
            # lint: allow(wall-clock) — display-only exemplar timestamp
            self.exemplars[-1] = (exemplar, v, time.time())

    def percentile(self, q: float) -> float | None:
        """Order statistic estimated from the buckets with linear
        interpolation inside the winning bucket (the histogram_quantile
        formula) — deterministic given the recorded values, so golden-
        value testable."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, hi in enumerate(TIMING_BUCKETS):
            prev = cum
            cum += self.buckets[i]
            if cum >= target:
                if self.buckets[i] == 0:
                    return hi
                frac = (target - prev) / self.buckets[i]
                return lo + frac * (hi - lo)
            lo = hi
        return TIMING_BUCKETS[-1]  # +Inf bucket: clamp to the last edge


class StatsClient:
    # Distinct values tracked per set_value() name before further values
    # collapse into one ":__other__" series: set_value feeds gauges, and
    # an unbounded dynamic value (client-chosen strings) must not grow
    # the gauge map — and /metrics — without bound.
    SET_VALUE_CAP = 64

    def __init__(self, tags: list[str] | None = None):
        self.tags = tags or []
        self._lock = make_lock("stats")
        self._counts: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # per-series log-bucket histograms — NOT raw samples: always-on
        # per-query timings must stay O(1) memory over a server's lifetime
        self._timings: dict[str, _Hist] = defaultdict(_Hist)
        # distinct values seen per set_value name (cardinality cap)
        self._set_values: dict[str, set] = defaultdict(set)

    def with_tags(self, *tags: str) -> "StatsClient":
        child = StatsClient(self.tags + list(tags))
        self._share_with(child)
        return child

    def _share_with(self, child: "StatsClient"):
        child._lock = self._lock  # shared metrics need the shared lock
        child._counts = self._counts
        child._gauges = self._gauges
        child._timings = self._timings
        child._set_values = self._set_values

    def _key(self, name: str) -> str:
        if not self.tags:
            return name
        return name + "{" + ",".join(sorted(self.tags)) + "}"

    def count(self, name: str, value: float = 1, rate: float = 1.0):
        with self._lock:
            self._counts[self._key(name)] += value

    def gauge(self, name: str, value: float, rate: float = 1.0):
        with self._lock:
            self._gauges[self._key(name)] = value

    def timing(self, name: str, value_s: float, rate: float = 1.0,
               exemplar: str | None = None):
        """``exemplar``: optional trace id attached to the bucket this
        observation lands in (only pass ids of SAMPLED traces — an
        exemplar must resolve at /debug/traces)."""
        with self._lock:
            self._timings[self._key(name)].observe(value_s, exemplar)

    def histogram(self, name: str, value: float, rate: float = 1.0):
        self.timing(name, value, rate)

    def percentile(self, name: str, q: float) -> float | None:
        """q-quantile (0..1) of a recorded timing/histogram series, or
        None when nothing has been recorded under ``name``."""
        with self._lock:
            h = self._timings.get(self._key(name))
            return None if h is None else h.percentile(q)

    def count_value(self, name: str) -> float:
        """One counter's current value without building the full
        snapshot — the time-series sampler reads a handful per tick
        (the timing_totals pattern)."""
        with self._lock:
            return self._counts.get(self._key(name), 0.0)

    def bucket_count_le(self, name: str, bound_s: float) -> int:
        """Observations of one timing series in buckets whose upper
        edge is <= ``bound_s`` — the SLO engine's good-count reader
        (utils/slo.py): exact when ``bound_s`` is a TIMING_BUCKETS
        edge, and conservatively snapped DOWN to the nearest edge
        otherwise (a query is never counted good on a bucket that may
        contain over-objective observations)."""
        with self._lock:
            h = self._timings.get(self._key(name))
            if h is None:
                return 0
            n = 0
            for edge, c in zip(TIMING_BUCKETS, h.buckets):
                if edge > bound_s:
                    break
                n += c
            return n

    def timing_totals(self, name: str) -> tuple[int, float]:
        """(count, sum) of one timing series without building the full
        snapshot — the time-series sampler reads these every interval,
        and interpolating every series' percentiles per tick would be
        pure waste."""
        with self._lock:
            h = self._timings.get(self._key(name))
            return (0, 0.0) if h is None else (h.count, h.total)

    def set_value(self, name: str, value: str, rate: float = 1.0):
        with self._lock:
            key = self._key(name)
            seen = self._set_values[key]
            if value not in seen:
                if len(seen) >= self.SET_VALUE_CAP:
                    value = "__other__"
                seen.add(value)
            self._gauges[key + ":" + value] = 1

    class _Timer:
        def __init__(self, client, name):
            self.client, self.name = client, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.client.timing(self.name, time.perf_counter() - self.t0)

    def timer(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            timings = {
                k: {"count": h.count, "sum": h.total,
                    "mean": h.total / h.count if h.count else 0,
                    "p50": h.percentile(0.50),
                    "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99)}
                for k, h in self._timings.items()
            }
            return {"counts": dict(self._counts),
                    "gauges": dict(self._gauges),
                    "timings": timings}

    def prometheus_text(self, exemplars: bool = False) -> str:
        """Prometheus exposition format for /metrics
        (prometheus/prometheus.go:40).  Timings export as histogram
        families: cumulative ``_bucket{le=...}`` series over the shared
        TIMING_BUCKETS edges plus ``_sum``/``_count``, so p99 is
        derivable with histogram_quantile.

        ``exemplars=True`` appends the per-bucket trace-id exemplars in
        OpenMetrics syntax — legal ONLY on the negotiated OpenMetrics
        exposition (the classic 0.0.4 text parser rejects a ``# {...}``
        token after a sample value, which would black out the whole
        scrape); the handler sets it from the Accept header."""
        lines = []

        def fmt(name):
            base, _, tags = name.partition("{")
            base = "pilosa_tpu_" + base.replace(".", "_").replace("-", "_")
            return base + ("{" + tags if tags else "")

        snap = self.snapshot()
        with self._lock:
            hists = {k: (h.count, h.total, list(h.buckets),
                         list(h.exemplars))
                     for k, h in self._timings.items()}
        for k, v in sorted(snap["counts"].items()):
            lines.append(f"# TYPE {fmt(k).split('{')[0]} counter")
            lines.append(f"{fmt(k)} {v}")
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {fmt(k).split('{')[0]} gauge")
            lines.append(f"{fmt(k)} {v}")

        # bound before the histogram loop, whose per-series `exemplars`
        # variable shadows the parameter inside the closure
        with_exemplars = exemplars

        def exemplar_suffix(ex):
            # OpenMetrics exemplar syntax on the bucket the observation
            # landed in: `... # {trace_id="<id>"} <value> <timestamp>` —
            # the p99-spike -> /debug/traces link
            # (docs/observability.md "Trace exemplars")
            if ex is None or not with_exemplars:
                return ""
            tid, val, wall = ex
            return (f' # {{trace_id="{tid}"}} {round(val, 6)}'
                    f" {round(wall, 3)}")

        for k, (count, total, buckets, exemplars) in \
                sorted(hists.items()):
            full = fmt(k)
            base, _, tags = full.partition("{")
            tags = tags.rstrip("}")  # series tags, merged with le below
            prefix = ",".join(t for t in (tags,) if t)
            lines.append(f"# TYPE {base}_seconds histogram")
            cum = 0
            for i, (edge, c) in enumerate(zip(TIMING_BUCKETS, buckets)):
                cum += c
                lbl = f'{prefix},le="{edge}"' if prefix else f'le="{edge}"'
                lines.append(f"{base}_seconds_bucket{{{lbl}}} {cum}"
                             + exemplar_suffix(exemplars[i]))
            cum += buckets[-1]
            lbl = f'{prefix},le="+Inf"' if prefix else 'le="+Inf"'
            lines.append(f"{base}_seconds_bucket{{{lbl}}} {cum}"
                         + exemplar_suffix(exemplars[-1]))
            suffix = "{" + prefix + "}" if prefix else ""
            lines.append(f"{base}_seconds_sum{suffix} {total}")
            lines.append(f"{base}_seconds_count{suffix} {count}")
        return "\n".join(lines) + "\n"


class BucketHistogram:
    """Fixed-bucket counting histogram — bounded memory for always-on
    hot-path recording (the dispatch batcher's batch-size distribution).
    ``bounds`` are inclusive upper edges; values above the last bound land
    in the +Inf bucket."""

    def __init__(self, bounds):
        self.bounds = list(bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._lock = make_lock("stats")
        self.count = 0
        self.total = 0.0

    def observe(self, v: float):
        with self._lock:
            self.count += 1
            self.total += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {f"le_{b}": c for b, c in zip(self.bounds, self._counts)}
            out["le_inf"] = self._counts[-1]
            out["count"] = self.count
            out["sum"] = self.total
            return out

    def prometheus_lines(self, name: str) -> list[str]:
        """Cumulative-bucket exposition (Prometheus histogram type)."""
        with self._lock:
            lines = [f"# TYPE {name} histogram"]
            cum = 0
            for b, c in zip(self.bounds, self._counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
            cum += self._counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {self.total}")
            lines.append(f"{name}_count {self.count}")
            return lines


class ReservoirTimer:
    """Ring buffer of the last ``size`` duration samples; percentile()
    computes order statistics over a snapshot copy.  O(size) memory over
    a server's lifetime, like the aggregated timings above — but able to
    answer p50/p99 (the window-wait distribution the batch dispatcher
    publishes)."""

    def __init__(self, size: int = 512):
        self.size = size
        self._buf: list[float] = []
        self._pos = 0
        self._lock = make_lock("stats")
        self.count = 0

    def observe(self, v: float):
        with self._lock:
            self.count += 1
            if len(self._buf) < self.size:
                self._buf.append(v)
            else:
                self._buf[self._pos] = v
                self._pos = (self._pos + 1) % self.size

    def percentile(self, q: float) -> float | None:
        with self._lock:
            buf = sorted(self._buf)
        if not buf:
            return None
        i = min(len(buf) - 1, int(q * (len(buf) - 1) + 0.5))
        return buf[i]

    def snapshot(self) -> dict:
        return {"count": self.count,
                "p50": self.percentile(0.5),
                "p99": self.percentile(0.99)}


class StatsdClient(StatsClient):
    """StatsClient that ALSO emits DataDog-flavored statsd UDP datagrams
    (reference statsd/statsd.go) while keeping the in-process snapshot so
    /debug/vars and /metrics stay live."""

    def __init__(self, host: str = "localhost", port: int = 8125,
                 tags: list[str] | None = None, sock=None):
        super().__init__(tags)
        import socket
        self._addr = (host, port)
        self._sock = sock if sock is not None else socket.socket(
            socket.AF_INET, socket.SOCK_DGRAM)

    def with_tags(self, *tags: str) -> "StatsdClient":
        child = StatsdClient(*self._addr, tags=self.tags + list(tags),
                             sock=self._sock)
        self._share_with(child)
        return child

    def _send(self, payload: str):
        if self.tags:
            payload += "|#" + ",".join(sorted(self.tags))
        try:
            self._sock.sendto(payload.encode(), self._addr)
        except OSError:
            pass  # stats must never take the server down (statsd.go:101)

    def count(self, name: str, value: float = 1, rate: float = 1.0):
        super().count(name, value, rate)
        self._send(f"{name}:{value}|c")

    def gauge(self, name: str, value: float, rate: float = 1.0):
        super().gauge(name, value, rate)
        self._send(f"{name}:{value}|g")

    def timing(self, name: str, value_s: float, rate: float = 1.0,
               exemplar: str | None = None):
        super().timing(name, value_s, rate, exemplar)
        self._send(f"{name}:{value_s * 1e3:.3f}|ms")

    def histogram(self, name: str, value: float, rate: float = 1.0):
        # record in-process via the BASE timing (bucketed, feeds
        # /metrics + percentile) but wire as a statsd histogram, not ms
        StatsClient.timing(self, name, value, rate)
        self._send(f"{name}:{value}|h")

    def set_value(self, name: str, value: str, rate: float = 1.0):
        super().set_value(name, value, rate)
        self._send(f"{name}:{value}|s")


def make_stats_client(service: str = "expvar", host: str = "localhost:8125"
                      ) -> StatsClient:
    """Backend selection by config (server/server.go:268): "expvar" (also
    serves "prometheus" — both read the in-process snapshot), "statsd", or
    "none"/"nop"."""
    if service == "statsd":
        if ":" in host:
            h, _, p = host.rpartition(":")
            return StatsdClient(h or "localhost", int(p))
        return StatsdClient(host or "localhost", 8125)
    if service in ("none", "nop"):
        return NopStatsClient()
    return StatsClient()


class NopStatsClient(StatsClient):
    """Discards everything but keeps the FULL StatsClient surface —
    histogram/percentile/set_value included — so a no-op-configured
    server never AttributeErrors on an instrumentation site.  percentile
    and snapshot answer from the (empty) shared state via the base."""

    def count(self, *a, **k):
        pass

    def gauge(self, *a, **k):
        pass

    def timing(self, *a, **k):
        pass

    def histogram(self, *a, **k):
        pass

    def set_value(self, *a, **k):
        pass
