"""Server: composition root (reference server.go:46 Server,
server/server.go:137 Command.Start) — the port of the JAX package's
``server/server.py`` for a single node.

Builds holder -> API -> HTTP handler.  Config cascades TOML file <
PILOSA_TPU_* env < explicit kwargs (reference cmd/root.go:60
setAllConfig).  See ``Server`` for what the port carries and refuses.
"""

from __future__ import annotations

import dataclasses
import os
import threading

from ..api import API
from ..executor.executor import resolve_device
from ..storage import Holder
from ..utils.logger import Logger
from .handler import make_http_server


# The JAX package's default data directory, shared so that either
# package opens what the other wrote.
DEFAULT_DATA_DIR = "~/.pilosa" + "_tpu"


@dataclasses.dataclass
class Config:
    """(reference server/config.go:36 Config) — the JAX package's keys,
    defaults, TOML names and env names, plus ``device``.  Keys of
    subsystems the port does not have yet are accepted and unused (see
    the ``Server`` docstring); two are refused there instead."""
    data_dir: str = DEFAULT_DATA_DIR
    bind: str = "localhost:10101"
    max_op_n: int = 10000
    # Highest row id accepted by any fragment (core.DEFAULT_MAX_ROW_ID).
    max_row_id: int = 0  # 0 = keep default
    # cluster
    node_id: str = "node0"
    cluster_hosts: list = dataclasses.field(default_factory=list)
    replica_n: int = 1
    # execution: serve queries through the device-mesh executor (stacked
    # shard batches + ICI reductions); off = per-shard host dispatch
    use_mesh: bool = True
    # -- cross-query dynamic batching (docs/batching.md) -------------------
    # Coalesce compatible concurrent queries into one fused device launch
    # (vmapped over a query axis) instead of one shard_map launch each
    # behind the collective-launch lock.  Off = every dispatch goes
    # straight to its own executable (the pre-batching behavior).
    dispatch_batch: bool = True
    # Queries per fused launch before the dispatcher fires early.
    dispatch_batch_max: int = 32
    # Microseconds the oldest queued ticket may wait for company before
    # the batch launches anyway (the solo-query latency tax ceiling).
    dispatch_batch_window_us: float = 200.0
    # -- whole-query pjit programs (docs/whole-query.md) -------------------
    # Compile each read request into ONE pjit program over the mesh
    # (every call, every shape group, reductions in-program) instead of
    # one executable per reducer stage.  Off restores the legacy
    # per-stage dispatch exactly (the kill switch).
    whole_query: bool = True
    # Fallback policy for shapes the program can't express: "legacy"
    # reroutes to the per-stage path (counted `wholequery.fallback` +
    # structured log event); "error" raises instead — a debugging mode
    # that makes every silent slow path loud.
    whole_query_fallback: str = "legacy"
    # HBM budget for device-resident fragment mirrors + stacked shard
    # blocks (storage/membudget.py DeviceBudget — the syswrap map-cap
    # analog, syswrap/mmap.go:46).  0 = unlimited (accounting only).
    device_budget_mb: int = 0
    # Host-side dense staging cache ceiling (docs/memory-budget.md):
    # expanded fragment blocks kept on host so re-uploads after HBM
    # eviction skip the sparse->dense expansion.  0 disables the cache,
    # -1 = unbounded.
    host_stage_mb: int = 4096
    # -- compressed residency (docs/memory-budget.md) ----------------------
    # Keep sparse fragments HBM-resident as packed array/bitmap/run
    # container streams (ops/containers.py), decoded to dense tiles on
    # device at op time; engages only under a device-budget limit.
    compressed_resident: bool = True
    # Density fallback: a fragment compresses only when its estimated
    # packed bytes are at most this fraction of its dense footprint
    # (dense corpora stay dense — no decode cost, no ~1x "compression").
    compress_max_density: float = 0.5
    # Per-launch dense decode workspace ceiling (MB): shard slices are
    # cut so one launch never decodes more dense tile bytes than this.
    decode_workspace_mb: int = 1024
    # Container decode backend.  The port accepts only "auto": the CUDA
    # kernels on a CUDA device, their plain versions on the CPU
    # (ops/kernels.py).  The JAX package's "pallas" / "jnp" values select
    # a backend the port does not have, and raise at start.
    container_kernels: str = "auto"
    # -- streaming ingest (docs/ingest.md) ---------------------------------
    # Group-commit window: milliseconds the committer lets submissions
    # coalesce before flushing (one WAL frame + one gen bump + one
    # rank-cache touch per fragment per flush).  <= 0 flushes inline.
    ingest_flush_ms: float = 50.0
    # Process-wide budget for ingest delta-overlay journals — the bits
    # OR'd into resident device state between folds.  Over it (or per
    # fragment over an eighth of it) journals fold and device forms
    # rebuild from the sparse store.  0 disables overlays entirely.
    ingest_delta_mb: int = 64
    # Per-frame ceiling on the ingest wire (a frame buffers whole for
    # its CRC, so this bounds per-connection memory).
    ingest_max_frame_mb: int = 32
    # monitors / metrics (reference server/config.go metric section)
    anti_entropy_interval: float = 600.0
    metric_poll_interval: float = 60.0
    metric_service: str = "expvar"  # expvar | statsd | none
    metric_host: str = "localhost:8125"
    # Diagnostics (reference diagnostics.go, default-off here): when an
    # endpoint is set, POST an anonymized runtime/schema summary there on
    # the given interval — for the OPERATOR's fleet monitoring.
    diagnostics_endpoint: str = ""
    diagnostics_interval: float = 3600.0
    # TLS (reference server/tlsconfig.go): serve HTTPS when certificate +
    # key are set; a CA certificate additionally enforces MUTUAL TLS.
    # Cluster peers must then be listed as https://host:port.
    tls_certificate: str = ""
    tls_key: str = ""
    tls_ca_certificate: str = ""
    tls_skip_verify: bool = False  # client side: don't verify peer certs
    # HTTP request-body ceiling (MB); 413 above it, 0 = unlimited.
    # Generous default: bulk imports of a dense shard legitimately run
    # to hundreds of MB.
    max_body_mb: int = 1024
    # Opt-in higher ceiling for the node-to-node /internal/ plane
    # (roaring import fan-out, resize fragment copies); 0 (default) =
    # same as max_body_mb.  Raise only behind mutual TLS — the path
    # prefix is not authentication.
    max_body_internal_mb: int = 0
    # -- overload armor (docs/robustness.md) -------------------------------
    # Default end-to-end deadline (seconds) for public queries without an
    # explicit ?timeout=; expired queries abort between shard slices and
    # return 504.  0 = unlimited.
    query_timeout: float = 0.0
    # Concurrent-query slot pool size (public and internal pools are
    # SEPARATE instances of this size so coordinator fan-out can never
    # self-deadlock behind public traffic).  0 = unlimited.
    max_queries: int = 64
    # Seconds an over-slot query may wait for a slot before 503 +
    # Retry-After; the wait queue holds at most 2*max_queries.
    queue_timeout: float = 0.5
    # Consecutive node-to-node TRANSPORT failures that open a peer's
    # circuit breaker (fail-fast ClusterError; half-open probe on the
    # health cadence).  0 disables breaking.
    breaker_threshold: int = 5
    # Graceful-drain budget: close() stops admitting new queries, lets
    # in-flight ones finish for up to this many seconds, then closes.
    drain_seconds: float = 5.0
    # Consecutive SOFT probe failures (timeouts/resets — refused
    # connections flip immediately) before NODE_DOWN.
    health_down_threshold: int = 2
    # -- tail-tolerant reads (docs/robustness.md "Tail-tolerant fan-out")
    # Hedged reads: a read fan-out RPC still unanswered after its hedge
    # delay speculatively duplicates to the next-best replica; the first
    # answer wins, the loser is ignored.  Internal read calls are
    # idempotent, so hedging never changes answers; writes are never
    # hedged.  Off disables speculation entirely.
    hedge_reads: bool = True
    # Milliseconds before an in-flight read RPC is hedged.  0 (default)
    # derives the delay per dispatch from the router's EWMA RTT (a
    # multiple of the cheapest known peer RTT — see parallel/routing.py);
    # a cold cluster with no RTT history then hedges nothing.
    hedge_delay_ms: float = 0.0
    # Server default for ?partialResults: when true, a read whose shards
    # are truly unservable (every replica dead/partitioned/exhausted)
    # answers with what it has, and the response's degraded object names
    # exactly the missing shards/nodes.  Off = such reads fail loudly.
    partial_results: bool = False
    # Internal query wire (docs/cluster.md "Internal query wire"):
    # "bin1" (default) speaks the PTPUQRY1 CRC-framed binary transport
    # on /internal/query — roaring-packed row segments, packed numpy
    # scalar arrays — negotiating per peer via the /status `wire`
    # capability list and downgrading to JSON on refusal; "json"
    # restores the pre-binary JSON envelope exactly, both served and
    # spoken.
    internal_wire: str = "bin1"
    # -- tenant isolation (docs/robustness.md "Tenant isolation") ----------
    # Weighted-fair per-tenant admission queues + tenant-first shedding.
    # Off collapses the wait queues back to the single pre-isolation
    # FIFO (reject-the-arrival shedding) for differential benches.
    tenant_isolation: bool = True
    # Relative admission weights, "name:weight,...": e.g.
    # "analytics:4,batch:1" gives analytics 4 slot grants per batch
    # grant under contention.  Unlisted tenants weigh 1.
    tenant_weights: str = ""
    # Burst allowance: an idle tenant banks up to weight*burst slot
    # credits, so a short burst rides through un-queued-on before
    # deficit round-robin paces it.
    tenant_burst: float = 8.0
    # Per-tenant byte cap (MB) inside the result cache AND the HBM
    # residency budget: a tenant filling past it evicts its OWN entries
    # first, and global pressure prefers over-quota tenants.  0 = no
    # per-tenant cap (the global budgets still apply).
    tenant_cache_quota_mb: int = 0
    # Per-tenant hedge token budget (tokens/second, equal burst): each
    # speculative read draws one token from the requesting tenant's
    # bucket; an exhausted bucket reads unhedged (counted, never an
    # error).  0 = unlimited hedging.
    tenant_hedge_budget: float = 32.0
    # -- elastic serving (docs/cluster.md "Read routing & rebalancing") ----
    # Read fan-out replica policy: "primary" pins reads to the jump-hash
    # primary (the pre-routing behavior, byte-for-byte), "round-robin"
    # rotates among READY owners, "loaded" scores replicas by EWMA RTT x
    # queue pressure with a residency discount (parallel/routing.py).
    read_routing: str = "loaded"
    # Prefer the replica that holds the queried shards HBM-resident or
    # host-staged (residency tiers piggybacked on /status probes); off =
    # pure load scores.
    residency_routing: bool = True
    # Hot-shard balancer (parallel/balancer.py): the coordinator widens a
    # sustained-hot shard's replica set by one underloaded node (resize-
    # fetch copy + epoch-gated placement-overlay broadcast).  Off
    # (default) keeps placement exactly static jump-hash.
    balancer: bool = False
    # Seconds between balancer ticks (also the shard-load counter
    # window).
    balancer_interval: float = 30.0
    # A shard is "hot" when its dispatch count over the window exceeds
    # this multiple of the mean across active shards (plus an absolute
    # floor; balancer.HOT_MIN_COUNT).
    hot_shard_threshold: float = 4.0
    # Failpoint spec armed at startup (utils/faults.py syntax); empty =
    # nothing armed.  For chaos tests and game-days only.
    failpoints: str = ""
    # -- durability & recovery (docs/robustness.md) ------------------------
    # Frame new WAL files with length+CRC records so torn tails are
    # detected and truncated at a record boundary on replay.  Off writes
    # the legacy bare record stream (old-reader compatibility /
    # differential testing); existing files always keep THEIR format
    # until the next snapshot truncation.
    wal_crc: bool = True
    # A corrupt snapshot/WAL quarantines the fragment — empty reads with
    # a degraded flag, writes refused with a retryable 503, replica
    # repair heals it — instead of raising out of startup.  Off restores
    # fail-stop opens (debugging / single-node forensics).
    quarantine_on_corruption: bool = True
    # Seconds between dedicated quarantine-repair sweeps (re-fetch
    # quarantined fragments wholesale from a healthy replica).  The
    # anti-entropy pass also repairs on its own cadence; this knob keeps
    # the time-to-heal well under anti-entropy-interval.  0 disables the
    # dedicated sweep.
    repair_interval: float = 60.0
    # -- query cache subsystem (docs/caching.md) ---------------------------
    # Host-byte budget for the generation-keyed result cache (LRU); 0
    # disables it.  Off by default so chaos/overload exercises hit the
    # real execution path; production serving wants it on (e.g. 256).
    result_cache_mb: int = 0
    # Distinct rows a batched write may touch before a fragment's rank
    # cache stops updating incrementally and rebuilds lazily instead.
    rank_rebuild_rows: int = 4096
    # -- observability (docs/observability.md) -----------------------------
    # Queries slower than this (seconds) land in the slow-query log ring
    # (/debug/slow) with their trace id + profile tree, and are emitted
    # as structured log lines.  0 disables the log.
    slow_query_threshold: float = 1.0
    # Entries kept in the slow-query ring buffer.
    slow_log_size: int = 128
    # Return the per-query profile tree on EVERY query response, not just
    # those with ?profile=true (an always-on EXPLAIN ANALYZE).
    profile_default: bool = False
    # Fraction of trace ROOTS recorded to the span ring buffer; the
    # decision propagates to children and across the wire, so a trace is
    # recorded everywhere or nowhere.  1.0 = always-on (Dapper-style).
    trace_sample_rate: float = 1.0
    # -- device-runtime observability (docs/observability.md) --------------
    # Seconds between in-process time-series samples of the runtime
    # gauges (HBM split, admission depth, compile/retrace counts, edge
    # histogram deltas) served at /debug/timeseries and rendered by
    # /debug/dashboard.  0 disables the sampler.
    timeseries_interval: float = 5.0
    # Seconds of history the time-series ring retains — the "what
    # happened in the last N minutes" horizon; memory is one flat dict
    # per window/interval samples.
    timeseries_window: float = 600.0
    # Entries kept in the device launch-ledger ring (/debug/launches).
    launch_ledger_size: int = 256
    # -- cluster observability plane (docs/observability.md) ---------------
    # Entries kept in the structured event-journal ring (/debug/events):
    # breaker/node/quarantine/overlay/resize/backpressure transitions.
    event_journal_size: int = 512
    # Persist the event journal to <data-dir>/events.log as length+CRC
    # framed JSON records (torn tails truncate at a frame boundary on
    # reopen).  Off keeps the journal in-memory only.
    event_log: bool = False
    # Characters of query text stored per slow-log entry.  Raise it when
    # harvesting a recorded workload for replay (bench.py): entries
    # still over the ceiling are marked textTruncated and skipped by the
    # replay harvester.
    slow_log_text_max: int = 512
    # -- SLOs & alerting (docs/observability.md "SLOs & alerting") ---------
    # Latency objective: the SLO counts an http.query over this many
    # milliseconds as bad (snapped down to the nearest latency-histogram
    # bucket edge so the count is exact).
    slo_latency_ms: float = 500.0
    # Objective target for BOTH SLOs: the good fraction of http.query
    # (non-5xx for availability, under slo-latency-ms for latency) the
    # burn-rate windows are judged against.
    slo_target: float = 0.999
    # Alert rules the SLO engine evaluates each time-series interval:
    # "all", "off", or a comma-separated list of rule ids (the
    # docs/observability.md alerts catalog).  Evaluation also requires
    # the time-series ring (timeseries-interval > 0).
    alert_rules: str = "all"
    # Disk budget (MB) for flight-recorder diagnostic bundles under
    # <data-dir>/flightrec, LRU-pruned by file mtime (the compile-cache
    # discipline).  0 disables the recorder (alerts still fire).
    flight_recorder_mb: int = 64
    # Per-launch batch-temp workspace ceiling (MB) for fused/batched
    # [B, rows, W] device temps (row_counts/TopN batches): the batch
    # axis chunks when a launch would exceed it (counted
    # query.batch_temp_splits), and the cross-query batcher stops
    # fusing past it.  The decode-workspace-mb pattern, on the batch
    # axis.
    batch_temp_mb: int = 4096
    # -- warm start (docs/warmup.md) ---------------------------------------
    # Directory for jax's persistent XLA compilation cache, so a
    # restarted process reuses executables instead of recompiling.
    # "" = <data-dir>/.compile-cache; "off" disables the on-disk cache
    # (the signature corpus + warmup replay still run).
    compile_cache_dir: str = ""
    # Size bound (MB) for the compile-cache directory, LRU-pruned by
    # file mtime at startup and clean shutdown.  0 = unbounded.
    compile_cache_mb: int = 256
    # Corpus signatures the AOT warmup replayer replays at startup (the
    # top-N by traffic) before this node reports READY.  0 disables the
    # replay (corpus recording still runs for the next restart).
    warmup_top_n: int = 32
    # Wall-clock budget (seconds) for the warmup replay: entries beyond
    # it are skipped (counted) and the node goes READY anyway — warmup
    # may make READY later, never absent.
    warmup_budget_s: float = 30.0
    verbose: bool = False
    # The torch device queries run on (TOML ``device``, CLI
    # ``--device``): "cuda" raises at construction without a card;
    # "cpu" runs the plain PyTorch paths.  Nothing moves to the CPU by
    # itself.
    device: str = "cuda"

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        cfg = cls()
        cls._apply_env(cfg)
        cls._apply_overrides(cfg, overrides)
        return cfg

    @staticmethod
    def _apply_env(cfg):
        env_map = {
            "PILOSA_TPU_DATA_DIR": ("data_dir", str),
            "PILOSA_TPU_BIND": ("bind", str),
            "PILOSA_TPU_NODE_ID": ("node_id", str),
            "PILOSA_TPU_REPLICA_N": ("replica_n", int),
            "PILOSA_TPU_CLUSTER_HOSTS": (
                "cluster_hosts", lambda s: s.split(",") if s else []),
            "PILOSA_TPU_ANTI_ENTROPY_INTERVAL": (
                "anti_entropy_interval", float),
            "PILOSA_TPU_VERBOSE": ("verbose", lambda s: s == "true"),
            "PILOSA_TPU_MAX_ROW_ID": ("max_row_id", int),
            "PILOSA_TPU_USE_MESH": ("use_mesh", lambda s: s != "false"),
            "PILOSA_TPU_DISPATCH_BATCH": (
                "dispatch_batch", lambda s: s != "false"),
            "PILOSA_TPU_DISPATCH_BATCH_MAX": ("dispatch_batch_max", int),
            "PILOSA_TPU_DISPATCH_BATCH_WINDOW_US": (
                "dispatch_batch_window_us", float),
            "PILOSA_TPU_WHOLE_QUERY": (
                "whole_query", lambda s: s != "false"),
            "PILOSA_TPU_WHOLE_QUERY_FALLBACK": ("whole_query_fallback",
                                                str),
            "PILOSA_TPU_DEVICE_BUDGET_MB": ("device_budget_mb", int),
            "PILOSA_TPU_HOST_STAGE_MB": ("host_stage_mb", int),
            "PILOSA_TPU_COMPRESSED_RESIDENT": (
                "compressed_resident", lambda s: s != "false"),
            "PILOSA_TPU_COMPRESS_MAX_DENSITY": ("compress_max_density",
                                                float),
            "PILOSA_TPU_DECODE_WORKSPACE_MB": ("decode_workspace_mb",
                                               int),
            "PILOSA_TPU_CONTAINER_KERNELS": ("container_kernels", str),
            "PILOSA_TPU_INGEST_FLUSH_MS": ("ingest_flush_ms", float),
            "PILOSA_TPU_INGEST_DELTA_MB": ("ingest_delta_mb", int),
            "PILOSA_TPU_INGEST_MAX_FRAME_MB": ("ingest_max_frame_mb",
                                               int),
            "PILOSA_TPU_METRIC_SERVICE": ("metric_service", str),
            "PILOSA_TPU_METRIC_HOST": ("metric_host", str),
            "PILOSA_TPU_DIAGNOSTICS_ENDPOINT": ("diagnostics_endpoint",
                                                str),
            "PILOSA_TPU_DIAGNOSTICS_INTERVAL": ("diagnostics_interval",
                                                float),
            "PILOSA_TPU_TLS_CERTIFICATE": ("tls_certificate", str),
            "PILOSA_TPU_TLS_KEY": ("tls_key", str),
            "PILOSA_TPU_TLS_CA_CERTIFICATE": ("tls_ca_certificate", str),
            "PILOSA_TPU_TLS_SKIP_VERIFY": (
                "tls_skip_verify", lambda s: s == "true"),
            "PILOSA_TPU_MAX_BODY_MB": ("max_body_mb", int),
            "PILOSA_TPU_MAX_BODY_INTERNAL_MB": ("max_body_internal_mb",
                                                int),
            "PILOSA_TPU_QUERY_TIMEOUT": ("query_timeout", float),
            "PILOSA_TPU_MAX_QUERIES": ("max_queries", int),
            "PILOSA_TPU_QUEUE_TIMEOUT": ("queue_timeout", float),
            "PILOSA_TPU_BREAKER_THRESHOLD": ("breaker_threshold", int),
            "PILOSA_TPU_DRAIN_SECONDS": ("drain_seconds", float),
            "PILOSA_TPU_HEALTH_DOWN_THRESHOLD": ("health_down_threshold",
                                                 int),
            "PILOSA_TPU_HEDGE_READS": (
                "hedge_reads", lambda s: s != "false"),
            "PILOSA_TPU_HEDGE_DELAY_MS": ("hedge_delay_ms", float),
            "PILOSA_TPU_PARTIAL_RESULTS": (
                "partial_results", lambda s: s == "true"),
            "PILOSA_TPU_INTERNAL_WIRE": ("internal_wire", str),
            "PILOSA_TPU_TENANT_ISOLATION": (
                "tenant_isolation", lambda s: s != "false"),
            "PILOSA_TPU_TENANT_WEIGHTS": ("tenant_weights", str),
            "PILOSA_TPU_TENANT_BURST": ("tenant_burst", float),
            "PILOSA_TPU_TENANT_CACHE_QUOTA_MB": (
                "tenant_cache_quota_mb", int),
            "PILOSA_TPU_TENANT_HEDGE_BUDGET": (
                "tenant_hedge_budget", float),
            "PILOSA_TPU_READ_ROUTING": ("read_routing", str),
            "PILOSA_TPU_RESIDENCY_ROUTING": (
                "residency_routing", lambda s: s != "false"),
            "PILOSA_TPU_BALANCER": ("balancer", lambda s: s == "true"),
            "PILOSA_TPU_BALANCER_INTERVAL": ("balancer_interval", float),
            "PILOSA_TPU_HOT_SHARD_THRESHOLD": ("hot_shard_threshold",
                                               float),
            "PILOSA_TPU_FAILPOINTS": ("failpoints", str),
            "PILOSA_TPU_WAL_CRC": ("wal_crc", lambda s: s != "false"),
            "PILOSA_TPU_QUARANTINE_ON_CORRUPTION": (
                "quarantine_on_corruption", lambda s: s != "false"),
            "PILOSA_TPU_REPAIR_INTERVAL": ("repair_interval", float),
            "PILOSA_TPU_RESULT_CACHE_MB": ("result_cache_mb", int),
            "PILOSA_TPU_RANK_REBUILD_ROWS": ("rank_rebuild_rows", int),
            "PILOSA_TPU_SLOW_QUERY_THRESHOLD": ("slow_query_threshold",
                                                float),
            "PILOSA_TPU_SLOW_LOG_SIZE": ("slow_log_size", int),
            "PILOSA_TPU_PROFILE_DEFAULT": (
                "profile_default", lambda s: s == "true"),
            "PILOSA_TPU_TRACE_SAMPLE_RATE": ("trace_sample_rate", float),
            "PILOSA_TPU_TIMESERIES_INTERVAL": ("timeseries_interval",
                                               float),
            "PILOSA_TPU_TIMESERIES_WINDOW": ("timeseries_window", float),
            "PILOSA_TPU_LAUNCH_LEDGER_SIZE": ("launch_ledger_size", int),
            "PILOSA_TPU_EVENT_JOURNAL_SIZE": ("event_journal_size", int),
            "PILOSA_TPU_EVENT_LOG": ("event_log", lambda s: s == "true"),
            "PILOSA_TPU_SLOW_LOG_TEXT_MAX": ("slow_log_text_max", int),
            "PILOSA_TPU_SLO_LATENCY_MS": ("slo_latency_ms", float),
            "PILOSA_TPU_SLO_TARGET": ("slo_target", float),
            "PILOSA_TPU_ALERT_RULES": ("alert_rules", str),
            "PILOSA_TPU_FLIGHT_RECORDER_MB": ("flight_recorder_mb", int),
            "PILOSA_TPU_BATCH_TEMP_MB": ("batch_temp_mb", int),
            "PILOSA_TPU_COMPILE_CACHE_DIR": ("compile_cache_dir", str),
            "PILOSA_TPU_COMPILE_CACHE_MB": ("compile_cache_mb", int),
            "PILOSA_TPU_WARMUP_TOP_N": ("warmup_top_n", int),
            "PILOSA_TPU_WARMUP_BUDGET_S": ("warmup_budget_s", float),
        }
        for env, (attr, conv) in env_map.items():
            if env in os.environ:
                setattr(cfg, attr, conv(os.environ[env]))

    @staticmethod
    def _apply_overrides(cfg, overrides):
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)

    @classmethod
    def from_toml(cls, path: str, **overrides) -> "Config":
        """Precedence: TOML file < PILOSA_TPU_* env < explicit kwargs
        (reference cmd/root.go:60 setAllConfig)."""
        from ..utils import toml
        with open(path, "rb") as f:
            doc = toml.load(f)
        cfg = cls()
        mapping = {
            "data-dir": "data_dir", "bind": "bind", "max-op-n": "max_op_n",
            "max-row-id": "max_row_id", "use-mesh": "use_mesh",
            "dispatch-batch": "dispatch_batch",
            "dispatch-batch-max": "dispatch_batch_max",
            "dispatch-batch-window-us": "dispatch_batch_window_us",
            "whole-query": "whole_query",
            "whole-query-fallback": "whole_query_fallback",
            "device-budget-mb": "device_budget_mb",
            "host-stage-mb": "host_stage_mb",
            "compressed-resident": "compressed_resident",
            "compress-max-density": "compress_max_density",
            "decode-workspace-mb": "decode_workspace_mb",
            "container-kernels": "container_kernels",
            "ingest-flush-ms": "ingest_flush_ms",
            "ingest-delta-mb": "ingest_delta_mb",
            "ingest-max-frame-mb": "ingest_max_frame_mb",
            "max-body-mb": "max_body_mb",
            "max-body-internal-mb": "max_body_internal_mb",
            "query-timeout": "query_timeout",
            "max-queries": "max_queries",
            "queue-timeout": "queue_timeout",
            "breaker-threshold": "breaker_threshold",
            "drain-seconds": "drain_seconds",
            "health-down-threshold": "health_down_threshold",
            "hedge-reads": "hedge_reads",
            "hedge-delay-ms": "hedge_delay_ms",
            "partial-results": "partial_results",
            "internal-wire": "internal_wire",
            "tenant-isolation": "tenant_isolation",
            "tenant-weights": "tenant_weights",
            "tenant-burst": "tenant_burst",
            "tenant-cache-quota-mb": "tenant_cache_quota_mb",
            "tenant-hedge-budget": "tenant_hedge_budget",
            "read-routing": "read_routing",
            "residency-routing": "residency_routing",
            "balancer": "balancer",
            "balancer-interval": "balancer_interval",
            "hot-shard-threshold": "hot_shard_threshold",
            "failpoints": "failpoints",
            "wal-crc": "wal_crc",
            "quarantine-on-corruption": "quarantine_on_corruption",
            "repair-interval": "repair_interval",
            "result-cache-mb": "result_cache_mb",
            "rank-rebuild-rows": "rank_rebuild_rows",
            "slow-query-threshold": "slow_query_threshold",
            "slow-log-size": "slow_log_size",
            "profile-default": "profile_default",
            "trace-sample-rate": "trace_sample_rate",
            "timeseries-interval": "timeseries_interval",
            "timeseries-window": "timeseries_window",
            "launch-ledger-size": "launch_ledger_size",
            "event-journal-size": "event_journal_size",
            "event-log": "event_log",
            "slow-log-text-max": "slow_log_text_max",
            "slo-latency-ms": "slo_latency_ms",
            "slo-target": "slo_target",
            "alert-rules": "alert_rules",
            "flight-recorder-mb": "flight_recorder_mb",
            "batch-temp-mb": "batch_temp_mb",
            "compile-cache-dir": "compile_cache_dir",
            "compile-cache-mb": "compile_cache_mb",
            "warmup-top-n": "warmup_top_n",
            "warmup-budget-s": "warmup_budget_s",
            "device": "device",
        }
        for key, attr in mapping.items():
            if key in doc:
                setattr(cfg, attr, doc[key])
        cluster = doc.get("cluster", {})
        if "hosts" in cluster:
            cfg.cluster_hosts = cluster["hosts"]
        if "replicas" in cluster:
            cfg.replica_n = cluster["replicas"]
        if "anti-entropy" in doc and "interval" in doc["anti-entropy"]:
            cfg.anti_entropy_interval = float(doc["anti-entropy"]["interval"])
        tls = doc.get("tls", {})
        for key, attr in (("certificate", "tls_certificate"),
                          ("key", "tls_key"),
                          ("ca-certificate", "tls_ca_certificate"),
                          ("skip-verify", "tls_skip_verify")):
            if key in tls:
                setattr(cfg, attr, tls[key])
        cls._apply_env(cfg)
        cls._apply_overrides(cfg, overrides)
        return cfg


class Server:
    """One node serving the public HTTP API on the configured device.

    Carried from the JAX package's Server: the holder, the process-wide
    knobs the port's modules have (device and host-stage budgets, WAL
    CRC, quarantine, compressed residency and its density bound, the
    batch-temp workspace, the ingest delta budget, the rank-rebuild
    threshold, the result cache with its tenant quota, the tracer's
    sample rate, the event journal), the three admission pools, the
    group committer, the slow-query log, the runtime-stats monitor and
    the HTTP(S) listener.  Like the JAX package's, these knobs are module
    globals: the most recent Server's config wins.

    With ``cluster_hosts`` the server builds the ``Cluster``
    (parallel/cluster.py) — placement with its overlay, health probes,
    the routed fan-out with hedged reads, import forwarding, DDL
    broadcast, anti-entropy, resize with topology persistence and the
    hot-shard balancer — registers its internal and resize routes and
    builds the fleet rollup (``/debug/cluster``, parallel/rollup.py), as
    the JAX Server does.  With TLS certificates it serves HTTPS (mutual
    TLS when a CA is set) and its cluster client presents the same
    certificate to its peers.  ``anti_entropy_interval > 0`` runs
    ``sync_holder`` on that cadence and ``repair_interval > 0`` the
    quarantine-repair sweep; ``balancer = true`` runs the balancer on
    the coordinator.

    Refused at construction: a ``container_kernels`` other than "auto".

    ``decode_workspace_mb`` sets the shard schedule's decode-workspace
    ceiling (parallel/stacked.py ``DECODE_WORKSPACE_BYTES``).

    Accepted and unused: the device-runtime observability, time-series,
    SLO, flight-recorder and diagnostics keys; and the warm-start keys —
    ``/status`` is READY at once, as for a bare JAX ``API``."""

    def __init__(self, config: Config | None = None):
        self.config = config or Config()
        if self.config.container_kernels != "auto":
            raise ValueError(
                f"container_kernels={self.config.container_kernels!r}: "
                f"only 'auto' is supported (the CUDA kernels on a CUDA "
                f"device, their plain versions on the CPU)")
        # resolve before any process-wide knob changes: a refusal
        # leaves the process as it was
        self.device = resolve_device(self.config.device)
        self.logger = Logger(verbose=self.config.verbose)
        from ..utils.stats import make_stats_client
        self.stats = make_stats_client(self.config.metric_service,
                                       self.config.metric_host)
        # The budget is process-wide; the most recent Server's config wins
        # (0 restores unlimited — a stale limit from an earlier instance in
        # the same process must not outlive its config).
        from ..storage.membudget import DEFAULT_BUDGET, HOST_STAGE_BUDGET
        DEFAULT_BUDGET.limit_bytes = (
            self.config.device_budget_mb * (1 << 20)
            if self.config.device_budget_mb > 0 else None)
        HOST_STAGE_BUDGET.limit_bytes = (
            self.config.host_stage_mb * (1 << 20)
            if self.config.host_stage_mb > 0
            else (0 if self.config.host_stage_mb == 0 else None))
        HOST_STAGE_BUDGET.shrink_to_limit()
        DEFAULT_BUDGET.tenant_quota_bytes = \
            max(self.config.tenant_cache_quota_mb, 0) << 20
        # Durability and residency knobs are process-wide module flags
        # on the fragment codec: they govern file OPENS, which happen
        # under holder.open(), and device forms.
        from ..storage import fragment as _fragment
        _fragment.WAL_CRC = bool(self.config.wal_crc)
        _fragment.QUARANTINE_ON_CORRUPTION = bool(
            self.config.quarantine_on_corruption)
        _fragment.COMPRESSED_RESIDENT = bool(self.config.compressed_resident)
        _fragment.COMPRESS_MAX_DENSITY = max(
            float(self.config.compress_max_density), 0.0)
        from ..parallel import stacked as _stacked
        _stacked.DECODE_WORKSPACE_BYTES = \
            max(self.config.decode_workspace_mb, 1) << 20
        from ..executor import executor as _executor_mod
        _executor_mod.BATCH_TEMP_BYTES = \
            max(self.config.batch_temp_mb, 1) << 20
        from ..storage import membudget as _membudget
        _membudget.INGEST_DELTA_LIMIT_BYTES = \
            max(self.config.ingest_delta_mb, 0) << 20
        data_dir = os.path.expanduser(self.config.data_dir)
        self.holder = Holder(
            data_dir, max_op_n=self.config.max_op_n,
            max_row_id=(self.config.max_row_id
                        if self.config.max_row_id > 0 else None))
        if self.config.failpoints:
            from ..utils.faults import FAULTS
            FAULTS.configure(self.config.failpoints)
        self.cluster = None
        if self.config.cluster_hosts:
            from ..parallel.cluster import Cluster
            self.cluster = Cluster(
                node_id=self.config.node_id,
                hosts=self.config.cluster_hosts,
                replica_n=self.config.replica_n,
                holder=self.holder,
                health_down_threshold=self.config.health_down_threshold,
                breaker_threshold=self.config.breaker_threshold,
                stats=self.stats,
                read_routing=self.config.read_routing,
                residency_routing=self.config.residency_routing,
                balancer=self.config.balancer,
                balancer_interval=self.config.balancer_interval,
                hot_shard_threshold=self.config.hot_shard_threshold,
                hedge_reads=self.config.hedge_reads,
                hedge_delay_ms=self.config.hedge_delay_ms,
                internal_wire=self.config.internal_wire,
                tenant_hedge_budget=(
                    self.config.tenant_hedge_budget
                    if self.config.tenant_isolation else 0.0),
            )
            # fan-out failure events (cluster.fanout_failed) land in the
            # server log like the whole-query fallbacks
            self.cluster.logger = self.logger
            if not self.cluster.is_coordinator:
                # key translation lives on the coordinator; replicas route
                # to it with a read-through cache
                self.holder.translate_factory = \
                    self.cluster.remote_translate_factory
        self.api = API(
            self.holder, cluster=self.cluster, stats=self.stats,
            use_mesh=self.config.use_mesh, device=self.device,
            dispatch_batch=self.config.dispatch_batch,
            dispatch_batch_max=self.config.dispatch_batch_max,
            dispatch_batch_window_us=self.config.dispatch_batch_window_us,
            whole_query=self.config.whole_query,
            whole_query_fallback=self.config.whole_query_fallback)
        # wholequery.fallback events land in the server log (the
        # executor stays silent standalone)
        self.api.executor.logger = self.logger
        self.api.executor.result_cache.limit_bytes = \
            max(self.config.result_cache_mb, 0) << 20
        self.api.executor.result_cache.tenant_quota_bytes = \
            (max(self.config.tenant_cache_quota_mb, 0) << 20) \
            if self.config.tenant_isolation else 0
        from ..cache import rank as _rank
        _rank.RANK_REBUILD_ROWS = max(self.config.rank_rebuild_rows, 0)
        host, port = self._parse_bind(self.config.bind)
        tls = None
        if self.config.tls_certificate and self.config.tls_key:
            tls = (self.config.tls_certificate, self.config.tls_key,
                   self.config.tls_ca_certificate or None)
            if self.cluster is not None:
                self.cluster.client.configure_tls(
                    self.config.tls_certificate, self.config.tls_key,
                    self.config.tls_ca_certificate or None,
                    self.config.tls_skip_verify)
        # Admission control (server/admission.py): public, internal and
        # ingest slot pools of the same size, as in the JAX package.
        from .admission import AdmissionController
        from ..utils.tenant import parse_weights
        tenant_kw = dict(weights=parse_weights(self.config.tenant_weights),
                         burst=self.config.tenant_burst,
                         fair=self.config.tenant_isolation)
        self.admission = AdmissionController(
            self.config.max_queries, self.config.queue_timeout,
            stats=self.stats, name="public", **tenant_kw)
        self.admission_internal = AdmissionController(
            self.config.max_queries, self.config.queue_timeout,
            stats=self.stats, name="internal", **tenant_kw)
        self.admission_ingest = AdmissionController(
            self.config.max_queries, self.config.queue_timeout,
            stats=self.stats, name="ingest", **tenant_kw)
        from ..ingest import GroupCommitter
        self.committer = GroupCommitter(
            self.holder, flush_ms=self.config.ingest_flush_ms,
            stats=self.stats)
        from ..utils.slowlog import SlowQueryLog
        from ..utils.tracing import GLOBAL_TRACER
        GLOBAL_TRACER.sample_rate = min(
            max(self.config.trace_sample_rate, 0.0), 1.0)
        self.slowlog = SlowQueryLog(
            threshold_s=self.config.slow_query_threshold,
            size=self.config.slow_log_size,
            logger=self.logger, stats=self.stats,
            text_max=self.config.slow_log_text_max)
        from ..utils.events import EVENTS
        EVENTS.resize(self.config.event_journal_size)
        EVENTS.node_id = self.config.node_id
        if self.config.event_log:
            os.makedirs(data_dir, exist_ok=True)
            EVENTS.open_log(os.path.join(data_dir, "events.log"))
        self.httpd = make_http_server(
            self.api, host, port, server=self, tls=tls,
            max_body_bytes=self.config.max_body_mb << 20,
            max_body_bytes_internal=self.config.max_body_internal_mb << 20,
            admission=self.admission,
            admission_internal=self.admission_internal,
            admission_ingest=self.admission_ingest,
            ingest_max_frame_bytes=max(
                self.config.ingest_max_frame_mb, 1) << 20,
            default_query_timeout=self.config.query_timeout,
            partial_results=self.config.partial_results,
            slowlog=self.slowlog,
            profile_default=self.config.profile_default)
        # Fleet rollup (docs/observability.md "Cluster plane"): any
        # clustered node can aggregate its peers' /debug/vars + event
        # journals into /debug/cluster and the pilosa_tpu_cluster_*
        # family; the local node's summary is built from the SAME
        # build_debug_vars body peers serve over the wire.
        self.rollup = None
        if self.cluster is not None:
            from ..parallel.rollup import FleetRollup
            from .handler import build_debug_vars
            self.rollup = FleetRollup(
                self.cluster,
                local_vars_fn=lambda: build_debug_vars(self.api, self),
                stats=self.stats)
        self._threads: list[threading.Thread] = []
        self._closing = threading.Event()

    @staticmethod
    def _parse_bind(bind: str) -> tuple[str, int]:
        bind = bind.removeprefix("https://").removeprefix("http://")
        host, _, port = bind.rpartition(":")
        return host or "localhost", int(port)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def register_internal_routes(self, router):
        if self.cluster is not None:
            self.cluster.register_routes(router, server=self)

    def open(self):
        """(reference server.go:417 Open)"""
        self.holder.open()
        if self.cluster is not None:
            self.cluster.open(self.api)
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        self.logger.info(
            f"pilosa-tpu listening on http://{self.config.bind} "
            f"(device {self.device})")
        if self.cluster is not None and self.config.anti_entropy_interval > 0:
            t = threading.Thread(target=self._monitor_anti_entropy,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if self.cluster is not None and self.config.repair_interval > 0:
            t = threading.Thread(target=self._monitor_repair, daemon=True)
            t.start()
            self._threads.append(t)
        if self.config.metric_poll_interval > 0:
            t = threading.Thread(target=self._monitor_runtime, daemon=True)
            t.start()
            self._threads.append(t)

    def collect_runtime_stats(self):
        """Process-level gauges (server.go:813 monitorRuntime; /proc in
        place of gopsutil, the gc module in place of MemStats)."""
        import gc as _gc
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        self.stats.gauge("runtime.rss_bytes",
                                         int(line.split()[1]) * 1024)
                        break
        except OSError:
            pass
        try:
            self.stats.gauge("runtime.open_fds",
                             len(os.listdir("/proc/self/fd")))
        except OSError:
            pass
        self.stats.gauge("runtime.threads", threading.active_count())
        self.stats.gauge("runtime.gc_gen0", _gc.get_count()[0])
        from ..storage.membudget import DEFAULT_BUDGET, HOST_STAGE_BUDGET
        b = DEFAULT_BUDGET.stats()
        self.stats.gauge("runtime.host_stage_bytes",
                         HOST_STAGE_BUDGET.resident_bytes)
        self.update_storage_gauges()
        for pool in (self.admission, self.admission_internal,
                     self.admission_ingest):
            s = pool.snapshot()
            self.stats.gauge(f"admission.{pool.name}.in_use", s["inUse"])
            self.stats.gauge(f"admission.{pool.name}.waiting",
                             s["waiting"])
        batcher = self.api.executor.batcher
        self.stats.gauge("runtime.batcher_queued",
                         batcher.pending() if batcher is not None else 0)

    def _monitor_anti_entropy(self):
        """(server.go:514 monitorAntiEntropy)"""
        while not self._closing.wait(self.config.anti_entropy_interval):
            try:
                self.cluster.sync_holder()
            except Exception as e:
                self.logger.error(f"anti-entropy sync failed: {e}")

    def _monitor_repair(self):
        """Dedicated quarantine-repair sweep (docs/robustness.md): a
        corrupt fragment heals on the repair-interval cadence instead of
        waiting out the (much longer) anti-entropy interval.  Cheap when
        healthy — one holder scan finding nothing."""
        while not self._closing.wait(self.config.repair_interval):
            try:
                if self.holder.quarantined_fragments():
                    n = self.cluster.repair_quarantined()
                    if n:
                        self.logger.info(
                            f"repaired {n} quarantined fragment(s) "
                            f"from replicas")
            except Exception as e:
                self.logger.error(f"quarantine repair failed: {e}")

    def _monitor_runtime(self):
        while not self._closing.wait(self.config.metric_poll_interval):
            try:
                self.collect_runtime_stats()
            except Exception as e:
                # a monitor that dies silently leaves gauges frozen at
                # their last values
                self.logger.error(f"runtime stats poll failed: {e}")

    def update_storage_gauges(self, container_stats=None):
        """Durability, residency, ingest and device counters -> stats
        gauges: called on the metric poll AND from the /metrics and
        /debug/vars handlers so scrapes see current values.
        ``container_stats`` lets a caller that already computed
        Holder.container_stats() pass it in."""
        from ..storage.fragment import storage_events
        ev = storage_events()
        self.stats.gauge("storage.quarantine_events", ev["quarantine"])
        self.stats.gauge("storage.torn_wal_recoveries",
                         ev["torn_tail_recovered"])
        self.stats.gauge("storage.repairs", ev["repair"])
        self.stats.gauge("storage.quarantined_fragments",
                         len(self.holder.quarantined_fragments()))
        from ..storage.membudget import DEFAULT_BUDGET, INGEST_DELTA_BUDGET
        b = DEFAULT_BUDGET.stats()
        # the shard schedule's streaming counters: upload volume,
        # prefetch effectiveness and pin pressure
        self.stats.gauge("runtime.hbm_resident_bytes", b["residentBytes"])
        self.stats.gauge("runtime.hbm_upload_bytes", b["uploadBytes"])
        self.stats.gauge("runtime.hbm_evictions", b["evictions"])
        self.stats.gauge("runtime.hbm_prefetch_hits", b["prefetchHits"])
        self.stats.gauge("runtime.hbm_prefetch_misses",
                         b["prefetchMisses"])
        self.stats.gauge("runtime.hbm_pinned_bytes", b["pinnedBytes"])
        self.stats.gauge("runtime.hbm_compressed_bytes",
                         b["compressedBytes"])
        self.stats.gauge("runtime.hbm_dense_bytes", b["denseBytes"])
        from ..parallel import stacked as _stacked
        self.stats.gauge("device.decode_workspace_limit_bytes",
                         _stacked.DECODE_WORKSPACE_BYTES)
        cs = container_stats if container_stats is not None \
            else self.holder.container_stats()
        self.stats.gauge("storage.containers_array", cs["array"])
        self.stats.gauge("storage.containers_bitmap", cs["bitmap"])
        self.stats.gauge("storage.containers_run", cs["run"])
        self.stats.gauge("storage.compressed_fragments",
                         cs["compressedFragments"])
        self.stats.gauge("ingest.delta_bytes",
                         INGEST_DELTA_BUDGET.resident_bytes)
        ing = self.committer.snapshot()
        self.stats.gauge("ingest.delta_fragments",
                         ing["journalFragments"])
        self.stats.gauge("ingest.merge_backlog", ing["pendingBytes"])
        self.stats.gauge("ingest.folds", ing["folds"])
        self.update_device_gauges()
        self.update_routing_gauges()

    def update_routing_gauges(self):
        """Per-peer routing-state gauges (docs/cluster.md "Read routing
        & rebalancing"), refreshed at scrape time like the storage
        gauges: the operator's answer to "why is this replica not taking
        reads" must reflect now, not the last metric poll."""
        if self.cluster is None:
            return
        for nid, g in self.cluster.router.peer_states():
            self.stats.gauge(f"cluster.peer.{nid}.ewma_rtt_ms",
                             g["ewma_rtt_ms"])
            self.stats.gauge(f"cluster.peer.{nid}.inflight",
                             g["inflight"])
            self.stats.gauge(f"cluster.peer.{nid}.queued", g["queued"])
            self.stats.gauge(f"cluster.peer.{nid}.residency_age_s",
                             g["residency_age_s"])
            self.stats.gauge(f"cluster.peer.{nid}.breaker_open",
                             g["breaker_open"])
            self.stats.gauge(f"cluster.peer.{nid}.dispatches",
                             g["dispatches"])
        snap = self.cluster.overlay_snapshot()
        self.stats.gauge("cluster.overlay_entries", len(snap["entries"]))
        self.stats.gauge("cluster.overlay_epoch", snap["epoch"])
        self.stats.gauge("cluster.balancer_handoffs",
                         self.cluster.balancer.handoffs)

    def update_device_gauges(self):
        """The container-kernel wrappers' launch counts and the stacked
        executor's stagings and ingest overlays (the port's stand-ins
        for the JAX package's compile registry and launch ledger)."""
        from ..ops import kernels
        with kernels._launches_lock:
            launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            self.stats.gauge(f"device.kernel_launches.{name}", n)
        self.stats.gauge("device.kernel_launches",
                         sum(launches.values()))
        st = self.api.executor.stacked
        if st is not None:
            self.stats.gauge("device.stack_builds", st.stack_builds)
            self.stats.gauge("device.stack_overlays", st.overlays)

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain: stop ADMITTING public queries (new ones get
        503 + Retry-After while the socket stays up, so clients fail over
        cleanly) and wait for in-flight ones to finish.  Returns True if
        everything drained inside the deadline.  Idempotent; close()
        calls it first."""
        if timeout is None:
            timeout = self.config.drain_seconds
        from ..utils import events
        events.emit("server.drain", budgetS=round(max(timeout, 0.0), 3))
        self.admission.begin_drain()
        drained = self.admission.wait_drained(max(timeout, 0.0))
        if not drained:
            self.logger.error(
                f"drain deadline ({timeout:.3g}s) passed with "
                f"{self.admission.snapshot()['inUse']} queries in flight; "
                f"closing anyway")
        return drained

    def close(self):
        # drain BEFORE severing sockets: in-flight queries finish under
        # the drain deadline instead of seeing a connection reset
        self.drain()
        self._closing.set()
        self.httpd.shutdown()
        # sever live keep-alive connections: their handler threads would
        # otherwise keep serving THIS closed server's holder
        self.httpd.close_connections()
        self.httpd.server_close()
        # final group-commit flush AFTER the listener is gone (no new
        # submissions) and BEFORE the holder closes the WAL files
        self.committer.close()
        if self.rollup is not None:
            self.rollup.close()
        if self.cluster is not None:
            self.cluster.close()
        self.api.executor.close()
        from ..utils.events import EVENTS
        if self.config.event_log:
            EVENTS.close_log()
        self.holder.close()
