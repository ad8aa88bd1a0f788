"""CLI: server|import|ingest|export|check|inspect|analyze|top|alerts|
bundle|generate-config|config (reference cmd/root.go + ctl/) — the port
of the JAX package's ``cli.py``.

Run as ``python -m pilosa_tpu_torch <command>``.  ``server`` takes
``--device`` (default ``cuda``, which raises without a card; ``cpu``
runs the plain PyTorch paths).  The client commands speak HTTP and are
the JAX package's, including the observability clients ``top`` (the
kernel backend line reads ``cuda`` or ``torch``), ``alerts`` and
``bundle``.  ``analyze`` runs the port's invariant analyzer
(``pilosa_tpu_torch/analysis``) over a checkout.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import urllib.request


def _http(method: str, url: str, body: bytes | None = None,
          ctype: str = "application/json",
          ok_codes: tuple[int, ...] = ()) -> dict:
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req) as resp:
            data = resp.read()
    except urllib.error.HTTPError as e:
        if e.code in ok_codes:
            return {}
        raise SystemExit(f"error: {e.code} {e.read().decode().strip()}")
    return json.loads(data) if data.strip() else {}


def _base_url(host: str) -> str:
    """--host may be bare (``node:10101``) or carry a scheme
    (``https://node:10101`` for TLS clusters); normalize to a base URL."""
    host = str(host)
    scheme, _, bare = host.rpartition("://")
    return f"{scheme or 'http'}://{bare}"


def cmd_server(args) -> int:
    """(ctl/server.go + server/server.go Command.Start)"""
    from .server.server import Config, Server

    overrides = dict(data_dir=args.data_dir, bind=args.bind,
                     replica_n=args.replicas, node_id=args.node_id,
                     device=args.device)
    if args.cluster_hosts:
        overrides["cluster_hosts"] = args.cluster_hosts.split(",")
    if args.config:
        cfg = Config.from_toml(args.config, **overrides)
    else:
        cfg = Config.from_env(**overrides)
    srv = Server(cfg)
    srv.open()
    import threading
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    srv.logger.info("shutting down")
    srv.close()
    return 0


def cmd_import(args) -> int:
    """CSV import: row,col[,timestamp] or col,value for -field-type=int
    (ctl/import.go:44-399)."""
    base = _base_url(args.host)
    if args.create:
        # 409 (already exists) is success for --create ("if missing")
        _http("POST", f"{base}/index/{args.index}",
              json.dumps({}).encode(), ok_codes=(409,))
        opts = {}
        if args.field_type == "int":
            opts = {"type": "int", "min": args.min, "max": args.max}
        elif args.field_type == "time":
            opts = {"type": "time", "timeQuantum": args.time_quantum}
        _http("POST", f"{base}/index/{args.index}/field/{args.field}",
              json.dumps({"options": opts}).encode(), ok_codes=(409,))

    url = f"{base}/index/{args.index}/field/{args.field}/import"
    total = 0
    rows, cols, vals, tss = [], [], [], []

    def flush():
        nonlocal rows, cols, vals, tss, total
        if not cols:
            return
        if args.field_type == "int":
            payload = {"columnIDs": cols, "values": vals}
            if args.clear:
                payload["clear"] = True
                payload.pop("values")
        else:
            payload = {"rowIDs": rows, "columnIDs": cols}
            if any(tss):
                payload["timestamps"] = tss
            if args.clear:
                payload["clear"] = True
        _http("POST", url, json.dumps(payload).encode())
        total += len(cols)
        rows, cols, vals, tss = [], [], [], []

    files = args.files or ["-"]
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if args.field_type == "int":
                cols.append(int(parts[0]))
                vals.append(int(parts[1]))
            else:
                rows.append(int(parts[0]))
                cols.append(int(parts[1]))
                tss.append(int(parts[2]) if len(parts) > 2 else 0)
            if len(cols) >= args.batch_size:
                flush()
        if fh is not sys.stdin:
            fh.close()
    flush()
    print(f"imported {total} records into {args.index}/{args.field}")
    return 0


def cmd_ingest(args) -> int:
    """Stream a CSV/TSV file to the binary ingest endpoint
    (docs/ingest.md): lines of ``row,col[,ts]`` (or ``col,value`` with
    --field-type=int) are packed into length-prefixed CRC frames
    (ingest/wire.py) and POSTed in bounded batches.  503 responses honor
    Retry-After and resend the batch — frames are idempotent set
    bits/values, so a resend after a mid-stream failure is safe.  A
    progress line (records/s, MB/s, retries) goes to stderr."""
    import time as _time
    import urllib.error

    from .ingest import wire

    base = _base_url(args.host)
    if args.create:
        _http("POST", f"{base}/index/{args.index}",
              json.dumps({}).encode(), ok_codes=(409,))
        opts = {}
        if args.field_type == "int":
            opts = {"type": "int"}
        elif args.field_type == "time":
            opts = {"type": "time", "timeQuantum": args.time_quantum}
        _http("POST", f"{base}/index/{args.index}/field/{args.field}",
              json.dumps({"options": opts}).encode(), ok_codes=(409,))

    url = f"{base}/index/{args.index}/field/{args.field}/ingest"
    total = total_bytes = retries = 0
    t0 = _time.perf_counter()
    a_buf: list[int] = []
    b_buf: list[int] = []
    ts_buf: list[int] = []

    def progress(final=False):
        dt = max(_time.perf_counter() - t0, 1e-9)
        line = (f"\r{total} records  {total / dt:,.0f} rec/s  "
                f"{total_bytes / dt / 1e6:.1f} MB/s  retries {retries}")
        print(line + ("\n" if final else ""), end="", file=sys.stderr,
              flush=True)

    def send():
        nonlocal total, total_bytes, retries, a_buf, b_buf, ts_buf
        if not b_buf:
            return
        if args.field_type == "int":
            body = wire.encode_records(None, a_buf, values=b_buf)
        else:
            ts = ts_buf if any(ts_buf) else None
            body = wire.encode_records(a_buf, b_buf, ts=ts)
        for attempt in range(args.max_retries + 1):
            req = urllib.request.Request(url, data=body, method="POST")
            req.add_header("Content-Type", "application/octet-stream")
            if args.tenant:
                # explicit tenant token (docs/robustness.md "Tenant
                # isolation"): the stream rides that tenant's ingest
                # admission queue instead of the index-derived one
                req.add_header("X-Pilosa-Tpu-Tenant", args.tenant)
            try:
                with urllib.request.urlopen(req) as resp:
                    resp.read()
                break
            except urllib.error.HTTPError as e:
                e.read()
                if e.code != 503 or attempt >= args.max_retries:
                    raise SystemExit(
                        f"\ningest: {e.code} {e.reason}")
                retries += 1
                try:
                    wait = float(e.headers.get("Retry-After") or 1)
                except (TypeError, ValueError):
                    wait = 1.0
                _time.sleep(min(wait, 30.0))
            except (urllib.error.URLError, ConnectionError) as e:
                # a dropped connection mid-batch is retryable too: the
                # server only acks after its group commit, and frames
                # are idempotent — resending cannot double-apply
                if attempt >= args.max_retries:
                    raise SystemExit(f"\ningest: {e}")
                retries += 1
                _time.sleep(1.0)
        total += len(b_buf)
        total_bytes += len(body)
        a_buf, b_buf, ts_buf = [], [], []
        progress()

    files = args.files or ["-"]
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        sep = None  # sniffed per file: TSV if the first line has a tab
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if sep is None:
                sep = "\t" if "\t" in line else ","
            parts = line.split(sep)
            if args.field_type == "int":
                a_buf.append(int(parts[0]))   # col
                b_buf.append(int(parts[1]))   # value
            else:
                a_buf.append(int(parts[0]))   # row
                b_buf.append(int(parts[1]))   # col
                ts_buf.append(int(parts[2]) if len(parts) > 2 else 0)
            if len(b_buf) >= args.batch_size:
                send()
        if fh is not sys.stdin:
            fh.close()
    send()
    progress(final=True)
    print(f"ingested {total} records into {args.index}/{args.field}")
    return 0


def cmd_export(args) -> int:
    """(ctl/export.go:35-112).  Each shard is fetched from a node that
    OWNS it (ctl/export.go fragment-nodes routing) — a single-host fetch
    would silently miss shards placed on other cluster nodes."""
    base = _base_url(args.host)
    scheme = base.split("://", 1)[0]
    maxes = _http("GET", f"{base}/internal/shards/max")["standard"]
    max_shard = maxes.get(args.index, 0)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    for shard in range(max_shard + 1):
        nodes = _http("GET", f"{base}/internal/fragment/nodes"
                             f"?index={args.index}&shard={shard}")
        hosts = [n["uri"] for n in nodes if n.get("uri")] or [args.host]
        last_err = None
        for host in hosts:  # replica failover: any live owner serves
            # node URIs may already carry a scheme (TLS clusters); bare
            # hosts inherit the scheme used for args.host
            h_scheme, _, h_bare = str(host).rpartition("://")
            url = (f"{h_scheme or scheme}://{h_bare}"
                   f"/export?index={args.index}"
                   f"&field={args.field}&shard={shard}")
            try:
                with urllib.request.urlopen(
                        urllib.request.Request(url)) as resp:
                    out.write(resp.read().decode())
                last_err = None
                break
            except OSError as e:
                last_err = e
        if last_err is not None:
            print(f"export: shard {shard}: no reachable owner "
                  f"({last_err})", file=sys.stderr)
            if out is not sys.stdout:
                out.close()
            return 1
    if out is not sys.stdout:
        out.close()
    return 0


import contextlib


@contextlib.contextmanager
def _fail_stop_opens():
    """Offline check/inspect must REPORT corruption, not quarantine it:
    disable quarantine-on-corruption (and its sidecar-marker side
    effect) for the duration so a bad file raises like it always did."""
    from .storage import fragment as fragment_mod

    prev = fragment_mod.QUARANTINE_ON_CORRUPTION
    fragment_mod.QUARANTINE_ON_CORRUPTION = False
    try:
        yield
    finally:
        fragment_mod.QUARANTINE_ON_CORRUPTION = prev


def cmd_check(args) -> int:
    """Offline fragment file integrity check (ctl/check.go:28-135)."""
    import numpy as np

    from .core import SHARD_WORDS
    from .storage.fragment import Fragment

    ok = True
    with _fail_stop_opens():
        for path in args.files:
            if path.endswith(".wal"):
                continue
            try:
                frag = Fragment(path, "check", "check", "check", 0)
                n = int(np.unique(frag._idx // SHARD_WORDS).size)
                print(f"{path}: OK rows_with_data={n}")
                frag.close()
            except Exception as e:
                ok = False
                print(f"{path}: CORRUPT {e}")
    return 0 if ok else 1


def cmd_analyze(args) -> int:
    """Run the port's invariant analyzer over a checkout
    (docs/static-analysis.md): AST lint rules plus the cross-file
    metric / event / alert / failpoint catalogs.  Exits non-zero on any
    finding."""
    from .analysis.astlint import main as analysis_main
    argv = ["--root", args.root]
    for r in args.rule or []:
        argv += ["--rule", r]
    if args.list_rules:
        argv.append("--list-rules")
    return analysis_main(argv)


def cmd_inspect(args) -> int:
    """Fragment stats (ctl/inspect.go:30-110)."""
    import numpy as np

    from .core import SHARD_WORDS
    from .storage.fragment import Fragment

    with _fail_stop_opens():
        for path in args.files:
            frag = Fragment(path, "inspect", "inspect", "inspect", 0)
            n_bits = int(np.bitwise_count(frag._val).sum())
            rows_used = int(np.unique(frag._idx // SHARD_WORDS).size)
            total_bits = frag.n_rows * SHARD_WORDS * 32
            density = n_bits / total_bits if total_bits else 0.0
            print(json.dumps({
                "path": path, "rows": frag.n_rows,
                "rowsWithData": rows_used,
                "bits": n_bits, "density": round(density, 6),
                "sizeBytes": frag.host_bytes(),
            }))
            frag.close()
    return 0


def _top_cluster(args) -> int:
    """``top --cluster``: poll /debug/cluster and render the fleet —
    per-node qps/p99/HBM/hedges with staleness flags plus the tail of
    the merged event timeline (docs/observability.md "Cluster
    plane")."""
    import time as _time

    base = _base_url(args.host)
    mb = 1 << 20
    polls = 0
    try:
        while True:
            c = _http("GET", f"{base}/debug/cluster")
            nodes = c.get("nodes") or {}
            print(f"-- pilosa-tpu fleet @ {args.host}  "
                  f"coordinator {c.get('coordinator')}  "
                  f"epoch {c.get('epoch')}  "
                  f"overlay {c.get('overlayEpoch')}")
            print(f"   {'node':<8} {'state':<8} {'qps':>7} {'p99ms':>8} "
                  f"{'hbmMB':>7} {'evict':>6} {'retrc':>6} "
                  f"{'hedges':>8} {'waves':>6} {'quar':>5} {'stale':>6}")
            for nid in sorted(nodes):
                n = nodes[nid]
                stale = "-" if not n.get("stale") else (
                    f"{n['staleS']:.0f}s" if n.get("staleS") is not None
                    else "?")
                p99 = n.get("p99Ms")
                hedges = f"{n.get('hedges', '-')}/{n.get('hedgeWins', '-')}"
                print(f"   {nid:<8} {n.get('state', '?'):<8} "
                      f"{n.get('qps', 0):>7.1f} "
                      f"{p99 if p99 is not None else '-':>8} "
                      f"{n.get('hbmResidentBytes', 0) // mb:>7} "
                      f"{n.get('evictions', '-'):>6} "
                      f"{n.get('retraces', '-'):>6} "
                      f"{hedges:>8} "
                      f"{n.get('retryWaves', '-'):>6} "
                      f"{n.get('quarantinedFragments', '-'):>5} "
                      f"{stale:>6}")
            tail = (c.get("timeline") or [])[-args.events:] \
                if args.events > 0 else []
            if tail:
                print("   -- recent events")
                for e in tail:
                    extra = " ".join(
                        f"{k}={v}" for k, v in e.items()
                        if k not in ("event", "node", "wall", "seq"))
                    print(f"   {e.get('node', '?'):<8} "
                          f"{e.get('event')} {extra}")
            polls += 1
            if args.count and polls >= args.count:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_top(args) -> int:
    """Live terminal summary of one node: poll /debug/timeseries +
    /debug/vars and render qps, p99, the HBM split, evictions/s, and
    compile/retrace counts — the operator loop for a box with no
    Prometheus attached (docs/observability.md "Device runtime").
    ``--cluster`` renders the whole fleet from /debug/cluster
    instead."""
    import time as _time

    if args.cluster:
        return _top_cluster(args)
    base = _base_url(args.host)
    mb = 1 << 20
    polls = 0
    prev_retraces = None
    try:
        while True:
            v = _http("GET", f"{base}/debug/vars")
            ts = _http("GET", f"{base}/debug/timeseries")
            samples = ts.get("samples") or []
            last = samples[-1] if samples else {}
            dt = ts.get("intervalS") or 1.0
            qps = last.get("httpQueriesDelta", 0) / dt
            evs = last.get("evictionsDelta", 0) / dt
            p99 = (v.get("timings", {}).get("http.query") or {}).get("p99")
            p99s = f"{p99 * 1e3:.1f}" if p99 is not None else "-"
            bud = v.get("deviceBudget", {})
            dev = v.get("device", {})
            comp = dev.get("compiles", {})
            lau = dev.get("launches", {})
            adm = (v.get("admission") or {}).get("public", {})
            bat = v.get("dispatchBatcher") or {}
            retr = comp.get("retraces", 0)
            flag = ""
            if prev_retraces is not None and retr > prev_retraces:
                # the PR-7-class red flag, front and center
                flag = f"  !! +{retr - prev_retraces} RETRACE"
            prev_retraces = retr
            print(f"-- pilosa-tpu top @ {args.host}  "
                  f"up {last.get('uptimeS', '-')}s  "
                  f"({len(samples)} samples x {dt}s)")
            print(f"   qps {qps:.1f}  p99 {p99s}ms  "
                  f"inflight {adm.get('inUse', 0)}  "
                  f"waiting {adm.get('waiting', 0)}  "
                  f"batcher queued {bat.get('queued', 0)}")
            print(f"   hbm {bud.get('residentBytes', 0) // mb}MB resident"
                  f" ({bud.get('compressedBytes', 0) // mb}MB compressed"
                  f" / {bud.get('denseBytes', 0) // mb}MB dense"
                  f" / {bud.get('pinnedBytes', 0) // mb}MB pinned)  "
                  f"evictions/s {evs:.2f}")
            # compile-s/interval: the ring's capture-seconds delta —
            # a warm restart's captures land before READY
            comp_s = last.get("compileSDelta", 0.0)
            print(f"   device: compiles {comp.get('compiles', 0)}  "
                  f"retraces {retr}{flag}  "
                  f"compile-s/int {comp_s:.2f}  "
                  f"launches {lau.get('launches', 0)}  "
                  f"padding {100 * lau.get('paddingWasteRatio', 0):.1f}%  "
                  f"decode peak {lau.get('decodePeakBytes', 0) // mb}MB")
            # container-kernel plane: the resolved backend rides the
            # device.kernel_backend 0/1 gauge (1 = the CUDA kernels)
            kb = (v.get("gauges") or {}).get("device.kernel_backend")
            print(f"   kernels: backend "
                  f"{'-' if kb is None else 'cuda' if kb else 'torch'}  "
                  f"launches {lau.get('kernelLaunches', 0)}  "
                  f"tiles {lau.get('kernelTiles', 0)}")
            active = (v.get("alerts") or {}).get("active") or {}
            if active:
                print("   !! ALERTS: " + "  ".join(
                    f"{aid}[{a.get('severity')}]"
                    for aid, a in sorted(active.items())))
            warm = v.get("warmup") or {}
            if warm.get("phase") == "warming":
                print(f"   WARMING: {warm.get('replayed', 0)}"
                      f"/{warm.get('planned', 0)} replayed  "
                      f"errors {warm.get('errors', 0)}  "
                      f"budget {warm.get('budgetS', 0)}s")
            # per-peer routing load (docs/cluster.md "Read routing &
            # rebalancing"): EWMA RTT, in-flight depth, breaker state
            routing = (v.get("cluster") or {}).get("routing") or {}
            for nid, pr in sorted((routing.get("peers") or {}).items()):
                rtt = pr.get("ewmaRttMs")
                print(f"   peer {nid}: "
                      f"rtt {rtt if rtt is not None else '-'}ms  "
                      f"inflight {pr.get('inFlight', 0)}"
                      f"+{pr.get('reportedInFlight', 0)}  "
                      f"queued {pr.get('reportedQueued', 0)}  "
                      f"dispatches {pr.get('dispatches', 0)}"
                      f"{'  BREAKER-OPEN' if pr.get('breakerOpen') else ''}"
                      f"{'  DOWN' if pr.get('state') == 'DOWN' else ''}")
            polls += 1
            if args.count and polls >= args.count:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_alerts(args) -> int:
    """Render /debug/alerts: objectives, burn-rate windows, the active
    alert table, and recent fire/resolve transitions
    (docs/observability.md "SLOs & alerting")."""
    base = _base_url(args.host)
    a = _http("GET", f"{base}/debug/alerts")
    if not a.get("enabled"):
        print("alert evaluation disabled (alert-rules = \"off\" "
              "or the time-series sampler is off)")
        return 0
    w = a.get("windows") or {}
    print(f"-- pilosa-tpu alerts @ {args.host}  "
          f"target {a.get('target')}  "
          f"latency-slo {a.get('latencyMs')}ms  "
          f"burn >{a.get('burnThreshold')}x  "
          f"windows {w.get('fastS')}s/{w.get('slowS')}s")
    print(f"   evaluations {a.get('evaluations', 0)}  "
          f"fired {a.get('firedTotal', 0)}  "
          f"resolved {a.get('resolvedTotal', 0)}")
    active = a.get("active") or {}
    if not active:
        print("   no active alerts")
    for aid, al in sorted(active.items()):
        print(f"   ACTIVE [{al.get('severity')}] {aid}  "
              f"for {al.get('durationS', 0):.0f}s  "
              f"{al.get('detail', '')}")
    hist = (a.get("history") or [])[-args.history:]
    if hist:
        import time as _time
        print("   -- recent transitions")
        for h in hist:
            when = _time.strftime("%H:%M:%S",
                                  _time.localtime(h.get("wall", 0)))
            extra = h.get("detail", "") \
                if h.get("action") == "fire" else ""
            print(f"   {when} {h.get('action'):<7} "
                  f"[{h.get('severity')}] {h.get('id')}  {extra}")
    rec = a.get("flightRecorder")
    if rec:
        last = rec.get("last") or {}
        print(f"   flight recorder: {rec.get('captures', 0)} bundles  "
              f"{rec.get('diskBytes', 0) >> 20}MB"
              f"/{rec.get('budgetMb', 0)}MB"
              + (f"  last {last.get('path')}" if last else ""))
    return 0


def cmd_bundle(args) -> int:
    """POST /debug/bundle: capture an on-demand flight-recorder
    diagnostic bundle and print where it landed."""
    base = _base_url(args.host)
    out = _http("POST", f"{base}/debug/bundle",
                json.dumps({"reason": args.reason}).encode())
    last = out.get("last") or {}
    print(f"bundle written: {out.get('path')} "
          f"({last.get('bytes', 0) >> 10} KiB)")
    return 0


DEFAULT_CONFIG = """\
# pilosa-tpu configuration (PyTorch / CUDA port)
data-dir = "{data_dir}"
bind = "localhost:10101"
max-op-n = 10000
device = "cuda"                # torch device; "cpu" runs the plain paths
# compile-cache-dir and compile-cache-mb are accepted and unused: CUDA
# graphs do not outlive their process (the warm start replays instead).
# max-body-mb = 1024
# compressed residency (docs/memory-budget.md)
# compressed-resident = true   # sparse fragments stay HBM-resident as
#                              # packed container streams under a
#                              # device-budget limit
# compress-max-density = 0.5   # dense fallback: compress only below
#                              # this fraction of the dense footprint
# decode-workspace-mb = 1024   # per-launch dense decode ceiling
#                              # (bounds the jnp backend only)
# container-kernels = "auto"   # the only value: CUDA kernels on a CUDA
#                              # device, their plain versions on the CPU
# cross-query dynamic batching (docs/batching.md)
# dispatch-batch = true         # fuse compatible in-flight queries
# dispatch-batch-max = 32       # queries per fused device launch
# dispatch-batch-window-us = 200  # max solo wait for batch company
# whole-query pjit programs (docs/whole-query.md)
# whole-query = true            # one compiled program per read request
# whole-query-fallback = "legacy"  # or "error": raise instead of
#                               # rerouting unsupported shapes
# streaming ingest (docs/ingest.md)
# ingest-flush-ms = 50     # group-commit window: one WAL frame + one gen
#                          # bump per fragment per flush
# ingest-delta-mb = 64     # device delta-overlay journal budget, 0 = off
# ingest-max-frame-mb = 32 # per-frame ceiling on the ingest wire
# query cache subsystem (docs/caching.md)
# result-cache-mb = 256    # generation-keyed result cache budget, 0 = off
# rank-rebuild-rows = 4096 # incremental rank-cache ceiling per batch
# overload armor (docs/robustness.md)
# query-timeout = 0        # default per-query deadline seconds, 0 = off
# max-queries = 64         # concurrent-query slots (public + internal)
# queue-timeout = 0.5      # seconds to wait for a slot before 503
# breaker-threshold = 5    # consecutive peer failures -> circuit open
# drain-seconds = 5        # graceful-drain budget on shutdown
# tail-tolerant reads (docs/robustness.md "Tail-tolerant fan-out")
# hedge-reads = true       # speculative duplicate of straggling read
#                          # RPCs; first answer wins, writes never hedge
# hedge-delay-ms = 0       # 0 = derive from the router's EWMA RTT
# partial-results = false  # server default for ?partialResults: serve
#                          # reads with unservable shards, naming the
#                          # missing shards in the degraded object
# internal-wire = "bin1"   # /internal/query transport: PTPUQRY1 framed
#                          # binary (roaring-packed segments), per-peer
#                          # negotiated; "json" restores the JSON
#                          # envelope exactly (docs/cluster.md)
# durability & recovery (docs/robustness.md)
# wal-crc = true           # CRC-frame new WAL files (torn-tail recovery)
# quarantine-on-corruption = true  # corrupt fragment -> quarantine +
#                          # replica repair instead of failing startup
# repair-interval = 60     # seconds between quarantine-repair sweeps
# observability (docs/observability.md)
# slow-query-threshold = 1 # seconds before a query lands in /debug/slow
# slow-log-size = 128      # slow-query ring-buffer entries
# slow-log-text-max = 512  # query-text chars stored per slow entry
#                          # (over-ceiling entries marked textTruncated)
# profile-default = false  # profile tree on every response, not just
#                          # ?profile=true
# trace-sample-rate = 1.0  # fraction of traces recorded (cluster-wide)
# timeseries-interval = 5  # seconds between /debug/timeseries samples,
#                          # 0 = sampler off
# timeseries-window = 600  # seconds of history the time-series ring keeps
# launch-ledger-size = 256 # /debug/launches ring entries
# event-journal-size = 512 # /debug/events ring entries (breaker/node/
#                          # quarantine/overlay/resize transitions)
# event-log = false        # persist the journal to <data-dir>/events.log
#                          # (length+CRC framed JSON records)
# batch-temp-mb = 4096     # per-launch batch-temp workspace for fused
#                          # [B, rows, W] row_counts/TopN device temps
# SLOs & alerting (docs/observability.md "SLOs & alerting")
# slo-latency-ms = 500     # latency objective: queries over this are
#                          # SLO-bad for the burn-rate evaluator
# slo-target = 0.999       # good-fraction objective for availability
#                          # and latency SLOs
# alert-rules = "all"      # "all", "off", or a comma list of rule ids
#                          # (catalog in docs/observability.md)
# flight-recorder-mb = 64  # on-alert diagnostic bundle disk budget
#                          # under <data-dir>/flightrec, 0 = off
# warm start (docs/warmup.md)
# compile-cache-dir = ""   # accepted and unused on the port
# compile-cache-mb = 256   # accepted and unused on the port
# warmup-top-n = 32        # corpus signatures replayed (twice each, so
#                          # their CUDA graphs are captured) before
#                          # READY, 0 = no warmup replay
# warmup-budget-s = 30     # wall-clock budget for the warmup replay

# elastic serving (docs/cluster.md "Read routing & rebalancing")
# read-routing = "loaded"  # or "primary" (pin to jump-hash primary),
#                          # "round-robin"
# residency-routing = true # prefer the replica holding the shard
#                          # HBM-resident / host-staged
# balancer = false         # hot-shard handoffs (coordinator-driven,
#                          # epoch-gated placement overlay)
# balancer-interval = 30   # seconds between balancer ticks
# hot-shard-threshold = 4  # hot = this multiple of the mean shard load

[cluster]
# hosts = ["localhost:10101", "localhost:10102"]
replicas = 1

[anti-entropy]
interval = 600
"""


def cmd_generate_config(args) -> int:
    from .server.server import DEFAULT_DATA_DIR
    print(DEFAULT_CONFIG.format(data_dir=DEFAULT_DATA_DIR), end="")
    return 0


def cmd_config(args) -> int:
    """Print the RESOLVED configuration after the TOML < env < flag
    cascade (reference `pilosa config`, cmd/config.go)."""
    from .server.server import Config

    cfg = Config.from_toml(args.config) if args.config else \
        Config.from_env()
    q = json.dumps  # JSON string syntax is valid TOML basic-string syntax
    print(f"data-dir = {q(cfg.data_dir)}")
    print(f"bind = {q(cfg.bind)}")
    print(f"device = {q(cfg.device)}")
    print(f"max-op-n = {cfg.max_op_n}")
    print(f"max-row-id = {cfg.max_row_id}")
    print(f"use-mesh = {str(cfg.use_mesh).lower()}")
    print(f"dispatch-batch = {str(cfg.dispatch_batch).lower()}")
    print(f"dispatch-batch-max = {cfg.dispatch_batch_max}")
    print(f"dispatch-batch-window-us = {cfg.dispatch_batch_window_us}")
    print(f"whole-query = {str(cfg.whole_query).lower()}")
    print(f"whole-query-fallback = {q(cfg.whole_query_fallback)}")
    print(f"device-budget-mb = {cfg.device_budget_mb}")
    print(f"compressed-resident = {str(cfg.compressed_resident).lower()}")
    print(f"compress-max-density = {cfg.compress_max_density}")
    print(f"decode-workspace-mb = {cfg.decode_workspace_mb}")
    print(f"container-kernels = {q(cfg.container_kernels)}")
    print(f"ingest-flush-ms = {cfg.ingest_flush_ms}")
    print(f"ingest-delta-mb = {cfg.ingest_delta_mb}")
    print(f"ingest-max-frame-mb = {cfg.ingest_max_frame_mb}")
    print(f"max-body-mb = {cfg.max_body_mb}")
    print(f"result-cache-mb = {cfg.result_cache_mb}")
    print(f"rank-rebuild-rows = {cfg.rank_rebuild_rows}")
    print(f"query-timeout = {cfg.query_timeout}")
    print(f"max-queries = {cfg.max_queries}")
    print(f"queue-timeout = {cfg.queue_timeout}")
    print(f"breaker-threshold = {cfg.breaker_threshold}")
    print(f"drain-seconds = {cfg.drain_seconds}")
    print(f"health-down-threshold = {cfg.health_down_threshold}")
    print(f"hedge-reads = {str(cfg.hedge_reads).lower()}")
    print(f"hedge-delay-ms = {cfg.hedge_delay_ms}")
    print(f"partial-results = {str(cfg.partial_results).lower()}")
    print(f"internal-wire = {q(cfg.internal_wire)}")
    print(f"read-routing = {q(cfg.read_routing)}")
    print(f"residency-routing = {str(cfg.residency_routing).lower()}")
    print(f"balancer = {str(cfg.balancer).lower()}")
    print(f"balancer-interval = {cfg.balancer_interval}")
    print(f"hot-shard-threshold = {cfg.hot_shard_threshold}")
    print(f"wal-crc = {str(cfg.wal_crc).lower()}")
    print(f"quarantine-on-corruption = "
          f"{str(cfg.quarantine_on_corruption).lower()}")
    print(f"repair-interval = {cfg.repair_interval}")
    print(f"slow-query-threshold = {cfg.slow_query_threshold}")
    print(f"slow-log-size = {cfg.slow_log_size}")
    print(f"slow-log-text-max = {cfg.slow_log_text_max}")
    print(f"profile-default = {str(cfg.profile_default).lower()}")
    print(f"trace-sample-rate = {cfg.trace_sample_rate}")
    print(f"timeseries-interval = {cfg.timeseries_interval}")
    print(f"timeseries-window = {cfg.timeseries_window}")
    print(f"launch-ledger-size = {cfg.launch_ledger_size}")
    print(f"event-journal-size = {cfg.event_journal_size}")
    print(f"event-log = {str(cfg.event_log).lower()}")
    print(f"batch-temp-mb = {cfg.batch_temp_mb}")
    print(f"slo-latency-ms = {cfg.slo_latency_ms}")
    print(f"slo-target = {cfg.slo_target}")
    print(f"alert-rules = {q(cfg.alert_rules)}")
    print(f"flight-recorder-mb = {cfg.flight_recorder_mb}")
    print()
    print("[cluster]")
    print(f"hosts = [{', '.join(q(h) for h in cfg.cluster_hosts)}]")
    print(f"replicas = {cfg.replica_n}")
    print()
    print("[anti-entropy]")
    print(f"interval = {cfg.anti_entropy_interval}")
    if cfg.tls_certificate:
        print()
        print("[tls]")
        print(f"certificate = {q(cfg.tls_certificate)}")
        print(f"key = {q(cfg.tls_key)}")
        if cfg.tls_ca_certificate:
            print(f"ca-certificate = {q(cfg.tls_ca_certificate)}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu-torch",
        description="bitmap index on one NVIDIA GPU (PyTorch / CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("server", help="run a server node")
    sp.add_argument("-c", "--config", help="TOML config file")
    sp.add_argument("-d", "--data-dir", default=None)
    sp.add_argument("-b", "--bind", default=None)
    sp.add_argument("--cluster-hosts", default=None,
                    help="comma-separated host:port list (multi-node)")
    sp.add_argument("--node-id", default=None)
    sp.add_argument("--replicas", type=int, default=None)
    sp.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda, which "
                         "needs a card; cpu runs the plain paths)")
    sp.set_defaults(fn=cmd_server)

    sp = sub.add_parser("import", help="bulk-import CSV")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("--create", action="store_true",
                    help="create index/field if missing")
    sp.add_argument("--field-type", default="set",
                    choices=["set", "int", "time"])
    sp.add_argument("--min", type=int, default=0)
    sp.add_argument("--max", type=int, default=2 ** 32)
    sp.add_argument("--time-quantum", default="YMD")
    sp.add_argument("--clear", action="store_true")
    sp.add_argument("--batch-size", type=int, default=100_000,
                    help="records per import request (ctl/import.go "
                         "importBufferSize)")
    sp.add_argument("files", nargs="*")
    sp.set_defaults(fn=cmd_import)

    sp = sub.add_parser("ingest",
                        help="stream CSV/TSV to the binary ingest "
                             "endpoint")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("--create", action="store_true",
                    help="create index/field if missing")
    sp.add_argument("--field-type", default="set",
                    choices=["set", "int", "time"])
    sp.add_argument("--time-quantum", default="YMD")
    sp.add_argument("--batch-size", type=int, default=200_000,
                    help="records per POST (each POST is one framed "
                         "stream; 503s resend the whole batch)")
    sp.add_argument("--max-retries", type=int, default=8,
                    help="503 retries per batch before giving up")
    sp.add_argument("--tenant", default="",
                    help="explicit tenant token sent as "
                         "X-Pilosa-Tpu-Tenant (default: the server "
                         "derives the tenant from the index name)")
    sp.add_argument("files", nargs="*")
    sp.set_defaults(fn=cmd_ingest)

    sp = sub.add_parser("export", help="export a field as CSV")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--field", required=True)
    sp.add_argument("-o", "--output", default="-")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("check", help="check fragment file integrity")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("inspect", help="inspect fragment file stats")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("analyze",
                        help="run the port's invariant analyzer "
                             "(AST lint suite) over a checkout")
    sp.add_argument("--root", default=".",
                    help="repo checkout to analyze (default: cwd)")
    sp.add_argument("--rule", action="append", default=None,
                    help="run only this rule id (repeatable)")
    sp.add_argument("--list-rules", action="store_true")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("top", help="live terminal summary of a node")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls")
    sp.add_argument("--count", type=int, default=0,
                    help="polls before exiting (0 = forever)")
    sp.add_argument("--cluster", action="store_true",
                    help="render the fleet rollup (/debug/cluster): "
                         "per-node summaries + merged event timeline")
    sp.add_argument("--events", type=int, default=8,
                    help="timeline entries shown per --cluster poll")
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser("alerts",
                        help="show the SLO engine's alert state "
                             "(/debug/alerts)")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("--history", type=int, default=16,
                    help="recent fire/resolve transitions shown")
    sp.set_defaults(fn=cmd_alerts)

    sp = sub.add_parser("bundle",
                        help="capture an on-demand flight-recorder "
                             "diagnostic bundle (POST /debug/bundle)")
    sp.add_argument("-host", default="localhost:10101")
    sp.add_argument("--reason", default="manual",
                    help="reason tag embedded in the bundle filename")
    sp.set_defaults(fn=cmd_bundle)

    sp = sub.add_parser("generate-config", help="print default config")
    sp.set_defaults(fn=cmd_generate_config)

    sp = sub.add_parser("config",
                        help="print the resolved configuration")
    sp.add_argument("-c", "--config", help="TOML config file")
    sp.set_defaults(fn=cmd_config)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a closed reader (e.g. `| head`): standard
        # CLI behavior is to exit quietly
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
