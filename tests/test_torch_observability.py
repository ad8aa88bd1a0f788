"""End-to-end query observability of the PyTorch port: the
counterpart of tests/test_observability.py, with ``device="cpu"`` on
every server.  Cluster-wide trace propagation with cross-node span
parenting, per-query profile trees, log-bucket latency histograms with
golden percentile math, the slow-query log, and the Prometheus
exposition round-tripped through a minimal text parser.

Differential: a JAX server and a port server, sent the same requests,
expose the same ``/debug/vars`` keys, section by section, apart from
the deviations stated in ``VARS_DEVIATIONS`` (among them
``stackCache.executables``, the JAX package's count of compiled XLA
executables, which tests/test_server.py asserts and the port cannot
have; the port's server docstring states it).
"""

import socket
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.utils.slowlog import SlowQueryLog  # noqa: E402
from pilosa_tpu_torch.utils.stats import (  # noqa: E402
    TIMING_BUCKETS, NopStatsClient, StatsClient, StatsdClient, _Hist)
from pilosa_tpu_torch.utils.tracing import (  # noqa: E402
    PROBE_HEADER, TRACE_HEADER, Tracer, format_trace_header,
    parse_trace_header)

from test_torch_cluster import restore_knobs  # noqa: E402, F401
from test_torch_cluster_diff import jax_knobs  # noqa: E402, F401
from test_torch_cluster_obs import (  # noqa: E402
    Config, _free_ports, _req, make_server)


def _walk(node):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


# -- histogram math (golden values) ------------------------------------------

def test_hist_bucket_and_percentile_golden():
    h = _Hist()
    vals = [0.0002, 0.0004, 0.003, 0.004, 0.07, 0.2, 30.0, 200.0]
    for v in vals:
        h.observe(v)
    assert h.count == 8
    assert h.total == pytest.approx(sum(vals))
    # bucket placement: inclusive upper edges
    by_edge = dict(zip(TIMING_BUCKETS, h.buckets))
    assert by_edge[0.00025] == 1 and by_edge[0.0005] == 1
    assert by_edge[0.005] == 2
    assert by_edge[0.1] == 1 and by_edge[0.25] == 1
    assert by_edge[50.0] == 1
    assert h.buckets[-1] == 1  # 200 s -> +Inf
    # interpolated order statistics (hand-computed golden values):
    # p50 target=4.0 lands exactly at the top of the (0.0025, 0.005]
    # bucket; p75 target=6.0 at the top of (0.1, 0.25]; p99 target=7.92
    # falls in the +Inf bucket and clamps to the last edge.
    assert h.percentile(0.50) == pytest.approx(0.005)
    assert h.percentile(0.75) == pytest.approx(0.25)
    assert h.percentile(0.99) == pytest.approx(100.0)
    assert _Hist().percentile(0.5) is None


def test_stats_client_percentiles_and_snapshot():
    st = StatsClient()
    for ms in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
        st.timing("op", ms / 1000.0)
    snap = st.snapshot()["timings"]["op"]
    assert snap["count"] == 10
    assert snap["sum"] == pytest.approx(0.055)
    for q in ("p50", "p95", "p99"):
        assert snap[q] is not None
    # percentile() answers the same math directly, tags share state
    assert st.percentile("op", 0.5) == pytest.approx(snap["p50"])
    assert st.with_tags("index:i").percentile("op", 0.5) is None  # new key
    assert st.percentile("absent", 0.5) is None


def test_set_value_cardinality_cap():
    st = StatsClient()
    for i in range(200):
        st.set_value("v", f"val{i}")
    keys = [k for k in st.snapshot()["gauges"] if k.startswith("v:")]
    # first CAP distinct values keep their own series; the rest collapse
    assert len(keys) == StatsClient.SET_VALUE_CAP + 1
    assert "v:__other__" in keys


def test_nop_and_statsd_clients_implement_histogram_api():
    nop = NopStatsClient()
    nop.count("a")
    nop.gauge("b", 1)
    nop.timing("c", 0.1)
    nop.histogram("d", 2.0)
    nop.set_value("e", "x")
    with nop.timer("f"):
        pass
    assert nop.percentile("c", 0.5) is None
    assert nop.snapshot()["timings"] == {}

    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("localhost", 0))
    recv.settimeout(2)
    st = StatsdClient("localhost", recv.getsockname()[1])
    st.histogram("lat", 0.004)
    st.set_value("who", "alice")
    got = {recv.recvfrom(1024)[0].decode() for _ in range(2)}
    assert "lat:0.004|h" in got
    assert "who:alice|s" in got
    # in-process the histogram is bucketed like any timing
    assert st.percentile("lat", 0.5) is not None
    assert st.snapshot()["timings"]["lat"]["count"] == 1
    recv.close()


# -- trace context plumbing --------------------------------------------------

def test_trace_header_round_trip():
    assert parse_trace_header(None) == (None, None, True)
    assert parse_trace_header("abc") == ("abc", None, True)  # legacy form
    assert parse_trace_header(format_trace_header("t1", "s1")) == \
        ("t1", "s1", True)
    assert parse_trace_header(format_trace_header("t1", "s1", False)) == \
        ("t1", "s1", False)


def test_tracer_context_crosses_thread_pools():
    from concurrent.futures import ThreadPoolExecutor
    tr = Tracer()
    with ThreadPoolExecutor(1) as pool:
        with tr.span("root") as root:
            # task() re-installs the submitting thread's context in the
            # worker; a plain thread-local would return None here
            seen = pool.submit(tr.task(lambda: tr.current())).result()
            assert seen.trace_id == root.trace_id
            assert seen.span_id == root.span_id
            with_span = pool.submit(
                tr.task(lambda: tr.current().span_id, name="child"))
            assert with_span.result() != root.span_id
    spans = {s["name"]: s for s in tr.spans(root.trace_id)}
    assert spans["child"]["parentID"] == root.span_id


def test_trace_sampling_is_decided_at_the_root():
    tr = Tracer()
    tr.sample_rate = 0.0
    with tr.span("root") as root:
        with tr.span("child"):
            pass
    assert tr.spans(root.trace_id) == []
    # an unsampled remote continuation (":0" on the wire) stays unsampled
    with tr.span("remote", trace_id="t9", parent_id="p1", sampled=False):
        pass
    assert tr.spans("t9") == []


def test_slowlog_ring_is_bounded():
    log = SlowQueryLog(threshold_s=0.001, size=3)
    for i in range(10):
        log.record(index="i", query=f"Q{i}" + "x" * 2000,
                   duration_s=0.5, trace_id=f"t{i}")
    snap = log.snapshot()
    assert snap["recorded"] == 10
    assert len(snap["entries"]) == 3
    assert snap["entries"][-1]["traceID"] == "t9"
    assert len(snap["entries"][0]["query"]) <= 512
    assert not SlowQueryLog(threshold_s=0).enabled


# -- served surfaces ---------------------------------------------------------

def test_profile_tree_and_slowlog_http(tmp_path):
    srv = make_server(tmp_path, slow_query_threshold=1e-9,
                      result_cache_mb=8)
    p = srv.port
    try:
        _req(p, "POST", "/index/i", {})
        _req(p, "POST", "/index/i/field/f", {})
        _req(p, "POST", "/index/i/query", "Set(1, f=1)Set(99, f=1)")
        out, hdrs = _req(p, "POST", "/index/i/query?profile=true",
                         "Count(Row(f=1))")
        assert out["results"] == [2]
        # one trace id, echoed in the response header too
        assert out["traceID"] == hdrs[TRACE_HEADER]
        names = [n["name"] for n in _walk(out["profile"])]
        assert names[0] == "query"
        assert "admission" in names
        # the device launch went through the cross-query batcher
        assert "batcher.queue" in names and "batcher.launch" in names
        stages = {n["name"]: n for n in _walk(out["profile"])}
        assert stages["query"]["durationMS"] > 0
        assert stages["query"]["tags"]["index"] == "i"
        # repeat: served from the result cache, and the profile says so
        out2, _ = _req(p, "POST", "/index/i/query?profile=true",
                       "Count(Row(f=1))")
        lookups = [n for n in _walk(out2["profile"])
                   if n["name"] == "resultcache.lookup"]
        assert lookups and lookups[0]["tags"]["outcome"] == "hit"
        # without ?profile= the response carries no tree
        out3, _ = _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
        assert "profile" not in out3

        # every query crossed the 1ns threshold -> slow-query ring
        # (recording runs AFTER the response is sent — handler._observe
        # in the finally block — so poll rather than race it)
        deadline = time.perf_counter() + 5
        while True:
            slow, _ = _req(p, "GET", "/debug/slow")
            if slow["recorded"] >= 4 or time.perf_counter() > deadline:
                break
            time.sleep(0.01)
        assert slow["recorded"] >= 4
        entry = slow["entries"][-1]
        assert entry["index"] == "i"
        assert entry["query"] == "Count(Row(f=1))"
        assert entry["traceID"]
        # the repeat Count was a result-cache hit: it dispatched against
        # no shards, so its entry carries none — the first (uncached)
        # Count recorded the real shard count
        assert entry["shards"] is None
        assert any(e["shards"] == 1 for e in slow["entries"])
        assert entry["profile"]["name"] == "query"
        # the trace id in the entry is retrievable from /debug/traces
        spans, _ = _req(p, "GET",
                        f"/debug/traces?trace={entry['traceID']}")
        assert any(s["name"] == "api.Query" for s in spans["spans"])
        dv, _ = _req(p, "GET", "/debug/vars")
        assert dv["slowLog"]["recorded"] >= 4
    finally:
        srv.close()


def test_probes_excluded_from_histograms_and_slowlog(tmp_path):
    srv = make_server(tmp_path, slow_query_threshold=1e-9)
    p = srv.port
    try:
        _req(p, "POST", "/index/i", {})
        _req(p, "POST", "/index/i/field/f", {})
        _req(p, "POST", "/index/i/query", "Set(1, f=1)")

        def counts():
            dv, _ = _req(p, "GET", "/debug/vars")
            t = dv["timings"]
            return (t.get("http.request", {}).get("count", 0),
                    t.get("http.query", {}).get("count", 0),
                    dv["slowLog"]["recorded"])

        def settled(min_query):
            # post-request accounting runs AFTER the response is sent
            # (handler._observe in the finally block), so a /debug/vars
            # read can race it; poll until the expected query count
            # lands before asserting
            deadline = time.perf_counter() + 5
            c = counts()
            while c[1] < min_query and time.perf_counter() < deadline:
                time.sleep(0.01)
                c = counts()
            return c

        req0, query0, slow0 = settled(1)
        assert req0 >= 1 and query0 >= 1 and slow0 >= 1
        # background paths: status/metrics/debug never reach the
        # histograms (the /debug/vars reads above are themselves exempt)
        _req(p, "GET", "/status")
        with urllib.request.urlopen(
                f"http://localhost:{p}/metrics", timeout=30) as resp:
            resp.read()
        _req(p, "GET", "/debug/traces")
        # a probe-TAGGED query (the wire tag health probes carry) is
        # excluded from histograms and can never land in the slow log
        _req(p, "POST", "/index/i/query", "Count(Row(f=1))",
             headers={PROBE_HEADER: "1"})
        req1, query1, slow1 = counts()
        assert (req1, query1, slow1) == (req0, query0, slow0)
        # an untagged query still counts everywhere
        _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
        req2, query2, slow2 = settled(query0 + 1)
        assert (req2, query2, slow2) == (req0 + 1, query0 + 1, slow0 + 1)
        # background requests never root recorded traces either — probe
        # cadence must not evict real query traces from the span ring
        spans, _ = _req(p, "GET", "/debug/traces")
        assert not any(s["name"].startswith("GET /status")
                       for s in spans["spans"])
    finally:
        srv.close()


def _parse_prometheus(text):
    """Minimal Prometheus text-format parser: name -> {types, samples}
    where samples maps (name, frozenset(labels)) -> float."""
    types = {}
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            if line.startswith("# TYPE "):
                _, _, rest = line.partition("# TYPE ")
                fam, typ = rest.split()
                types[fam] = typ
            continue
        # OpenMetrics exemplar suffix (` # {trace_id="..."} v ts`) is
        # metadata, not the sample value — strip it like a real
        # exemplar-aware scraper does
        line = line.split(" # ")[0]
        metric, _, value = line.rpartition(" ")
        name, _, labelstr = metric.partition("{")
        labels = frozenset(
            kv for kv in labelstr.rstrip("}").split(",") if kv) \
            if labelstr else frozenset()
        samples[(name, labels)] = float(value)
    return types, samples


def test_metrics_histogram_round_trip(tmp_path):
    srv = make_server(tmp_path)
    p = srv.port
    try:
        _req(p, "POST", "/index/i", {})
        _req(p, "POST", "/index/i/field/f", {})
        for _ in range(3):
            _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
        fam = "pilosa_tpu_http_query_seconds"
        # the histogram observation lands in post-response accounting
        # (the _observe finally block), so poll the scrape until the
        # last query's sample settles
        deadline = time.monotonic() + 5.0
        while True:
            r = urllib.request.Request(f"http://localhost:{p}/metrics")
            with urllib.request.urlopen(r, timeout=30) as resp:
                text = resp.read().decode()
            types, samples = _parse_prometheus(text)
            if samples.get((f"{fam}_count", frozenset())) == 3 \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert types[fam] == "histogram"
        buckets = sorted(
            ((float(next(iter(ls)).split('"')[1])
              if '"+Inf"' not in next(iter(ls)) else float("inf")), v)
            for (n, ls) in samples if n == f"{fam}_bucket"
            for v in [samples[(n, ls)]])
        # cumulative and monotone, +Inf equals _count
        assert [v for _, v in buckets] == \
            sorted(v for _, v in buckets)
        assert buckets[-1][0] == float("inf")
        assert buckets[-1][1] == samples[(f"{fam}_count", frozenset())]
        assert samples[(f"{fam}_count", frozenset())] == 3
        assert samples[(f"{fam}_sum", frozenset())] > 0
        # p99 is derivable from the buckets (histogram_quantile shape)
        # and agrees with the server's own interpolation
        target = 0.99 * buckets[-1][1]
        cum_prev, lo = 0.0, 0.0
        for edge, cum in buckets:
            if cum >= target:
                n_in = cum - cum_prev
                frac = (target - cum_prev) / n_in if n_in else 1.0
                p99 = lo + frac * (edge - lo)
                break
            cum_prev, lo = cum, edge
        assert p99 == pytest.approx(
            srv.stats.percentile("http.query", 0.99))
    finally:
        srv.close()


# -- 2-node cluster: one trace spans both nodes ------------------------------

def test_cluster_trace_parenting_and_profile(tmp_path):
    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i in range(2):
            srv = Server(Config(
                data_dir=str(tmp_path / f"n{i}"), bind=hosts[i],
                node_id=f"node{i}", cluster_hosts=hosts, replica_n=1,
                anti_entropy_interval=0, use_mesh=False))
            servers.append(srv)
            srv.open()
        coord = servers[0]
        p0 = ports[0]
        _req(p0, "POST", "/index/ci", {})
        _req(p0, "POST", "/index/ci/field/f", {})
        # a shard owned SOLELY by the remote node, so the query must fan
        # out and the trace must cross the wire
        shard = next(
            s for s in range(64)
            if coord.cluster.placement.shard_nodes("ci", s) == ["node1"])
        col0 = shard * SHARD_WIDTH + 11
        _req(p0, "POST", "/index/ci/field/f/import",
             {"rowIDs": [3, 3], "columnIDs": [col0, col0 + 1]})
        out, _ = _req(p0, "POST", "/index/ci/query?profile=true",
                      "Count(Row(f=3))")
        assert out["results"] == [2]
        tid = out["traceID"]
        # coordinator profile: per-peer fan-out RTT with the peer's own
        # execution time split out
        peers = [n for n in _walk(out["profile"])
                 if n["name"].startswith("peer.")]
        assert peers and peers[0]["name"] == "peer.node1"
        assert peers[0]["tags"]["shards"] == 1
        assert peers[0]["tags"]["peerExecS"] >= 0
        assert peers[0]["tags"]["wireS"] >= 0

        spans, _ = _req(p0, "GET", f"/debug/traces?trace={tid}")
        spans = spans["spans"]
        assert spans and all(s["traceID"] == tid for s in spans)
        by_id = {s["spanID"]: s for s in spans}
        # remote span summaries were piggybacked on the /internal/query
        # response and adopted into the coordinator's ring
        remote = [s for s in spans if s.get("remote")]
        assert remote, "no remote spans adopted by the coordinator"
        rpc = next(s for s in spans
                   if s["name"].startswith("cluster.rpc node1"))
        remote_root = next(s for s in remote
                           if s["name"].startswith("POST /internal/query"))
        # cross-node parent links: remote handler span parents under the
        # coordinator's rpc span; remote execution under the handler span
        assert remote_root["parentID"] == rpc["spanID"]
        remote_exec = next(s for s in remote
                           if s["name"] == "executor.execute")
        assert remote_exec["parentID"] == remote_root["spanID"]
        # and the whole chain roots at the public request span
        assert by_id[rpc["parentID"]]["name"] == "api.Query"
        root = next(s for s in spans if s["parentID"] is None)
        assert root["name"].startswith("POST /index/ci/query")
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# -- differential: /debug/vars keys against the JAX server -------------------

# Keys of /debug/vars that one package has and the other has not, each
# with its reason.  Every other key, two levels deep, is in both.
VARS_DEVIATIONS = {
    # the JAX package counts its compiled XLA executables; the port has
    # none to count and reports stack stagings and ingest overlays
    "stackCache.executables": "jax",
    "stackCache.builds": "port",
    "stackCache.overlays": "port",
    # fields that only exist on the device: the torch device, the CUDA
    # graph registry of the whole-query runner, the kernel launch counts
    "device.device": "port",
    "device.graphs": "port",
    "device.kernelLaunches": "port",
    # the port also reports the ingest admission gate beside the public
    # and internal ones
    "admission.ingest": "port",
}


# sections keyed by data (tenant names, from a process-wide registry
# that other servers of the process also fill), compared by name only
DATA_KEYED = {"tenants"}


def _vars_keys(d, prefix="", depth=0):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if depth == 0 and isinstance(v, dict) and k not in DATA_KEYED:
            out |= _vars_keys(v, prefix + k + ".", 1)
    return out


def test_debug_vars_keys_match_jax(tmp_path, jax_knobs):
    from pilosa_tpu.server import server as jax_server

    jcfg = jax_server.Config(
        data_dir=str(tmp_path / "jax"), bind="localhost:0",
        compile_cache_dir="off", warmup_top_n=0, timeseries_interval=0,
        flight_recorder_mb=0, metric_poll_interval=0,
        anti_entropy_interval=0, slow_query_threshold=1e-9,
        result_cache_mb=8)
    pcfg = Config(data_dir=str(tmp_path / "port"), bind="localhost:0",
                  warmup_top_n=0, timeseries_interval=0,
                  flight_recorder_mb=0, anti_entropy_interval=0,
                  slow_query_threshold=1e-9, result_cache_mb=8)
    keys = {}
    for tag, srv in (("jax", jax_server.Server(jcfg)), ("port", Server(pcfg))):
        srv.open()
        try:
            p = srv.port
            _req(p, "POST", "/index/i", {})
            _req(p, "POST", "/index/i/field/f", {})
            _req(p, "POST", "/index/i/query", "Set(1, f=1)Set(99, f=1)")
            for _ in range(2):
                out, _ = _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
                assert out["results"] == [2]
            dv, _ = _req(p, "GET", "/debug/vars")
            keys[tag] = _vars_keys(dv)
        finally:
            srv.close()
    only = {k: "jax" for k in keys["jax"] - keys["port"]}
    only.update({k: "port" for k in keys["port"] - keys["jax"]})
    assert only == VARS_DEVIATIONS
