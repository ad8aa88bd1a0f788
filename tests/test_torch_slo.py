"""SLO engine + flight recorder on the PyTorch port (pilosa_tpu_torch/
utils/slo.py, utils/flightrec.py, the server's sampler and routes): the
cases of tests/test_slo.py against the port's modules and servers —
multi-window burn-rate math and the fire/resolve lifecycle over a real
TimeSeriesRing, every pathology rule against its synthetic trigger,
exact latency-good counting from the fixed histogram buckets, rule
selection, flight-recorder capture, rate limiting and LRU pruning, the
alert ids against docs/observability.md's catalog and runbook column,
answers byte-identical with evaluation on and off and equal to the JAX
executor's, and the real-socket straggler story on a 3-node port
cluster: a ChaosProxy straggler fires the latency burn alert, a bundle
lands on disk inside the budget, the alert resolves after the heal.

The JAX test runs the ``alert-names`` analyzer rule over a synthetic
tree; the port's ``alert-names`` rule (tests/test_torch_analysis.py)
lints the registrations against the catalog two ways, and the catalog
case here still reads the docs table directly, for the port's rule
registry and the JAX package's alike.  Answers are compared exactly.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server.handler import serialize_result  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.utils import slo as jax_slo  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.server import Config as _Config  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.utils import slo as slomod  # noqa: E402
from pilosa_tpu_torch.utils.flightrec import FlightRecorder  # noqa: E402
from pilosa_tpu_torch.utils.netchaos import ChaosProxy  # noqa: E402
from pilosa_tpu_torch.utils.slo import (RULES, EvalContext,  # noqa: E402
                                        SLOEngine)
from pilosa_tpu_torch.utils.stats import (TIMING_BUCKETS,  # noqa: E402
                                          StatsClient)
from pilosa_tpu_torch.utils.timeseries import TimeSeriesRing  # noqa: E402

from test_torch_cluster import _free_ports, _req, query  # noqa: E402
from test_torch_server import restore_knobs  # noqa: E402, F401


def Config(**kw):
    """The port server's Config on the CPU, without the metric poll."""
    return _Config(device="cpu", metric_poll_interval=0, **kw)


class _Log:
    def __init__(self):
        self.errors, self.infos = [], []

    def error(self, msg):
        self.errors.append(str(msg))

    def info(self, msg):
        self.infos.append(str(msg))


def _engine(ring=None, **kw):
    ring = ring or TimeSeriesRing(interval_s=1.0, window_s=40.0)
    kw.setdefault("logger", _Log())
    return SLOEngine(ring, StatsClient(), **kw), ring


def _push(ring, n, **cols):
    for _ in range(n):
        ring.sample(dict(cols), force=True)


# -- burn-rate math ---------------------------------------------------------


def test_burn_rate_and_window_sizing():
    eng, ring = _engine(target=0.999)
    # capacity 41 -> fast = max(2, 2) = 2, slow = max(6, 10) = 10
    assert eng.fast_n == 2 and eng.slow_n == 10
    _push(ring, 4, httpQueriesDelta=100, sloErrorsDelta=2)
    ctx = EvalContext(ring.last(eng.slow_n), eng)
    # 2% bad over a 0.1% budget = 20x in both windows
    assert ctx.burn("sloErrorsDelta", "httpQueriesDelta",
                    eng.fast_n) == pytest.approx(20.0)
    assert ctx.burn("sloErrorsDelta", "httpQueriesDelta",
                    eng.slow_n) == pytest.approx(20.0)


def test_no_traffic_burns_nothing():
    eng, ring = _engine()
    _push(ring, eng.slow_n, httpQueriesDelta=0, sloErrorsDelta=0)
    eng.evaluate()
    assert eng.active == {} and eng.fired_total == 0


def test_slow_window_guards_against_blips():
    """One bad fast-window interval must NOT fire: the slow window
    still averages healthy (the whole point of multi-window)."""
    eng, ring = _engine(target=0.999)
    _push(ring, eng.slow_n - 1, httpQueriesDelta=100, sloErrorsDelta=0)
    # the blip: 4 errors in the newest interval -> fast burn 20x (over
    # threshold) but slow burn only 4x (under) -> no page
    _push(ring, 1, httpQueriesDelta=100, sloErrorsDelta=4)
    eng.evaluate()
    assert "slo-availability-burn" not in eng.active


def test_fire_then_resolve_lifecycle():
    from pilosa_tpu_torch.utils.events import EVENTS
    fired_hook = []
    eng, ring = _engine(target=0.999, on_fire=fired_hook.append)
    seq0 = EVENTS.last_seq()
    _push(ring, eng.slow_n, httpQueriesDelta=100, sloErrorsDelta=50)
    eng.evaluate()
    assert "slo-availability-burn" in eng.active
    assert eng.fired_total == 1
    assert fired_hook and fired_hook[0]["id"] == "slo-availability-burn"
    assert fired_hook[0]["severity"] == "page"
    # still firing: no double count, detail refreshed
    eng.evaluate()
    assert eng.fired_total == 1
    # heal: fast window drains first, resolve after clear_after=2
    # consecutive healthy evaluations
    _push(ring, eng.fast_n, httpQueriesDelta=100, sloErrorsDelta=0)
    eng.evaluate()
    assert "slo-availability-burn" in eng.active  # 1 quiet eval only
    eng.evaluate()
    assert "slo-availability-burn" not in eng.active
    assert eng.resolved_total == 1
    names = [e["event"] for e in EVENTS.since(seq0)]
    assert "alert.fire" in names and "alert.resolve" in names
    hist = [h["action"] for h in eng.snapshot()["history"]]
    assert hist == ["fire", "resolve"]


def test_rule_selection_and_unknown_id():
    log = _Log()
    eng, _ = _engine(rules="off")
    assert not eng.enabled
    eng2, _ = _engine(rules="quarantine,nope-nope", logger=log)
    assert set(eng2.rules) == {"quarantine"}
    assert any("nope-nope" in m for m in log.errors)
    eng3, _ = _engine(rules="all")
    assert set(eng3.rules) == set(RULES)


def test_broken_rule_is_logged_not_fatal(monkeypatch):
    log = _Log()
    eng, ring = _engine(logger=log)

    def boom(ctx):
        raise RuntimeError("rule bug")

    monkeypatch.setitem(
        eng.rules, "quarantine",
        slomod.AlertRule("quarantine", "ticket", "", boom))
    _push(ring, 2, httpQueriesDelta=1)
    eng.evaluate()  # must not raise
    assert any("quarantine" in m for m in log.errors)
    assert eng.evaluations == 1


# -- pathology rules --------------------------------------------------------


@pytest.mark.parametrize("col,threshold_attr,rule_id", [
    ("retracesDelta", "RETRACE_STORM", "retrace-storm"),
    ("evictionsDelta", "EVICTION_PRESSURE", "eviction-pressure"),
    ("ingestRejectedDelta", "INGEST_BACKPRESSURE", "ingest-backpressure"),
    ("breakerOpensDelta", "BREAKER_FLAPS", "breaker-flapping"),
])
def test_pathology_threshold_rules(col, threshold_attr, rule_id):
    thr = getattr(slomod, threshold_attr)
    eng, ring = _engine()
    _push(ring, 1, **{col: thr - 1})
    eng.evaluate()
    assert rule_id not in eng.active
    _push(ring, 1, **{col: thr})
    eng.evaluate()
    assert rule_id in eng.active


def test_hedge_storm_needs_fraction_and_floor():
    eng, ring = _engine()
    # plenty of hedges but a tiny fraction of queries: healthy
    _push(ring, 1, hedgesDelta=slomod.HEDGE_STORM_MIN,
          httpQueriesDelta=1000)
    eng.evaluate()
    assert "hedge-storm" not in eng.active
    # majority of queries hedged AND above the absolute floor (fresh
    # ring: the slow window must not still hold the healthy sample)
    eng2, ring2 = _engine()
    _push(ring2, 1, hedgesDelta=40, httpQueriesDelta=50)
    eng2.evaluate()
    assert "hedge-storm" in eng2.active


def test_quarantine_is_a_level_gauge_rule():
    eng, ring = _engine()
    _push(ring, 1, quarantinedFragments=0)
    eng.evaluate()
    assert "quarantine" not in eng.active
    _push(ring, 1, quarantinedFragments=2)
    eng.evaluate()
    assert "quarantine" in eng.active
    assert "2" in eng.active["quarantine"]["detail"]


def test_latency_burn_names_worst_tenant():
    class Reg:
        def snapshot(self):
            return {"polite": {"p99Ms": 10.0},
                    "noisy": {"p99Ms": 900.0},
                    "worse": {"p99Ms": 1200.0}}

    eng, ring = _engine(latency_ms=500.0, tenant_registry=Reg())
    _push(ring, eng.slow_n, httpQueriesDelta=10, sloSlowQueriesDelta=10)
    eng.evaluate()
    assert "worse" in eng.active["slo-latency-burn"]["detail"]


# -- exact good-count from the fixed histogram ------------------------------


def test_bucket_count_le_exact_at_edges():
    st = StatsClient()
    assert 0.05 in TIMING_BUCKETS and 0.5 in TIMING_BUCKETS
    for v in (0.01, 0.04, 0.2, 0.9):
        st.timing("http.query", v)
    assert st.bucket_count_le("http.query", 0.05) == 2
    assert st.bucket_count_le("http.query", 0.5) == 3
    # a non-edge bound snaps DOWN (conservative: never counts a bad
    # query as good) — 0.3 s sits in the (0.25, 0.5] bucket, so only
    # the <= 0.25 counts qualify
    assert st.bucket_count_le("http.query", 0.3) == \
        st.bucket_count_le("http.query", 0.25)
    assert st.bucket_count_le("never.recorded", 0.5) == 0


# -- flight recorder --------------------------------------------------------


def test_flightrec_capture_and_stamp(tmp_path):
    rec = FlightRecorder(str(tmp_path / "fr"), budget_mb=4)
    path = rec.capture("alert-x y/z", lambda: {"k": 1})
    assert path is not None and os.path.isfile(path)
    assert "alert-x-y-z" in os.path.basename(path)  # sanitized reason
    data = json.loads(open(path).read())
    assert data["k"] == 1 and data["reason"] == "alert-x-y-z"
    assert rec.captures == 1
    assert rec.last["path"] == path and rec.last["bytes"] > 0


def test_flightrec_rate_limit_and_force(tmp_path):
    rec = FlightRecorder(str(tmp_path / "fr"), budget_mb=4,
                         min_interval_s=3600.0)
    assert rec.capture("a", lambda: {}) is not None
    assert rec.capture("b", lambda: {}) is None  # inside the interval
    assert rec.rate_limited == 1
    assert rec.capture("c", lambda: {}, force=True) is not None


def test_flightrec_collect_failure_is_counted(tmp_path):
    log = _Log()
    rec = FlightRecorder(str(tmp_path / "fr"), budget_mb=4, logger=log)

    def boom():
        raise RuntimeError("collector bug")

    assert rec.capture("x", boom, force=True) is None
    assert rec.errors == 1 and log.errors
    assert rec.capture("y", lambda: {}, force=True) is not None


def test_flightrec_lru_prune_keeps_newest(tmp_path):
    rec = FlightRecorder(str(tmp_path / "fr"), budget_mb=1,
                         min_interval_s=0.0)
    blob = "z" * (400 << 10)  # ~400 KiB per bundle, 1 MB budget
    paths = []
    for i in range(4):
        p = rec.capture(f"b{i}", lambda: {"blob": blob}, force=True)
        assert p is not None
        paths.append(p)
        # distinct mtimes so LRU order is deterministic
        os.utime(p, (time.monotonic(), 1_000_000 + i))
    rec.prune(keep=paths[-1])
    alive = [p for p in paths if os.path.exists(p)]
    assert paths[-1] in alive            # newest never pruned
    assert paths[0] not in alive         # oldest went first
    assert rec.disk_bytes() <= rec.budget_mb << 20
    assert rec.pruned >= 1


# -- alert ids against the docs catalog -------------------------------------


def _catalog():
    """{alert id: runbook cell} of docs/observability.md's alerts table."""
    import pathlib
    import re
    doc = (pathlib.Path(__file__).resolve().parent.parent / "docs"
           / "observability.md").read_text()
    table = doc.split("<!-- alerts-catalog:begin -->")[1].split(
        "<!-- alerts-catalog:end -->")[0]
    rows = {}
    for line in table.splitlines():
        m = re.match(r"\|\s*`([a-z0-9-]+)`\s*\|(.*)\|\s*$", line)
        if m:
            rows[m.group(1)] = m.group(2).split("|")[-1]
    return rows


def test_alert_names_match_docs_catalog_and_runbook():
    """Every rule id the port registers has a catalog row whose runbook
    names a /debug surface, every row names a registered rule, and the
    ids, severities and thresholds are the JAX package's."""
    rows = _catalog()
    assert set(rows) == set(RULES) == set(jax_slo.RULES)
    for rid, runbook in rows.items():
        assert "/debug" in runbook, f"{rid}: runbook names no /debug surface"
    for rid, rule in RULES.items():
        theirs = jax_slo.RULES[rid]
        assert (rule.severity, rule.summary, rule.clear_after) == \
            (theirs.severity, theirs.summary, theirs.clear_after)
    for name in ("RETRACE_STORM", "HEDGE_STORM_FRAC", "HEDGE_STORM_MIN",
                 "EVICTION_PRESSURE", "INGEST_BACKPRESSURE",
                 "BREAKER_FLAPS"):
        assert getattr(slomod, name) == getattr(jax_slo, name)
    assert (SLOEngine.BURN_THRESHOLD, SLOEngine.FAST_FRAC,
            SLOEngine.SLOW_FRAC) == (jax_slo.SLOEngine.BURN_THRESHOLD,
                                     jax_slo.SLOEngine.FAST_FRAC,
                                     jax_slo.SLOEngine.SLOW_FRAC)


# -- real-socket acceptance -------------------------------------------------


def _get_raw(port, path):
    with urllib.request.urlopen(
            f"http://localhost:{port}{path}", timeout=30) as r:
        return r.read()


def _query_raw(port, index, pql):
    req = urllib.request.Request(
        f"http://localhost:{port}/index/{index}/query",
        method="POST", data=pql.encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


PQLS = ("Count(Row(f=1))", "Row(f=2)", "TopN(f, n=3)",
        "Count(Union(Row(f=0), Row(f=3)))")


def test_answers_byte_identical_slo_on_off(tmp_path):
    """Evaluation must never change an answer: the same workload on an
    alerts-on and an alerts-off port server produces byte-identical
    response bodies, and they equal the JAX executor's answers on the
    same columns."""
    bodies = {}
    for mode in ("all", "off"):
        cfg = Config(data_dir=str(tmp_path / f"d-{mode}"),
                     bind="localhost:0", alert_rules=mode,
                     timeseries_interval=0.2, timeseries_window=10,
                     trace_sample_rate=0.0)
        s = Server(cfg)
        s.open()
        try:
            assert (s.slo is not None) == (mode == "all")
            _req(s.port, "POST", "/index/bi", {})
            _req(s.port, "POST", "/index/bi/field/f", {})
            cols = [i * 97 for i in range(300)]
            _req(s.port, "POST", "/index/bi/field/f/import",
                 {"rowIDs": [i % 7 for i in range(300)],
                  "columnIDs": cols})
            out = []
            for pql in PQLS:
                out.append(_query_raw(s.port, "bi", pql))
            # a few evaluation passes while traffic flows, so the "on"
            # server actually exercises the engine mid-workload
            if s.slo is not None:
                s.sample_timeseries(force=True)
                s.slo.evaluate()
            out.append(_query_raw(s.port, "bi", "Count(Row(f=1))"))
            bodies[mode] = out
        finally:
            s.close()
    assert bodies["all"] == bodies["off"]
    jh = JaxHolder(None)
    jf = jh.create_index("bi").create_field("f")
    jf.import_bits(np.array([i % 7 for i in range(300)]),
                   np.array([i * 97 for i in range(300)]))
    jex = JaxExecutor(jh, use_mesh=True)
    try:
        want = [[serialize_result(r) for r in jex.execute("bi", pql)]
                for pql in PQLS + ("Count(Row(f=1))",)]
    finally:
        jex.close()
    assert [json.loads(b)["results"] for b in bodies["all"]] == \
        json.loads(json.dumps(want))


@pytest.fixture(scope="module")
def straggler_cluster(tmp_path_factory):
    """3 real servers, node1/node2 behind ChaosProxies, primary
    routing so a delayed proxy is a deterministic straggler."""
    tmp_path = tmp_path_factory.mktemp("slo")
    binds = _free_ports(3)
    proxies = {}
    hosts = [f"localhost:{binds[0]}"]
    for i in (1, 2):
        proxies[f"node{i}"] = ChaosProxy("localhost", binds[i])
        hosts.append(proxies[f"node{i}"].address)
    servers = []
    for i, p in enumerate(binds):
        srv = Server(Config(
            data_dir=str(tmp_path / f"node{i}"),
            bind=f"localhost:{p}", node_id=f"node{i}",
            cluster_hosts=hosts, replica_n=1,
            anti_entropy_interval=0, read_routing="primary",
            hedge_reads=False,
            # 250 ms objective: a TIMING_BUCKETS edge (exact good
            # counting), far above a healthy localhost fan-out
            # (~50-100 ms) and far below the proxy's 500 ms straggle
            slo_latency_ms=250.0, slo_target=0.999,
            flight_recorder_mb=4,
            # huge interval: the monitor thread stays quiet and the
            # test drives force-samples + evaluations deterministically
            timeseries_interval=60, timeseries_window=1200,
            trace_sample_rate=0.0))
        srv.open()
        servers.append(srv)
    yield servers, proxies
    for s in servers:
        try:
            s.close()
        except Exception:
            pass
    for pr in proxies.values():
        pr.close()


def test_straggler_fires_latency_alert_and_resolves(straggler_cluster):
    """The acceptance story: a proxied straggler pushes queries over
    the latency objective -> slo-latency-burn fires -> a bundle lands
    on disk inside the budget -> heal + healthy traffic -> resolve."""
    servers, proxies = straggler_cluster
    srv0 = servers[0]
    port = srv0.port
    n_shards = 6
    # an index where node0 does NOT own every shard, so the proxy
    # delay sits on the query path
    cl = srv0.cluster
    index = next(
        name for name in (f"sa{i}" for i in range(64))
        if any("node0" not in cl.placement.shard_nodes(name, s)
               for s in range(n_shards)))
    _req(port, "POST", f"/index/{index}", {})
    _req(port, "POST", f"/index/{index}/field/f", {})
    cols = [s * SHARD_WIDTH + 7 for s in range(n_shards)]
    _req(port, "POST", f"/index/{index}/field/f/import",
         {"rowIDs": [1] * len(cols), "columnIDs": cols})
    [baseline] = query(port, index, "Count(Row(f=1))")

    eng = srv0.slo
    assert eng is not None and eng.enabled

    def sample_and_evaluate():
        assert srv0.sample_timeseries(force=True)
        eng.evaluate()

    # prime: one healthy sample so deltas are per-interval
    sample_and_evaluate()
    assert "slo-latency-burn" not in eng.active

    for pr in proxies.values():
        pr.configure("down=latency:0.5")  # every remote read > 250 ms
    try:
        evals_before = eng.evaluations
        for _ in range(eng.fast_n + 1):
            for _ in range(3):
                assert query(port, index,
                             "Count(Row(f=1))") == [baseline]
            sample_and_evaluate()
            if "slo-latency-burn" in eng.active:
                break
        assert "slo-latency-burn" in eng.active, eng.snapshot()
        fired_at = eng.active["slo-latency-burn"]["firedAtEvaluation"]
        # fired within 2 evaluation passes of the first faulted sample
        assert fired_at - evals_before <= 2

        # the on-fire hook captured a bundle, on disk, within budget,
        # readable, and carrying the full debug plane
        rec = srv0.flightrec
        assert rec.captures >= 1
        bundle_path = rec.last["path"]
        assert os.path.isfile(bundle_path)
        assert rec.disk_bytes() <= rec.budget_mb << 20
        bundle = json.loads(open(bundle_path).read())
        assert bundle["reason"].startswith("alert-slo-latency-burn")
        assert "slo-latency-burn" in bundle["alerts"]["active"]
        assert bundle["timeseries"]["samples"]
        assert "vars" in bundle and "slowLog" in bundle

        # the debug surfaces agree
        alerts = json.loads(_get_raw(port, "/debug/alerts"))
        assert alerts["enabled"]
        assert "slo-latency-burn" in alerts["active"]
        v = json.loads(_get_raw(port, "/debug/vars"))
        assert "slo-latency-burn" in v["alerts"]["active"]
        # fleet rollup folds per-node alert state in (local node path)
        c = json.loads(_get_raw(port, "/debug/cluster"))
        assert c["nodes"]["node0"]["activeAlerts"] >= 1
        assert "slo-latency-burn" in c["nodes"]["node0"]["alertIds"]
    finally:
        for pr in proxies.values():
            pr.heal()

    # healthy traffic drains the fast window; resolve after 2 quiet
    # evaluation passes (extra iterations absorb a stray slow query on
    # a loaded CI box)
    for _ in range(8):
        for _ in range(3):
            assert query(port, index, "Count(Row(f=1))") == [baseline]
        sample_and_evaluate()
        if "slo-latency-burn" not in eng.active:
            break
    assert "slo-latency-burn" not in eng.active, eng.snapshot()
    assert eng.resolved_total >= 1


def test_on_demand_bundle_endpoint(straggler_cluster):
    servers, _ = straggler_cluster
    srv0 = servers[0]
    out = _req(srv0.port, "POST", "/debug/bundle",
               {"reason": "operator-drill"})
    assert os.path.isfile(out["path"])
    assert "operator-drill" in os.path.basename(out["path"])
    bundle = json.loads(open(out["path"]).read())
    assert bundle["node"] == "node0"
    # the stamp rides /debug/vars and the diagnostics payload
    v = _req(srv0.port, "GET", "/debug/vars")
    assert v["flightRecorder"]["last"]["path"] == out["path"]
    from pilosa_tpu_torch.utils.diagnostics import \
        DiagnosticsCollector
    diag = DiagnosticsCollector(srv0, endpoint="")
    payload = diag.payload()
    assert payload["lastBundle"]["path"] == out["path"]
    assert "activeAlerts" in payload
    assert payload["device"] == "cpu" and "card" not in payload
    # the CLI's bundle and alerts commands drive the same routes
    from pilosa_tpu_torch import cli
    assert cli.main(["bundle", "-host", f"localhost:{srv0.port}",
                     "--reason", "cli-drill"]) == 0
    assert cli.main(["alerts", "-host", f"localhost:{srv0.port}"]) == 0
    assert "cli-drill" in srv0.flightrec.last["path"]
