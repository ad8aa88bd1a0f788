"""The cluster observability plane on the PyTorch port: the cases of
tests/test_cluster_obs.py run on port nodes (``device="cpu"``) and held
to the same assertions — the fleet rollup's agreement with per-node
``/debug/vars``, the ``pilosa_tpu_cluster_*`` family with node labels,
EXPLAIN naming the chosen replica per shard, staleness stamping that
never blocks a scrape on a dead peer with the chaos events in the merged
timeline, the single-node ``/debug/cluster`` fallback and the
``/debug/events`` cursor.

The port has no device-runtime observability yet, so the rollup's
``retraces`` (like ``compiles``, ``launches``, ``paddingWasteRatio`` and
the alert fields) reads 0 where the JAX case compares it with the
compile registry.  The two dashboard cases wait for the dashboards.
"""

import json
import re
import socket
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.server.server import Config as _Config  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.utils.events import EVENTS  # noqa: E402

from test_torch_cluster import restore_knobs  # noqa: E402, F401


def Config(**kw):
    """The port server's Config on the CPU, without the metric poll."""
    return _Config(device="cpu", metric_poll_interval=0, **kw)


def _req(port, method, path, data=None, headers=None, timeout=60):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) else \
            json.dumps(data).encode()
    r = urllib.request.Request(
        f"http://localhost:{port}{path}", method=method, data=body,
        headers=headers or {})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def make_server(tmp_path, name="srv", **cfg):
    cfg.setdefault("anti_entropy_interval", 0)
    cfg.setdefault("bind", "localhost:0")
    s = Server(Config(data_dir=str(tmp_path / name), **cfg))
    s.open()
    return s


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("localhost", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


@pytest.fixture(scope="module")
def cluster3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs3")
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, p in enumerate(ports):
        cfg = Config(
            data_dir=str(tmp / f"node{i}"),
            bind=f"localhost:{p}",
            node_id=f"node{i}",
            cluster_hosts=hosts,
            replica_n=2,
            anti_entropy_interval=0,   # driven manually
            breaker_threshold=2,       # two probe misses open a breaker
            slow_query_threshold=0,    # keep the ring quiet
        )
        srv = Server(cfg)
        srv.open()
        servers.append(srv)
    p0 = ports[0]
    _req(p0, "POST", "/index/ci", {})
    _req(p0, "POST", "/index/ci/field/f", {})
    from pilosa_tpu_torch.core import SHARD_WIDTH
    sets = "".join(f"Set({s * SHARD_WIDTH + c}, f={r})"
                   for s in range(6) for r in range(3) for c in range(8))
    _req(p0, "POST", "/index/ci/query", sets)
    yield servers, ports
    for s in servers:
        try:
            s.close()
        except Exception:
            pass


def test_rollup_agrees_with_per_node_vars(cluster3):
    servers, ports = cluster3
    p0 = ports[0]
    for i in range(4):
        _req(p0, "POST", "/index/ci/query", f"Count(Row(f={i % 3}))")
    roll, _ = _req(p0, "GET", "/debug/cluster?refresh=true", timeout=30)
    assert set(roll["nodes"]) == {"node0", "node1", "node2"}
    assert roll["coordinator"] == "node0"
    # golden: each node's rollup summary equals that node's OWN
    # /debug/vars surface (no traffic between the two reads)
    for i, p in enumerate(ports):
        v, _ = _req(p, "GET", "/debug/vars")
        n = roll["nodes"][f"node{i}"]
        assert n["stale"] is False
        hq = v["timings"].get("http.query") or {}
        assert n["queries"] == hq.get("count", 0)
        assert n["evictions"] == v["deviceBudget"]["evictions"]
        # no compile registry on the port: the field reads 0
        assert "compiles" not in v["device"]
        assert n["retraces"] == 0 and n["compiles"] == 0
        assert n["launches"] == 0 and n["paddingWasteRatio"] == 0.0
        assert n["hedges"] == int(
            v["counts"].get("cluster.hedges", 0))
        assert n["quarantinedFragments"] == \
            len(v["storage"]["quarantined"])
        assert n["overlayEpoch"] == v["cluster"]["overlay"]["epoch"]
    # the coordinator served at least the queries this test just sent
    assert roll["nodes"]["node0"]["queries"] >= 4


def test_cluster_metrics_family_with_node_labels(cluster3):
    servers, ports = cluster3
    with urllib.request.urlopen(
            f"http://localhost:{ports[0]}/metrics", timeout=30) as r:
        text = r.read().decode()
    for nid in ("node0", "node1", "node2"):
        assert re.search(
            rf'pilosa_tpu_cluster_qps{{node="{nid}"}} ', text)
        assert re.search(
            rf'pilosa_tpu_cluster_stale{{node="{nid}"}} 0', text)
    assert "# TYPE pilosa_tpu_cluster_hedges gauge" in text


def test_explain_names_chosen_replica_per_shard(cluster3):
    servers, ports = cluster3
    out, _ = _req(ports[0], "POST", "/index/ci/query?explain=true",
                  "Count(Row(f=1))")
    exp = out["explain"]
    routing = exp.get("routing") or []
    assert routing, "no routing section on a cluster query"
    cl = servers[0].cluster
    chosen_by_shard = {}
    for e in routing:
        assert e["chosen"] in e["candidates"]
        # the chosen node really owns the shard (overlay-aware)
        assert cl.owns_shard(e["chosen"], "ci", e["shard"])
        chosen_by_shard[e["shard"]] = e["chosen"]
    # ACCEPTANCE: the wave-0 dispatch went to exactly the replicas the
    # routing section names, shard by shard
    dispatched = {}
    for d in exp.get("dispatch") or []:
        if d.get("wave") == 0 and not d.get("hedge"):
            for s in d["shards"]:
                dispatched[s] = d["node"]
    assert dispatched == chosen_by_shard
    # loaded-policy score breakdowns name the components
    scored = [e for e in routing if "scores" in e]
    if scored:
        s0 = next(iter(scored[0]["scores"].values()))
        if isinstance(s0, dict):
            assert {"ewmaMs", "pressure", "residencyTier",
                    "score"} <= set(s0)


def test_chaos_timeline_and_stale_peer(cluster3):
    """The acceptance scenario: kill a peer — the rollup marks it stale
    WITHOUT blocking the scrape, the breaker-open event the death
    caused lands in the merged timeline, and a quarantine+repair cycle
    lands its repair event too."""
    servers, ports = cluster3
    p0 = ports[0]
    cl0 = servers[0].cluster

    # warm the rollup so node2 has a last-known summary to go stale
    _req(p0, "GET", "/debug/cluster?refresh=true", timeout=30)

    # -- chaos: kill node2, then probe twice (threshold=2 opens the
    # breaker; the probe path also flips NODE_DOWN)
    servers[2].close()
    cl0.probe_peers()
    cl0.probe_peers()
    host2 = cl0.by_id["node2"].host
    assert cl0.client.breaker_open(host2)
    assert cl0.by_id["node2"].state == "DOWN"

    # -- chaos: corrupt a fragment on node0 that node1 replicates, then
    # run the repair sweep
    shard = next(s for s in range(64)
                 if {"node0", "node1"} <=
                 set(cl0.shard_owner_nodes("ci", s)))
    from pilosa_tpu_torch.core import SHARD_WIDTH
    _req(p0, "POST", "/index/ci/query",
         f"Set({shard * SHARD_WIDTH + 2}, f=9)")
    for srv in servers[:2]:
        srv.cluster.sync_holder()  # both replicas hold the bit
    frag = servers[0].holder.fragment("ci", "f", "standard", shard)
    assert frag is not None
    frag._enter_quarantine("chaos: injected corruption")
    assert servers[0].holder.quarantined_fragments("ci")
    repaired = cl0.repair_quarantined()
    assert repaired >= 1

    # -- the scrape: bounded despite the dead peer, stale-stamped
    t0 = time.perf_counter()
    roll, _ = _req(p0, "GET", "/debug/cluster?refresh=true", timeout=30)
    elapsed = time.perf_counter() - t0
    assert elapsed < 5.0, f"scrape blocked {elapsed:.1f}s on a dead peer"
    n2 = roll["nodes"]["node2"]
    assert n2["state"] == "DOWN"
    assert n2["stale"] is True
    assert n2.get("queries") is not None  # last-known summary retained
    assert roll["nodes"]["node0"]["stale"] is False

    # -- ACCEPTANCE: the merged timeline contains the events the chaos
    # actually caused
    names = [e["event"] for e in roll["timeline"]]
    assert "breaker.open" in names
    assert "node.down" in names
    assert "storage.quarantine" in names
    assert "storage.repair" in names
    # (filter by index: the process-global journal may also hold repair
    # events other tests in this process emitted — the breaker pattern
    # below)
    rep = next(e for e in roll["timeline"]
               if e["event"] == "storage.repair"
               and e.get("index") == "ci")
    assert rep["shard"] == shard
    # (search by host: the process-global journal may also hold
    # breaker events other tests in this process emitted)
    assert any(e["event"] == "breaker.open" and e.get("host") == host2
               for e in roll["timeline"])
    # stale /metrics stamp flips for the dead node
    with urllib.request.urlopen(
            f"http://localhost:{p0}/metrics", timeout=30) as r:
        text = r.read().decode()
    assert 'pilosa_tpu_cluster_stale{node="node2"} 1' in text


def test_debug_cluster_single_node_fallback(tmp_path):
    """A clusterless server still answers /debug/cluster with its own
    summary, so dashboards work unchanged on one box."""
    srv = make_server(tmp_path, slow_query_threshold=0)
    try:
        out, _ = _req(srv.port, "GET", "/debug/cluster")
        assert set(out["nodes"]) == {"local"}
        info = out["nodes"]["local"]
        assert info["stale"] is False
        assert "queries" in info and "hbmResidentBytes" in info
        assert isinstance(out["timeline"], list)
    finally:
        srv.close()


def test_debug_events_since_cursor_over_http(cluster3):
    servers, ports = cluster3
    seq0 = EVENTS.last_seq()
    EVENTS.emit("node.up", peer="cursor-probe")
    out, _ = _req(ports[1], "GET", f"/debug/events?since={seq0}")
    assert any(e["event"] == "node.up"
               and e.get("peer") == "cursor-probe"
               for e in out["events"])
