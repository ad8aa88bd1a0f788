"""Multi-node tests of the PyTorch port's cluster read plane
(pilosa_tpu_torch/parallel/cluster.py and the server wiring) via the
in-process harness of tests/test_cluster.py: N port servers with
``device="cpu"`` in one process, wired through real HTTP on localhost
ephemeral ports.

The cases are the read-plane cases of tests/test_cluster.py, run on
port nodes: DDL broadcast, status, imports and distributed queries,
the batched multi-call fan-out, replica write fan-out, Store / ClearRow,
node-down replica retry, Options-wrapped aggregates, TopN tanimoto
(against the JAX package's single-node ``Executor``), GroupBy across
nodes, a write failing with a replica down, an application error not
marking a peer down, the sole-owner retry, a dead sole owner failing
loud, schema catch-up after recovery and pooled-connection
replacement.  The anti-entropy, resize, balancer, chaos, fleet-rollup
and TLS cases are in tests/test_torch_antientropy.py,
test_torch_resize.py, test_torch_balancer.py, test_torch_churn.py,
test_torch_cluster_obs.py and test_torch_cluster_tls.py.
"""

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.server import Config, Server  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("localhost", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(autouse=True)
def restore_knobs():
    """Port servers set process-wide knobs; restore them so a test file
    sharing the worker sees the values it started with."""
    import pilosa_tpu_torch.executor.executor as pex
    import pilosa_tpu_torch.parallel.stacked as pst
    import pilosa_tpu_torch.storage.fragment as pfrag
    import pilosa_tpu_torch.storage.membudget as pmb
    import pilosa_tpu_torch.utils.tracing as ptr
    knobs = [(pmb.DEFAULT_BUDGET, "limit_bytes"),
             (pmb.DEFAULT_BUDGET, "tenant_quota_bytes"),
             (pmb.HOST_STAGE_BUDGET, "limit_bytes"),
             (pmb, "INGEST_DELTA_LIMIT_BYTES"),
             (pfrag, "COMPRESSED_RESIDENT"), (pfrag, "WAL_CRC"),
             (pfrag, "QUARANTINE_ON_CORRUPTION"),
             (pfrag, "COMPRESS_MAX_DENSITY"),
             (pex, "BATCH_TEMP_BYTES"), (pst, "DECODE_WORKSPACE_BYTES"),
             (ptr.GLOBAL_TRACER, "sample_rate")]
    saved = [(o, a, getattr(o, a)) for o, a in knobs]
    yield
    for o, a, v in saved:
        setattr(o, a, v)


def port_config(data_dir, port, hosts, i, replica_n, **kw):
    return Config(data_dir=str(data_dir), bind=f"localhost:{port}",
                  node_id=f"node{i}", cluster_hosts=hosts,
                  replica_n=replica_n, device="cpu",
                  anti_entropy_interval=0, metric_poll_interval=0, **kw)


def make_cluster(tmp_path, n=3, replica_n=2, **kw):
    ports = _free_ports(n)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, p in enumerate(ports):
        srv = Server(port_config(tmp_path / f"node{i}", p, hosts, i,
                                 replica_n, **kw))
        srv.open()
        servers.append(srv)
    return servers


def close_all(servers):
    for s in servers:
        try:
            s.close()
        except Exception:
            pass


@pytest.fixture
def cluster3(tmp_path):
    servers = make_cluster(tmp_path, n=3, replica_n=2)
    yield servers
    close_all(servers)


def _req(port, method, path, data=None):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) else json.dumps(
            data).encode()
    r = urllib.request.Request(
        f"http://localhost:{port}{path}", method=method, data=body)
    with urllib.request.urlopen(r, timeout=180) as resp:
        return json.loads(resp.read())


def query(port, index, pql):
    return _req(port, "POST", f"/index/{index}/query", pql)["results"]


def setup_index(servers, name="ci"):
    p = servers[0].port
    _req(p, "POST", f"/index/{name}", {})
    _req(p, "POST", f"/index/{name}/field/f", {})
    _req(p, "POST", f"/index/{name}/field/v",
         {"options": {"type": "int", "min": 0, "max": 1000}})
    return name


def test_ddl_broadcast_and_status(cluster3):
    setup_index(cluster3)
    for srv in cluster3:
        schema = _req(srv.port, "GET", "/schema")["indexes"]
        assert [i["name"] for i in schema] == ["ci"]
        assert {"f", "v"} <= {f["name"] for f in schema[0]["fields"]}
    st = _req(cluster3[0].port, "GET", "/status")
    assert st["state"] == "NORMAL"
    assert len(st["nodes"]) == 3
    assert st["nodes"][0]["isCoordinator"]
    assert st["wire"] == ["json", "bin1"] and st["epoch"] == 0


def test_import_and_distributed_queries(cluster3):
    setup_index(cluster3)
    rng = np.random.default_rng(7)
    n_shards = 6
    cols = rng.choice(n_shards * SHARD_WIDTH, size=3000, replace=False)
    rows = rng.integers(0, 8, size=3000)
    vals = rng.integers(0, 1000, size=1500)
    p0 = cluster3[0].port
    _req(p0, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    _req(p0, "POST", "/index/ci/field/v/import",
         {"columnIDs": cols[:1500].tolist(), "values": vals.tolist()})
    by_row = {r: set(cols[rows == r].tolist()) for r in range(8)}
    for srv in cluster3:
        [count] = query(srv.port, "ci", "Count(Row(f=3))")
        assert count == len(by_row[3])
    [cols_out] = query(cluster3[1].port, "ci", "Row(f=1)")
    assert set(cols_out["columns"]) == by_row[1]
    [inter] = query(cluster3[2].port, "ci",
                    "Count(Intersect(Row(f=1), Row(f=2)))")
    assert inter == len(by_row[1] & by_row[2])
    [topn] = query(cluster3[0].port, "ci", "TopN(f, n=3)")
    exact = sorted(((len(v), -r) for r, v in by_row.items()), reverse=True)
    assert [p["count"] for p in topn] == [c for c, _ in exact[:3]]
    [s] = query(cluster3[1].port, "ci", "Sum(field=v)")
    assert s["value"] == int(vals.sum())
    [rws] = query(cluster3[2].port, "ci", "Rows(f)")
    assert rws["rows"] == sorted(by_row)


def test_batched_multicall_matches_per_call(cluster3):
    setup_index(cluster3)
    rng = np.random.default_rng(13)
    cols = rng.choice(6 * SHARD_WIDTH, size=4000, replace=False)
    rows = rng.integers(0, 8, size=4000)
    vals = rng.integers(0, 1000, size=2000)
    p0 = cluster3[0].port
    _req(p0, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    _req(p0, "POST", "/index/ci/field/v/import",
         {"columnIDs": cols[:2000].tolist(), "values": vals.tolist()})
    singles_q = ("Count(Row(f=1))", "TopN(f, n=3)",
                 "Sum(Row(f=2), field=v)",
                 "Count(Intersect(Row(f=3), Row(f=4)))", "Rows(f)",
                 "Row(f=5)")
    multi = " ".join(singles_q)
    batched = query(p0, "ci", multi)
    singles = [query(cluster3[1].port, "ci", q)[0] for q in singles_q]
    assert batched == singles
    assert query(cluster3[2].port, "ci", multi) == singles
    snap = _req(p0, "GET", "/debug/vars")
    assert "cluster.multi.peer_exec" in snap["timings"]
    assert "cluster.multi.reduce" in snap["timings"]
    assert snap["cluster"]["routing"]["policy"] == "loaded"
    # the binary internal wire carried the fan-out
    assert cluster3[0].cluster.client.peer_wire_mode(
        cluster3[1].cluster.local.host) == "bin1"


def test_batched_multicall_replica_retry(cluster3):
    setup_index(cluster3)
    p0 = cluster3[0].port
    query(p0, "ci", "Set(5, f=1) Set(300000, f=1) Set(2097200, f=2)")
    q = "Count(Row(f=1)) Count(Row(f=2)) TopN(f, n=2)"
    want = query(p0, "ci", q)
    cluster3[2].close()
    cluster3[0].cluster.probe_peers()
    assert query(p0, "ci", q) == want


def test_replica_write_fanout(cluster3):
    setup_index(cluster3)
    col = 3 * SHARD_WIDTH + 17
    [changed] = query(cluster3[1].port, "ci", f"Set({col}, f=5)")
    assert changed is True
    owners = cluster3[0].cluster.placement.shard_nodes("ci", 3)
    assert len(owners) == 2
    for srv in cluster3:
        frag = srv.holder.fragment("ci", "f", "standard", 3)
        if srv.cluster.node_id in owners:
            assert frag is not None
            assert col % SHARD_WIDTH in frag.row_columns(5)
        else:
            assert frag is None or col % SHARD_WIDTH not in \
                frag.row_columns(5)
    for srv in cluster3:
        assert query(srv.port, "ci", "Count(Row(f=5))") == [1]


def test_store_and_clearrow_cluster_wide(cluster3):
    setup_index(cluster3)
    cols = [10, SHARD_WIDTH + 5, 4 * SHARD_WIDTH + 2]
    for c in cols:
        query(cluster3[0].port, "ci", f"Set({c}, f=1)")
    assert query(cluster3[1].port, "ci", "Store(Row(f=1), f=9)") == [True]
    [out] = query(cluster3[2].port, "ci", "Row(f=9)")
    assert set(out["columns"]) == set(cols)
    assert query(cluster3[0].port, "ci", "ClearRow(f=9)") == [True]
    assert query(cluster3[1].port, "ci", "Count(Row(f=9))") == [0]


def test_node_down_replica_retry(cluster3):
    setup_index(cluster3)
    rng = np.random.default_rng(11)
    cols = rng.choice(4 * SHARD_WIDTH, size=1000, replace=False)
    rows = rng.integers(0, 4, size=1000)
    _req(cluster3[0].port, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    expect = int((rows == 2).sum())
    assert query(cluster3[0].port, "ci", "Count(Row(f=2))") == [expect]
    cluster3[2].close()
    cluster3[0].cluster.probe_peers()
    assert cluster3[0].cluster.state == "DEGRADED"
    assert query(cluster3[0].port, "ci", "Count(Row(f=2))") == [expect]
    [topn] = query(cluster3[0].port, "ci", "TopN(f, n=2)")
    assert len(topn) == 2


def test_options_wrapped_aggregates_reduce_correctly(cluster3):
    setup_index(cluster3)
    rng = np.random.default_rng(11)
    cols = rng.choice(6 * SHARD_WIDTH, size=1200, replace=False)
    rows = rng.integers(0, 4, size=1200)
    p0 = cluster3[0].port
    _req(p0, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    _req(p0, "POST", "/index/ci/field/v/import",
         {"columnIDs": cols.tolist(),
          "values": [int(v) for v in rng.integers(0, 1000, size=1200)]})
    for srv in cluster3:
        [plain] = query(srv.port, "ci", "Count(Row(f=1))")
        [wrapped] = query(srv.port, "ci", "Options(Count(Row(f=1)))")
        assert wrapped == plain == int((rows == 1).sum())
        assert query(srv.port, "ci", "Options(Sum(field=v))") == \
            query(srv.port, "ci", "Sum(field=v)")
        [t_plain] = query(srv.port, "ci", "TopN(f, n=2)")
        [t_wrapped] = query(srv.port, "ci", "Options(TopN(f, n=2))")
        assert t_wrapped == t_plain and len(t_wrapped) == 2
    col = int(cols[rows == 1][0])
    _req(p0, "POST", "/index/ci/query",
         f'SetColumnAttrs({col}, tier="gold")')
    out = _req(p0, "POST", "/index/ci/query",
               f"Options(Row(f=1), columnAttrs=true, "
               f"shards=[{col // SHARD_WIDTH}])")
    assert out["columnAttrs"] == [{"id": col, "attrs": {"tier": "gold"}}]


def test_topn_tanimoto_matches_single_node(cluster3):
    """Tanimoto on GLOBAL counts, against the JAX package's single-node
    Executor."""
    from pilosa_tpu.executor import Executor as JaxExecutor
    from pilosa_tpu.storage import Holder as JaxHolder
    setup_index(cluster3)
    src_cols = list(range(0, 6 * SHARD_WIDTH, SHARD_WIDTH // 2))
    r1_cols = src_cols[:10] + [7, 8]
    r2_cols = src_cols[:3] + [100, 101, 102, 103, 104, 105]
    rows, cols_ = [], []
    for r, cs in [(0, src_cols), (1, r1_cols), (2, r2_cols)]:
        rows += [r] * len(cs)
        cols_ += cs
    _req(cluster3[0].port, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows, "columnIDs": cols_})
    q = "TopN(f, Row(f=0), tanimotoThreshold=60)"
    h = JaxHolder(None)
    h.create_index("ci").create_field("f").import_bits(
        np.array(rows), np.array(cols_))
    ex = JaxExecutor(h)
    try:
        want = [{"id": p.id, "count": p.count}
                for p in ex.execute("ci", q)[0]]
    finally:
        ex.close()
    assert want
    for s in cluster3:
        assert query(s.port, "ci", q)[0] == want


def test_group_by_across_nodes(cluster3):
    setup_index(cluster3)
    _req(cluster3[0].port, "POST", "/index/ci/field/g", {})
    cols = [1, 2, SHARD_WIDTH + 1, 2 * SHARD_WIDTH + 3]
    for c in cols:
        query(cluster3[0].port, "ci", f"Set({c}, f=1)")
        query(cluster3[0].port, "ci", f"Set({c}, g={c % 2})")
    [groups] = query(cluster3[1].port, "ci", "GroupBy(Rows(f), Rows(g))")
    got = {tuple((fr["field"], fr["rowID"]) for fr in g["group"]):
           g["count"] for g in groups}
    odd = sum(1 for c in cols if c % 2 == 1)
    assert got[(("f", 1), ("g", 0))] == len(cols) - odd
    assert got[(("f", 1), ("g", 1))] == odd


def test_write_fails_when_replica_down(cluster3):
    setup_index(cluster3)
    cluster3[2].close()
    cluster3[0].cluster.probe_peers()
    cl = cluster3[0].cluster
    shard = next(s for s in range(32)
                 if "node2" in cl.placement.shard_nodes("ci", s))
    with pytest.raises(urllib.error.HTTPError) as exc:
        query(cluster3[0].port, "ci", f"Set({shard * SHARD_WIDTH + 1}, f=1)")
    assert exc.value.code == 500
    assert "unavailable" in exc.value.read().decode()


def test_app_error_does_not_mark_peer_down(cluster3):
    from pilosa_tpu_torch.parallel.cluster import ClusterError
    setup_index(cluster3)
    query(cluster3[0].port, "ci",
          "Set(5, f=1) Set(2097200, f=1) Set(4194400, f=1)")
    coord = cluster3[0].cluster
    real = coord.client.query_calls
    failed = []

    def flaky(host, index, calls, shards):
        if not failed:
            failed.append(host)
            raise ClusterError(f"{host}: 500 injected app error")
        return real(host, index, calls, shards)

    coord.client.query_calls = flaky
    try:
        assert query(cluster3[0].port, "ci", "Count(Row(f=1))") == [3]
    finally:
        coord.client.query_calls = real
    assert failed, "fan-out never reached a peer"
    assert all(n.state == "READY" for n in coord.nodes)
    assert coord.state == "NORMAL"


def test_sole_owner_transient_failure_retried(tmp_path):
    from pilosa_tpu_torch.parallel.cluster import ClusterError
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ri", {})
        _req(p0, "POST", "/index/ri/field/f", {})
        query(p0, "ri", "Set(5, f=1) Set(2097200, f=1) Set(4194400, f=1)")
        coord = servers[0].cluster
        real = coord.client.query_calls
        fails = []

        def transient(host, index, calls, shards):
            if not fails:
                fails.append(host)
                raise ClusterError(f"{host}: 500 transient")
            return real(host, index, calls, shards)

        coord.client.query_calls = transient
        try:
            assert query(p0, "ri", "Count(Row(f=1))") == [3]
        finally:
            coord.client.query_calls = real
        assert fails, "no peer-owned shard was exercised"
    finally:
        close_all(servers)


def test_dead_sole_owner_fails_loud_not_partial(tmp_path):
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/lo", {})
        _req(p0, "POST", "/index/lo/field/f", {})
        query(p0, "lo", " ".join(
            f"Set({s * SHARD_WIDTH + 9}, f=1)" for s in range(12)))
        assert query(p0, "lo", "Count(Row(f=1))") == [12]
        owners = {servers[0].cluster.placement.shard_nodes("lo", s)[0]
                  for s in range(12)}
        assert "node1" in owners
        servers[1].close()
        servers[0].cluster.probe_peers()
        assert servers[0].cluster.state == "DEGRADED"
        with pytest.raises(urllib.error.HTTPError) as ei:
            query(p0, "lo", "Count(Row(f=1))")
        assert ei.value.code == 500
    finally:
        close_all(servers)


def test_schema_catchup_after_recovery(tmp_path):
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        a, b = servers
        a.cluster.by_id["node1"].state = "DOWN"
        _req(a.port, "POST", "/index/late", {})
        _req(a.port, "POST", "/index/late/field/f", {})
        assert b.holder.index("late") is None
        a.cluster.probe_peers()
        assert a.cluster.by_id["node1"].state == "READY"
        idx = b.holder.index("late")
        assert idx is not None and idx.field("f") is not None
    finally:
        close_all(servers)


def test_pooled_conn_idle_replacement(cluster3, monkeypatch):
    import time as _time

    from pilosa_tpu_torch.parallel.cluster import InternalClient
    setup_index(cluster3)
    client = cluster3[0].cluster.client
    host = cluster3[1].cluster.nodes[1].host
    status, _ = client._request(host, "GET", "/status")
    assert status == 200
    first = client._local.conns[host]
    monkeypatch.setattr(InternalClient, "POOL_IDLE_MAX", 0.05)
    _time.sleep(0.1)
    status, _ = client._request(host, "GET", "/status")
    assert status == 200
    assert client._local.conns[host] is not first
    second = client._local.conns[host]
    monkeypatch.setattr(InternalClient, "POOL_IDLE_MAX", 60.0)
    status, _ = client._request(host, "GET", "/status")
    assert status == 200
    assert client._local.conns[host] is second


def test_ingest_forwards_to_shard_owners(tmp_path):
    """``/ingest`` on one node routes each record to its shard's owner
    through ``/internal/ingest``; every node then answers the same."""
    from pilosa_tpu_torch.ingest import wire
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ig", {})
        _req(p0, "POST", "/index/ig/field/f", {})
        rng = np.random.default_rng(5)
        cols = rng.choice(8 * SHARD_WIDTH, size=2000, replace=False)
        rows = rng.integers(0, 3, size=2000)
        body = wire.encode_records(rows, cols)
        r = urllib.request.Request(
            f"http://localhost:{p0}/index/ig/field/f/ingest",
            method="POST", data=body)
        with urllib.request.urlopen(r, timeout=180) as resp:
            out = json.loads(resp.read())
        assert out["records"] == 2000 and out["forwarded"] > 0
        for s in servers:
            assert query(s.port, "ig", "Count(Row(f=1))") == \
                [int((rows == 1).sum())]
    finally:
        close_all(servers)
