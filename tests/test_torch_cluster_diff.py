"""Differential tests of the PyTorch port's cluster read plane against the
JAX package: read-routing selection (the ``ReadRouter`` cases of
tests/test_routing.py that need no balancer or chaos proxy) and the
hedge unit cases of tests/test_churn.py, each run on a port ``Cluster``
and a JAX ``Cluster`` over the same placement; a 3-node port cluster
against the JAX package's single-node ``Executor`` on one seeded corpus
and query mix; and one mixed cluster of a JAX node and a port node,
on the ``bin1`` and the JSON internal wire, answering byte for byte
what a 2-node JAX cluster answers.

Every comparison is EXACT (response bytes, node ids, integers).
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.parallel.cluster import Cluster as JaxCluster  # noqa: E402
from pilosa_tpu.server import server as jax_server  # noqa: E402
from pilosa_tpu.server.handler import serialize_result  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel.balancer import \
    ShardLoadTracker  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import Cluster  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, _req, close_all, make_cluster, port_config, query,
    restore_knobs)

HOSTS = ["localhost:1", "localhost:2", "localhost:3"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bare_pair():
    """Unopened 3-node clusters of both packages over memory holders:
    placement, router and breaker state are live without sockets."""
    p = Cluster("node0", HOSTS, replica_n=2, holder=Holder(None))
    j = JaxCluster("node0", HOSTS, replica_n=2, holder=JaxHolder(None))
    yield p, j
    p.close()
    j.close()


def legacy_group(cl, index, shards):
    """The pre-routing grouping: self if an owner, else the first READY
    owner (executor.go:2435)."""
    groups = {}
    for s in shards:
        owners = cl.placement.shard_nodes(index, s)
        ready = [o for o in owners if cl.by_id[o].state == "READY"]
        order = ready or owners
        target = cl.node_id if cl.node_id in order else order[0]
        groups.setdefault(target, []).append(s)
    return groups


def test_primary_policy_matches_legacy_grouping(bare_pair):
    for cl in bare_pair:
        cl.router.policy = "primary"
    shards = list(range(24))
    p, j = bare_pair
    assert p.router.group_shards("i", shards) == \
        legacy_group(p, "i", shards) == j.router.group_shards("i", shards)
    for s in shards:
        assert p.shard_owner_nodes("i", s) == \
            p.placement.shard_nodes("i", s) == j.shard_owner_nodes("i", s)


def test_loaded_with_no_history_falls_back_to_primary(bare_pair):
    p, j = bare_pair
    shards = list(range(16))
    assert p.router.policy == "loaded"
    assert p.router.group_shards("i", shards) == \
        legacy_group(p, "i", shards) == j.router.group_shards("i", shards)
    assert p.router.fallbacks >= 1
    assert p.router.snapshot()["fallbacks"] >= 1


def test_round_robin_spreads_owners(bare_pair):
    p, j = bare_pair
    shard = next(s for s in range(64)
                 if "node0" not in p.placement.shard_nodes("i", s))
    for cl in bare_pair:
        cl.router.policy = "round-robin"
    seen_p, seen_j = [], []
    for _ in range(6):
        seen_p.append(next(iter(p.router.group_shards("i", [shard]))))
        seen_j.append(next(iter(j.router.group_shards("i", [shard]))))
    assert seen_p == seen_j
    assert set(seen_p) == set(p.placement.shard_nodes("i", shard))


def test_breaker_skip_before_dispatch_and_all_open_waiver(bare_pair):
    p, _ = bare_pair
    p.router.policy = "primary"
    shard = next(s for s in range(64)
                 if "node0" not in p.placement.shard_nodes("i", s))
    a, b = p.placement.shard_nodes("i", shard)
    p.client._breaker(p.by_id[a].host).state = "open"
    skips0 = p.router.breaker_skips
    assert p.router.group_shards("i", [shard]) == {b: [shard]}
    assert p.router.breaker_skips == skips0 + 1
    assert p.by_id[a].state == "DOWN"
    p.by_id[a].state = "READY"
    p.client._breaker(p.by_id[b].host).state = "open"
    groups = p.router.group_shards("i", [shard])
    assert sum(groups.values(), []) == [shard]
    assert p.router.breaker_skips == skips0 + 1


def test_hedge_delay_derivation(bare_pair):
    for cl in bare_pair:
        r = cl.router
        assert r.hedge_delay(0.2) == 0.2
        assert r.hedge_delay(0.0) is None
        r.note_dispatch("node1", 1)
        r.note_done("node1", 0.05)
        r.note_dispatch("node2", 1)
        r.note_done("node2", 0.5)
        assert abs(r.hedge_delay(0.0) - 0.2) < 1e-9
        r.note_done("node1", None, ok=False)
        assert abs(r.hedge_delay(0.0) - 0.2) < 1e-9


def test_hedge_candidate_owns_all_shards_and_skips_self(bare_pair):
    p, j = bare_pair
    shard = next(s for s in range(64)
                 if "node0" not in p.placement.shard_nodes("i", s))
    a, b = p.placement.shard_nodes("i", shard)
    assert p.router.hedge_candidate("i", [shard], {a}) == b == \
        j.router.hedge_candidate("i", [shard], {a})
    p.by_id[b].state = "DOWN"
    assert p.router.hedge_candidate("i", [shard], {a}) is None
    p.by_id[b].state = "READY"
    other = next(s for s in range(64)
                 if b not in p.placement.shard_nodes("i", s))
    assert p.router.hedge_candidate("i", [shard, other], {a}) is None


def test_shard_load_tracker_hot_and_spread():
    tr = ShardLoadTracker(window_s=1000)
    for _ in range(40):
        tr.note("i", [7], "node1")
    for _ in range(8):
        tr.note("i", [7], "node2")
    for s in range(4):
        tr.note("i", [s], "node0")
    hot = tr.hot_shards(threshold=2.0)
    assert hot and hot[0][:2] == ("i", 7) and hot[0][2] == 48
    top = tr.snapshot()["hottest"][0]
    assert top["shard"] == 7 and set(top["nodes"]) == {"node1", "node2"}
    tr.rotate()
    assert tr.hot_shards(threshold=2.0)[0][2] == 48
    tr.rotate()
    assert tr.hot_shards(threshold=2.0) == []


# -- the 3-node port cluster against the JAX single-node executor ----------

N_SHARDS = 6
QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Row(f=3)",
    "Difference(Row(f=4), Row(g=1))",
    "TopN(f, Row(g=1), n=3)",
    "TopN(f, n=4)",
    "Sum(Row(f=2), field=v)",
    "Min(field=v) Max(Row(g=0), field=v)",
    "Count(Row(10 < v < 500))",
    "Rows(f)",
    "GroupBy(Rows(g), Rows(f), Row(v > 100))",
    "Count(Row(f=1)) Count(Row(f=7)) TopN(g, Row(f=4), n=2) Row(g=0)",
]


def _corpus():
    rng = np.random.default_rng(2024)
    n = 6000
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, size=n, replace=False)
    return {"f": (rng.integers(0, 8, size=n), cols),
            "g": (rng.integers(0, 4, size=n), cols),
            "v": (cols[: n // 2], rng.integers(0, 1000, size=n // 2))}


def _load_http(port, data):
    _req(port, "POST", "/index/d", {})
    for f in ("f", "g"):
        _req(port, "POST", f"/index/d/field/{f}", {})
    _req(port, "POST", "/index/d/field/v",
         {"options": {"type": "int", "min": 0, "max": 1000}})
    for f in ("f", "g"):
        rows, cols = data[f]
        _req(port, "POST", f"/index/d/field/{f}/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    cols, vals = data["v"]
    _req(port, "POST", "/index/d/field/v/import",
         {"columnIDs": cols.tolist(), "values": vals.tolist()})


def test_three_node_port_cluster_matches_jax_executor(tmp_path):
    from pilosa_tpu.storage import FieldOptions as JaxFieldOptions
    data = _corpus()
    h = JaxHolder(None)
    idx = h.create_index("d")
    for f in ("f", "g"):
        idx.create_field(f).import_bits(*data[f])
    idx.create_field("v", JaxFieldOptions(type="int", min=0, max=1000)) \
        .import_values(*data["v"])
    idx.add_existence(data["f"][1])
    ex = JaxExecutor(h)
    servers = make_cluster(tmp_path, n=3, replica_n=2)
    try:
        _load_http(servers[0].port, data)
        for q in QUERIES:
            want = json.loads(json.dumps(
                [serialize_result(r) for r in ex.execute("d", q)]))
            for s in servers:
                assert query(s.port, "d", q) == want, (q, s.cluster.node_id)
    finally:
        close_all(servers)
        ex.close()


# -- the mixed cluster ------------------------------------------------------

def _jax_config(data_dir, port, hosts, i, wire):
    return jax_server.Config(
        data_dir=str(data_dir), bind=f"localhost:{port}",
        node_id=f"node{i}", cluster_hosts=hosts, replica_n=1,
        anti_entropy_interval=0, metric_poll_interval=0,
        compile_cache_dir="off", warmup_top_n=0, timeseries_interval=0,
        flight_recorder_mb=0, internal_wire=wire)


def _raw_query(port, pql) -> bytes:
    r = urllib.request.Request(f"http://localhost:{port}/index/d/query",
                               method="POST", data=pql.encode())
    with urllib.request.urlopen(r, timeout=180) as resp:
        return resp.read()


def _two_nodes(tmp_path, tag, kinds, wire):
    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i, (kind, p) in enumerate(zip(kinds, ports)):
            d = tmp_path / f"{tag}{i}"
            if kind == "jax":
                srv = jax_server.Server(_jax_config(d, p, hosts, i, wire))
            else:
                srv = port_server.Server(port_config(
                    d, p, hosts, i, 1, internal_wire=wire))
            srv.open()
            servers.append(srv)
    except BaseException:
        close_all(servers)
        raise
    return servers


@pytest.fixture
def jax_knobs():
    """The JAX servers set the JAX package's process-wide knobs too."""
    import pilosa_tpu.executor.executor as jex
    import pilosa_tpu.parallel.mesh_exec as jmesh
    import pilosa_tpu.storage.fragment as jfrag
    import pilosa_tpu.storage.membudget as jmb
    knobs = [(jmb.DEFAULT_BUDGET, "limit_bytes"),
             (jmb.HOST_STAGE_BUDGET, "limit_bytes"),
             (jfrag, "COMPRESSED_RESIDENT"), (jex, "BATCH_TEMP_BYTES"),
             (jmesh, "DECODE_WORKSPACE_BYTES")]
    saved = [(o, a, getattr(o, a)) for o, a in knobs]
    yield
    for o, a, v in saved:
        setattr(o, a, v)


@pytest.mark.parametrize("wire", ["bin1", "json"])
def test_mixed_jax_and_port_cluster_byte_identical(tmp_path, jax_knobs,
                                                   wire):
    """node0 JAX + node1 port answers every query byte for byte as a
    2-node JAX cluster does, through either node."""
    data = _corpus()
    ref = _two_nodes(tmp_path, "ref", ("jax", "jax"), wire)
    try:
        _load_http(ref[0].port, data)
        want = {q: [_raw_query(s.port, q) for s in ref] for q in QUERIES}
    finally:
        close_all(ref)
    mixed = _two_nodes(tmp_path, "mix", ("jax", "port"), wire)
    try:
        _load_http(mixed[0].port, data)
        for q in QUERIES:
            got = [_raw_query(s.port, q) for s in mixed]
            assert got == want[q], q
        # the port node really served its shards over the chosen wire
        port_node = mixed[1]
        assert port_node.holder.index("d").available_shards()
        assert mixed[0].cluster.client.peer_wire_mode(
            port_node.cluster.local.host) == wire
        assert port_node.cluster.client.peer_wire_mode(
            mixed[0].cluster.local.host) == wire
    finally:
        close_all(mixed)
