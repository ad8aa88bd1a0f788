"""Resize with topology persistence on the PyTorch port's cluster
(pilosa_tpu_torch/parallel/cluster.py): the resize cases of
tests/test_cluster.py and every case of tests/test_topology.py, run on
port nodes (``device="cpu"``) and held to the same assertions — grow and
shrink with the deferred cleaner, reads serving while writes are blocked
during a resize, an aborted resize restoring service, a dead sole owner
removed with its data lost, the cluster-wide lost-shard prune; the
persisted ``.topology`` across restarts, a mismatched topology refused,
a straggler re-converged by the probe, a coordinator crash between the
two phases recovered from the job record, and the removed node's
revert, by recovery or by the probe's safety net.

Then a mixed cluster: a JAX coordinator and a port node grow by a port
node and shrink back.  Every answer equals a JAX-only cluster's on the
same steps, and the JAX and port nodes' ``.topology`` files are equal
byte for byte.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.server import server as jax_server  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import Cluster, ClusterError  # noqa: E402,E501
from pilosa_tpu_torch.server.server import Config, Server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, _req, close_all, cluster3, make_cluster, query,
    restore_knobs, setup_index)
from test_torch_cluster_diff import jax_knobs  # noqa: E402, F401


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _owned_frag_count(srv, index="ci"):
    idx = srv.holder.index(index)
    if idx is None:
        return 0
    return sum(len(v.fragments) for f in idx.fields.values()
               for v in f.views.values())


def _cfg(tmp_path, i, host_list, my_host=None, replica_n=2):
    return Config(data_dir=str(tmp_path / f"node{i}"),
                  bind=my_host or host_list[i], node_id=f"node{i}",
                  cluster_hosts=host_list, replica_n=replica_n,
                  device="cpu", anti_entropy_interval=0,
                  metric_poll_interval=0)


def _mk(tmp_path, i, host_list, my_host=None, replica_n=2):
    srv = Server(_cfg(tmp_path, i, host_list, my_host, replica_n))
    srv.open()
    return srv


def _seed(p0, n_shards=6, n=3000):
    _req(p0, "POST", "/index/ci", {})
    _req(p0, "POST", "/index/ci/field/f", {})
    rng = np.random.default_rng(5)
    cols = rng.choice(n_shards * SHARD_WIDTH, size=n, replace=False)
    rows = rng.integers(0, 4, size=n)
    _req(p0, "POST", "/index/ci/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    return {r: int((rows == r).sum()) for r in range(4)}


def _check_oracle(servers, oracle):
    for srv in servers:
        for r, want in oracle.items():
            [cnt] = query(srv.port, "ci", f"Count(Row(f={r}))")
            assert cnt == want, (srv.cluster.node_id, r)


# -- the resize cases of tests/test_cluster.py ------------------------------

def test_resize_grow_and_shrink(tmp_path):
    """2 -> 3 grow then 3 -> 2 shrink with data intact, placement
    rebalanced and unowned fragments collected by the cleaner."""
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, 0, hosts[:2]), _mk(tmp_path, 1, hosts[:2])]
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ci", {})
        _req(p0, "POST", "/index/ci/field/f", {})
        rng = np.random.default_rng(3)
        cols = rng.choice(8 * SHARD_WIDTH, size=4000, replace=False)
        rows = rng.integers(0, 6, size=4000)
        _req(p0, "POST", "/index/ci/field/f/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        oracle = {r: int((rows == r).sum()) for r in range(6)}
        servers.append(_mk(tmp_path, 2, hosts))
        _req(p0, "POST", "/cluster/resize/add-node",
             {"id": "node2", "host": hosts[2]})
        assert len(_req(p0, "GET", "/status")["nodes"]) == 3
        for srv in servers:
            assert srv.cluster.state == "NORMAL"
            assert len(srv.cluster.nodes) == 3
        _check_oracle(servers, oracle)
        assert _owned_frag_count(servers[2]) > 0
        for srv in servers:
            srv.cluster._holder_cleaner()
        pl = servers[0].cluster.placement
        for srv in servers:
            nid = srv.cluster.node_id
            for f in srv.holder.index("ci").fields.values():
                for v in f.views.values():
                    for s in v.fragments:
                        assert nid in pl.shard_nodes("ci", s), (nid, s)
        _req(p0, "POST", "/cluster/resize/remove-node", {"id": "node2"})
        for srv in servers[:2]:
            assert len(srv.cluster.nodes) == 2
        _check_oracle(servers[:2], oracle)
    finally:
        close_all(servers)


def test_reads_serve_writes_blocked_during_resize(cluster3):
    setup_index(cluster3)
    query(cluster3[0].port, "ci", "Set(5, f=1) Set(2097200, f=2)")
    for srv in cluster3:
        srv.cluster.state = "RESIZING"
    try:
        for srv in cluster3:
            [cnt] = query(srv.port, "ci", "Count(Row(f=1))")
            assert cnt == 1
            got = query(srv.port, "ci",
                        "Count(Row(f=1)) Count(Row(f=2)) TopN(f, n=1)")
            assert got[0] == 1 and got[1] == 1
        for bad in ("Set(6, f=1)", "Options(Set(6, f=1))"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                query(cluster3[0].port, "ci", bad)
            assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _req(cluster3[0].port, "POST", "/index/ci/field/h", {})
        assert exc.value.code == 400
    finally:
        for srv in cluster3:
            srv.cluster.state = "NORMAL"
    [cnt] = query(cluster3[0].port, "ci", "Count(Row(f=1))")
    assert cnt == 1


def test_resize_abort_restores_service(cluster3):
    setup_index(cluster3)
    query(cluster3[0].port, "ci", "Set(5, f=1)")
    dead = _free_ports(1)[0]
    with pytest.raises(urllib.error.HTTPError):
        _req(cluster3[0].port, "POST", "/cluster/resize/add-node",
             {"id": "node3", "host": f"localhost:{dead}"})
    for srv in cluster3:
        assert srv.cluster.state == "NORMAL"
        assert len(srv.cluster.nodes) == 3
        [cnt] = query(srv.port, "ci", "Count(Row(f=1))")
        assert cnt == 1


def test_remove_dead_sole_owner_succeeds_with_data_loss(tmp_path):
    """Removing a DEAD node whose shards had no replica (ReplicaN=1)
    completes the resize, accepting the loss of its unreplicated
    shards; queries afterwards cover only the surviving shards."""
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/rm", {})
        _req(p0, "POST", "/index/rm/field/f", {})
        query(p0, "rm", " ".join(
            f"Set({s * SHARD_WIDTH + 9}, f=1)" for s in range(12)))
        [cnt] = query(p0, "rm", "Count(Row(f=1))")
        assert cnt == 12
        cl = servers[0].cluster
        node0_shards = [s for s in range(12)
                        if cl.placement.shard_nodes("rm", s)[0] == "node0"]
        assert 0 < len(node0_shards) < 12
        servers[1].close()
        cl.probe_peers()
        assert cl.state == "DEGRADED"
        # reads over the dead node's shards fail loudly...
        with pytest.raises(urllib.error.HTTPError):
            query(p0, "rm", "Count(Row(f=1))")
        # ...until the operator explicitly removes the dead node
        _req(p0, "POST", "/cluster/resize/remove-node", {"id": "node1"})
        assert cl.state == "NORMAL"
        assert len(cl.nodes) == 1
        [cnt] = query(p0, "rm", "Count(Row(f=1))")
        assert cnt == len(node0_shards)
    finally:
        close_all(servers)


def test_resize_complete_prunes_lost_shards_everywhere():
    """Data-loss shards ride the resize-complete broadcast so EVERY
    node's availability maps drop them, on the first application of an
    epoch only."""
    h = Holder(None)
    idx = h.create_index("i")
    f = idx.create_field("f")
    f.remote_available_shards.update({2, 3, 9})
    c = Cluster("node0", ["localhost:1", "localhost:2"], holder=h)
    try:
        c.cleaner_grace = 0
        c._remote_shards["i"] = {1, 2, 3}
        members = [{"id": "node0", "uri": "localhost:1"},
                   {"id": "node1", "uri": "localhost:2"}]
        c.handle_message({
            "type": "resize-complete", "epoch": 1, "replicaN": 1,
            "membership": members,
            "lostShards": {"i": [2, 3], "ghost": [7]}})
        assert c._remote_shards["i"] == {1}
        assert f.remote_available_shards == {9}
        assert c.epoch == 1
        # shard 2 re-imported after the resize survives a re-driven
        # duplicate (same epoch) and a stale older-epoch message alike
        for dup_epoch in (1, 0):
            c._remote_shards["i"] = {1, 2}
            c.handle_message({
                "type": "resize-complete", "epoch": dup_epoch,
                "replicaN": 1, "membership": members,
                "lostShards": {"i": [2, 3]}})
            assert c._remote_shards["i"] == {1, 2}, dup_epoch
    finally:
        c.close()


# -- tests/test_topology.py -------------------------------------------------

def test_topology_persists_across_restart(tmp_path):
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, 0, hosts[:2]), _mk(tmp_path, 1, hosts[:2])]
    try:
        oracle = _seed(servers[0].port)
        servers.append(_mk(tmp_path, 2, hosts))
        _req(servers[0].port, "POST", "/cluster/resize/add-node",
             {"id": "node2", "host": hosts[2]})
        for srv in servers:
            assert srv.cluster.epoch == 1
            with open(os.path.join(srv.holder.path, ".topology")) as fh:
                top = json.load(fh)
            assert top["epoch"] == 1 and len(top["membership"]) == 3
        close_all(servers)
        servers = [_mk(tmp_path, 0, hosts[:2], my_host=hosts[0]),
                   _mk(tmp_path, 1, hosts[:2], my_host=hosts[1]),
                   _mk(tmp_path, 2, hosts)]
        for srv in servers:
            assert len(srv.cluster.nodes) == 3, srv.cluster.node_id
            assert srv.cluster.epoch == 1
        _check_oracle(servers, oracle)
        pl0 = servers[0].cluster.placement
        for srv in servers[1:]:
            for s in range(6):
                assert srv.cluster.placement.shard_nodes("ci", s) == \
                    pl0.shard_nodes("ci", s)
    finally:
        close_all(servers)


def test_topology_mismatch_rejected(tmp_path):
    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    os.makedirs(tmp_path / "node0", exist_ok=True)
    with open(tmp_path / "node0" / ".topology", "w") as f:
        json.dump({"epoch": 3, "replicaN": 1, "membership": [
            {"id": "nodeX", "uri": "localhost:1"}]}, f)
    with pytest.raises(ClusterError, match="not in the persisted"):
        _mk(tmp_path, 0, hosts)


def _flaky(coord, pred):
    """Wrap the coordinator's client.send_message: raise for messages
    ``pred(host, msg)`` selects."""
    orig = coord.client.send_message

    def send(host, msg, timeout=None):
        if pred(host, msg):
            raise OSError("injected: unreachable")
        return orig(host, msg, timeout) if timeout is not None \
            else orig(host, msg)

    coord.client.send_message = send
    return orig


def test_resize_straggler_reconverges_by_probe(tmp_path):
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, 0, hosts[:2]), _mk(tmp_path, 1, hosts[:2])]
    try:
        oracle = _seed(servers[0].port)
        servers.append(_mk(tmp_path, 2, hosts))
        coord = servers[0].cluster
        orig = _flaky(coord, lambda h, m: m.get("type") == "resize-complete"
                      and h == hosts[1])
        try:
            _req(servers[0].port, "POST", "/cluster/resize/add-node",
                 {"id": "node2", "host": hosts[2]})
        finally:
            coord.client.send_message = orig
        assert coord.epoch == 1 and len(coord.nodes) == 3
        assert servers[1].cluster.epoch == 0
        assert coord._load_resize_job() is not None
        coord.probe_peers()
        assert servers[1].cluster.epoch == 1
        assert len(servers[1].cluster.nodes) == 3
        assert servers[1].cluster.state == "NORMAL"
        assert coord._load_resize_job() is None
        _check_oracle(servers, oracle)
    finally:
        close_all(servers)


def _crash_before_complete(coord):
    orig_handle = coord.handle_message

    def crashing_handle(msg):
        if msg.get("type") == "resize-complete":
            raise RuntimeError("injected coordinator crash")
        return orig_handle(msg)

    coord.handle_message = crashing_handle
    _flaky(coord, lambda h, m: m.get("type") == "resize-complete")


def test_coordinator_crash_midresize_recovers_on_restart(tmp_path):
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, 0, hosts[:2]), _mk(tmp_path, 1, hosts[:2])]
    try:
        oracle = _seed(servers[0].port)
        servers.append(_mk(tmp_path, 2, hosts))
        coord = servers[0].cluster
        _crash_before_complete(coord)
        with pytest.raises(urllib.error.HTTPError):
            _req(servers[0].port, "POST", "/cluster/resize/add-node",
                 {"id": "node2", "host": hosts[2]})
        assert coord._load_resize_job() is not None
        assert servers[1].cluster.state == "RESIZING"
        assert len(servers[1].cluster.nodes) == 2
        dead_cfg = servers[0].config
        servers[0].close()
        servers[0] = Server(dead_cfg)
        servers[0].open()
        for srv in servers:
            assert len(srv.cluster.nodes) == 3, srv.cluster.node_id
            assert srv.cluster.epoch == 1
            assert srv.cluster.state == "NORMAL"
        assert servers[0].cluster._load_resize_job() is None
        _check_oracle(servers, oracle)
    finally:
        close_all(servers)


def test_removed_node_recovers_after_coordinator_crash(tmp_path):
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, i, hosts) for i in range(3)]
    try:
        _seed(servers[0].port)
        _crash_before_complete(servers[0].cluster)
        with pytest.raises(urllib.error.HTTPError):
            _req(servers[0].port, "POST", "/cluster/resize/remove-node",
                 {"id": "node2"})
        assert servers[2].cluster.state == "RESIZING"
        dead_cfg = servers[0].config
        servers[0].close()
        servers[0] = Server(dead_cfg)
        servers[0].open()
        for srv in servers[:2]:
            assert len(srv.cluster.nodes) == 2, srv.cluster.node_id
            assert srv.cluster.state in ("NORMAL", "DEGRADED")
        assert [n.id for n in servers[2].cluster.nodes] == ["node2"]
        assert servers[2].cluster.state == "NORMAL"
    finally:
        close_all(servers)


def test_removed_node_unlatches_via_probe_safety_net(tmp_path):
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, i, hosts) for i in range(3)]
    try:
        _seed(servers[0].port)
        coord = servers[0].cluster
        orig = _flaky(coord, lambda h, m: m.get("type") == "resize-complete"
                      and h == hosts[2])
        try:
            _req(servers[0].port, "POST", "/cluster/resize/remove-node",
                 {"id": "node2"})
        finally:
            coord.client.send_message = orig
        assert servers[2].cluster.state == "RESIZING"
        assert len(servers[2].cluster.nodes) == 3
        servers[2].cluster.probe_peers()
        assert servers[2].cluster.state == "NORMAL"
        assert [n.id for n in servers[2].cluster.nodes] == ["node2"]
    finally:
        close_all(servers)


def test_stale_resizing_latch_unlatches_by_probe(tmp_path):
    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    servers = [_mk(tmp_path, 0, hosts), _mk(tmp_path, 1, hosts)]
    try:
        c1 = servers[1].cluster
        c1.handle_message({"type": "set-state", "state": "RESIZING"})
        assert c1.state == "RESIZING"
        c1.probe_peers()
        assert c1.state == "NORMAL"
    finally:
        close_all(servers)


# -- a JAX coordinator resizing a cluster that holds port nodes -------------

def _raw_query(port, pql) -> bytes:
    r = urllib.request.Request(f"http://localhost:{port}/index/ci/query",
                               method="POST", data=pql.encode())
    with urllib.request.urlopen(r, timeout=180) as resp:
        return resp.read()


QUERIES = ["Count(Row(f=1))", "Row(f=2)", "TopN(f, n=0)",
           "Count(Intersect(Row(f=0), Row(f=3)))"]


def _resize_run(tmp_path, tag, kinds):
    """node0 (JAX, the coordinator) + node1 -> add node2 -> remove
    node2.  Returns the raw answers of every node at each stage and the
    .topology bytes of every member after each resize."""
    ports = _free_ports(3)
    hosts = [f"localhost:{p}" for p in ports]

    def mk(i, host_list):
        d = tmp_path / f"{tag}{i}"
        if kinds[i] == "jax":
            srv = jax_server.Server(jax_server.Config(
                data_dir=str(d), bind=hosts[i], node_id=f"node{i}",
                cluster_hosts=host_list, replica_n=2,
                anti_entropy_interval=0, metric_poll_interval=0,
                compile_cache_dir="off", warmup_top_n=0,
                timeseries_interval=0, flight_recorder_mb=0))
        else:
            srv = Server(Config(
                data_dir=str(d), bind=hosts[i], node_id=f"node{i}",
                cluster_hosts=host_list, replica_n=2, device="cpu",
                anti_entropy_interval=0, metric_poll_interval=0))
        srv.open()
        return srv

    def topologies(members):
        out = []
        for srv in members:
            with open(os.path.join(srv.holder.path, ".topology"),
                      "rb") as fh:
                out.append(fh.read())
        return out

    servers = []
    try:
        servers.append(mk(0, hosts[:2]))
        servers.append(mk(1, hosts[:2]))
        p0 = servers[0].port
        _req(p0, "POST", "/index/ci", {})
        _req(p0, "POST", "/index/ci/field/f", {})
        rng = np.random.default_rng(21)
        cols = rng.choice(8 * SHARD_WIDTH, size=3000, replace=False)
        rows = rng.integers(0, 5, size=cols.size)
        _req(p0, "POST", "/index/ci/field/f/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        answers = [[[_raw_query(s.port, q) for q in QUERIES]
                    for s in servers]]
        servers.append(mk(2, hosts))
        _req(p0, "POST", "/cluster/resize/add-node",
             {"id": "node2", "host": hosts[2]})
        for s in servers:
            s.cluster._holder_cleaner()
        answers.append([[_raw_query(s.port, q) for q in QUERIES]
                        for s in servers])
        grown = topologies(servers)
        _req(p0, "POST", "/cluster/resize/remove-node", {"id": "node2"})
        for s in servers[:2]:
            s.cluster._holder_cleaner()
        answers.append([[_raw_query(s.port, q) for q in QUERIES]
                        for s in servers[:2]])
        shrunk = topologies(servers[:2])
        return answers, grown, shrunk, hosts
    finally:
        close_all(servers)


def test_mixed_cluster_resize_matches_jax_cluster(tmp_path, jax_knobs):
    want, want_grown, want_shrunk, want_hosts = _resize_run(
        tmp_path, "ref", ("jax", "jax", "jax"))
    got, grown, shrunk, hosts = _resize_run(
        tmp_path, "mix", ("jax", "port", "port"))
    assert got == want
    # JAX and port members wrote the same bytes ...
    assert len(set(grown)) == 1 and len(set(shrunk)) == 1
    # ... which are the JAX-only cluster's bytes, up to its ports
    def norm(blob, hs):
        for i, h in enumerate(hs):
            blob = blob.replace(h.encode(), f"HOST{i}".encode())
        return blob
    assert norm(grown[0], hosts) == norm(want_grown[0], want_hosts)
    assert norm(shrunk[0], hosts) == norm(want_shrunk[0], want_hosts)
    top = json.loads(grown[0])
    assert top["epoch"] == 1 and len(top["membership"]) == 3
