"""Read routing, the placement overlay and the hot-shard balancer on the
PyTorch port's cluster (pilosa_tpu_torch/parallel/cluster.py,
routing.py, balancer.py): the cases of tests/test_routing.py that
tests/test_torch_cluster_diff.py does not already hold, run on port
nodes (``device="cpu"``) with the same assertions — loaded scoring,
residency preference with one replica budget-constrained, the overlay's
epoch gating and owner extension, the loaded-vs-primary differential
under interleaved writes (against the JAX package's ``Executor``), the
skew corpus spreading a hot shard, the piggybacked load and residency
fold, the local residency tiers, a balancer handoff that converges with
oracle answers and survives a state-wiped restart of the overlay owner,
and balancer-off reproducing static jump-hash.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server.handler import serialize_result  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import Cluster  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _req, close_all, make_cluster, query, restore_knobs)
from test_torch_cluster_diff import legacy_group  # noqa: E402


@pytest.fixture
def bare_cluster():
    """Unopened 3-node port cluster over a memory holder: placement,
    router and breaker state are live without sockets."""
    cl = Cluster("node0", ["localhost:1", "localhost:2", "localhost:3"],
                 replica_n=2, holder=Holder(None))
    yield cl
    cl.close()


def test_loaded_prefers_low_load_replica(bare_cluster):
    cl = bare_cluster
    cl.router.policy = "loaded"
    cl.router.residency_routing = False
    shard = next(s for s in range(64)
                 if "node0" not in cl.placement.shard_nodes("i", s))
    a, b = cl.placement.shard_nodes("i", shard)
    cl.router.note_dispatch(a, 1)
    cl.router.note_done(a, 0.01)
    cl.router.note_dispatch(b, 1)
    cl.router.note_done(b, 0.01)
    cl.router.note_query_load(b, {"inFlight": 50, "queued": 10})
    assert cl.router.group_shards("i", [shard]) == {a: [shard]}
    cl.router.note_query_load(a, {"inFlight": 50, "queued": 10})
    cl.router.note_query_load(b, {"inFlight": 0, "queued": 0})
    assert cl.router.group_shards("i", [shard]) == {b: [shard]}


def test_residency_preference_with_budget_constrained_replica(bare_cluster):
    cl = bare_cluster
    cl.router.policy = "loaded"
    cl.router.residency_routing = True
    shard = next(s for s in range(64)
                 if "node0" not in cl.placement.shard_nodes("i", s))
    a, b = cl.placement.shard_nodes("i", shard)
    for nid in (a, b):
        cl.router.note_dispatch(nid, 1)
        cl.router.note_done(nid, 0.01)
    cl.router.note_status(b, {"residency": {"i": {"hbm": [shard],
                                                  "host": []}}})
    cl.router.note_status(a, {"residency": {}})
    assert cl.router.group_shards("i", [shard]) == {b: [shard]}
    snap = cl.router.snapshot()["peers"][b]
    assert snap["residencyAgeS"] is not None
    assert snap["residentShards"]["i"]["hbm"] == 1
    cl.router.note_status(b, {"residency": {"i": {"hbm": [],
                                                  "host": [shard]}}})
    assert cl.router.group_shards("i", [shard]) == {b: [shard]}
    cl.router.residency_routing = False
    assert cl.router.group_shards("i", [shard]) == {a: [shard]}


def test_overlay_epoch_gating_and_owner_extension(bare_cluster):
    cl = bare_cluster
    owners = cl.placement.shard_nodes("i", 0)
    extra = next(n.id for n in cl.nodes if n.id not in owners)
    cl._apply_overlay({"epoch": 3, "overlay": [["i", 0, [extra]]]})
    assert cl.overlay_epoch == 3
    assert cl.shard_owner_nodes("i", 0) == owners + [extra]
    assert cl.owned_shards(extra, "i", [0, 1]) \
        == [0] + ([1] if extra in cl.placement.shard_nodes("i", 1) else [])
    cl._apply_overlay({"epoch": 2, "overlay": []})
    assert cl.overlay_epoch == 3
    assert cl.shard_owner_nodes("i", 0) == owners + [extra]
    cl._apply_overlay({"epoch": 4, "overlay": []})
    assert cl.shard_owner_nodes("i", 0) == owners


# -- 3-node end-to-end suite -------------------------------------------------

def _setup(servers, name):
    p0 = servers[0].port
    _req(p0, "POST", f"/index/{name}", {})
    _req(p0, "POST", f"/index/{name}/field/a", {})
    _req(p0, "POST", f"/index/{name}/field/v",
         {"options": {"type": "int", "min": -500, "max": 500}})
    return p0


@pytest.fixture(scope="module")
def rcluster(tmp_path_factory):
    """3-node replica_n=2 port cluster with the ``sk`` corpus loaded,
    shared read-only by the skew / piggyback / residency cases."""
    servers = make_cluster(tmp_path_factory.mktemp("routing"), n=3,
                           replica_n=2, read_routing="loaded")
    p0 = _setup(servers, "sk")
    cols = list(range(0, 4 * SHARD_WIDTH, SHARD_WIDTH // 8))
    _req(p0, "POST", "/index/sk/field/a/import",
         {"rowIDs": [1] * len(cols), "columnIDs": cols})
    yield servers
    close_all(servers)


def test_differential_loaded_vs_primary_interleaved_writes(rcluster):
    """The same queries answer identically under primary and loaded
    routing, across interleaved writes, and equal the JAX package's
    single-node ``Executor`` holding identical data."""
    servers = rcluster
    p0 = _setup(servers, "dr")
    rng = np.random.default_rng(17)
    n = 2500
    cols = rng.integers(0, 4 * SHARD_WIDTH, size=n)
    rows = rng.integers(0, 8, size=n)
    vcols = np.unique(cols[: n // 2])
    vvals = rng.integers(-500, 500, size=vcols.size)
    _req(p0, "POST", "/index/dr/field/a/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    _req(p0, "POST", "/index/dr/field/v/import",
         {"columnIDs": vcols.tolist(), "values": vvals.tolist()})
    oh = JaxHolder(None)
    idx = oh.create_index("dr")
    idx.create_field("a").import_bits(rows, cols)
    idx.create_field("v", JaxFieldOptions(
        type="int", min=-500, max=500)).import_values(vcols, vvals)
    idx.add_existence(cols)
    oracle = JaxExecutor(oh, use_mesh=True)
    queries = ["Count(Row(a=3))", "Row(a=1)",
               "Count(Intersect(Row(a=1), Row(a=2)))",
               "Sum(Row(a=4), field=v)", "Min(field=v)", "Max(field=v)",
               "TopN(a, n=0)", "Rows(a)",
               "GroupBy(Rows(a), limit=6)"]

    def run_policy(policy):
        for s in servers:
            s.cluster.router.policy = policy
        return [query(p0, "dr", q) for q in queries]

    try:
        for phase in range(2):
            want = [[json.loads(json.dumps(serialize_result(r)))
                     for r in oracle.execute("dr", q)] for q in queries]
            got_primary = run_policy("primary")
            got_loaded = run_policy("loaded")
            assert got_loaded == got_primary == want, f"phase {phase}"
            wcol = int(rng.integers(0, 4 * SHARD_WIDTH))
            w = (f"Set({wcol}, a=2) "
                 f"Clear({int(cols[phase])}, a={int(rows[phase])})")
            _req(p0, "POST", "/index/dr/query", w)
            oracle.execute("dr", w)
            idx.add_existence(np.array([wcol]))
    finally:
        for s in servers:
            s.cluster.router.policy = "loaded"
        oracle.close()


def test_skew_corpus_spreads_hot_shard(rcluster):
    """Skewed load on one shard with replica_n=2: loaded routing serves
    the hot shard from MORE than one node."""
    servers = rcluster
    p0 = servers[0].port
    cols = list(range(0, 4 * SHARD_WIDTH, SHARD_WIDTH // 8))
    coord = servers[0].cluster
    hot = next(s for s in range(4)
               if "node0" not in coord.placement.shard_nodes("sk", s))
    hot_q = "Count(Row(a=1))"
    for _ in range(4):
        query(p0, "sk", hot_q)
    tracker = coord.load_tracker
    tracker.rotate()
    tracker.rotate()
    served = set()
    for _round in range(3):
        threads = [threading.Thread(
            target=query, args=(p0, "sk", hot_q)) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        snap = tracker.snapshot(top=16)
        for entry in snap["hottest"]:
            if entry["index"] == "sk" and entry["shard"] == hot:
                served |= set(entry["nodes"])
        if len(served) > 1:
            break
    assert len(served) > 1, \
        f"hot shard {hot} only ever served by {served}"
    [cnt] = query(p0, "sk", hot_q)
    assert cnt == len(cols)


def test_piggybacked_load_and_residency_fold(rcluster):
    servers = rcluster
    p0 = servers[0].port
    coord = servers[0].cluster
    query(p0, "sk", "Count(Row(a=1))")
    coord.probe_peers()
    peers = coord.router.snapshot()["peers"]
    assert peers, "router never saw a peer"
    remotes = {nid: st for nid, st in peers.items() if nid != "node0"}
    assert remotes, "router never saw a remote peer"
    for nid, st in remotes.items():
        assert st["reportedInFlight"] >= 0
        assert st["residencyAgeS"] is not None, \
            f"{nid} never advertised residency"
    assert any(st["residentShards"] for st in remotes.values())
    st = _req(servers[1].port, "GET", "/status")
    assert "load" in st and "residency" in st and "overlayEpoch" in st
    dv = _req(p0, "GET", "/debug/vars")
    assert dv["cluster"]["routing"]["policy"] == "loaded"
    assert set(dv["cluster"]["routing"]["peers"]) >= {"node1", "node2"}
    with urllib.request.urlopen(
            f"http://localhost:{p0}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert "pilosa_tpu_cluster_peer_node1_ewma_rtt_ms" in text
    assert "pilosa_tpu_cluster_peer_node2_inflight" in text
    assert "pilosa_tpu_cluster_overlay_epoch" in text


def test_local_residency_summary_tiers(rcluster):
    """A node that just served a stacked query reports the shards
    resident (stacked blocks count as resident)."""
    servers = rcluster
    query(servers[0].port, "sk", "Count(Row(a=1))")
    summaries = [s.cluster.residency_summary() for s in servers]
    assert any("sk" in s and s["sk"]["hbm"] for s in summaries), \
        f"no node reports sk resident: {summaries}"


# -- hot-shard balancer ------------------------------------------------------

def test_balancer_handoff_converges_with_oracle_answers(tmp_path):
    """A hot shard with replica_n=1 gains an overlay owner (fragments
    copied by the resize fetch), every node adopts the overlay epoch,
    answers stay right, writes fan to the overlay owner, and a
    restarted state-wiped node is reconciled by the probe's
    overlay-epoch re-push."""
    servers = make_cluster(tmp_path, n=3, replica_n=1,
                           hot_shard_threshold=2.0)
    try:
        p0 = _setup(servers, "hb2")
        rng = np.random.default_rng(5)
        cols = np.unique(rng.integers(0, 6 * SHARD_WIDTH, size=1200))
        rows = rng.integers(0, 6, size=cols.size)
        _req(p0, "POST", "/index/hb2/field/a/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        coord = servers[0].cluster
        hot = next(s for s in range(6)
                   if coord.placement.primary("hb2", s) != "node0")
        hot_q = "Count(Row(a=2))"
        want = query(p0, "hb2", hot_q)
        for _ in range(40):
            coord.load_tracker.note("hb2", [hot],
                                    coord.placement.primary("hb2", hot))
        for s in range(6):
            coord.load_tracker.note("hb2", [s], "node0")
        owners0 = coord.shard_owner_nodes("hb2", hot)
        assert len(owners0) == 1
        assert coord.balancer.tick() == 1, coord.balancer.snapshot()
        owners1 = coord.shard_owner_nodes("hb2", hot)
        assert len(owners1) == 2 and owners1[:1] == owners0
        extra = owners1[1]
        for s in servers:
            assert s.cluster.overlay_epoch == coord.overlay_epoch
            assert s.cluster.shard_owner_nodes("hb2", hot) == owners1
        extra_srv = next(s for s in servers if s.cluster.node_id == extra)
        frag = extra_srv.holder.fragment("hb2", "a", "standard", hot)
        assert frag is not None and frag.n_rows > 0
        for s in servers:
            assert query(s.port, "hb2", hot_q) == want
        wcol = hot * SHARD_WIDTH + 123
        query(p0, "hb2", f"Set({wcol}, a=2)")
        assert extra_srv.holder.fragment(
            "hb2", "a", "standard", hot).row(2)[123 // 32] >> (123 % 32) & 1
        [cnt] = query(p0, "hb2", hot_q)
        assert cnt == want[0] + 1
        coord.balancer.tick()
        assert len(coord.shard_owner_nodes("hb2", hot)) <= 3

        victim = extra_srv
        vcfg = victim.config
        servers.remove(victim)
        victim.close()
        topo = os.path.join(os.path.expanduser(vcfg.data_dir), ".topology")
        if os.path.exists(topo):
            os.remove(topo)
        restarted = Server(vcfg)
        restarted.open()
        servers.append(restarted)
        assert restarted.cluster.overlay_epoch == 0  # wiped
        coord.probe_peers()

        def wait_for(cond, timeout=10.0):
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                if cond():
                    return True
                time.sleep(0.05)
            return False

        assert wait_for(lambda: restarted.cluster.overlay_epoch
                        == coord.overlay_epoch)
        assert restarted.cluster.shard_owner_nodes("hb2", hot) \
            == coord.shard_owner_nodes("hb2", hot)
        assert query(restarted.port, "hb2", hot_q) == [want[0] + 1]
        dv = _req(p0, "GET", "/debug/vars")
        assert dv["cluster"]["balancer"]["handoffs"] >= 1
        assert dv["cluster"]["overlay"]["epoch"] >= 1
    finally:
        close_all(servers)


def test_balancer_off_is_static_jump_hash(tmp_path):
    servers = make_cluster(tmp_path, n=2, replica_n=2,
                           read_routing="primary")
    try:
        p0 = _setup(servers, "st")
        _req(p0, "POST", "/index/st/field/a/import",
             {"rowIDs": [1, 1, 1],
              "columnIDs": [5, SHARD_WIDTH + 5, 2 * SHARD_WIDTH + 5]})
        coord = servers[0].cluster
        assert not coord.balancer_on
        assert coord.overlay_snapshot() == {"epoch": 0, "entries": []}
        shards = [0, 1, 2]
        assert coord.router.group_shards("st", shards) == \
            legacy_group(coord, "st", shards)
        [cnt] = query(p0, "st", "Count(Row(a=1))")
        assert cnt == 3
    finally:
        close_all(servers)
