"""Anti-entropy with repair on the PyTorch port's cluster
(pilosa_tpu_torch/parallel/cluster.py ``sync_holder``): the
anti-entropy cases of tests/test_cluster.py run on port nodes
(``device="cpu"``) and held to the same assertions — the bootstrap
copy of a deleted fragment, the majority clear with pushed repairs, the
attr sync and the crash / restart / catch-up lifecycle.

Then what only the port has to show:

* ``Fragment.blocks`` / ``block_data`` of the same bits are equal in
  both packages (a mixed cluster compares the hex digests across
  packages), over array, bitmap and run containers, and so is the
  whole-fragment roaring copy that ``/internal/fragment/data`` serves;
* a repaired or re-created fragment is not read from a stale stack: a
  request run before the repair, then after it, answers the repaired
  bits, and the stacked executor staged the shard group afresh;
* a mixed cluster of one JAX node and one port node with
  ``replica_n = 2``: diverge the replicas, run ``sync_holder`` on each
  side in turn, and both packages end with identical fragments and
  equal block digests.

Every comparison is exact.
"""

import urllib.error

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.ops.bitset import \
    unpack_fragment as jax_unpack_fragment  # noqa: E402
from pilosa_tpu.server import server as jax_server  # noqa: E402
from pilosa_tpu.storage.roaring_io import \
    pack_roaring as jax_pack_roaring  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import fragment_roaring  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, _req, close_all, cluster3, make_cluster, port_config,
    query, restore_knobs, setup_index)
from test_torch_cluster_diff import jax_knobs  # noqa: E402, F401


def test_anti_entropy_repair(cluster3):
    setup_index(cluster3)
    col = 2 * SHARD_WIDTH + 9
    query(cluster3[0].port, "ci", f"Set({col}, f=4)")
    cl0 = cluster3[0].cluster
    owners = cl0.placement.shard_nodes("ci", 2)
    # wipe the fragment on one owner
    victim = next(s for s in cluster3 if s.cluster.node_id == owners[1])
    v = victim.holder.index("ci").field("f").view("standard")
    assert v is not None and v.fragment(2) is not None
    del v.fragments[2]
    # anti-entropy on the victim pulls the fragment back
    victim.cluster.sync_holder()
    frag = victim.holder.fragment("ci", "f", "standard", 2)
    assert frag is not None
    assert col % SHARD_WIDTH in frag.row_columns(4)


def test_anti_entropy_majority_clear_and_push(tmp_path):
    """A bit cleared on a majority of replicas is CLEARED on the
    minority holder (not resurrected), and repairs are PUSHED to
    disagreeing peers, not just pulled."""
    servers = make_cluster(tmp_path, n=3, replica_n=3)
    try:
        setup_index(servers)
        col = 9
        query(servers[0].port, "ci", f"Set({col}, f=4)")
        for s in servers:
            assert s.holder.fragment("ci", "f", "standard", 0) is not None
        for s in servers[:2]:
            s.holder.fragment("ci", "f", "standard", 0).clear_bit(4, col)
        servers[0].cluster.sync_holder()
        for s in servers:
            frag = s.holder.fragment("ci", "f", "standard", 0)
            assert col not in frag.row_columns(4), s.cluster.node_id
        query(servers[0].port, "ci", f"Set({col + 1}, f=4)")
        servers[2].holder.fragment("ci", "f", "standard", 0) \
            .clear_bit(4, col + 1)
        servers[0].cluster.sync_holder()  # push path: 0 repairs 2
        frag2 = servers[2].holder.fragment("ci", "f", "standard", 0)
        assert col + 1 in frag2.row_columns(4)
    finally:
        close_all(servers)


def test_anti_entropy_attr_sync(cluster3):
    """Attr stores sync by block diff: a replica stale on an attr
    converges to its peers on its own pass."""
    setup_index(cluster3)
    query(cluster3[0].port, "ci", "Set(1, f=2)")
    query(cluster3[0].port, "ci", 'SetRowAttrs(f, 2, team="core")')
    f1 = cluster3[1].holder.index("ci").field("f")
    f1.row_attrs.set_attrs(2, {"team": "stale", "extra": None})
    col_attrs = cluster3[1].holder.index("ci").column_attrs
    col_attrs.set_attrs(7, {"ghost": True})
    cluster3[1].cluster.sync_holder()
    assert f1.row_attrs.attrs(2)["team"] == "core"
    cluster3[0].cluster.sync_holder()
    assert cluster3[0].holder.index("ci").column_attrs.attrs(7) == \
        {"ghost": True}


def test_node_crash_recovery_lifecycle(tmp_path):
    """A node dies -> DEGRADED, reads serve from replicas -> it restarts
    on its data dir -> schema catches up on the next probe ->
    anti-entropy repairs what it missed -> NORMAL."""
    servers = make_cluster(tmp_path, n=3, replica_n=2)
    try:
        setup_index(servers)
        query(servers[0].port, "ci", "Set(5, f=2)")
        dead_cfg = servers[2].config
        servers[2].close()
        servers[0].cluster.probe_peers()
        assert servers[0].cluster.state == "DEGRADED"
        [cnt] = query(servers[0].port, "ci", "Count(Row(f=2))")
        assert cnt == 1
        with pytest.raises(urllib.error.HTTPError) as exc:
            _req(servers[0].port, "POST", "/index/ci/field/g", {})
        assert exc.value.code == 400
        servers[2] = port_server.Server(dead_cfg)
        servers[2].open()
        servers[0].cluster.probe_peers()
        assert servers[0].cluster.state == "NORMAL"
        _req(servers[0].port, "POST", "/index/ci/field/g", {})
        schema = _req(servers[2].port, "GET", "/schema")["indexes"]
        assert {f["name"] for f in schema[0]["fields"]} >= {"f", "g"}
        servers[2].cluster.probe_peers()
        servers[2].cluster.sync_holder()
        for srv in servers:
            [cnt] = query(srv.port, "ci", "Count(Row(f=2))")
            assert cnt == 1, srv.cluster.node_id
    finally:
        close_all(servers)


# -- block digests across packages ------------------------------------------

def _bits(kind: str, seed: int):
    """(rows, cols) in one shard whose containers are mostly ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "array":
        cols = rng.choice(SHARD_WIDTH, size=3000, replace=False)
        rows = rng.integers(0, 250, size=cols.size)
    elif kind == "bitmap":
        cols = np.concatenate([rng.choice(65536, size=20000, replace=False)
                               + 65536 * k for k in range(3)])
        rows = np.repeat(rng.integers(0, 210, size=3), 20000)
    else:
        starts = rng.choice(SHARD_WIDTH - 5000, size=6, replace=False)
        cols = np.concatenate([np.arange(s, s + 4000) for s in starts])
        rows = np.repeat(np.array([3, 101, 205, 3, 150, 99]), 4000)
    return rows.astype(np.int64), cols.astype(np.int64)


@pytest.mark.parametrize("kind", ["array", "bitmap", "run"])
def test_block_digests_equal_across_packages(kind):
    rows, cols = _bits(kind, 11)
    jf = JaxHolder(None).create_index("d").create_field("f") \
        ._create_view_if_not_exists("standard") \
        .create_fragment_if_not_exists(0)
    pf = Holder(None).create_index("d").create_field("f") \
        ._create_view_if_not_exists("standard") \
        .create_fragment_if_not_exists(0)
    jf.bulk_import(rows, cols)
    pf.bulk_import(rows, cols)
    jb = {b: ck.hex() for b, ck in jf.blocks().items()}
    pb = {b: ck.hex() for b, ck in pf.blocks().items()}
    assert jb and pb == jb
    for b in jb:
        jr, jc = jf.block_data(b)
        pr, pc = pf.block_data(b)
        assert np.array_equal(jr, pr) and np.array_equal(jc, pc)
    # the whole-fragment copy a bootstrap or resize fetch serves: the
    # JAX route's pair-expanded pack, byte for byte
    want = jax_pack_roaring(*jax_unpack_fragment(jf.words))
    assert fragment_roaring(pf) == want
    assert fragment_roaring(None) == jax_pack_roaring(
        np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))


# -- repairs are not read from a stale stack --------------------------------

@pytest.mark.parametrize("divergence", ["cleared-row", "deleted-fragment"])
def test_repair_restages_the_stack(tmp_path, divergence):
    """Run a request (its shard group is staged), diverge one replica,
    repair it, run the request again on the repaired node: the answer
    is the repaired one and the stack was staged afresh (the fragment
    generation moved, so the stack token changed)."""
    servers = make_cluster(tmp_path, n=2, replica_n=2)
    try:
        setup_index(servers)
        cols = [s * SHARD_WIDTH + c for s in range(3) for c in (1, 7, 40)]
        _req(servers[0].port, "POST", "/index/ci/field/f/import",
             {"rowIDs": [4] * len(cols), "columnIDs": cols})
        victim = servers[1]
        q = "Count(Row(f=4))"
        ex = victim.api.executor
        for _ in range(2):
            assert ex.execute("ci", q)[0] == len(cols)
        v = victim.holder.index("ci").field("f").view("standard")
        if divergence == "cleared-row":
            frag = v.fragment(1)
            for c in (1, 7, 40):
                frag.clear_bit(4, c)
        else:
            del v.fragments[1]
        assert ex.execute("ci", q)[0] == len(cols) - 3
        builds = ex.stacked.stack_builds
        victim.cluster.sync_holder()
        assert ex.execute("ci", q)[0] == len(cols)
        assert ex.stacked.stack_builds > builds
        assert sorted(victim.holder.fragment(
            "ci", "f", "standard", 1).row_columns(4).tolist()) == [1, 7, 40]
    finally:
        close_all(servers)


# -- a mixed JAX + port cluster ---------------------------------------------

def _mixed_pair(tmp_path):
    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        servers.append(jax_server.Server(jax_server.Config(
            data_dir=str(tmp_path / "jax0"), bind=hosts[0],
            node_id="node0", cluster_hosts=hosts, replica_n=2,
            anti_entropy_interval=0, metric_poll_interval=0,
            compile_cache_dir="off", warmup_top_n=0,
            timeseries_interval=0, flight_recorder_mb=0)))
        servers.append(port_server.Server(port_config(
            tmp_path / "port1", ports[1], hosts, 1, 2)))
        for s in servers:
            s.open()
    except BaseException:
        close_all(servers)
        raise
    return servers


def _frag_state(srv, shard):
    frag = srv.holder.fragment("ci", "f", "standard", shard)
    if frag is None:
        return None
    return (np.asarray(frag.words, dtype=np.uint32).copy(),
            {b: ck.hex() for b, ck in frag.blocks().items()})


@pytest.mark.parametrize("first", ["jax", "port"])
def test_mixed_cluster_anti_entropy_converges(tmp_path, jax_knobs, first):
    """node0 JAX + node1 port, replica_n = 2 (both own every shard).
    Delete a fragment on one side and clear a row's bits in another
    fragment on the other side; ``sync_holder`` from ``first``, then
    diverge again the other way and sync from the other side.  With 2
    replicas the majority is 1 of 2, so the union wins: every fragment
    is restored, and the two packages hold identical words and equal
    block digests (as served over ``/internal/fragment/blocks``)."""
    servers = _mixed_pair(tmp_path)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ci", {})
        _req(p0, "POST", "/index/ci/field/f", {})
        rng = np.random.default_rng(7)
        cols = np.unique(rng.integers(0, 4 * SHARD_WIDTH, size=4000))
        rows = rng.integers(0, 5, size=cols.size)
        _req(p0, "POST", "/index/ci/field/f/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        want = [query(p0, "ci", f"Count(Row(f={r}))")[0] for r in range(5)]
        by_kind = {"jax": servers[0], "port": servers[1]}
        order = [first, "port" if first == "jax" else "jax"]
        for step, syncer in enumerate(order):
            other = order[1 - step]
            # the syncer lost a whole fragment; the other side lost a
            # row's bits in another fragment
            del by_kind[syncer].holder.index("ci").field("f") \
                .view("standard").fragments[step]
            frag = by_kind[other].holder.fragment("ci", "f", "standard",
                                                  2 + step)
            for c in frag.row_columns(3).tolist():
                frag.clear_bit(3, c)
            by_kind[syncer].cluster.sync_holder()
            for shard in range(4):
                js, ps = _frag_state(servers[0], shard), \
                    _frag_state(servers[1], shard)
                assert js is not None and ps is not None, (syncer, shard)
                assert np.array_equal(js[0], ps[0]), (syncer, shard)
                assert js[1] == ps[1], (syncer, shard)
                wire = [_req(s.port, "GET",
                             f"/internal/fragment/blocks?index=ci&field=f"
                             f"&view=standard&shard={shard}")
                        for s in servers]
                assert wire[0] == wire[1] and wire[0]["blocks"]
            for s in servers:
                got = [query(s.port, "ci", f"Count(Row(f={r}))")[0]
                       for r in range(5)]
                assert got == want, (syncer, s.cluster.node_id)
    finally:
        close_all(servers)
