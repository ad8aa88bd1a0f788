"""Tail-tolerant cluster reads under NETWORK faults on the PyTorch port's
cluster: the cases of tests/test_churn.py that
tests/test_torch_cluster_diff.py does not already hold, run on port
nodes (``device="cpu"``) dialed through the port's ``ChaosProxy``
(pilosa_tpu_torch/utils/netchaos.py) and held to the same assertions.

Covers: the shared failpoint spec grammar and the proxy's forwarding and
fault modes; the shard-discovery poll riding the prober's miss
accounting; the degraded accumulator; hedged reads beating a proxied
straggler; immediate failover off a partitioned peer; the
partial-results contract; the hedging differential; writes never
hedging; and, slow-marked as in the reference, a 20-cycle churn soak.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.parallel.cluster import Cluster  # noqa: E402
from pilosa_tpu_torch.server.server import Config as _Config  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.utils import degraded  # noqa: E402
from pilosa_tpu_torch.utils.faults import parse_spec  # noqa: E402
from pilosa_tpu_torch.utils.netchaos import ChaosProxy  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, _req, query, restore_knobs)


def Config(**kw):
    """The port server's Config on the CPU, without the metric poll."""
    return _Config(device="cpu", metric_poll_interval=0, **kw)


# -- unit: shared spec grammar + proxy mechanics ----------------------------

def test_parse_spec_shared_grammar():
    got = parse_spec("down=latency:0.25@peer1#3; connect=partition")
    assert got == [("down", "latency", 0.25, "peer1", 3),
                   ("connect", "partition", 0.0, None, None)]
    with pytest.raises(ValueError):
        parse_spec("nomode")


def test_chaos_proxy_rejects_unknown_sites_and_modes():
    srv = socket.socket()
    srv.bind(("localhost", 0))
    srv.listen(1)
    proxy = ChaosProxy("localhost", srv.getsockname()[1])
    try:
        with pytest.raises(ValueError):
            proxy.arm("sideways", "latency")
        with pytest.raises(ValueError):
            proxy.arm("down", "explode")
        # failpoint-registry modes are NOT network modes: the shared
        # grammar parses, the proxy's own mode set rejects
        with pytest.raises(ValueError):
            # lint: allow(failpoint-names) — deliberately-bad proxy spec
            # (registry mode on a proxy site); never armed on FAULTS
            proxy.configure("down=delay:0.1")
    finally:
        proxy.close()
        srv.close()


def _echo_server():
    """A tiny TCP echo server; returns (sock, port, closer)."""
    srv = socket.socket()
    srv.bind(("localhost", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            def pump(c=conn):
                try:
                    while True:
                        b = c.recv(65536)
                        if not b:
                            return
                        c.sendall(b)
                except OSError:
                    pass
                finally:
                    c.close()
            threading.Thread(target=pump, daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    return srv, srv.getsockname()[1]


def test_chaos_proxy_forwards_latency_and_rst():
    srv, port = _echo_server()
    proxy = ChaosProxy("localhost", port)
    try:
        # clean forwarding round trip
        c = socket.create_connection(("localhost", proxy.port), timeout=5)
        c.sendall(b"hello")
        assert c.recv(64) == b"hello"
        # latency on the response direction
        proxy.configure("down=latency:0.15")
        t0 = time.perf_counter()
        c.sendall(b"slow")
        assert c.recv(64) == b"slow"
        assert time.perf_counter() - t0 >= 0.14
        proxy.heal()
        c.close()
        # mid-response RST: the client sees a reset, not a FIN
        proxy.configure("down=rst")
        c2 = socket.create_connection(("localhost", proxy.port), timeout=5)
        c2.sendall(b"boom")
        with pytest.raises(OSError):
            got = c2.recv(64)
            if got == b"":          # platform surfaced the RST as EOF:
                raise ConnectionResetError  # still a dead connection
        c2.close()
        snap = proxy.snapshot()
        assert snap["bytesUp"] >= 9 and snap["bytesDown"] >= 9
        assert snap["rsts"] >= 1
        assert snap["connections"] >= 2
    finally:
        proxy.close()
        srv.close()


def test_chaos_proxy_partition_and_blackhole():
    srv, port = _echo_server()
    proxy = ChaosProxy("localhost", port)
    try:
        proxy.configure("connect=partition")
        with pytest.raises(OSError):
            c = socket.create_connection(("localhost", proxy.port),
                                         timeout=2)
            c.sendall(b"x")
            if c.recv(16) == b"":
                raise ConnectionResetError
        proxy.heal()
        # half-open drop: bytes vanish, the sender's read times out
        proxy.configure("up=blackhole")
        c2 = socket.create_connection(("localhost", proxy.port), timeout=2)
        c2.settimeout(0.3)
        c2.sendall(b"into-the-void")
        with pytest.raises(TimeoutError):
            c2.recv(64)
        c2.close()
        assert proxy.snapshot()["droppedBytes"] >= 13
    finally:
        proxy.close()
        srv.close()


# -- unit: discovery polls ride the prober's miss accounting ----------------

def test_single_poll_failure_keeps_node_ready():
    """One transient _available_shards poll failure must count ONE
    probe miss (health-down-threshold discipline), not
    flip the peer DOWN outright and silently shrink every later
    fan-out wave."""
    cl = Cluster("node0", ["localhost:1", "localhost:2"], replica_n=1,
                 holder=Holder(None), health_down_threshold=2)
    try:
        calls = {"n": 0}

        def boom(host, index, timeout=None):
            calls["n"] += 1
            raise socket.timeout("discovery poll timed out")

        cl.client.available_shards = boom
        cl._available_shards("i")
        assert cl.by_id["node1"].state == "READY"      # one miss
        assert cl.by_id["node1"].probe_fails == 1
        assert cl.state != "DEGRADED"
        cl._available_shards("i")
        assert cl.by_id["node1"].state == "DOWN"       # second miss
        # success clears the streak exactly like a successful probe
        cl.by_id["node1"].state = "READY"
        cl.client.available_shards = lambda host, index, timeout=None: [0]
        cl._available_shards("i")
        assert cl.by_id["node1"].probe_fails == 0
        # informational callers never touch health accounting
        cl.client.available_shards = boom
        cl._available_shards("i", mark_down=False)
        assert cl.by_id["node1"].probe_fails == 0
    finally:
        cl.close()


# -- unit: degraded accumulator (partial contract) --------------------------

def test_degraded_partial_accumulator():
    assert degraded.partial_allowed() is False   # inert outside collect
    degraded.note_missing("i", [1, 2])           # no-op, no crash
    with degraded.collect(allow_partial=False) as acc:
        assert degraded.partial_allowed() is False
        degraded.note(2)
        assert degraded.to_response(acc) == {"quarantinedFragments": 2}
    with degraded.collect(allow_partial=True) as acc:
        assert degraded.partial_allowed() is True
        assert degraded.is_partial() is False
        degraded.note_missing("i", [3, 1], nodes=["node1"])
        degraded.note_missing("i", [3, 7], nodes=["node2"])
        assert degraded.is_partial() is True
        out = degraded.to_response(acc)
        assert out["missingShards"] == {"i": [1, 3, 7]}
        assert out["missingNodes"] == ["node1", "node2"]
    assert degraded.is_partial() is False


# -- proxied 3-node cluster (real sockets) ----------------------------------

N_SHARDS = 8


class _ProxiedCluster:
    """3 real servers; node1/node2 are dialed THROUGH ChaosProxies by
    every peer, so network faults on them are real TCP behavior."""

    def __init__(self, tmp_path):
        binds = _free_ports(3)
        self.servers = []
        self.proxies = {}
        hosts = [f"localhost:{binds[0]}"]
        for i in (1, 2):
            proxy = ChaosProxy("localhost", binds[i])
            self.proxies[f"node{i}"] = proxy
            hosts.append(proxy.address)
        for i, p in enumerate(binds):
            srv = Server(Config(
                data_dir=str(tmp_path / f"node{i}"),
                bind=f"localhost:{p}", node_id=f"node{i}",
                cluster_hosts=hosts, replica_n=2,
                anti_entropy_interval=0,
                read_routing="primary",     # deterministic targeting
                hedge_delay_ms=40.0))
            srv.open()
            self.servers.append(srv)
        self.port = self.servers[0].port
        self.cl = self.servers[0].cluster
        # pick an index name whose placement gives node0 SOME shards
        # but not all (jump-hash is name-keyed; a tiny shard count can
        # land every replica set on node0 by chance) — the partial-
        # results test needs both truly-remote and locally-served shards
        self.index = next(
            name for name in (f"tt{i}" for i in range(64))
            if 0 < len(self._remote_owned(name)) < N_SHARDS)
        _req(self.port, "POST", f"/index/{self.index}", {})
        _req(self.port, "POST", f"/index/{self.index}/field/f", {})
        cols = [s * SHARD_WIDTH + (s % 5) for s in range(N_SHARDS)]
        _req(self.port, "POST", f"/index/{self.index}/field/f/import",
             {"rowIDs": [1] * len(cols), "columnIDs": cols})
        [self.count_all] = query(self.port, self.index,
                                 "Count(Row(f=1))")

    def heal(self):
        for proxy in self.proxies.values():
            proxy.heal()
        # force probe recovery instead of waiting out the health cadence
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            self.cl.probe_peers()
            if all(n.state == "READY" for n in self.cl.nodes):
                return
            time.sleep(0.1)
        raise AssertionError(
            f"peers never recovered: "
            f"{[(n.id, n.state) for n in self.cl.nodes]}")

    def close(self):
        for s in self.servers:
            try:
                s.close()
            except Exception:
                pass
        for proxy in self.proxies.values():
            proxy.close()

    def _remote_owned(self, index):
        return [s for s in range(N_SHARDS)
                if "node0" not in
                self.cl.placement.shard_nodes(index, s)]

    def remote_owned(self):
        """Shards owned by node1+node2 only (node0 holds no replica)."""
        return self._remote_owned(self.index)


@pytest.fixture(scope="module")
def proxied(tmp_path_factory):
    # module-scoped on purpose: one 3-node spin-up amortizes over
    # every real-socket test below; each
    # test heals the proxies and restores READY before returning
    c = _ProxiedCluster(tmp_path_factory.mktemp("churn"))
    yield c
    c.close()


def _counts(port):
    return _req(port, "GET", "/debug/vars")["counts"]


def test_hedged_read_beats_proxied_straggler(proxied):
    """A replica delayed FAR past the hedge delay must not set the
    query's latency: the hedge fires at the other replica and its
    answer wins, byte-identical to the healthy answer."""
    shards = proxied.remote_owned()
    assert shards, "placement gave node0 every shard replica?"
    s = shards[0]
    straggler = proxied.cl._ready_owner_order(proxied.index, s)[0]
    [want] = query(proxied.port, proxied.index, "Count(Row(f=1))")
    before = _counts(proxied.port)
    delay = 1.0
    proxied.proxies[straggler].configure(f"down=latency:{delay}")
    try:
        t0 = time.perf_counter()
        got = _req(proxied.port, "POST",
                   f"/index/{proxied.index}/query?shards={s}", "Count(Row(f=1))")
        elapsed = time.perf_counter() - t0
    finally:
        proxied.heal()
    assert got["results"] == [1]
    assert "degraded" not in got          # hedged != partial
    assert elapsed < delay * 0.7, \
        f"hedge never rescued the query ({elapsed:.2f}s)"
    after = _counts(proxied.port)
    assert after.get("cluster.hedges", 0) > before.get("cluster.hedges", 0)
    assert after.get("cluster.hedge_wins", 0) > \
        before.get("cluster.hedge_wins", 0)
    # per-peer hedge state surfaces at /debug/vars cluster.routing
    peers = _req(proxied.port, "GET",
                 "/debug/vars")["cluster"]["routing"]["peers"]
    assert any(p.get("hedgeWins", 0) >= 1 for p in peers.values())
    # full query afterwards: answers unchanged
    assert query(proxied.port, proxied.index, "Count(Row(f=1))") == [want]


def test_hedged_full_query_straggler_group(proxied):
    """A FULL-index query's straggler group rarely has one common
    alternate owner under jump-hash: the hedge then splits across
    replica subgroups via the router's own grouping — every shard still
    gets its speculative second chance, and the straggler never sets
    the query's latency."""
    shards = proxied.remote_owned()
    straggler = proxied.cl._ready_owner_order(proxied.index,
                                              shards[0])[0]
    before = _counts(proxied.port)
    delay = 1.0
    proxied.proxies[straggler].configure(f"down=latency:{delay}")
    try:
        t0 = time.perf_counter()
        got = _req(proxied.port, "POST",
                   f"/index/{proxied.index}/query", "Count(Row(f=1))")
        elapsed = time.perf_counter() - t0
    finally:
        proxied.heal()
    assert got["results"] == [proxied.count_all]
    assert "degraded" not in got
    assert elapsed < delay * 0.7, \
        f"full-query hedge never rescued ({elapsed:.2f}s)"
    after = _counts(proxied.port)
    assert after.get("cluster.hedges", 0) > before.get("cluster.hedges", 0)


def test_partitioned_peer_fails_over_mid_query(proxied):
    """Hard partition (accept+RST, live flows severed) on one replica:
    the fan-out re-dispatches its shards to the surviving owner
    IMMEDIATELY (cluster.retry_waves) and the answer stays complete."""
    before = _counts(proxied.port)
    proxy = proxied.proxies["node1"]
    proxy.configure("connect=partition")
    proxy.sever()
    try:
        t0 = time.perf_counter()
        [got] = query(proxied.port, proxied.index, "Count(Row(f=1))")
        elapsed = time.perf_counter() - t0
    finally:
        proxied.heal()
    assert got == proxied.count_all       # full answer off replicas
    assert elapsed < 20.0                 # never a full socket timeout
    after = _counts(proxied.port)
    assert after.get("cluster.retry_waves", 0) > \
        before.get("cluster.retry_waves", 0)


def test_partial_results_names_exact_missing_shards(proxied):
    """With BOTH remote nodes partitioned, shards node0 doesn't own are
    truly unservable: without the opt-in the query fails with the
    per-node attempt log; with ?partialResults=true it answers 200 and
    degraded.missingShards lists EXACTLY those shards."""
    lost = proxied.remote_owned()
    served = [s for s in range(N_SHARDS) if s not in lost]
    for nid in ("node1", "node2"):
        proxied.proxies[nid].configure("connect=partition")
        proxied.proxies[nid].sever()
    try:
        # loud failure without the opt-in, with the attempt trail
        try:
            query(proxied.port, proxied.index, "Count(Row(f=1))")
            raise AssertionError("unservable shards answered without "
                                 "partialResults")
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            assert "attempts:" in body["error"]
        got = _req(proxied.port, "POST",
                   f"/index/{proxied.index}/query?partialResults=true",
                   "Count(Row(f=1))")
        assert got["results"] == [len(served)]
        deg = got["degraded"]
        assert deg["missingShards"] == {proxied.index: sorted(lost)}
        assert set(deg["missingNodes"]) <= {"node1", "node2"}
        assert _counts(proxied.port).get("cluster.partial_results", 0) >= 1
        # Row over the partial scope: the served segments are intact
        row = _req(proxied.port, "POST",
                   f"/index/{proxied.index}/query?partialResults=true", "Row(f=1)")
        assert "degraded" in row
    finally:
        proxied.heal()
    # healed: complete answers, no degraded object
    full = _req(proxied.port, "POST", f"/index/{proxied.index}/query",
                "Count(Row(f=1))")
    assert full["results"] == [proxied.count_all]
    assert "degraded" not in full


def test_hedging_differential_no_fault_byte_identical(proxied):
    """With no fault armed, aggressive hedging must be invisible in the
    answers: every query result byte-identical to the hedge-off run."""
    queries = ["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=0)",
               "Count(Intersect(Row(f=1), Row(f=1)))"]
    cl = proxied.cl
    old_delay = cl.hedge_delay_ms
    cl.hedge_delay_ms = 0.001     # hedge every remote dispatch
    try:
        before = _counts(proxied.port)
        hedged = [query(proxied.port, proxied.index, q) for q in queries]
        assert _counts(proxied.port).get("cluster.hedges", 0) > \
            before.get("cluster.hedges", 0), "hedges never fired"
        cl.hedge_reads = False
        unhedged = [query(proxied.port, proxied.index, q) for q in queries]
    finally:
        cl.hedge_reads = True
        cl.hedge_delay_ms = old_delay
    assert json.dumps(hedged, sort_keys=True) == \
        json.dumps(unhedged, sort_keys=True)


def test_writes_are_never_hedged(proxied):
    """Writes fan through their replica-synchronous paths: even with an
    instant hedge delay, no write dispatch may hedge."""
    cl = proxied.cl
    old_delay = cl.hedge_delay_ms
    cl.hedge_delay_ms = 0.001
    try:
        before = _counts(proxied.port).get("cluster.hedges", 0)
        for s in range(4):
            query(proxied.port, proxied.index,
                  f"Set({s * SHARD_WIDTH + 99}, f=7)")
        _req(proxied.port, "POST", f"/index/{proxied.index}/field/f/import",
             {"rowIDs": [8, 8], "columnIDs": [5, SHARD_WIDTH + 5]})
        assert _counts(proxied.port).get("cluster.hedges", 0) == before
    finally:
        cl.hedge_delay_ms = old_delay
        for s in range(4):
            query(proxied.port, proxied.index,
                  f"Clear({s * SHARD_WIDTH + 99}, f=7)")


# -- churn soak (slow): kill/restart/partition under live load --------------

@pytest.mark.slow
def test_churn_soak_no_wrong_answers_no_acked_loss(tmp_path):
    """20 churn cycles (partition / straggler / mid-response RSTs /
    kill -> restart) against a 3-node proxied cluster under concurrent
    reads + binary streaming ingest.  Invariants: a 200 read's count is
    never below the acked-distinct-column watermark at issue time nor
    above the sent total (zero wrong answers), every acked ingest
    column survives to the end (zero acked-write loss), and
    successful-read p99 stays bounded."""
    from pilosa_tpu_torch.ingest import wire

    binds = _free_ports(3)
    proxies = {}
    hosts = [f"localhost:{binds[0]}"]
    for i in (1, 2):
        proxies[f"node{i}"] = ChaosProxy("localhost", binds[i])
        hosts.append(proxies[f"node{i}"].address)
    cfgs = [Config(data_dir=str(tmp_path / f"node{i}"),
                   bind=f"localhost:{binds[i]}", node_id=f"node{i}",
                   cluster_hosts=hosts, replica_n=2,
                   anti_entropy_interval=0)
            for i in range(3)]
    servers = [Server(c) for c in cfgs]
    for s in servers:
        s.open()
    p0 = servers[0].port
    stop = threading.Event()
    state_lock = threading.Lock()
    acked_cols: set[int] = {1}     # cols whose ingest ack arrived
    sent_cols: set[int] = {1}      # cols ever sent (acked or not —
    #                                an ack lost mid-churn may still
    #                                have durably applied)
    lats: list[float] = []
    wrong: list[str] = []

    try:
        _req(p0, "POST", "/index/ch", {})
        _req(p0, "POST", "/index/ch/field/f", {})
        query(p0, "ch", "Set(1, f=1)")

        def writer():
            # deterministic fresh batches, spread over 4 shards; a
            # failed batch retries verbatim (idempotent frames) before
            # the next one, so `acked_cols` only ever grows
            batch_no = 0
            while not stop.is_set():
                base = 8 + batch_no * 16
                cols = np.asarray(
                    [(base + j) * 977 % (4 * SHARD_WIDTH)
                     for j in range(16)], dtype=np.int64)
                body = wire.encode_records(
                    np.ones(cols.size, dtype=np.int64), cols)
                with state_lock:
                    sent_cols.update(int(c) for c in cols)
                req = urllib.request.Request(
                    f"http://localhost:{p0}/index/ch/field/f/ingest",
                    method="POST", data=body)
                while not stop.is_set():
                    try:
                        with urllib.request.urlopen(req,
                                                    timeout=30) as resp:
                            resp.read()
                        with state_lock:
                            acked_cols.update(int(c) for c in cols)
                        break
                    except Exception:
                        time.sleep(0.05)   # refused/cut: retry verbatim
                batch_no += 1
                time.sleep(0.005)

        def reader():
            while not stop.is_set():
                with state_lock:
                    floor = len(acked_cols)
                t0 = time.perf_counter()
                try:
                    [n] = query(p0, "ch", "Count(Row(f=1))")
                except Exception:
                    continue  # churn may refuse/cut queries; only
                    #           ANSWERS are held to correctness
                lats.append(time.perf_counter() - t0)
                with state_lock:
                    ceil = len(sent_cols)
                if n < floor:
                    wrong.append(f"count {n} < acked floor {floor}")
                if n > ceil:
                    wrong.append(f"count {n} > sent ceiling {ceil}")
                time.sleep(0.01)

        wt = threading.Thread(target=writer, daemon=True)
        rt = threading.Thread(target=reader, daemon=True)
        wt.start()
        rt.start()

        for cycle in range(20):
            ev = cycle % 4
            nid = f"node{1 + (cycle % 2)}"
            if ev == 0:       # hard partition + heal
                proxies[nid].configure("connect=partition")
                proxies[nid].sever()
                time.sleep(0.4)
                proxies[nid].heal()
            elif ev == 1:     # straggler
                proxies[nid].configure("down=latency:0.3")
                time.sleep(0.4)
                proxies[nid].heal()
            elif ev == 2:     # mid-response resets
                proxies[nid].configure("down=rst#2")
                time.sleep(0.3)
                proxies[nid].heal()
            else:             # kill -> restart (same port, same data)
                i = 1 + (cycle % 2)
                servers[i].close()
                time.sleep(0.2)
                servers[i] = Server(cfgs[i])
                servers[i].open()
            servers[0].cluster.probe_peers()
        stop.set()
        wt.join(timeout=60)
        rt.join(timeout=60)
        assert not (wt.is_alive() or rt.is_alive()), "hung load thread"
        assert not wrong, wrong[:5]

        # quiesce: heal everything, restore READY, let anti-entropy
        # converge any divergence churn left behind
        for proxy in proxies.values():
            proxy.heal()
        deadline = time.monotonic() + 20
        cl = servers[0].cluster
        while time.monotonic() < deadline:
            cl.probe_peers()
            if all(n.state == "READY" for n in cl.nodes):
                break
            time.sleep(0.2)
        for s in servers:
            s.cluster.sync_holder()

        # zero acked-write loss: every acked column is present
        with state_lock:
            want_cols = set(acked_cols)
        row = query(p0, "ch", "Row(f=1)")[0]
        got_cols = set(row["columns"])
        missing = want_cols - got_cols
        assert not missing, f"acked writes lost: {sorted(missing)[:10]}"

        # bounded p99 across the whole churn
        assert lats, "reader never completed a query"
        lats.sort()
        p99 = lats[max(int(len(lats) * 0.99) - 1, 0)]
        assert p99 < 30.0, f"p99 {p99:.2f}s under churn"
        # every node answers identically after convergence
        counts = {s.config.node_id:
                  query(s.port, "ch", "Count(Row(f=1))")[0]
                  for s in servers}
        assert len(set(counts.values())) == 1, counts
    finally:
        stop.set()
        for s in servers:
            try:
                s.close()
            except Exception:
                pass
        for proxy in proxies.values():
            proxy.close()
