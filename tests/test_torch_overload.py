"""Overload armor of the PyTorch port (deadlines, admission control,
per-peer circuit breakers, graceful drain and the failpoint registry):
the counterpart of tests/test_overload.py, with ``device="cpu"`` on
every server.  Each case asserts the HTTP codes and body fields that
the reference suite asserts of the JAX server.

The two whole-query deadline cases hold the port's default read path
(one whole-query program per request, parallel/wholequery.py) to the
``mesh.slice`` failpoint: a delay armed on it must expire a
``?timeout=`` budget (504) and must not be answered by a fallback.
Queued expiry in the dispatch batcher is covered by
tests/test_torch_batcher.py.  The multi-server chaos cases are marked
slow, as in the reference.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.admission import (  # noqa: E402
    AdmissionController, AdmissionRejected)
from pilosa_tpu_torch.utils.deadline import (  # noqa: E402
    DeadlineExceeded, QueryContext, activate, check_current)
from pilosa_tpu_torch.utils.faults import FAULTS, FaultInjected  # noqa: E402

from test_torch_cluster import _free_ports, restore_knobs  # noqa: E402, F401
from test_torch_cluster_obs import make_server  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    """The registry is process-global: never leak an armed failpoint
    into the next test."""
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _req(port, method, path, data=None, timeout=30):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) else \
            json.dumps(data).encode()
    r = urllib.request.Request(
        f"http://localhost:{port}{path}", method=method, data=body)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read())


def _status_of(port, path, data=None):
    """(status_code, body_dict) — errors don't raise."""
    try:
        return 200, _req(port, "POST", path, data)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except Exception:
            body = {}
        return e.code, body


def make_cluster(tmp_path, n=2, replica_n=2, **cfg):
    ports = _free_ports(n)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, p in enumerate(ports):
        servers.append(make_server(
            tmp_path, name=f"node{i}", bind=f"localhost:{p}",
            node_id=f"node{i}", cluster_hosts=hosts,
            replica_n=replica_n, **cfg))
    return servers


def _setup(port, index="ov", n_shards=4):
    _req(port, "POST", f"/index/{index}", {})
    _req(port, "POST", f"/index/{index}/field/f", {})
    # explicit generous timeout: setup must not flake under a server
    # configured with a tiny default query-timeout (cold JIT on the
    # first write can exceed it)
    _req(port, "POST", f"/index/{index}/query?timeout=120", " ".join(
        f"Set({s * SHARD_WIDTH + 3}, f=1)" for s in range(n_shards)))
    return index


# -- unit: failpoint registry ----------------------------------------------

def test_faults_registry_spec_and_times():
    # lint: allow(failpoint-names) — registry unit test arms synthetic
    # names on purpose; no trigger site should exist for them
    FAULTS.configure("a.b=error@key1#2; c.d=delay:0.01")
    # match filter: a miss doesn't trigger or consume
    FAULTS.hit("a.b", key="other")
    with pytest.raises(FaultInjected):
        FAULTS.hit("a.b", key="key1-and-more")
    with pytest.raises(FaultInjected):
        FAULTS.hit("a.b", key="key1")
    FAULTS.hit("a.b", key="key1")  # #2 exhausted -> disarmed
    t0 = time.perf_counter()
    FAULTS.hit("c.d")
    assert time.perf_counter() - t0 >= 0.01
    assert "c.d" in FAULTS.snapshot()
    # FaultInjected is an OSError so transport handling sees a real fault
    assert issubclass(FaultInjected, OSError)


def test_faults_bad_spec_rejected():
    with pytest.raises(ValueError):
        # lint: allow(failpoint-names) — malformed-spec rejection test
        FAULTS.configure("oops")
    with pytest.raises(ValueError):
        # lint: allow(failpoint-names) — unknown-mode rejection test
        FAULTS.arm("x", mode="explode")


# -- unit: deadline context -------------------------------------------------

def test_query_context_expiry_and_contextvar():
    ctx = QueryContext(0.02)
    ctx.check("early")  # not expired yet
    time.sleep(0.03)
    assert ctx.expired()
    with pytest.raises(DeadlineExceeded) as ei:
        ctx.check("late")
    assert "late" in str(ei.value)
    check_current("no ctx active")  # no-op outside activate
    with activate(QueryContext(None)):
        check_current("unlimited")  # unlimited budget never expires
    c2 = QueryContext(10)
    c2.cancel()
    with pytest.raises(DeadlineExceeded):
        c2.check()


# -- unit: admission controller --------------------------------------------

def test_admission_slots_queue_and_drain():
    adm = AdmissionController(max_slots=1, queue_timeout=0.05)
    adm.acquire()
    # slot busy + empty queue: second caller waits queue_timeout then 503
    t0 = time.perf_counter()
    with pytest.raises(AdmissionRejected) as ei:
        adm.acquire()
    assert time.perf_counter() - t0 >= 0.04
    assert ei.value.retry_after >= 1
    # queue overflow rejects IMMEDIATELY (no wait)
    blockers = [threading.Thread(
        target=lambda: _try_acquire(adm)) for _ in range(2)]
    for t in blockers:
        t.start()
    time.sleep(0.01)  # both waiting -> queue (max 2*1) full
    t0 = time.perf_counter()
    with pytest.raises(AdmissionRejected):
        adm.acquire()
    assert time.perf_counter() - t0 < 0.04
    for t in blockers:
        t.join()
    # drain: release the slot; wait_drained returns True; new acquires 503
    adm.begin_drain()
    adm.release()
    assert adm.wait_drained(1.0)
    with pytest.raises(AdmissionRejected):
        adm.acquire()
    snap = adm.snapshot()
    assert snap["draining"] and snap["inUse"] == 0
    assert snap["rejectedQueueFull"] >= 1 and snap["rejectedBusy"] >= 1


def _try_acquire(adm):
    try:
        adm.acquire()
        adm.release()
    except AdmissionRejected:
        pass


# -- deadline through the real server --------------------------------------

def test_deadline_expired_query_returns_504(tmp_path):
    srv = make_server(tmp_path)
    try:
        index = _setup(srv.port)
        # delay the shard-slice loop past the budget: the query must
        # abort between slices, not run to completion
        FAULTS.arm("mesh.slice", mode="delay", arg=0.2, match=index)
        t0 = time.perf_counter()
        code, body = _status_of(
            srv.port, f"/index/{index}/query?timeout=0.05",
            "Count(Row(f=1))")
        elapsed = time.perf_counter() - t0
        assert code == 504
        assert body["budgetS"] == 0.05
        assert body["elapsedS"] >= 0.05
        assert "deadline" in body["error"]
        assert elapsed < 2.0  # aborted, not run to completion
        FAULTS.disarm()
        # counters visible at /debug/vars; un-budgeted queries unaffected
        snap = _req(srv.port, "GET", "/debug/vars")
        assert snap["counts"]["query.deadline_abort"] >= 1
        assert snap["admission"]["public"]["admitted"] >= 1
        # the whole-query program expired at its gate: no fallback ran
        assert snap["wholeQuery"]["fallbacks"] == 0
        [cnt] = _req(srv.port, "POST", f"/index/{index}/query",
                     "Count(Row(f=1))")["results"]
        assert cnt == 4
    finally:
        srv.close()


def test_default_query_timeout_config(tmp_path):
    """query-timeout applies to public queries with no explicit
    ?timeout=, and an explicit one overrides it."""
    srv = make_server(tmp_path, query_timeout=0.05)
    try:
        index = _setup(srv.port)
        FAULTS.arm("mesh.slice", mode="delay", arg=0.2, match=index)
        code, _ = _status_of(srv.port, f"/index/{index}/query",
                             "Count(Row(f=1))")
        assert code == 504
        code, body = _status_of(srv.port,
                                f"/index/{index}/query?timeout=5",
                                "Count(Row(f=1))")
        assert code == 200 and body["results"] == [4]
        snap = _req(srv.port, "GET", "/debug/vars")
        assert snap["wholeQuery"]["fallbacks"] == 0
    finally:
        srv.close()


# -- admission through the real server -------------------------------------

def test_admission_overflow_returns_503_under_burst(tmp_path):
    srv = make_server(tmp_path, max_queries=1, queue_timeout=0.05)
    try:
        index = _setup(srv.port)
        FAULTS.arm("mesh.slice", mode="delay", arg=0.4, match=index)
        results = []

        def one():
            results.append(_status_of(
                srv.port, f"/index/{index}/query", "Count(Row(f=1))")[0])

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), "hung handler thread"
        assert set(results) <= {200, 503}
        assert results.count(200) >= 1
        assert results.count(503) >= 1
        snap = _req(srv.port, "GET", "/debug/vars")
        pub = snap["admission"]["public"]
        assert pub["maxSlots"] == 1
        assert pub["rejectedBusy"] + pub["rejectedQueueFull"] >= 1
        assert snap["counts"]["admission.public.rejected"] >= 1
        # the Retry-After header rides the 503
        req = urllib.request.Request(
            f"http://localhost:{srv.port}/index/{index}/query",
            method="POST", data=b"Count(Row(f=1))")
        FAULTS.disarm()
        FAULTS.arm("mesh.slice", mode="delay", arg=0.4, match=index)
        slow = threading.Thread(target=one)
        slow.start()
        time.sleep(0.05)
        try:
            urllib.request.urlopen(req, timeout=10)
        except urllib.error.HTTPError as e:
            assert e.code == 503
            # computed + jittered backoff: fractional seconds, floored
            # at 1 (cli ingest parses floats)
            assert float(e.headers["Retry-After"]) >= 1
        slow.join(timeout=30)
    finally:
        srv.close()


# -- graceful drain ---------------------------------------------------------

def test_drain_completes_inflight_then_rejects(tmp_path):
    srv = make_server(tmp_path, max_queries=4, drain_seconds=5)
    try:
        index = _setup(srv.port)
        FAULTS.arm("mesh.slice", mode="delay", arg=0.3, match=index)
        inflight = []

        def one():
            inflight.append(_status_of(
                srv.port, f"/index/{index}/query", "Count(Row(f=1))")[0])

        t = threading.Thread(target=one)
        t.start()
        time.sleep(0.1)  # the query is inside its slice delay
        assert srv.drain() is True  # waited for the in-flight query
        t.join(timeout=10)
        assert inflight == [200]  # finished, not reset
        # post-drain: the socket is still up, new queries get 503
        code, body = _status_of(srv.port, f"/index/{index}/query",
                                "Count(Row(f=1))")
        assert code == 503 and "drain" in body["error"]
    finally:
        srv.close()


# -- circuit breaker + replica retry ----------------------------------------
# The multi-server chaos tests are slow-marked with the soak: each spins a
# fresh in-process cluster (seconds of XLA/server setup), and tier-1's
# wall-clock budget is tight.  The single-server deadline/admission/drain
# tests above stay tier-1.

@pytest.mark.slow
def test_breaker_opens_fails_fast_and_recovers(tmp_path):
    servers = make_cluster(tmp_path, n=2, replica_n=2,
                           breaker_threshold=2)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/cb", {})
        _req(p0, "POST", "/index/cb/field/f", {})
        _req(p0, "POST", "/index/cb/query", " ".join(
            f"Set({s * SHARD_WIDTH + 1}, f=1)" for s in range(6)))
        [want] = _req(p0, "POST", "/index/cb/query",
                      "Count(Row(f=1))")["results"]
        assert want == 6

        cl = servers[0].cluster
        peer_host = cl.by_id["node1"].host
        # every request to node1 transport-fails; threshold=2 opens
        FAULTS.arm("client.request", mode="error", match=peer_host)
        for _ in range(2):
            with pytest.raises(OSError):
                cl.client.status(peer_host, timeout=2)
        snap = cl.client.breaker_snapshot()
        assert snap[peer_host]["state"] == "open"
        FAULTS.disarm()  # node1 is healthy again, but the breaker is
        #                  still open (cooldown) -> the read router skips
        #                  it BEFORE dispatch (routing.breaker_skip) and
        #                  the replica answers instead of waiting out a
        #                  timeout
        t0 = time.perf_counter()
        [got] = _req(p0, "POST", "/index/cb/query",
                     "Count(Row(f=1))")["results"]
        assert time.perf_counter() - t0 < 5.0
        assert got == want
        assert cl.by_id["node1"].state == "DOWN"  # breaker agrees
        # breaker + routing state surface at /debug/vars
        dv = _req(p0, "GET", "/debug/vars")
        assert dv["breakers"][peer_host]["openedTotal"] >= 1
        assert dv["counts"].get("routing.breaker_skip", 0) >= 1
        assert dv["cluster"]["routing"]["breakerSkips"] >= 1
        # recovery: the health probe is ALWAYS admitted as the half-open
        # trial (no cooldown wait); success closes the breaker + READY
        cl.probe_peers()
        assert cl.client.breaker_snapshot()[peer_host]["state"] == "closed"
        assert cl.by_id["node1"].state == "READY"
        assert cl.state == "NORMAL"
    finally:
        for s in servers:
            s.close()


@pytest.mark.slow
def test_probe_soft_failures_need_threshold(tmp_path):
    """One transient probe miss must NOT flip the cluster DEGRADED;
    health-down-threshold consecutive misses must; recovery resets the
    streak.  Connection-refused (dead process) still flips at once."""
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        cl = servers[0].cluster
        real_status = cl.client.status
        cl.client.status = lambda host, timeout=None: (
            (_ for _ in ()).throw(socket.timeout("probe timed out")))
        cl.probe_peers()
        assert cl.by_id["node1"].state == "READY"  # one soft miss
        assert cl.state == "NORMAL"
        cl.probe_peers()
        assert cl.by_id["node1"].state == "DOWN"   # second miss
        assert cl.state == "DEGRADED"
        cl.client.status = real_status
        cl.probe_peers()
        assert cl.by_id["node1"].state == "READY"
        assert cl.by_id["node1"].probe_fails == 0
        assert cl.state == "NORMAL"
        # refused = definite: one probe flips (the killed-node case)
        servers[1].close()
        cl.probe_peers()
        assert cl.by_id["node1"].state == "DOWN"
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# -- deadline across the fan-out wire ---------------------------------------

@pytest.mark.slow
def test_deadline_mid_fanout_remote_inherits_budget(tmp_path):
    """A coordinator whose remote is failpoint-delayed must 504 within
    ~2x the budget (socket timeout clamped to the remaining budget), and
    the REMOTE must abort via the inherited header budget rather than
    running its delayed slice loop to completion."""
    servers = make_cluster(tmp_path, n=2, replica_n=1)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/fx", {})
        _req(p0, "POST", "/index/fx/field/f", {})
        cl = servers[0].cluster
        # a shard owned by node1 only (replica_n=1): the fan-out has no
        # local work and no replica to fall back to
        shard = next(s for s in range(64)
                     if cl.placement.shard_nodes("fx", s) == ["node1"])
        _req(p0, "POST", "/index/fx/query",
             f"Set({shard * SHARD_WIDTH + 7}, f=1)")
        FAULTS.arm("mesh.slice", mode="delay", arg=0.5, match="fx")
        t0 = time.perf_counter()
        code, body = _status_of(
            p0, f"/index/fx/query?timeout=0.05&shards={shard}",
            "Count(Row(f=1))")
        elapsed = time.perf_counter() - t0
        assert code == 504
        assert body["budgetS"] == 0.05
        # never waits out the remote's 0.5s slice delay, let alone the
        # 30s default socket timeout
        assert elapsed < 0.45, f"coordinator waited {elapsed:.3f}s"
        # the remote aborted by ITS deadline (inherited via the header):
        # its own 504 counter ticks once its delayed slice check runs
        deadline = time.monotonic() + 5
        aborted = 0
        while time.monotonic() < deadline:
            snap = _req(servers[1].port, "GET", "/debug/vars")
            aborted = snap["counts"].get("query.deadline_abort", 0)
            if aborted:
                break
            time.sleep(0.05)
        assert aborted >= 1, "remote never saw the shrunken budget"
    finally:
        for s in servers:
            s.close()


# -- durability and tracing ------------------------------------------------

def test_snapshot_fsyncs_file_and_directory(tmp_path, monkeypatch):
    import pilosa_tpu_torch.utils.durable as durable
    synced = []
    real_fsync = durable.os.fsync
    monkeypatch.setattr(durable.os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd))[1])
    from pilosa_tpu_torch.storage.fragment import Fragment
    frag = Fragment(str(tmp_path / "frag" / "0"), "i", "f", "standard", 0)
    frag.set_bit(1, 2)
    synced.clear()
    frag.snapshot()
    assert len(synced) >= 2  # temp file + directory
    frag.close()
    # attrs take the same durable path
    from pilosa_tpu_torch.storage.attrs import AttrStore
    store = AttrStore(str(tmp_path / "attrs.json"))
    synced.clear()
    store.set_attrs(1, {"k": "v"})
    assert len(synced) >= 2


def test_snapshot_failpoint_surfaces_error(tmp_path):
    from pilosa_tpu_torch.storage.fragment import Fragment
    frag = Fragment(str(tmp_path / "fp" / "0"), "i", "f", "standard", 0)
    try:
        FAULTS.arm("fragment.snapshot", mode="error")
        frag.set_bit(0, 1)
        with pytest.raises(OSError):
            frag.snapshot()
        FAULTS.disarm()
        frag.snapshot()  # recovers cleanly
    finally:
        FAULTS.disarm()
        frag.close()


def test_span_duration_immune_to_wall_clock_steps(monkeypatch):
    from pilosa_tpu_torch.utils import tracing
    walls = iter([1000.0, 900.0, 900.0])  # wall clock steps BACKWARD
    monkeypatch.setattr(tracing.time, "time",
                        lambda: next(walls, 900.0))
    tracer = tracing.Tracer()
    with tracer.span("step") as s:
        time.sleep(0.01)
    d = s.to_dict()
    assert d["durationMS"] >= 10.0  # perf_counter pair, not wall delta


# -- soak: burst > slots against a 2-node cluster (CI, slow-marked) ---------

@pytest.mark.slow
def test_overload_soak_no_deadlock_bounded_p99(tmp_path):
    """Burst of 4x max-queries concurrent public queries against a
    2-node cluster: only 200s and 503s, every thread returns (no
    admission deadlock between public and internal planes), and the
    successful tail stays bounded."""
    servers = make_cluster(tmp_path, n=2, replica_n=2, max_queries=4,
                           queue_timeout=0.2)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/soak", {})
        _req(p0, "POST", "/index/soak/field/f", {})
        _req(p0, "POST", "/index/soak/query", " ".join(
            f"Set({s * SHARD_WIDTH + 2}, f=1)" for s in range(8)))
        FAULTS.arm("mesh.slice", mode="delay", arg=0.05, match="soak")
        codes, lats = [], []
        lock = threading.Lock()

        def one():
            for _ in range(3):
                t0 = time.perf_counter()
                code, _ = _status_of(p0, "/index/soak/query",
                                     "Count(Row(f=1))")
                dt = time.perf_counter() - t0
                with lock:
                    codes.append(code)
                    if code == 200:
                        lats.append(dt)

        threads = [threading.Thread(target=one) for _ in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "deadlocked thread"
        assert set(codes) <= {200, 503}, f"unexpected statuses {set(codes)}"
        assert codes.count(200) >= 1
        lats.sort()
        p99 = lats[int(len(lats) * 0.99) - 1] if len(lats) > 1 else lats[0]
        # bounded tail: slots cap concurrency, the queue is short, and
        # rejections are instant — nothing can queue for the whole burst
        assert p99 < 30.0, f"p99 {p99:.2f}s"
        assert time.perf_counter() - t0 < 120
    finally:
        for s in servers:
            s.close()
