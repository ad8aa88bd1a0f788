"""The tenant isolation plane of the PyTorch port: the counterpart of
tests/test_tenant.py, with ``device="cpu"`` on every executor and
server.  Each case asserts the HTTP codes, body fields and counters
that the reference suite asserts of the JAX package.

Covers: the tenant-token grammar fuzz contract (garbage, oversize or
empty -> TenantError, never anything else, and a clean 400 at the HTTP
edge); the contextvar identity spine (derived vs explicit, header
forwarding on internal hops); the per-tenant registry accounting and
LRU churn armor; deficit-round-robin slot grants converging to the
weight ratio; tenant-first shedding; the ``fair=False`` legacy
single-FIFO differential; computed and decorrelated-jitter Retry-After
ranges; per-tenant byte quotas in the result cache and the device
residency budget; per-tenant hedge budgets; the degraded-result cache
guard; and a hostile-flood chaos test over real ChaosProxy sockets.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.cache.results import ResultCache  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.server.admission import (  # noqa: E402
    AdmissionController, AdmissionRejected, decorrelated_retry_after)
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DeviceBudget  # noqa: E402
from pilosa_tpu_torch.utils import degraded  # noqa: E402
from pilosa_tpu_torch.utils import tenant as qtenant  # noqa: E402
from pilosa_tpu_torch.utils.netchaos import ChaosProxy  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, _req, query, restore_knobs)
from test_torch_cluster_obs import Config  # noqa: E402


N_SHARDS = 8


# -- token grammar + weights spec (fuzz contract) ---------------------------

@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_validate_token_accepts_metrics_safe_names():
    for tok in ("a", "acme", "tenant-7", "a.b_c-d", "X9", "a" * 64):
        assert qtenant.validate_token(tok) == tok


def test_validate_token_rejects_garbage_cleanly():
    bad = ["", "a" * 65, "-lead", ".lead", "_lead", "has space",
           "semi;colon", "tab\tchar", "new\nline", "nul\x00", "é",
           "a/b", "a:b", "{inject}", " ", None, 7, b"bytes"]
    for tok in bad:
        with pytest.raises(qtenant.TenantError):
            qtenant.validate_token(tok)


def test_validate_token_fuzz_never_raises_other_exceptions():
    rng = np.random.default_rng(171)
    for _ in range(500):
        n = int(rng.integers(0, 200))
        raw = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        tok = raw.decode("latin-1")
        try:
            out = qtenant.validate_token(tok)
            assert out == tok  # accepted means unchanged
        except qtenant.TenantError:
            pass  # the ONLY permitted failure


def test_derive_prefers_explicit_header_over_index():
    assert qtenant.derive("acme", "myindex") == ("acme", True)
    assert qtenant.derive(None, "myindex") == ("myindex", False)
    assert qtenant.derive(None, None) == (qtenant.DEFAULT_TENANT, False)
    with pytest.raises(qtenant.TenantError):
        qtenant.derive("bad token", "myindex")


def test_parse_weights_spec():
    assert qtenant.parse_weights("analytics:4,batch:1") == \
        {"analytics": 4.0, "batch": 1.0}
    assert qtenant.parse_weights("") == {}
    assert qtenant.parse_weights(" a:2 , b:0.5 ") == {"a": 2.0, "b": 0.5}
    for bad in ("noweight", "a:xyz", "bad name:2", ":3", "a:"):
        with pytest.raises(qtenant.TenantError):
            qtenant.parse_weights(bad)


# -- contextvar spine -------------------------------------------------------

def test_tenant_context_activate_and_forwarding():
    assert qtenant.current() == qtenant.DEFAULT_TENANT
    assert qtenant.current_or_none() is None
    assert qtenant.header_value() is None
    with qtenant.activate("idx-derived", explicit=False):
        assert qtenant.current() == "idx-derived"
        assert qtenant.current_or_none() == "idx-derived"
        # derived identities never forward: the peer re-derives
        assert qtenant.header_value() is None
        with qtenant.activate("acme", explicit=True):
            assert qtenant.current() == "acme"
            assert qtenant.header_value() == "acme"
        assert qtenant.current() == "idx-derived"
    assert qtenant.current_or_none() is None
    # None is a passthrough (the deadline.activate convention)
    with qtenant.activate(None):
        assert qtenant.current_or_none() is None


def test_registry_accounting_and_churn_cap():
    qtenant.REGISTRY.clear()
    qtenant.REGISTRY.note_request("t1", 0.010, 200)
    qtenant.REGISTRY.note_request("t1", 0.030, 500)
    qtenant.REGISTRY.note_shed("t1", "public")
    qtenant.REGISTRY.note_hedge_denied("t1")
    snap = qtenant.REGISTRY.snapshot()["t1"]
    assert snap["requests"] == 2 and snap["errors"] == 1
    assert snap["shed"] == 1 and snap["shedByPool"] == {"public": 1}
    assert snap["hedgeDenied"] == 1
    assert snap["p50Ms"] >= 10.0 and snap["p99Ms"] >= 29.0
    # hostile identifier churn cannot grow the table without bound
    for i in range(qtenant.MAX_TENANTS + 40):
        qtenant.REGISTRY.note_request(f"churn{i}", 0.001, 200)
    assert len(qtenant.REGISTRY.snapshot()) <= qtenant.MAX_TENANTS
    assert qtenant.REGISTRY.evicted >= 40
    qtenant.REGISTRY.clear()


def test_hedge_budget_token_bucket():
    hb = qtenant.HedgeBudget(rate=2.0)
    assert hb.try_take("t") and hb.try_take("t")
    assert not hb.try_take("t")           # bucket drained
    assert hb.denied == 1
    assert hb.try_take("other")           # per-tenant buckets
    assert hb.snapshot()["denied"] == 1
    # rate 0 disables the budget entirely
    free = qtenant.HedgeBudget(rate=0.0)
    assert all(free.try_take("t") for _ in range(50))
    assert free.denied == 0


# -- computed Retry-After ---------------------------------------------------

def test_decorrelated_retry_after_range_floor_cap():
    for _ in range(300):
        v = decorrelated_retry_after(2.0)
        assert 2.0 <= v <= 6.0
    # base below the floor clamps to [1, 3]
    assert all(1.0 <= decorrelated_retry_after(0.01) <= 3.0
               for _ in range(100))
    # base past the cap pins to the cap exactly
    assert decorrelated_retry_after(100.0) == 30.0
    # jitter actually spreads (not a constant)
    vals = {decorrelated_retry_after(2.0) for _ in range(100)}
    assert len(vals) > 5


# -- weighted-fair admission (DRR) ------------------------------------------

def test_drr_grant_order_follows_weights():
    """max_slots=1 with a held seed slot; 4 'a' then 2 'b' waiters with
    weights a:2,b:1 and burst=1 drain in EXACTLY the 2:1 pattern."""
    adm = AdmissionController(max_slots=1, queue_timeout=30.0,
                              max_queue=16, name="t-drr",
                              weights={"a": 2.0, "b": 1.0}, burst=1.0)
    assert adm.acquire(tenant="seed") == 0.0
    order, threads = [], []
    olock = threading.Lock()

    def worker(t):
        adm.acquire(tenant=t)
        with olock:
            order.append(t)
        adm.release()

    for t in ["a"] * 4 + ["b"] * 2:
        th = threading.Thread(target=worker, args=(t,), daemon=True)
        th.start()
        threads.append(th)
        deadline = time.monotonic() + 5
        while adm.waiting < len(threads) and time.monotonic() < deadline:
            time.sleep(0.002)
    assert adm.waiting == 6
    adm.release()           # seed frees the only slot: cascade drains
    for th in threads:
        th.join(timeout=10)
    assert order == ["a", "a", "b", "a", "a", "b"]
    snap = adm.snapshot()
    assert snap["inUse"] == 0 and snap["waiting"] == 0
    assert snap["tenants"]["a"]["admitted"] == 4
    assert snap["tenants"]["b"]["admitted"] == 2


def test_tenant_first_shedding_attributes_to_over_share_tenant():
    """Queue full of one tenant's flood: the polite arrival is seated by
    evicting the flooder's NEWEST waiter, the shed is attributed to the
    flooder, and its Retry-After is computed + capped."""
    qtenant.REGISTRY.clear()
    adm = AdmissionController(max_slots=1, queue_timeout=60.0,
                              max_queue=3, name="t-shed")
    adm.acquire(tenant="seed")
    rejected, done, threads = [], [], []

    def worker(t):
        try:
            adm.acquire(tenant=t)
            done.append(t)
            adm.release()
        except AdmissionRejected as e:
            rejected.append((t, e.retry_after))

    for _ in range(3):
        th = threading.Thread(target=worker, args=("hostile",),
                              daemon=True)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + 5
    while adm.waiting < 3 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert adm.waiting == 3                     # queue exactly full
    th = threading.Thread(target=worker, args=("polite",), daemon=True)
    th.start()
    threads.append(th)
    deadline = time.monotonic() + 5
    while not rejected and time.monotonic() < deadline:
        time.sleep(0.002)
    # exactly one shed, the flooder's, with the capped computed backoff
    assert rejected == [("hostile", 30.0)]
    adm.release()                               # cascade the rest
    for th in threads:
        th.join(timeout=10)
    assert sorted(done) == ["hostile", "hostile", "polite"]
    snap = adm.snapshot()
    assert snap["shedOverQuota"] == 1
    assert snap["tenants"]["hostile"]["shed"] == 1
    assert snap["tenants"]["polite"]["shed"] == 0
    reg = qtenant.REGISTRY.snapshot()
    assert reg["hostile"]["shed"] == 1
    assert reg["hostile"]["shedByPool"] == {"t-shed": 1}
    assert "polite" not in reg or reg["polite"]["shed"] == 0
    qtenant.REGISTRY.clear()


def test_fair_false_restores_legacy_fifo_shedding():
    """fair=False: one shared FIFO, queue overflow rejects the ARRIVAL
    (the pre-isolation behavior), and timeouts count rejected_busy."""
    adm = AdmissionController(max_slots=1, queue_timeout=0.15,
                              max_queue=1, name="t-legacy", fair=False)
    adm.acquire(tenant="seed")
    errs = []

    def waiter():
        try:
            adm.acquire(tenant="w1")
            adm.release()
        except AdmissionRejected as e:
            errs.append(("w1", e))

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    deadline = time.monotonic() + 5
    while adm.waiting < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    with pytest.raises(AdmissionRejected):      # arrival rejected
        adm.acquire(tenant="w2")
    assert adm.rejected_queue_full == 1
    th.join(timeout=10)                          # w1 times out
    assert [t for t, _ in errs] == ["w1"]
    assert adm.rejected_busy == 1
    assert adm.shed_over_quota == 0              # no fair-mode eviction
    assert adm.snapshot()["fair"] is False
    adm.release()


# -- per-tenant byte quotas (result cache + HBM residency) ------------------

def _fill(cache, i, tenant):
    # one plain-object result costs a fixed 128 estimated bytes
    cache.fill(("q", tenant, i), ("k", tenant, i), [object()],
               tenant=tenant)


def test_result_cache_tenant_quota_evicts_own_lru_first():
    qtenant.REGISTRY.clear()
    c = ResultCache(limit_bytes=1 << 20, tenant_quota_bytes=300)
    _fill(c, 0, "polite")
    for i in range(3):                 # 3 x 128 = 384 > 300 quota
        _fill(c, i, "hostile")
    snap = c.snapshot()
    assert snap["quotaEvicts"] == 1    # hostile's own OLDEST evicted
    assert snap["tenantBytes"]["hostile"] <= 300
    assert snap["tenantBytes"]["polite"] == 128   # neighbor untouched
    assert c.lookup(("k", "hostile", 0)) is None  # the LRU victim
    assert c.lookup(("k", "hostile", 2)) is not None
    assert c.lookup(("k", "polite", 0)) is not None
    reg = qtenant.REGISTRY.snapshot()
    assert reg["hostile"]["quotaEvicts"] == 1
    assert reg["hostile"]["quotaEvictBytes"] == 128
    qtenant.REGISTRY.clear()


def test_result_cache_quota_never_evicts_the_entry_being_filled():
    """A quota smaller than one answer still caches that answer — it
    rides transiently over; the NEXT fill pays instead."""
    c = ResultCache(limit_bytes=1 << 20, tenant_quota_bytes=100)
    _fill(c, 0, "t")
    assert c.snapshot()["entries"] == 1          # kept despite > quota
    _fill(c, 1, "t")
    snap = c.snapshot()
    assert snap["entries"] == 1                  # old one paid
    assert c.lookup(("k", "t", 1)) is not None


def test_result_cache_global_pressure_prefers_over_quota_tenant():
    """Global byte pressure lands on an over-quota tenant's entries
    before anyone else's, even when the filler is a polite tenant."""
    c = ResultCache(limit_bytes=550, tenant_quota_bytes=300)
    # one 320-byte entry: over quota, kept (lone-entry transient ride)
    c.fill(("q", "h"), ("k", "h"), [object()] * 4, tenant="hostile")
    _fill(c, 0, "polite")              # 448 resident
    c.lookup(("k", "h"))               # hostile is now MRU, polite LRU
    _fill(c, 1, "polite")              # 576 > 550: global eviction
    snap = c.snapshot()
    assert "hostile" not in snap["tenantBytes"]  # its entry paid
    assert snap["tenantBytes"]["polite"] == 256  # well under ITS quota
    assert c.lookup(("k", "h")) is None
    assert c.lookup(("k", "polite", 0)) is not None
    assert c.lookup(("k", "polite", 1)) is not None


def test_device_budget_tenant_quota_evicts_own_entries():
    qtenant.REGISTRY.clear()
    evicted = []
    b = DeviceBudget(limit_bytes=1000, tenant_quota_bytes=300)
    b.register(("p", 0), 150, lambda: evicted.append(("p", 0)),
               tenant="polite")
    for i in range(4):                 # 4 x 150 = 600 > 300 quota
        b.register(("h", i), 150,
                   (lambda k: lambda: evicted.append(("h", k)))(i),
                   tenant="hostile")
    st = b.stats()
    assert st["quotaEvictions"] == 2   # hostile's own oldest two
    assert st["tenantBytes"]["hostile"] == 300
    assert st["tenantBytes"]["polite"] == 150
    assert evicted == [("h", 0), ("h", 1)]
    assert qtenant.REGISTRY.snapshot()["hostile"]["quotaEvicts"] >= 1
    qtenant.REGISTRY.clear()


def test_device_budget_global_pressure_prefers_over_quota_tenant():
    evicted = []
    b = DeviceBudget(limit_bytes=550, tenant_quota_bytes=300)
    b.register(("h", 0), 320, lambda: evicted.append("h0"),
               tenant="hostile")      # over quota, kept (lone entry)
    b.register(("p", 0), 128, lambda: evicted.append("p0"),
               tenant="polite")
    b.touch(("h", 0))                 # hostile is now MRU, polite LRU
    # 128 more forces global pressure: the over-quota hostile entry
    # pays even though polite's is the colder LRU position otherwise
    b.register(("p", 1), 128, lambda: evicted.append("p1"),
               tenant="polite")
    assert evicted == ["h0"]
    assert b.stats()["tenantBytes"]["polite"] == 256


# -- degraded-result cache guard (regression pin) ---------------------------

def _one_shard_holder():
    h = Holder(None)
    idx = h.create_index("i", track_existence=False)
    idx.create_field("f")
    f = idx.field("f")
    f.import_bits(np.array([1, 1, 1]), np.array([0, 5, 9]))
    return h


def test_quarantined_degraded_answer_never_memoized():
    """A regression pin: is_partial() alone would memoize a
    quarantined-degraded answer (empty rows standing in for poisoned
    fragments) and keep serving it after the fragments heal — the fill
    guard must check is_degraded(), i.e. quarantine counts too."""
    ex = Executor(_one_shard_holder(), device="cpu")
    try:
        ex.result_cache.limit_bytes = 8 << 20
        with degraded.collect():
            degraded.note(1)           # a quarantined fragment touched
            assert degraded.is_degraded() and not degraded.is_partial()
            ex.execute("i", "Count(Row(f=1))")
        assert ex.result_cache.snapshot()["entries"] == 0
        # same query healthy: cached, then served from cache
        ex.execute("i", "Count(Row(f=1))")
        assert ex.result_cache.snapshot()["entries"] == 1
        ex.execute("i", "Count(Row(f=1))")
        assert ex.result_cache.hits == 1
    finally:
        ex.close()


def test_partial_answer_never_memoized_at_executor():
    ex = Executor(_one_shard_holder(), device="cpu")
    try:
        ex.result_cache.limit_bytes = 8 << 20
        with degraded.collect(allow_partial=True):
            degraded.note_missing("i", [3], nodes=["node9"])
            assert degraded.is_partial()
            ex.execute("i", "Count(Row(f=1))")
        assert ex.result_cache.snapshot()["entries"] == 0
    finally:
        ex.close()


# -- HTTP edge + cluster plane (real servers, real sockets) -----------------

class _TenantCluster:
    """3 real servers with the isolation plane on; node1/node2 dialed
    through ChaosProxies (the test_churn.py harness) so floods and
    stragglers are real TCP behavior.  Tight slots (max_queries=2) +
    polite:4/hostile:1 weights make admission pressure testable."""

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
                read_routing="primary", hedge_delay_ms=40.0,
                max_queries=2, queue_timeout=0.25,
                tenant_weights="polite:4,hostile:1",
                result_cache_mb=8))
            srv.open()
            self.servers.append(srv)
        self.port = self.servers[0].port
        self.cl = self.servers[0].cluster
        self.index = next(
            name for name in (f"tn{i}" for i in range(64))
            if 0 < len(self._remote_owned(name)) < N_SHARDS)
        _req(self.port, "POST", f"/index/{self.index}", {})
        _req(self.port, "POST", f"/index/{self.index}/field/f", {})
        cols = [s * SHARD_WIDTH + (s % 5) for s in range(N_SHARDS)]
        _req(self.port, "POST", f"/index/{self.index}/field/f/import",
             {"rowIDs": [1] * len(cols), "columnIDs": cols})
        [self.count_all] = query(self.port, self.index,
                                 "Count(Row(f=1))")

    def _remote_owned(self, index):
        return [s for s in range(N_SHARDS)
                if "node0" not in
                self.cl.placement.shard_nodes(index, s)]

    def remote_owned(self):
        return self._remote_owned(self.index)

    def heal(self):
        for proxy in self.proxies.values():
            proxy.heal()
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


@pytest.fixture(scope="module")
def tcluster(tmp_path_factory):
    c = _TenantCluster(tmp_path_factory.mktemp("tenant"))
    yield c
    c.close()


def _counts(port):
    return _req(port, "GET", "/debug/vars")["counts"]


def _tquery(port, index, pql, tenant=None, qs=""):
    r = urllib.request.Request(
        f"http://localhost:{port}/index/{index}/query{qs}",
        method="POST", data=pql.encode())
    if tenant is not None:
        r.add_header(qtenant.TENANT_HEADER, tenant)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_bad_tenant_tokens_are_clean_400(tcluster):
    """The HTTP fuzz contract: malformed tokens are a 400 with an error
    body — never a 500, never a stack trace, never admitted."""
    for tok in ("has space", "a" * 65, "-lead", "bad!char", "a;b", ""):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _tquery(tcluster.port, tcluster.index, "Count(Row(f=1))",
                    tenant=tok)
        assert ei.value.code == 400
        body = json.loads(ei.value.read())
        assert "tenant" in body["error"].lower()
    # and the garbage never became a metrics label / registry row
    assert "a" * 65 not in qtenant.REGISTRY.snapshot()


def test_http_tenant_identity_derived_and_explicit(tcluster):
    """Identity lands in /debug/vars "tenants" and EXPLAIN's admission
    note; an explicit token forwards to peers' INTERNAL pools while a
    derived identity is re-derived from the index name."""
    # distinct PQL per sub-case: a result-cache hit would short-circuit
    # the fan-out whose internal-pool attribution this test asserts
    got = _tquery(tcluster.port, tcluster.index,
                  "Count(Intersect(Row(f=1)))", qs="?explain=true")
    assert got["results"] == [tcluster.count_all]
    [adm_note] = got["explain"]["admission"]
    assert adm_note["tenant"] == tcluster.index   # derived from index
    assert adm_note["pool"] == "public"
    assert adm_note["queuedMs"] >= 0.0
    got = _tquery(tcluster.port, tcluster.index,
                  "Count(Union(Row(f=1)))", tenant="acme",
                  qs="?explain=true")
    assert got["results"] == [tcluster.count_all]
    [adm_note] = got["explain"]["admission"]
    assert adm_note["tenant"] == "acme"
    # registry accounting lands in the handler's post-response finally —
    # poll briefly rather than racing the microseconds after _send
    deadline = time.monotonic() + 5.0
    while True:
        dv = _req(tcluster.port, "GET", "/debug/vars")
        rows = dv["tenants"]
        if tcluster.index in rows and "acme" in rows:
            break
        assert time.monotonic() < deadline, f"tenant rows: {rows}"
        time.sleep(0.02)
    assert dv["tenants"][tcluster.index]["requests"] >= 1
    assert dv["tenants"]["acme"]["requests"] >= 1
    # explicit token reached at least one peer's internal pool; the
    # derived identity was re-derived there from the index in the path
    peer_tenants = {}
    for srv in tcluster.servers[1:]:
        for t, row in srv.admission_internal.snapshot()[
                "tenants"].items():
            peer_tenants[t] = peer_tenants.get(t, 0) + row["admitted"]
    assert peer_tenants.get("acme", 0) >= 1
    assert peer_tenants.get(tcluster.index, 0) >= 1


def test_hedge_budget_exhaustion_degrades_to_unhedged(tcluster):
    """An exhausted hedge budget must deny the speculative duplicate —
    counted and named in EXPLAIN — while the query still answers
    correctly (slow, unhedged), never erroring."""
    cl = tcluster.cl
    shards = tcluster.remote_owned()
    assert shards, "placement gave node0 every shard replica?"
    s = shards[0]
    straggler = cl._ready_owner_order(tcluster.index, s)[0]
    before = _counts(tcluster.port)
    old_budget = cl.hedge_budget
    cl.hedge_budget = qtenant.HedgeBudget(rate=0.001)  # ~empty bucket
    tcluster.proxies[straggler].configure("down=latency:0.4")
    try:
        got = _tquery(tcluster.port, tcluster.index, "Count(Row(f=1))",
                      qs=f"?shards={s}&explain=true")
    finally:
        cl.hedge_budget = old_budget
        tcluster.heal()
    assert got["results"] == [1]                  # correct, unhedged
    assert "degraded" not in got
    denials = [h for h in got["explain"].get("hedges", [])
               if h.get("outcome") == "budget_denied"]
    assert denials and denials[0]["tenant"] == tcluster.index
    after = _counts(tcluster.port)
    assert after.get("cluster.hedge_budget_denied", 0) > \
        before.get("cluster.hedge_budget_denied", 0)
    assert after.get(f"tenant.{tcluster.index}.hedge_denied", 0) > \
        before.get(f"tenant.{tcluster.index}.hedge_denied", 0)
    assert qtenant.REGISTRY.snapshot()[
        tcluster.index]["hedgeDenied"] >= 1


def test_partial_answer_never_cached_complete_failover_is(tcluster):
    """The cluster-level fill guard: a partial answer (both remote
    nodes partitioned, ?partialResults=true) is never memoized — after
    healing, the same query answers COMPLETE, not the cached stub.  A
    complete answer served via mid-query failover (one node down) IS
    cached: the guard must not over-block."""
    rc = tcluster.servers[0].api.executor.result_cache
    pql = "Count(Union(Row(f=1), Row(f=1)))"   # unique to this test
    lost = tcluster.remote_owned()
    served = N_SHARDS - len(lost)
    for nid in ("node1", "node2"):
        tcluster.proxies[nid].configure("connect=partition")
        tcluster.proxies[nid].sever()
    try:
        got = _tquery(tcluster.port, tcluster.index, pql,
                      qs="?partialResults=true")
        assert got["results"] == [served]
        assert got["degraded"]["missingShards"] == \
            {tcluster.index: sorted(lost)}
        # repeat: STILL degraded and partial — not a cached complete lie
        again = _tquery(tcluster.port, tcluster.index, pql,
                        qs="?partialResults=true")
        assert again["results"] == [served] and "degraded" in again
    finally:
        tcluster.heal()
    # healed: the same query must answer complete — the partial answer
    # was never memoized under the (unchanged) generation key
    full = _tquery(tcluster.port, tcluster.index, pql)
    assert full["results"] == [tcluster.count_all]
    assert "degraded" not in full
    # fill-after-failover: ONE node partitioned, answer stays complete
    # via replica failover and THAT answer is cacheable
    hits0 = rc.snapshot()["hits"]
    tcluster.proxies["node1"].configure("connect=partition")
    tcluster.proxies["node1"].sever()
    try:
        got = _tquery(tcluster.port, tcluster.index, pql)
        assert got["results"] == [tcluster.count_all]
        assert "degraded" not in got
        again = _tquery(tcluster.port, tcluster.index, pql)
        assert again["results"] == [tcluster.count_all]
        assert rc.snapshot()["hits"] > hits0   # the repeat was served
    finally:
        tcluster.heal()


def test_hostile_flood_polite_tenant_stays_admitted(tcluster):
    """End to end: 8 hostile threads flood through real
    sockets while a polite tenant runs sequential queries honoring
    Retry-After.  The polite tenant completes every query with
    byte-identical answers; >= 95% of sheds are attributed to the
    hostile tenant; hostile 503s carry computed fractional
    Retry-After."""
    qtenant.REGISTRY.clear()
    for proxy in tcluster.proxies.values():
        proxy.configure("down=latency:0.05")   # stretch fan-out RTT
    stop = threading.Event()
    hostile_unexpected, retry_afters = [], []

    def hostile_flood():
        n = 0
        while not stop.is_set() and n < 400:
            n += 1
            try:
                _tquery(tcluster.port, tcluster.index,
                        "Count(Row(f=1))", tenant="hostile")
            except urllib.error.HTTPError as e:
                e.read()
                if e.code != 503:
                    hostile_unexpected.append(e.code)
                else:
                    ra = e.headers.get("Retry-After")
                    if ra is not None:
                        retry_afters.append(float(ra))
            except OSError:
                pass

    threads = [threading.Thread(target=hostile_flood, daemon=True)
               for _ in range(8)]
    for th in threads:
        th.start()
    time.sleep(0.3)                     # let the flood saturate slots
    polite_ok = 0
    try:
        for _ in range(10):
            for _attempt in range(40):
                try:
                    got = _tquery(tcluster.port, tcluster.index,
                                  "Count(Row(f=1))", tenant="polite")
                    assert got["results"] == [tcluster.count_all]
                    polite_ok += 1
                    break
                except urllib.error.HTTPError as e:
                    e.read()
                    assert e.code == 503
                    ra = float(e.headers.get("Retry-After", "1"))
                    assert ra >= 1.0
                    time.sleep(min(ra, 0.2))   # bounded polite backoff
            else:
                raise AssertionError(
                    "polite tenant starved out by the flood")
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        tcluster.heal()
    assert polite_ok == 10
    assert not hostile_unexpected       # only 503s, never 5xx surprises
    reg = qtenant.REGISTRY.snapshot()
    hostile_shed = reg.get("hostile", {}).get("shed", 0)
    total_shed = sum(row.get("shed", 0) for row in reg.values())
    assert hostile_shed > 0, "the flood never hit admission pressure"
    assert hostile_shed / total_shed >= 0.95, \
        f"shed attribution leaked: {hostile_shed}/{total_shed}"
    # computed backoff: fractional, floored at 1, capped at 30
    assert retry_afters and all(1.0 <= ra <= 30.0
                                for ra in retry_afters)
    assert len({round(ra, 2) for ra in retry_afters}) > 1 \
        or len(retry_afters) < 5       # jitter spreads (unless tiny N)
    # the isolation columns surface at /debug/vars and the rollup
    dv = _req(tcluster.port, "GET", "/debug/vars")
    assert dv["tenants"]["hostile"]["shed"] == hostile_shed
    roll = _req(tcluster.port, "GET", "/debug/cluster?refresh=true")
    assert roll["tenants"]["hostile"]["shed"] >= hostile_shed
    qtenant.REGISTRY.clear()
