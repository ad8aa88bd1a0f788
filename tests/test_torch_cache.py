"""The query cache subsystem of the PyTorch port
(pilosa_tpu_torch/cache): the counterpart of tests/test_cache.py, with
``device="cpu"`` on every API, executor and server.

Covers: FieldOptions cache-option validation, RankCache
build/incremental/bound semantics, the exact TopN candidate-pruning
path, a differential suite asserting the port's cached results
byte-identical both to ``cache-type: none`` and to the JAX package's
executor across a PQL corpus with interleaved set/clear/import/repair/
attr writes, result-cache hit/invalidate/evict behaviour, the
``POST /internal/cache/clear`` route (the same answers cold, warm and
after the clear), and a 2-node test that a remote import invalidates
the coordinator's result-cache entry.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.api import API, ApiError  # noqa: E402
from pilosa_tpu_torch.cache.rank import RankCache, topn_from_rank  # noqa: E402,E501
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.server.handler import serialize_result  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.storage.field import FieldError  # noqa: E402

from test_torch_cluster import restore_knobs  # noqa: E402, F401
from test_torch_cluster_obs import Config  # noqa: E402


# -- FieldOptions validation ------------------------------------------------

def test_field_options_rejects_unknown_cache_type():
    with pytest.raises(FieldError, match="cacheType"):
        FieldOptions(cache_type="bogus")


def test_field_options_rejects_negative_cache_size():
    with pytest.raises(FieldError, match="cacheSize"):
        FieldOptions(cache_size=-1)
    with pytest.raises(FieldError, match="cacheSize"):
        FieldOptions.from_dict({"cacheSize": "fifty"})


def test_create_field_bad_cache_options_is_api_error():
    """The HTTP layer maps ApiError to 400 — a bad cacheType must fail at
    field creation, not be silently persisted into the schema."""
    api = API(Holder(None), use_mesh=False, device="cpu")
    try:
        api.create_index("i")
        with pytest.raises(ApiError, match="cacheType"):
            api.create_field("i", "f", {"cacheType": "rankedd"})
        with pytest.raises(ApiError, match="cacheSize"):
            api.create_field("i", "g", {"cacheSize": -5})
        # valid options still work
        api.create_field("i", "h", {"cacheType": "lru", "cacheSize": 10})
    finally:
        api.executor.close()


# -- RankCache unit behavior -------------------------------------------------

def _frag_with_counts(holder, counts, field="f", index="i"):
    """One-shard field whose row r has ``counts[r]`` bits."""
    idx = holder.index(index) or holder.create_index(
        index, track_existence=False)
    f = idx.field(field) or idx.create_field(field)
    rows, cols = [], []
    for r, c in enumerate(counts):
        rows += [r] * c
        cols += list(range(c))
    f.import_bits(np.array(rows), np.array(cols))
    from pilosa_tpu_torch.core import VIEW_STANDARD
    return f, f.view(VIEW_STANDARD).fragment(0)


def test_rank_cache_complete_build():
    h = Holder(None)
    _f, frag = _frag_with_counts(h, [5, 3, 10, 1])
    rc = frag.rank_cache
    assert rc is not None and rc.dirty  # lazily built
    rc.ensure(frag)
    assert rc.complete and rc.bound == 0
    assert rc.rows == {0: 5, 1: 3, 2: 10, 3: 1}


def test_rank_cache_incremental_and_zero_row_removal():
    h = Holder(None)
    f, frag = _frag_with_counts(h, [5, 3])
    frag.rank_cache.ensure(frag)
    f.set_bit(1, 100)
    assert frag.rank_cache.rows[1] == 4
    f.clear_bit(0, 0)
    assert frag.rank_cache.rows[0] == 4
    for c in range(4):
        f.clear_bit(1, c if c < 3 else 100)
    assert 1 not in frag.rank_cache.rows
    assert frag.rank_cache.complete  # still knows every nonzero row


def test_rank_cache_bound_ratchets_on_eviction():
    h = Holder(None)
    _f, frag = _frag_with_counts(h, [10, 9, 8, 7, 6])
    rc = RankCache("ranked", 3)
    frag.rank_cache = rc
    rc.build(frag)
    assert not rc.complete
    assert set(rc.rows) == {0, 1, 2}
    assert rc.bound == 7  # best excluded count
    # a write pushing row 4 above the floor evicts row 2 and ratchets
    frag.bulk_import(np.full(3, 4), np.arange(100, 103))
    assert 4 in rc.rows and 2 not in rc.rows
    assert rc.bound == 8 and rc.degraded()


def test_rank_cache_bulk_write_marks_dirty():
    from pilosa_tpu_torch.cache import rank as rank_mod
    h = Holder(None)
    _f, frag = _frag_with_counts(h, [2, 2])
    frag.rank_cache.ensure(frag)
    old = rank_mod.RANK_REBUILD_ROWS
    rank_mod.RANK_REBUILD_ROWS = 4
    try:
        rows = np.arange(10)
        frag.bulk_import(rows, rows + 50)
        assert frag.rank_cache.dirty
        frag.rank_cache.ensure(frag)
        assert not frag.rank_cache.dirty
    finally:
        rank_mod.RANK_REBUILD_ROWS = old


def test_topn_from_rank_pruning_and_fallback():
    h = Holder(None)
    f, frag = _frag_with_counts(h, [100, 90, 80, 10, 9, 8])
    frag.rank_cache = RankCache("ranked", 3)
    # n=1: top candidate (100) strictly beats the bound (10) -> exact
    pairs = topn_from_rank(f, [0], 1)
    assert [(p.id, p.count) for p in pairs] == [(0, 100)]
    # n=0 (unlimited) needs every nonzero row: incomplete cache -> fallback
    assert topn_from_rank(f, [0], 0) is None
    # n=4: the 4th candidate doesn't exist in the cache -> fallback
    assert topn_from_rank(f, [0], 4) is None


# -- differential suite: cached vs cache-type=none ---------------------------

CORPUS = [
    "TopN(f)",
    "TopN(f, n=1)",
    "TopN(f, n=2)",
    "TopN(f, Row(f=1), n=2)",
    "Count(Row(f=1))",
    "Count(Union(Row(f=0), Row(f=2)))",
    "Row(f=0)",
    "Row(f=1)",
    "Rows(f)",
    "Sum(Row(v > 10), field=v)",
    "Min(field=v)",
    "GroupBy(Rows(f))",
]


@pytest.fixture
def executors():
    """Executor(holder) on the CPU; every one built is closed after the
    test."""
    made = []

    def make(holder):
        made.append(Executor(holder, device="cpu"))
        return made[-1]

    yield make
    for ex in made:
        ex.close()


def _build_pair(rng, cache_type, holder_cls=Holder, opts=FieldOptions):
    """Two identically-loaded holders differing only in f's cacheType."""
    h = holder_cls(None)
    idx = h.create_index("i", track_existence=False)
    idx.create_field("f", opts(cache_type=cache_type, cache_size=4))
    idx.create_field("v", opts(type="int", min=0, max=1000))
    f = idx.field("f")
    f.import_bits(rng.integers(0, 8, size=400),
                  rng.integers(0, 2 * SHARD_WIDTH, size=400))
    cols_v = np.unique(rng.integers(0, SHARD_WIDTH, size=100)) + 7
    idx.field("v").import_values(cols_v,
                                 rng.integers(0, 1000, size=cols_v.size))
    return h


def _snap(ex, index="i", serialize=serialize_result):
    return [json.dumps(serialize(ex.execute(index, q)[0]),
                       sort_keys=True) for q in CORPUS]


def test_differential_cached_vs_none_interleaved_writes(rng, executors):
    """Byte-identical results between cacheType=ranked (+ result cache),
    cacheType=none and the JAX package's executor (ranked, result cache
    on) across the corpus, with set/clear/import/repair/attr writes
    interleaved between query rounds."""
    from pilosa_tpu.executor import Executor as JaxExecutor
    from pilosa_tpu.server.handler import serialize_result as jax_ser
    from pilosa_tpu.storage import FieldOptions as JaxFieldOptions
    from pilosa_tpu.storage import Holder as JaxHolder

    h_ranked = _build_pair(rng, "ranked")
    h_none = _build_pair(np.random.default_rng(42), "none")
    h_jax = _build_pair(np.random.default_rng(42), "ranked", JaxHolder,
                        JaxFieldOptions)
    ex_ranked = executors(h_ranked)
    ex_none = executors(h_none)
    ex_jax = JaxExecutor(h_jax)
    ex_ranked.result_cache.limit_bytes = 8 << 20  # caches ON vs OFF
    ex_jax.result_cache.limit_bytes = 8 << 20

    def jax_snap():
        return _snap(ex_jax, serialize=jax_ser)

    def mutate(h):
        f = h.index("i").field("f")
        f.set_bit(2, 123)
        f.clear_bit(1, 5)
        f.import_bits(np.array([0, 3, 9]), np.array([7, 8, 9]))
        # anti-entropy repair analog: a clear-side bulk import
        frag = f.view("standard").fragment(0)
        frag.bulk_import(np.array([0, 2]), np.array([7, 123]), clear=True)
        h.index("i").field("v").import_values(np.array([7, 8]),
                                              np.array([500, 2]))
        f.row_attrs.set_attrs(1, {"tag": "x"})

    try:
        for _round in range(3):
            # query twice per round so the second pass rides the cache
            want = jax_snap()
            assert _snap(ex_ranked) == _snap(ex_none) == want
            assert _snap(ex_ranked) == _snap(ex_none) == jax_snap()
            for h in (h_ranked, h_none, h_jax):
                mutate(h)
        assert _snap(ex_ranked) == _snap(ex_none) == jax_snap()
    finally:
        ex_jax.close()
    snap = ex_ranked.result_cache.snapshot()
    assert snap["hits"] > 0  # the cache actually served repeats


# -- result cache behavior ---------------------------------------------------

def test_result_cache_hit_and_structural_invalidation(rng, executors):
    h = _build_pair(rng, "ranked")
    ex = executors(h)
    ex.result_cache.limit_bytes = 8 << 20
    q = "Count(Row(f=1))"
    before = ex.execute("i", q)[0]
    assert ex.execute("i", q)[0] == before
    assert ex.result_cache.hits == 1
    # a write bumps the fragment gen: the entry stops matching, the next
    # fill supersedes it (counted as an invalidation), and the result is
    # fresh — never stale
    h.index("i").field("f").set_bit(1, 999_000)
    after = ex.execute("i", q)[0]
    assert after == before + 1
    ex.execute("i", q)
    snap = ex.result_cache.snapshot()
    assert snap["invalidates"] >= 1
    assert snap["hits"] >= 2


def test_result_cache_never_caches_writes(rng, executors):
    h = _build_pair(rng, "ranked")
    ex = executors(h)
    ex.result_cache.limit_bytes = 8 << 20
    assert ex.execute("i", "Set(77, f=7)")[0] is True
    assert ex.execute("i", "Set(77, f=7)")[0] is False  # re-executed
    assert ex.result_cache.snapshot()["entries"] == 0


def test_result_cache_byte_budget_evicts(rng, executors):
    h = _build_pair(rng, "ranked")
    ex = executors(h)
    # room for exactly one small entry: the second fill evicts the first
    ex.result_cache.limit_bytes = 150
    ex.execute("i", "Count(Row(f=1))")
    ex.execute("i", "Count(Row(f=2))")
    snap = ex.result_cache.snapshot()
    assert snap["entries"] == 1 and snap["evicts"] >= 1
    # an oversized result is never admitted at all
    ex.result_cache.limit_bytes = 1
    ex.execute("i", "Count(Row(f=3))")
    assert ex.result_cache.snapshot()["entries"] == 1


def test_debug_vars_and_cache_clear_route(tmp_path):
    """Counters visible at /debug/vars and /metrics; the admin clear
    route flushes both layers."""
    import urllib.request

    srv = Server(Config(data_dir=str(tmp_path / "d"), bind="localhost:0",
                        anti_entropy_interval=0, use_mesh=False,
                        result_cache_mb=8))
    try:
        srv.open()

        def req(method, path, data=None):
            r = urllib.request.Request(
                f"http://localhost:{srv.port}{path}", method=method,
                data=data)
            with urllib.request.urlopen(r, timeout=60) as resp:
                return resp.read()

        req("POST", "/index/ci", b"{}")
        req("POST", "/index/ci/field/f", b"{}")
        req("POST", "/index/ci/query", b"Set(1, f=1) Set(5, f=2)")
        # cold, then warm from the result cache: the same answer
        answers = [req("POST", "/index/ci/query", b"TopN(f, n=2)")
                   for _ in range(2)]
        assert answers[0] == answers[1]
        dv = json.loads(req("GET", "/debug/vars"))
        assert dv["resultCache"]["hits"] >= 1
        counts = dv["counts"]
        assert counts.get("resultcache.hit", 0) >= 1
        assert counts.get("resultcache.miss", 0) >= 1
        assert counts.get("rankcache.hit", 0) >= 1
        metrics = req("GET", "/metrics").decode()
        assert "pilosa_tpu_resultcache_hit" in metrics
        assert "pilosa_tpu_rankcache_hit" in metrics
        out = json.loads(req("POST", "/internal/cache/clear", b""))
        assert out["resultEntries"] >= 1
        assert out["rankCaches"] >= 1
        assert json.loads(req(
            "GET", "/debug/vars"))["resultCache"]["entries"] == 0
        # after the clear: recomputed (a miss), the same answer
        misses = json.loads(req("GET", "/debug/vars"))["resultCache"][
            "misses"]
        assert req("POST", "/index/ci/query", b"TopN(f, n=2)") == answers[0]
        assert json.loads(req("GET", "/debug/vars"))["resultCache"][
            "misses"] == misses + 1
    finally:
        srv.close()


# -- 2-node: a remote import invalidates the coordinator's entry -------------

def test_remote_import_invalidates_coordinator_cache(tmp_path):
    import socket
    import urllib.request

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i in range(2):
            srv = Server(Config(
                data_dir=str(tmp_path / f"n{i}"), bind=hosts[i],
                node_id=f"node{i}", cluster_hosts=hosts, replica_n=1,
                anti_entropy_interval=0, use_mesh=False,
                result_cache_mb=8))
            servers.append(srv)
            srv.open()
        coord = servers[0]

        def req(port, method, path, data=None):
            r = urllib.request.Request(
                f"http://localhost:{port}{path}", method=method,
                data=data if data is None or isinstance(data, bytes)
                else json.dumps(data).encode())
            with urllib.request.urlopen(r, timeout=120) as resp:
                return json.loads(resp.read())

        req(ports[0], "POST", "/index/ci", {})
        req(ports[0], "POST", "/index/ci/field/f", {})
        # a shard owned SOLELY by the remote node (replica_n=1)
        shard = next(
            s for s in range(64)
            if coord.cluster.placement.shard_nodes("ci", s) == ["node1"])
        col0 = shard * SHARD_WIDTH + 11

        def count():
            return req(ports[0], "POST", "/index/ci/query",
                       b"Count(Row(f=3))")["results"][0]

        req(ports[0], "POST", "/index/ci/field/f/import",
            {"rowIDs": [3, 3], "columnIDs": [col0, col0 + 1]})
        assert count() == 2
        assert count() == 2  # warm: served from the coordinator cache
        hits0 = coord.api.executor.result_cache.snapshot()["hits"]
        assert hits0 >= 1
        # import forwarded THROUGH the coordinator to the remote owner:
        # note_peer_write bumps node1's data version, so the cached entry
        # stops matching and the next query recomputes
        req(ports[0], "POST", "/index/ci/field/f/import",
            {"rowIDs": [3], "columnIDs": [col0 + 2]})
        assert count() == 3
        # import posted DIRECTLY to the remote node (never crossing the
        # coordinator): the probe piggyback (status dataGens) catches it
        assert count() == 3  # re-warm the cache
        req(ports[1], "POST", "/index/ci/field/f/import",
            {"rowIDs": [3], "columnIDs": [col0 + 3]})
        coord.cluster.probe_peers()
        assert count() == 4
        snap = coord.api.executor.result_cache.snapshot()
        assert snap["invalidates"] >= 1
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass
