"""The warm-start subsystem on the PyTorch port (pilosa_tpu_torch/
warmup/): the cases of tests/test_warmup.py against the port's modules —
the CRC-framed signature corpus's crash safety (every-length truncation,
every-byte corruption), recorder fold/seed/flush/compaction, the
coordinator's degrade-to-cold guarantees, the WARMING status and a real
server warm restart — with each corpus entry replayed twice (the port
captures a program's CUDA graph on its second sighting), plus corpora
read across both packages byte for byte and a port server warmed by a
JAX server's corpus.

Left out: tests/test_warmup.py's ``test_resolve_dir_semantics`` and
``test_prune_removes_oldest_first``, which test ``compile_cache.py``: it
only points JAX's persistent XLA compile cache at the data dir, and the
port has no counterpart (CUDA graphs do not outlive their process).

Captures on the CPU go through ``cpu_graphs`` (tests/test_torch_devobs.py).
Answers are compared exactly with the JAX package's.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import warmup as jax_warmup  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.warmup import (CorpusRecorder,  # noqa: E402
                                     SignatureCorpus, top_n,
                                     WarmupCoordinator)
from pilosa_tpu_torch.warmup.corpus import (CORPUS_MAGIC,  # noqa: E402
                                            SCHEMA_VERSION, _frame)
from pilosa_tpu_torch.warmup.replayer import (PHASE_READY,  # noqa: E402
                                              PHASE_WARMING)

from test_torch_devobs import cpu_graphs, make_server  # noqa: E402, F401
from test_torch_devobs import _req as _req_json  # noqa: E402
from test_torch_server import restore_knobs  # noqa: E402, F401


def _req(port, method, path, data=None):
    return _req_json(port, method, path, data), None


def _rec(index="i", template="Count(Row(f=?))", query="Count(Row(f=1))",
         hits=1, **kw):
    rec = {"v": SCHEMA_VERSION, "index": index, "template": template,
           "query": query, "sig": "wholequery:abc", "fp": "fp1",
           "hits": hits, "lastUsed": 100.0, "compileS": 0.5}
    rec.update(kw)
    return rec


def _write_corpus(path, records):
    c = SignatureCorpus(str(path))
    c.open()
    c.append(records)
    c.close()


# -- corpus frame discipline -------------------------------------------------


def test_append_read_load_latest_wins(tmp_path):
    path = tmp_path / "signatures.log"
    recs = [_rec(hits=1), _rec(template="Row(g=?)", query="Row(g=2)",
                               hits=3),
            _rec(hits=7, query="Count(Row(f=9))")]  # same key as recs[0]
    _write_corpus(path, recs)
    assert SignatureCorpus.read(str(path)) == recs
    folded = SignatureCorpus.load(str(path))
    assert set(folded) == {("i", "Count(Row(f=?))"), ("i", "Row(g=?)")}
    # latest frame for a key wins (each frame is a full snapshot)
    assert folded[("i", "Count(Row(f=?))")]["hits"] == 7
    assert folded[("i", "Count(Row(f=?))")]["query"] == "Count(Row(f=9))"


def test_every_length_truncation_recovers(tmp_path):
    """Any kill -9 mid-write leaves a prefix; every prefix must load
    without raising and yield only records that were actually written."""
    path = tmp_path / "signatures.log"
    recs = [_rec(template=f"t{i}(?)", query=f"t{i}(1)", hits=i + 1)
            for i in range(3)]
    _write_corpus(path, recs)
    data = path.read_bytes()
    for cut in range(len(data) + 1):
        path.write_bytes(data[:cut])
        got = SignatureCorpus.read(str(path))
        assert got == recs[:len(got)]  # valid prefix, in order
        # and a fresh open() truncates the torn tail durably
        c = SignatureCorpus(str(path))
        c.open()
        c.close()
        assert SignatureCorpus.read(str(path)) == got
    path.write_bytes(data)
    assert len(SignatureCorpus.load(str(path))) == 3


def test_every_byte_corruption_recovers(tmp_path):
    """Flipping any single byte must never raise and must never invent
    a record: every loaded record equals one that was written."""
    path = tmp_path / "signatures.log"
    recs = [_rec(template=f"t{i}(?)", query=f"t{i}(1)", hits=i + 1)
            for i in range(3)]
    _write_corpus(path, recs)
    data = bytearray(path.read_bytes())
    for i in range(len(data)):
        corrupted = bytearray(data)
        corrupted[i] ^= 0xFF
        path.write_bytes(bytes(corrupted))
        for got in (SignatureCorpus.read(str(path)),
                    list(SignatureCorpus.load(str(path)).values())):
            for rec in got:
                assert rec in recs


def test_wrong_magic_resets_empty(tmp_path):
    path = tmp_path / "signatures.log"
    path.write_bytes(b"NOTMAGIC" + b"junk" * 10)
    c = SignatureCorpus(str(path))
    c.open()  # garbage prefix -> rewritten empty, not refused
    c.append([_rec()])
    c.close()
    assert len(SignatureCorpus.load(str(path))) == 1


def test_bad_records_dropped_not_fatal(tmp_path):
    path = tmp_path / "signatures.log"
    good = _rec()
    stale = _rec(template="old(?)")
    stale["v"] = SCHEMA_VERSION + 1          # stale schema version
    missing = {"v": SCHEMA_VERSION, "index": "i"}  # missing keys
    with open(path, "wb") as f:
        f.write(CORPUS_MAGIC)
        f.write(_frame(json.dumps(good).encode()))
        f.write(_frame(b"[1, 2, 3]"))         # CRC-valid, not a dict
        f.write(_frame(b"{not json"))         # CRC-valid, not JSON
        f.write(_frame(json.dumps(stale).encode()))
        f.write(_frame(json.dumps(missing).encode()))
    folded = SignatureCorpus.load(str(path))
    assert list(folded.values()) == [good]


def test_load_missing_and_empty_file(tmp_path):
    assert SignatureCorpus.load(str(tmp_path / "absent.log")) == {}
    (tmp_path / "empty.log").write_bytes(b"")
    assert SignatureCorpus.load(str(tmp_path / "empty.log")) == {}


def test_compact_rewrites_to_survivors(tmp_path):
    path = tmp_path / "signatures.log"
    c = SignatureCorpus(str(path))
    c.open()
    for i in range(40):
        c.append([_rec(template="hot(?)", query="hot(1)", hits=i)])
    big = path.stat().st_size
    c.compact([_rec(template="hot(?)", query="hot(1)", hits=39)])
    assert path.stat().st_size < big
    assert c.frames_appended == 1
    # the handle survives compaction: appends still land
    c.append([_rec(template="new(?)", query="new(2)")])
    c.close()
    assert set(SignatureCorpus.load(str(path))) == {
        ("i", "hot(?)"), ("i", "new(?)")}


def test_top_n_ranks_hits_then_recency():
    a = _rec(template="a(?)", hits=5, lastUsed=1.0)
    b = _rec(template="b(?)", hits=5, lastUsed=9.0)
    c = _rec(template="c(?)", hits=50, lastUsed=0.0)
    assert top_n([a, b, c], 2) == [c, b]
    assert top_n([a, b, c], 0) == []


# -- recorder ----------------------------------------------------------------


def test_recorder_note_flush_and_seed(tmp_path):
    path = tmp_path / "signatures.log"
    corpus = SignatureCorpus(str(path))
    corpus.open()
    rec = CorpusRecorder(keep_n=8)
    rec.note_sig("wholequery:deadbeef")
    rec.note("i", "Count(Row(f=1))")
    rec.note("i", "Count(Row(f=2))")  # same template, staged sig consumed
    rec.flush(corpus)
    corpus.close()
    folded = SignatureCorpus.load(str(path))
    (key, stored), = folded.items()
    assert key == ("i", "Count(Row(f=?))")
    assert stored["hits"] == 2
    assert stored["sig"] == "wholequery:deadbeef"
    assert stored["query"] == "Count(Row(f=2))"  # latest sample text

    # restart: seeding carries the hit count, new traffic adds to it
    rec2 = CorpusRecorder(keep_n=8)
    rec2.seed(folded)
    rec2.note("i", "Count(Row(f=3))")
    assert rec2.snapshot()["templates"] == 1
    corpus2 = SignatureCorpus(str(path))
    corpus2.open()
    rec2.flush(corpus2)
    corpus2.close()
    assert SignatureCorpus.load(str(path))[key]["hits"] == 3


def test_recorder_compacts_when_log_outgrows_bound(tmp_path):
    path = tmp_path / "signatures.log"
    corpus = SignatureCorpus(str(path))
    corpus.open()
    rec = CorpusRecorder(keep_n=2)
    for i in range(2 * rec.COMPACT_FACTOR + 3):
        rec.note(f"idx{i}", "Count(Row(f=1))")
        rec.flush(corpus)
    # the log was rewritten to the keep_n survivor set at least once
    assert corpus.frames_appended <= rec.keep_n * rec.COMPACT_FACTOR
    corpus.close()
    assert len(SignatureCorpus.read(str(path))) <= \
        rec.keep_n * rec.COMPACT_FACTOR + 1


# -- coordinator (stub executor) ---------------------------------------------


class _StubExecutor:
    def __init__(self, fail_on=()):
        self.calls = []
        self.fail_on = set(fail_on)

    def execute(self, index, query):
        self.calls.append((index, query))
        if query in self.fail_on:
            raise RuntimeError("index dropped")
        return [0]


def _wait_ready(co, timeout=10.0):
    t0 = time.monotonic()
    while co.warming() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    assert not co.warming()


def test_coordinator_cold_without_corpus(tmp_path):
    ex = _StubExecutor()
    co = WarmupCoordinator(ex, str(tmp_path / "signatures.log"))
    assert co.open() is False          # nothing to warm
    assert co.status()["phase"] == PHASE_READY
    co.start()
    co.close()
    assert ex.calls == []


def test_coordinator_disabled_by_top_n_zero(tmp_path):
    path = tmp_path / "signatures.log"
    _write_corpus(path, [_rec()])
    co = WarmupCoordinator(_StubExecutor(), str(path), top_n=0)
    assert co.open() is False
    co.close()


def test_coordinator_replays_top_n_then_ready(tmp_path):
    path = tmp_path / "signatures.log"
    _write_corpus(path, [_rec(template=f"t{i}(?)", query=f"t{i}(1)",
                              hits=10 - i) for i in range(5)])
    ex = _StubExecutor()
    co = WarmupCoordinator(ex, str(path), top_n=3, budget_s=30.0)
    flipped = []
    co.on_ready = lambda: flipped.append(True)
    assert co.open() is True
    assert co.status()["phase"] == PHASE_WARMING
    co.start()
    _wait_ready(co)
    st = co.status()
    # each entry twice: the eager first sighting, then the capture
    assert st["planned"] == 3 and st["replayed"] == 6
    assert st["errors"] == 0 and st["skipped"] == 0
    # replay order is traffic rank: hottest first
    assert [q for _, q in ex.calls] == ["t0(1)", "t0(1)", "t1(1)",
                                        "t1(1)", "t2(1)", "t2(1)"]
    assert flipped == [True]
    co.close()


def test_coordinator_replay_error_degrades_not_fails(tmp_path):
    path = tmp_path / "signatures.log"
    _write_corpus(path, [_rec(template="bad(?)", query="bad(1)", hits=9),
                         _rec(template="ok(?)", query="ok(1)", hits=1)])
    co = WarmupCoordinator(_StubExecutor(fail_on={"bad(1)"}), str(path))
    assert co.open() is True
    co.start()
    _wait_ready(co)
    st = co.status()
    assert st["errors"] == 1 and st["replayed"] == 2
    assert st["phase"] == PHASE_READY
    co.close()


def test_coordinator_budget_expiry_skips_remainder(tmp_path):
    path = tmp_path / "signatures.log"
    _write_corpus(path, [_rec(template=f"t{i}(?)", query=f"t{i}(1)")
                         for i in range(4)])
    co = WarmupCoordinator(_StubExecutor(), str(path), budget_s=0.0)
    assert co.open() is True
    co.start()
    _wait_ready(co)
    st = co.status()
    assert st["skipped"] == st["planned"] == 4
    assert st["replayed"] == 0 and st["phase"] == PHASE_READY
    co.close()


def test_coordinator_corrupt_corpus_cold_start(tmp_path):
    path = tmp_path / "signatures.log"
    path.write_bytes(os.urandom(512))  # garbage: wrong magic
    co = WarmupCoordinator(_StubExecutor(), str(path))
    assert co.open() is False          # cold start, never a crash
    assert co.status()["corpusEntries"] == 0
    co.start()
    co.close()
    # and the rewritten-empty log is usable going forward
    co.recorder.note("i", "Count(Row(f=1))")


# -- corpora across the two packages ----------------------------------------


def _records():
    return [_rec(template=f"t{i}(?)", query=f"t{i}({i})", hits=i + 1,
                 sig=f"wholequery:{i:010x}", fp=f"{i}x4:int32")
            for i in range(4)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corpus_bytes_identical_across_packages(tmp_path, writer):
    """The same records written by either package's SignatureCorpus are
    the same bytes, and each package's loader reads the other's file
    into the same folded view."""
    paths = {}
    for name, mod in (("jax", jax_warmup), ("port", None)):
        path = tmp_path / f"{name}.log"
        c = (mod.SignatureCorpus if mod else SignatureCorpus)(str(path))
        c.open()
        c.append(_records())
        c.close()
        paths[name] = path
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    src = str(paths[writer])
    assert SignatureCorpus.load(src) == \
        jax_warmup.SignatureCorpus.load(src)
    assert SignatureCorpus.read(src) == _records()


def test_recorders_fold_and_compact_alike(tmp_path):
    """Both packages' recorders fed the same traffic write corpora that
    fold to the same records (hits, queries, templates)."""
    out = {}
    for name, cls, corp in (
            ("jax", jax_warmup.CorpusRecorder, jax_warmup.SignatureCorpus),
            ("port", CorpusRecorder, SignatureCorpus)):
        path = tmp_path / f"{name}.log"
        corpus = corp(str(path))
        corpus.open()
        rec = cls(keep_n=2)
        for i in range(40):
            rec.note(f"idx{i % 5}", f"Count(Row(f={i}))")
            rec.flush(corpus)
        corpus.close()
        out[name] = {k: (r["hits"], r["query"], r["template"])
                     for k, r in corp.load(str(path)).items()}
    assert out["port"] == out["jax"]


# -- server end-to-end -------------------------------------------------------


def _fill(h):
    rng = np.random.default_rng(7)
    idx = h.create_index("wi")
    f = idx.create_field("f")
    cols = rng.integers(0, 3 * SHARD_WIDTH, size=3000)
    f.import_bits(rng.integers(0, 4, size=cols.size), cols)
    return h


QUERIES = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))",
           "TopN(f, n=3)", "Count(Row(f=0)) Count(Row(f=3))"]


def _load(port, holder):
    _req(port, "POST", "/index/wi", {})
    _req(port, "POST", "/index/wi/field/f", {})
    pairs = [holder.fragment("wi", "f", "standard", s).pairs()
             for s in range(3)]
    rows = np.concatenate([r for r, _ in pairs])
    cols = np.concatenate([c + s * SHARD_WIDTH
                           for s, (_, c) in enumerate(pairs)])
    _req(port, "POST", "/index/wi/field/f/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})


def _wait_server_ready(srv, timeout=60.0):
    t0 = time.monotonic()
    while srv.warmup.warming() and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
    assert not srv.warmup.warming()


def test_server_warm_restart_end_to_end(tmp_path, cpu_graphs):
    """The full loop on the port: serve -> corpus flushed on close ->
    restart enters warming -> each corpus query replayed twice through
    the real executor (the second run captures its graph) with zero
    retraces -> READY; post-restart requests replay those graphs
    (EXPLAIN says compile warm, no new capture) and answer as the JAX
    executor does on the same data."""
    from pilosa_tpu_torch.utils.devobs import COMPILES

    from pilosa_tpu.server.handler import serialize_result
    jex = JaxExecutor(_fill(JaxHolder(None)), use_mesh=True)
    try:
        want = {q: json.loads(json.dumps(
            [serialize_result(r) for r in jex.execute("wi", q)]))
            for q in QUERIES}
    finally:
        jex.close()

    s = make_server(tmp_path, timeseries_interval=0)
    p = s.port
    _load(p, _fill(Holder(None)))
    for q in QUERIES:
        out, _ = _req(p, "POST", "/index/wi/query", q)
        assert out["results"] == want[q]
    st1, _ = _req(p, "GET", "/status")
    assert st1["phase"] == "ready" and st1["warming"] is False
    s.close()  # final flush writes the corpus

    s2 = make_server(tmp_path, timeseries_interval=0)
    try:
        _wait_server_ready(s2)
        st = s2.warmup.status()
        assert st["phase"] == "ready" and st["planned"] == len(QUERIES)
        assert st["replayed"] == 2 * len(QUERIES)
        assert st["errors"] == 0 and st["skipped"] == 0
        assert st["retracesDuringWarm"] == 0
        prep = s2.api.executor.prepared
        assert prep is not None and len(prep._entries) >= 1
        before = COMPILES.totals()
        r0 = s2.api.executor.wholequery.snapshot()["replays"]
        programs = 0
        for q in QUERIES:
            out, _ = _req(s2.port, "POST", "/index/wi/query?explain=true",
                          q)
            assert out["results"] == want[q]
            # an unfiltered TopN is answered by the rank cache: no plan
            plan = [e for e in out["explain"].get("plan", [])
                    if e.get("mode") == "wholequery"]
            assert all(e["compile"] == "warm" for e in plan)
            programs += len(plan)
        assert programs >= 3
        # every program replayed a graph the warm start captured
        assert s2.api.executor.wholequery.snapshot()["replays"] - r0 \
            == programs
        assert COMPILES.totals()["compiles"] == before["compiles"]
        dv, _ = _req(s2.port, "GET", "/debug/vars")
        assert dv["warmup"]["phase"] == "ready"
        assert dv["warmup"]["replayed"] == st["replayed"]
        assert dv["device"]["graphs"]["graphs"] == programs
    finally:
        s2.close()


def test_warm_restart_captures_past_the_result_cache(tmp_path,
                                                    cpu_graphs):
    """With the result cache on, the replay's second run would be a
    cache hit; the replay bypasses the cache, so every corpus program is
    still held as a graph at READY."""
    s = make_server(tmp_path, timeseries_interval=0, result_cache_mb=64)
    _load(s.port, _fill(Holder(None)))
    for q in QUERIES:
        _req(s.port, "POST", "/index/wi/query", q)
    s.close()
    s2 = make_server(tmp_path, timeseries_interval=0, result_cache_mb=64)
    try:
        _wait_server_ready(s2)
        st = s2.warmup.status()
        assert st["replayed"] == 2 * len(QUERIES) and st["errors"] == 0
        corpus = SignatureCorpus.load(str(tmp_path / "srv"
                                          / "signatures.log"))
        sigs = {r["sig"] for r in corpus.values() if r["sig"]}
        assert len(sigs) >= 3
        assert sigs <= s2.api.executor.wholequery.held_sigs()
    finally:
        s2.close()


def test_jax_corpus_warms_port_server(tmp_path, cpu_graphs):
    """A corpus written by a JAX server warms a port server over the
    same data dir: the port replays every JAX record twice and then
    serves the queries from captured graphs."""
    from pilosa_tpu.server import server as jax_server
    from pilosa_tpu_torch.server import server as port_server
    d = tmp_path / "shared"
    js = jax_server.Server(jax_server.Config(
        data_dir=str(d), bind="localhost:0", compile_cache_dir="off",
        warmup_top_n=0, timeseries_interval=0, flight_recorder_mb=0,
        metric_poll_interval=0))
    js.open()
    try:
        _load(js.port, _fill(Holder(None)))
        want = {q: _req(js.port, "POST", "/index/wi/query", q)[0]
                for q in QUERIES}
    finally:
        js.close()
    jax_records = SignatureCorpus.load(str(d / "signatures.log"))
    assert len(jax_records) == len(QUERIES)
    ps = port_server.Server(port_server.Config(
        data_dir=str(d), bind="localhost:0", device="cpu",
        metric_poll_interval=0, timeseries_interval=0))
    ps.open()
    try:
        _wait_server_ready(ps)
        st = ps.warmup.status()
        assert st["corpusEntries"] == len(QUERIES)
        assert st["replayed"] == 2 * len(QUERIES) and st["errors"] == 0
        r0 = ps.api.executor.wholequery.snapshot()["replays"]
        programs = 0
        for q in QUERIES:
            out, _ = _req(ps.port, "POST", "/index/wi/query?explain=true",
                          q)
            assert out["results"] == want[q]["results"]
            plan = [e for e in out["explain"].get("plan", [])
                    if e.get("mode") == "wholequery"]
            assert all(e["compile"] == "warm" for e in plan)
            programs += len(plan)
        assert programs >= 3
        assert ps.api.executor.wholequery.snapshot()["replays"] - r0 \
            == programs
    finally:
        ps.close()
    # and the port's flushed corpus loads in the JAX package
    folded = jax_warmup.SignatureCorpus.load(str(d / "signatures.log"))
    assert set(folded) == set(jax_records)
    assert all(folded[k]["hits"] >= jax_records[k]["hits"]
               for k in folded)


def test_status_reports_warming_not_ready(tmp_path):
    """While the coordinator is warming, /status must say so (probes
    treat warming as not-READY) without ever claiming DOWN."""
    s = make_server(tmp_path, timeseries_interval=0)
    try:
        class _Stuck:
            def warming(self):
                return True

            def status(self):
                return {"phase": "warming"}

        s.api.warmup = _Stuck()
        st, _ = _req(s.port, "GET", "/status")
        assert st["warming"] is True and st["phase"] == "warming"
        assert st["nodes"][0]["state"] == "WARMING"
    finally:
        s.api.warmup = s.warmup
        s.close()


def test_cluster_local_warming_state(tmp_path):
    from pilosa_tpu_torch.parallel.cluster import (Cluster, NODE_READY,
                                                   NODE_WARMING)

    h = Holder(str(tmp_path / "h"))
    c = Cluster("node0", ["localhost:1", "localhost:2"], holder=h)
    c.set_local_warming(True)
    me = c.by_id["node0"]
    assert me.state == NODE_WARMING
    c.set_local_warming(False)
    assert me.state == NODE_READY
