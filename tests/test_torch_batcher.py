"""Tests of the PyTorch port's cross-query dispatch batcher
(pilosa_tpu_torch/parallel/batcher.py), held against the JAX package's:
concurrent same-shape requests fuse and answer byte-for-byte as with
batching off and as the JAX package; a lone ticket takes the un-fused
call; a ticket whose deadline expired while queued is dropped before
launch and maps to HTTP 504; the knobs arrive through env, TOML and the
server, and show at /debug/vars and /metrics (tests/test_torch_server.py
holds those sections against a JAX server's).

The corpus is tests/test_batcher.py's (3 shards, a 32-row set field and
an int field), built from one seed in both packages.  Every executor and
server is closed in its test, so no dispatcher thread outlives it.
Comparisons are exact (JSON text of the results).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server.handler import \
    serialize_result as jax_serialize  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402
from pilosa_tpu_torch.server.handler import serialize_result  # noqa: E402
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.utils.deadline import (  # noqa: E402
    DeadlineExceeded, QueryContext)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fill(h, field_options):
    rng = np.random.default_rng(11)
    idx = h.create_index("b", track_existence=False)
    f = idx.create_field("f")
    f.import_bits(rng.integers(0, 32, size=4000),
                  rng.integers(0, 3 * SHARD_WIDTH, size=4000))
    v = idx.create_field("v", field_options(type="int", min=0, max=1000))
    cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, size=800))
    v.import_values(cols, rng.integers(0, 1000, size=cols.size))
    return h


@pytest.fixture(scope="module")
def holders():
    return _fill(JaxHolder(None), JaxFieldOptions), \
        _fill(Holder(None), FieldOptions)


def _mixed_corpus(n):
    out = []
    for i in range(n):
        out += [
            f"Count(Row(f={i % 32}))",
            f"Row(f={(i * 5) % 32})",
            f"Count(Intersect(Row(f={i % 32}), Row(f={(i + 3) % 32})))",
            f"TopN(f, Row(f={(i + 1) % 32}), n=4)",
            f"Sum(Row(v > {(i * 83) % 1000}), field=v)",
        ]
    return out


def _run_threaded(ex, queries, n_threads):
    """The corpus from n_threads concurrent clients, each result as JSON
    text, so the comparison is byte-level."""
    out = [None] * len(queries)
    errs = []
    barrier = threading.Barrier(n_threads)

    def worker(k):
        barrier.wait()
        for i in range(k, len(queries), n_threads):
            try:
                out[i] = json.dumps(
                    serialize_result(ex.execute("b", queries[i])))
            except Exception as e:  # surfaced below, not swallowed
                errs.append((queries[i], repr(e)))

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs[:3]
    return out


@pytest.mark.parametrize("whole_query", [True, False])
def test_batched_vs_off_byte_identical(holders, whole_query):
    """A mixed Count/Row/Intersect/TopN/Sum corpus from 8 concurrent
    threads is byte-identical with batching on and off and to the JAX
    package, whole-query on (the default) and off — and the on-run
    fused: some launch carried more than one ticket."""
    queries = _mixed_corpus(8)
    jex = JaxExecutor(holders[0], use_mesh=True)
    ex_on = Executor(holders[1], device="cpu", whole_query=whole_query,
                     dispatch_batch_window_us=20_000)
    ex_off = Executor(holders[1], device="cpu", whole_query=whole_query,
                      dispatch_batch=False)
    try:
        want = [json.dumps(jax_serialize(jex.execute("b", q)))
                for q in queries]
        assert _run_threaded(ex_on, queries, 8) == want
        assert _run_threaded(ex_off, queries, 8) == want
        assert ex_on.batcher.fused_launches > 0, \
            "8 concurrent threads never fused a launch"
        hist = ex_on.batcher.batch_size_hist.snapshot()
        assert hist["count"] > hist["le_1"]
        # off-mode batcher is pure delegation: no dispatcher activity
        assert ex_off.batcher.fused_launches == 0
        assert ex_off.batcher.single_launches == 0
    finally:
        jex.close()
        ex_on.close()
        ex_off.close()


def test_fused_wholequery_tickets(holders):
    """Concurrent same-shape whole-query requests fuse: one program run
    over the concatenated params, each ticket's slice equal to its solo
    answer."""
    ex = Executor(holders[1], device="cpu", dispatch_batch_window_us=50_000)
    try:
        want = {i: ex.execute("b", f"Count(Row(f={i}))")[0]
                for i in range(8)}
        f0, r0 = ex.batcher.fused_launches, ex.wholequery.runs
        results: dict = {}
        barrier = threading.Barrier(8)

        def worker(i):
            barrier.wait()
            results[i] = ex.execute("b", f"Count(Row(f={i}))")[0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results == want
        assert ex.batcher.fused_launches > f0, \
            "concurrent whole-query tickets never fused"
        assert ex.wholequery.runs - r0 < 8
    finally:
        ex.close()


def test_solo_query_takes_unfused_call(holders):
    ex = Executor(holders[1], device="cpu", dispatch_batch_window_us=100)
    off = Executor(holders[1], device="cpu", dispatch_batch=False)
    try:
        assert ex.execute("b", "Count(Row(f=3))") == \
            off.execute("b", "Count(Row(f=3))")
        assert ex.batcher.single_launches >= 1
        assert ex.batcher.fused_launches == 0
        hist = ex.batcher.batch_size_hist.snapshot()
        assert hist["le_1"] == hist["count"]
    finally:
        ex.close()
        off.close()


def test_expired_ticket_dropped_before_launch(holders):
    """A ticket whose deadline expires while queued in the batch window
    is dropped BEFORE launch (DeadlineExceeded to its waiter), while a
    healthy ticket sharing the window still gets its answer."""
    ex = Executor(holders[1], device="cpu",
                  dispatch_batch_window_us=300_000)
    off = Executor(holders[1], device="cpu", dispatch_batch=False)
    try:
        results, errors = [], []

        def doomed():
            try:
                ex.execute("b", "Count(Row(f=2))", ctx=QueryContext(0.05))
            except DeadlineExceeded as e:
                errors.append(str(e))

        def healthy():
            results.append(ex.execute("b", "Count(Row(f=2))")[0])

        ts = [threading.Thread(target=doomed),
              threading.Thread(target=healthy)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert errors and "deadline" in errors[0]
        assert results == [off.execute("b", "Count(Row(f=2))")[0]]
        assert ex.batcher.expired_drops >= 1
        hist = ex.batcher.batch_size_hist.snapshot()
        assert hist["le_inf"] == 0 and hist["count"] >= 1
    finally:
        ex.close()
        off.close()


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(f"http://localhost:{port}{path}",
                                 method="POST", data=body.encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def test_queued_expiry_maps_to_504_via_server(tmp_path):
    srv = port_server.Server(port_server.Config(
        data_dir=str(tmp_path / "d"), bind="localhost:0", device="cpu",
        metric_poll_interval=0, dispatch_batch_window_us=400_000))
    try:
        srv.open()
        assert _post(srv.port, "/index/dl", "{}")[0] == 200
        assert _post(srv.port, "/index/dl/field/f", "{}")[0] == 200
        assert _post(srv.port, "/index/dl/query", "Set(1, f=1)")[0] == 200
        code, body = _post(srv.port, "/index/dl/query?timeout=0.05",
                           "Count(Row(f=1))")
        assert code == 504, body
        assert b"deadline" in body
        snap = _get_json(srv.port, "/debug/vars")
        assert snap["dispatchBatcher"]["expiredDrops"] >= 1
        assert snap["counts"]["dispatch.expired_drop"] >= 1
    finally:
        srv.close()


def test_knob_plumbing_env_toml_and_debug_vars(tmp_path, monkeypatch):
    Config = port_server.Config
    assert Config().whole_query is True
    assert Config().whole_query_fallback == "legacy"
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_BATCH", "false")
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_BATCH_MAX", "7")
    monkeypatch.setenv("PILOSA_TPU_DISPATCH_BATCH_WINDOW_US", "123")
    monkeypatch.setenv("PILOSA_TPU_WHOLE_QUERY", "false")
    monkeypatch.setenv("PILOSA_TPU_WHOLE_QUERY_FALLBACK", "error")
    cfg = Config.from_env()
    assert cfg.dispatch_batch is False
    assert cfg.dispatch_batch_max == 7
    assert cfg.dispatch_batch_window_us == 123.0
    assert cfg.whole_query is False
    assert cfg.whole_query_fallback == "error"
    for k in ("PILOSA_TPU_DISPATCH_BATCH", "PILOSA_TPU_DISPATCH_BATCH_MAX",
              "PILOSA_TPU_DISPATCH_BATCH_WINDOW_US",
              "PILOSA_TPU_WHOLE_QUERY", "PILOSA_TPU_WHOLE_QUERY_FALLBACK"):
        monkeypatch.delenv(k)
    toml = tmp_path / "c.toml"
    toml.write_text('whole-query = false\n'
                    'whole-query-fallback = "error"\n'
                    'dispatch-batch-max = 5\n')
    cfg = Config.from_toml(str(toml))
    assert (cfg.whole_query, cfg.whole_query_fallback,
            cfg.dispatch_batch_max) == (False, "error", 5)
    srv = port_server.Server(Config(
        data_dir=str(tmp_path / "k"), bind="localhost:0", device="cpu",
        metric_poll_interval=0, dispatch_batch_max=7,
        dispatch_batch_window_us=123, whole_query=False))
    try:
        srv.open()
        ex = srv.api.executor
        assert ex.batcher.enabled and ex.batcher.max_batch == 7
        assert ex.whole_query is False
        assert ex.logger is srv.logger
        snap = _get_json(srv.port, "/debug/vars")
        assert snap["dispatchBatcher"]["maxBatch"] == 7
        assert snap["dispatchBatcher"]["windowUs"] == 123.0
        assert snap["wholeQuery"]["enabled"] is False
        text = urllib.request.urlopen(
            f"http://localhost:{srv.port}/metrics",
            timeout=30).read().decode()
        assert "pilosa_tpu_dispatch_batch_size_bucket" in text
        assert "pilosa_tpu_dispatch_window_wait_seconds_count" in text
        srv.collect_runtime_stats()
        assert srv.stats.snapshot()["gauges"]["runtime.batcher_queued"] == 0
    finally:
        srv.close()


def test_background_work_yields(holders):
    """recalculate_caches runs as background batcher work; the flag is
    this thread's only, and yield_to_foreground returns at once on an
    empty queue."""
    from pilosa_tpu_torch.api import API
    api = API(holders[1], device="cpu")
    try:
        b = api.executor.batcher
        with b.background():
            assert b._bg_local.flag
            b.yield_to_foreground(max_wait=5)
        assert not b._bg_local.flag
        api.recalculate_caches()
        assert api.query("b", "Count(Row(f=1))")[0] == \
            api.executor.execute("b", "Count(Row(f=1))")[0]
    finally:
        api.executor.close()
