"""Differential tests of the PyTorch port's whole-query program
(pilosa_tpu_torch/parallel/wholequery.py, the executor's ``_wq_*``
lowering) against the JAX package's whole-query path and the port's own
grouped path (``whole_query=False``).

The corpus is tests/test_wholequery.py's, cut to 4 shards and built from
one seed into a JAX holder and a port holder: ragged set fields (a, b —
high row ids only in shard 0, so stacking splits into several signature
groups), a BSI field (v), run-heavy clustered ranges (a row 11), a
time-quantum field (t), existence, and a fragment-less shard (3).  Each
query runs through the port's whole-query path and grouped path, dense-
resident, compressed-resident and under eviction pressure, and must
equal the JAX package's whole-query answer; fallbacks must carry the JAX
package's node for the same request.  On the CPU the program body runs
eagerly (no CUDA graph): the graph capture and replay run on the card
(chip_smoke.py).

Every comparison is EXACT: answers are integers and column ids, so there
is no tolerance to state.
"""

from datetime import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.executor import executor as jax_exmod  # noqa: E402
from pilosa_tpu.executor.executor import \
    ExecutionError as JaxExecutionError  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import fragment as jax_fragment  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH, SHARD_WORDS  # noqa: E402
from pilosa_tpu_torch.executor import ExecutionError, Executor  # noqa: E402
from pilosa_tpu_torch.executor import executor as port_exmod  # noqa: E402
from pilosa_tpu_torch.executor.plan import (  # noqa: E402
    NaryPlan, RowPlan, eval_plan, parametrize)
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.storage import fragment as port_fragment  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402

N_SHARDS = 4


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
    rng = np.random.default_rng(99)
    idx = h.create_index("w")
    a = idx.create_field("a")
    b = idx.create_field("b")
    v = idx.create_field("v", field_options(type="int", min=-500, max=500))
    t = idx.create_field("t", field_options(type="time",
                                            time_quantum="YMD"))
    n = 12_000
    live = N_SHARDS - 1
    cols = rng.integers(0, live * SHARD_WIDTH, size=n)
    a.import_bits(rng.integers(0, 10, size=n), cols)
    b.import_bits(rng.integers(0, 6, size=n), cols)
    ragged = rng.integers(0, SHARD_WIDTH, size=800)
    a.import_bits(rng.integers(20, 25, size=800), ragged)
    run_cols = np.concatenate([
        np.arange(s * SHARD_WIDTH + 1000, s * SHARD_WIDTH + 30_000)
        for s in range(live)])
    a.import_bits(np.full(run_cols.size, 11), run_cols)
    vcols = np.unique(cols[: n // 2])
    v.import_values(vcols, rng.integers(-500, 500, size=vcols.size))
    tcols = np.unique(cols[: n // 4])
    t.import_bits(np.full(tcols.size, 2), tcols,
                  timestamps=[datetime(2017, 5, 15)] * tcols.size)
    idx.add_existence(np.unique(np.concatenate([cols, ragged, run_cols])))
    # the fragment-less shard still belongs to the index
    idx.add_existence(np.array([(N_SHARDS - 1) * SHARD_WIDTH + 5]))
    return h


@pytest.fixture(scope="module")
def corpus():
    return (_fill(JaxHolder(None), JaxFieldOptions),
            _fill(Holder(None), FieldOptions))


@pytest.fixture
def budgets():
    """Save and restore both packages' device budgets, residency flags
    and batch-temp workspaces."""
    saved = [(b, b.limit_bytes)
             for b in (jax_membudget.DEFAULT_BUDGET, DEFAULT_BUDGET)]
    flags = [(m, m.COMPRESSED_RESIDENT)
             for m in (jax_fragment, port_fragment)]
    temps = [(m, m.BATCH_TEMP_BYTES) for m in (jax_exmod, port_exmod)]
    yield
    for b, old in saved:
        b.limit_bytes = old
    for m, old in flags:
        m.COMPRESSED_RESIDENT = old
    for m, old in temps:
        m.BATCH_TEMP_BYTES = old


QUERIES = [
    "Count(Intersect(Row(a=1), Row(b=2)))",
    "Count(Union(Row(a=0), Not(Row(b=3)), Shift(Row(a=2), n=5)))",
    "Row(a=3)",
    "Difference(Row(a=11), Row(b=1))",
    "Count(Row(-200 < v < 200))",
    "Sum(Row(v > 17), field=v)",
    "Sum(field=v)",
    "Min(field=v) Max(Row(a=2), field=v)",
    "TopN(a, Row(b=1), n=3)",
    "TopN(a, n=4)",
    "Rows(a)",
    "MinRow(field=a) MaxRow(field=a)",
    "GroupBy(Rows(b), Rows(a), Row(v > 0))",
    "Row(t=2, from=2017-01-01T00:00, to=2017-12-31T00:00)",
    "Count(Row(t=2, from=2017-05-01T00:00, to=2017-06-01T00:00))",
    "Count(Row(a=1)) Count(Row(a=7)) Sum(Row(a=1), field=v) "
    "TopN(b, Row(a=4), n=2) Row(b=0)",
    "TopN(a, Row(b=1), n=3, tanimotoThreshold=10)",
    "Count(Row(a=999)) Count(Row(a=3)) Count(Row(a=1000))",
]

# one query per reducer kind, for the compressed and pressure legs
SUBSET = [QUERIES[0], QUERIES[3], QUERIES[5], QUERIES[7], QUERIES[8],
          QUERIES[12], QUERIES[15]]


def _norm(r):
    if hasattr(r, "columns"):
        return ("row", tuple(int(c) for c in r.columns()))
    if isinstance(r, list):
        return tuple(_norm(x) for x in r)
    if hasattr(r, "to_dict"):
        return r.to_dict()
    return r


def _run(ex, queries):
    return [_norm(r) for q in queries for r in ex.execute("w", q)]


@pytest.fixture(scope="module")
def jax_answers(corpus):
    """The JAX package's whole-query answers, dense-resident (answers do
    not depend on residency)."""
    old = jax_membudget.DEFAULT_BUDGET.limit_bytes
    jax_membudget.DEFAULT_BUDGET.limit_bytes = None
    ex = JaxExecutor(corpus[0], use_mesh=True)
    try:
        return dict(zip(QUERIES, ([_norm(r) for r in ex.execute("w", q)]
                                  for q in QUERIES)))
    finally:
        ex.close()
        jax_membudget.DEFAULT_BUDGET.limit_bytes = old


@pytest.mark.parametrize("leg", ["dense", "compressed", "pressure"])
def test_differential_three_legs(corpus, jax_answers, budgets, leg):
    """The port's whole-query results equal the JAX package's and the
    port's grouped path, dense-resident, compressed-resident and under
    eviction pressure."""
    queries = QUERIES if leg == "dense" else SUBSET
    port_fragment.COMPRESSED_RESIDENT = True
    DEFAULT_BUDGET.limit_bytes = {"dense": None, "compressed": 256 << 20,
                                  "pressure": 1 << 20}[leg]
    DEFAULT_BUDGET.shrink_to_limit()
    ev0 = DEFAULT_BUDGET.evictions
    legacy = Executor(corpus[1], device="cpu", whole_query=False)
    wq = Executor(corpus[1], device="cpu", whole_query_fallback="error")
    try:
        want = [r for q in queries for r in jax_answers[q]]
        assert _run(wq, queries) == want
        assert _run(legacy, queries) == want
        assert wq.wq_requests == len(queries) and wq.wq_fallbacks == 0
        assert legacy.wq_requests == 0
        if leg == "compressed":
            assert DEFAULT_BUDGET.stats()["compressedBytes"] > 0, \
                "the compressed leg never staged a packed stream"
        if leg == "pressure":
            assert DEFAULT_BUDGET.evictions > ev0, \
                "the pressure leg never evicted"
    finally:
        legacy.close()
        wq.close()


def test_one_run_per_request(corpus):
    """A whole-query request is ONE program run, counted in
    wq_requests; the mixed Count + Sum + TopN + bitmap request is still
    one, where the grouped path takes a launch per reducer stage."""
    wq = Executor(corpus[1], device="cpu", whole_query_fallback="error")
    legacy = Executor(corpus[1], device="cpu", whole_query=False)
    mixed = ("Count(Intersect(Row(a=1), Row(b=2))) Sum(Row(a=1), field=v)"
             " TopN(b, Row(a=4), n=2) Row(b=0)")
    try:
        for q in ("Count(Intersect(Row(a=1), Row(b=2)))", mixed):
            r0, n0 = wq.wholequery.runs, wq.wq_requests
            wq.execute("w", q)
            assert wq.wholequery.runs - r0 == 1
            assert wq.wq_requests - n0 == 1
        s0 = legacy.batcher.single_launches
        legacy.execute("w", mixed)
        assert legacy.batcher.single_launches - s0 > 1
        assert legacy.wholequery.runs == 0
    finally:
        wq.close()
        legacy.close()


class _CaptureLog:
    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))


def _fallback_of(ex, q):
    """(fallbacks added, last fallback, logged node) of one request."""
    log = _CaptureLog()
    ex.logger = log
    f0 = ex.wq_fallbacks
    ex.execute("w", q)
    nodes = [f["node"] for n, f in log.events if n == "wholequery.fallback"]
    return ex.wq_fallbacks - f0, ex.wq_last_fallback, nodes


@pytest.mark.parametrize("q", [
    "Options(Row(a=1), shards=[0, 1])",
    "GroupBy(Rows(b, limit=3), Rows(a))",
    "GroupBy(Rows(a), Rows(a), Rows(b))",
    "Rows(a, column=5)",
    " ".join(f"Count(Row(a={i}))" for i in range(9)),
])
def test_fallbacks_match_jax(corpus, budgets, q):
    """Each shape outside the program's vocabulary falls back with the
    counter, the log event and the node the JAX package gives the same
    request (batch-chunks forced by shrinking BATCH_TEMP_BYTES in both),
    and the grouped path's answer equals the JAX answer."""
    jax_exmod.BATCH_TEMP_BYTES = 1
    port_exmod.BATCH_TEMP_BYTES = 1
    jex = JaxExecutor(corpus[0], use_mesh=True)
    ex = Executor(corpus[1], device="cpu")
    try:
        jlog = _CaptureLog()
        jex.logger = jlog
        jf0 = jex.wq_fallbacks
        want = [_norm(r) for r in jex.execute("w", q)]
        got = _fallback_of(ex, q)
        assert got[0] == 1 == jex.wq_fallbacks - jf0
        assert got[1] == jex.wq_last_fallback
        assert got[2] == [f["node"] for n, f in jlog.events
                          if n == "wholequery.fallback"]
        assert [_norm(r) for r in ex.execute("w", q)] == want
    finally:
        jex.close()
        ex.close()


def test_error_policy_raises_like_jax(corpus):
    q = "Options(Row(a=1), shards=[0])"
    jex = JaxExecutor(corpus[0], use_mesh=True,
                      whole_query_fallback="error")
    ex = Executor(corpus[1], device="cpu", whole_query_fallback="error")
    try:
        with pytest.raises(JaxExecutionError) as jerr:
            jex.execute("w", q)
        with pytest.raises(ExecutionError, match="whole-query fallback") \
                as err:
            ex.execute("w", q)
        assert str(err.value) == str(jerr.value)
    finally:
        jex.close()
        ex.close()


def test_device_params_out_of_range_rows():
    """eval_plan with its [B, P] params as a tensor (the program body's
    form) equals the host form: an id at or past the row count reads as
    an empty row for that b only."""
    rng = np.random.default_rng(3)
    S, rows = 2, 4
    frags = {(f, "standard"): torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (S, rows, SHARD_WORDS), dtype=np.int64)
        .astype(np.int32)) for f in ("f", "g")}
    plan = NaryPlan("union", (RowPlan("f", ("standard",), 0),
                              RowPlan("g", ("standard",), 1)))
    slotted, _ = parametrize(plan)
    params = np.array([[0, 1], [7, 2], [3, 99], [4, 4]], dtype=np.int32)
    host = eval_plan(slotted, frags, params, lead=(S,))
    dev = eval_plan(slotted, frags, torch.from_numpy(params), lead=(S,))
    assert torch.equal(host, dev)
    assert torch.equal(dev[3], torch.zeros_like(dev[3]))


def test_tanimoto_rides_two_extra_nodes(corpus):
    """A tanimoto TopN is one program of three nodes: the filtered row
    counts, the unfiltered row totals and the source count."""
    ex = Executor(corpus[1], device="cpu", whole_query_fallback="error")
    seen = []
    run = ex.wholequery.run
    ex.wholequery.run = lambda program, *a: seen.append(
        [n.kind for n in program]) or run(program, *a)
    try:
        ex.execute("w", "TopN(a, Row(b=1), n=3, tanimotoThreshold=10)")
        assert seen == [["row_counts", "row_counts", "count"]]
    finally:
        ex.close()


def test_kill_switch_restores_grouped_path(corpus):
    ex = Executor(corpus[1], device="cpu", whole_query=False)
    try:
        ex.execute("w", "Count(Row(a=1)) Count(Row(a=2))")
        assert ex.wq_requests == 0 and ex.wq_fallbacks == 0
        assert ex.wholequery.runs == 0 and ex.stacked.batch_chunks == 1
    finally:
        ex.close()


def test_stack_drop_drops_programs(corpus):
    """A program cache entry dies with the stack it was captured over:
    re-staging, trimming or evicting the stack drops it (on the card
    the entry holds a CUDA graph over the stack's addresses)."""
    from pilosa_tpu_torch.parallel.stacked import StackedExecutor

    class _Entry:
        def __init__(self, ckey):
            self.ckey = ckey

    st = StackedExecutor("cpu")
    try:
        keys = [("a", "standard")]
        shards = list(range(N_SHARDS))
        ckey = ("w", tuple(keys), tuple(shards))
        st._placed_groups(keys, corpus[1], "w", shards)
        st._graphs["g"] = _Entry(ckey)
        st._graphs["other"] = _Entry(("w", (("b", "standard"),),
                                      tuple(shards)))
        st._stack_cache.clear()                 # forces a re-stage
        st._placed_groups(keys, corpus[1], "w", shards)
        assert list(st._graphs) == ["other"]
    finally:
        st.close()


def test_dropped_runner_pools_are_retired_until_a_capture():
    """A dropped runner's graph pools are not torn down where the
    collector drops it, which may be in the middle of another thread's
    capture; the next capture releases them under the capture lock."""
    import gc
    import weakref

    from pilosa_tpu_torch.parallel import wholequery as wq

    class Pool:                  # stands in for a torch.cuda.MemPool
        pass

    pool, graph = Pool(), Pool()
    runner = wq.WholeQueryRunner(None)
    runner._pools[0] = [pool, None, (graph, [], {})]
    pool_ref, graph_ref = weakref.ref(pool), weakref.ref(graph)
    del pool, graph, runner
    gc.collect()
    assert pool_ref() is not None and graph_ref() is not None
    with wq._CAPTURE_LOCK:
        wq._release_retired()
    assert pool_ref() is None and graph_ref() is None
    assert not wq._RETIRED
