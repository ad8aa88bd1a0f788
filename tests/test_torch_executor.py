"""Differential tests of the PyTorch port's read path
(pilosa_tpu_torch/executor, parallel/stacked.py) against the JAX
package's ``Executor(use_mesh=True)`` — the executor the server and the
SSB bench legs build.

Three corpora, each built from a seed into a JAX holder and a port
holder: a 3-shard SSB star-schema corpus (pilosa_tpu_torch/ssb.py, the
copy of bench.build_ssb) queried with its three shapes; the small corpus
of tests/test_differential.py, int field included, queried with that
file's generator pattern (BSI conditions, Sum, Min and Max too); and
BASELINE config 4 (pilosa_tpu_torch/bsi64.py) cut to 3 shards at its
full depth.  Every query runs on the port's stacked and per-shard paths,
dense-resident and compressed-resident, and must equal the JAX answers
(the JAX side runs in both residencies on the SSB and config-4 corpora,
dense on the generated one).  The grouped multi-call path, its chunking,
the prepared-statement cache and the result cache are held against the
per-call path and the JAX package.

Every comparison is EXACT (result ``to_dict()`` equality): answers are
integers and column ids, so there is no tolerance to state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import fragment as jax_fragment  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu_torch import bsi64, ssb  # noqa: E402
from pilosa_tpu_torch.executor import ExecutionError, Executor  # noqa: E402
from pilosa_tpu_torch.executor import executor as port_exmod  # noqa: E402
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage import fragment as port_fragment  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402

N_SSB_SHARDS = 3
N_QUERIES = 24


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["dense", "compressed"])
def residency(request):
    """Dense-resident (no device budget) or compressed-resident (a budget
    set, so sparse fragments stay packed) in BOTH packages, restored
    after the test."""
    saved = [(b, b.limit_bytes)
             for b in (jax_membudget.DEFAULT_BUDGET, DEFAULT_BUDGET)]
    flags = [(m, m.COMPRESSED_RESIDENT)
             for m in (jax_fragment, port_fragment)]
    limit = None if request.param == "dense" else 64 << 20
    for b, _ in saved:
        b.limit_bytes = limit
    for m, _ in flags:
        m.COMPRESSED_RESIDENT = True
    yield request.param
    for b, old in saved:
        b.limit_bytes = old
    for m, old in flags:
        m.COMPRESSED_RESIDENT = old


@pytest.fixture(scope="module")
def ssb_corpus():
    jh = JaxHolder(None)
    ssb.build_ssb(jh, np.random.default_rng(5), n_shards=N_SSB_SHARDS)
    th = Holder(None)
    hist = ssb.build_ssb(th, np.random.default_rng(5),
                         n_shards=N_SSB_SHARDS)
    return jh, th, hist


def _diff_fill(h, field_options):
    """tests/test_differential.py's corpus (over 3 shards): two set
    fields and the int field ``v`` in [-500, 500)."""
    rng = np.random.default_rng(77)
    idx = h.create_index("d")
    a = idx.create_field("a")
    b = idx.create_field("b")
    v = idx.create_field("v", field_options(type="int", min=-500, max=500))
    n = 6000
    cols = rng.integers(0, 3 * SHARD_WIDTH, size=n)
    a.import_bits(rng.integers(0, 10, size=n), cols)
    b.import_bits(rng.integers(0, 6, size=n), cols)
    vcols = np.unique(cols[: n // 2])
    v.import_values(vcols, rng.integers(-500, 500, size=vcols.size))
    idx.add_existence(cols)


def _holders(fill):
    """(JAX holder, port holder), both filled by ``fill(h, options)``."""
    from pilosa_tpu_torch.storage import FieldOptions
    jh, th = JaxHolder(None), Holder(None)
    fill(jh, JaxFieldOptions)
    fill(th, FieldOptions)
    return jh, th


@pytest.fixture(scope="module")
def diff_corpus():
    return _holders(_diff_fill)


def gen_bitmap(rng, depth=0):
    """test_differential.gen_bitmap, plus Xor and Shift."""
    choice = rng.integers(0, 10 if depth < 2 else 4)
    if choice == 0:
        return f"Row(a={rng.integers(0, 12)})"   # sometimes empty rows
    if choice == 1:
        return f"Row(b={rng.integers(0, 8)})"
    if choice == 2:
        op = rng.choice([">", "<", ">=", "<=", "==", "!="])
        return f"Row(v {op} {rng.integers(-600, 600)})"
    if choice == 3:
        lo = int(rng.integers(-550, 400))
        return f"Row({lo} < v < {lo + int(rng.integers(1, 400))})"
    if choice == 9:
        return f"Shift({gen_bitmap(rng, depth + 1)}, n={rng.integers(0, 70)})"
    kids = ", ".join(gen_bitmap(rng, depth + 1)
                     for _ in range(rng.integers(2, 4)))
    if choice == 4:
        return f"Intersect({kids})"
    if choice == 5:
        return f"Union({kids})"
    if choice == 6:
        return f"Difference({kids})"
    if choice == 7:
        return f"Xor({kids})"
    return f"Not({gen_bitmap(rng, depth + 1)})"


def gen_query(rng):
    kind = rng.integers(0, 11)
    bm = gen_bitmap(rng)
    if kind == 0:
        return bm
    if kind == 1:
        return f"Count({bm})"
    if kind == 2:
        return f"TopN(a, {bm}, n={rng.integers(0, 6)})"
    if kind == 3:
        return f"TopN(b, n={rng.integers(0, 4)})"
    if kind == 4:
        return f"Rows(a, limit={rng.integers(1, 12)})"
    if kind == 5:
        return f"{rng.choice(['MinRow', 'MaxRow'])}(field=b)"
    if kind == 6:
        return f"Options({bm}, excludeRowAttrs=true)"
    if kind == 7:
        return f"Sum({bm}, field=v)"
    if kind in (8, 9):
        return f"{'Min' if kind == 8 else 'Max'}({bm}, field=v)"
    return "GroupBy(Rows(b), Rows(a), " + bm + ")"


def _norm(results):
    out = []
    for r in results:
        if hasattr(r, "columns"):
            out.append(("row", tuple(int(c) for c in r.columns())))
        elif isinstance(r, list):
            out.append([x.to_dict() for x in r])
        elif hasattr(r, "to_dict"):
            out.append(r.to_dict())
        else:
            out.append(r)
    return out


def _port_executors(th):
    return {"stacked": Executor(th, device="cpu", stacked=True),
            "per-shard": Executor(th, device="cpu", stacked=False)}


def test_ssb_shapes_match_jax_and_the_oracle(ssb_corpus, residency):
    jh, th, hist = ssb_corpus
    jex = JaxExecutor(jh, use_mesh=True)
    ports = _port_executors(th)
    rng = np.random.default_rng(9)
    shards = list(range(N_SSB_SHARDS))
    try:
        for _ in range(2):
            calls = ssb.ssb_calls(rng, 9)
            q = ssb.ssb_batch(calls)
            want = ssb.normalize(jex.execute("ssb", q))
            assert want == [ssb.oracle(hist, shards, c) for c in calls]
            for name, ex in ports.items():
                assert ssb.normalize(ex.execute("ssb", q)) == want, name
        # a shard subset (the bench legs query quarters of the corpus)
        q = ssb.ssb_batch(calls)
        got = ports["stacked"].execute("ssb", q, shards=[0, 2])
        assert ssb.normalize(got) == [ssb.oracle(hist, [0, 2], c)
                                      for c in calls]
        frag = th.fragment("ssb", "rev", "standard", 0)
        assert frag.device_form() == residency
        # compressed TopN goes through the fused_row_counts entry (its
        # plain version on the CPU: no kernel launch is counted here)
        kernels.reset_launches()
        st = ports["stacked"].stacked
        before = st.fused_calls
        ports["stacked"].execute(
            "ssb", "TopN(rev, Intersect(Row(region=1), Row(category=3)), "
                   "n=5)")
        assert (st.fused_calls > before) == (residency == "compressed")
        assert kernels.LAUNCHES == {"decode_block": 0, "fused_row_counts": 0}
    finally:
        jex.close()
        for ex in ports.values():
            ex.close()


@pytest.fixture(scope="module")
def diff_workload(diff_corpus):
    """The generated request batches and the JAX answers to them.  The
    JAX side runs once, dense-resident: its compressed-resident answers
    are held equal to its dense ones by the JAX package's own tests
    (tests/test_kernels.py), and the SSB test above runs it in both
    residencies."""
    jh, _ = diff_corpus
    rng = np.random.default_rng(1234)
    queries = [gen_query(rng) for _ in range(N_QUERIES)]
    batches, i = [], 0
    while i < len(queries):
        take = int(rng.integers(1, 4))
        batches.append(" ".join(queries[i: i + take]))
        i += take
    budget = jax_membudget.DEFAULT_BUDGET
    old = budget.limit_bytes
    budget.limit_bytes = None
    jex = JaxExecutor(jh, use_mesh=True)
    try:
        want = [_norm(jex.execute("d", b)) for b in batches]
    finally:
        jex.close()
        budget.limit_bytes = old
    return batches, want


def test_generated_workload_matches_jax(diff_corpus, diff_workload,
                                        residency):
    _, th = diff_corpus
    batches, want = diff_workload
    ports = _port_executors(th)
    try:
        for batch, w in zip(batches, want):
            for name, ex in ports.items():
                assert _norm(ex.execute("d", batch)) == w, (name, batch)
        assert th.fragment("d", "a", "standard", 0).device_form() == \
            residency
    finally:
        for ex in ports.values():
            ex.close()


def test_writes_then_reads_match_jax():
    jh, th = _holders(_diff_fill)
    jex = JaxExecutor(jh, use_mesh=True)
    tex = Executor(th, device="cpu")
    try:
        for q in ["Set(5, a=11)", "Set(2000000, b=7)", "Clear(5, a=11)",
                  "Set(7, a=11)", "Store(Row(a=3), a=12)", "ClearRow(b=2)",
                  "Count(Row(a=11)) Count(Row(a=12)) Rows(b) "
                  "TopN(a, Row(b=7), n=3) Row(b=7)"]:
            assert _norm(tex.execute("d", q)) == _norm(jex.execute("d", q)), q
    finally:
        jex.close()
        tex.close()


def test_bsi_calls_are_refused_until_their_slice(diff_corpus):
    """BSI calls on a field that is not an int field are refused with the
    JAX package's ExecutionError (the BSI calls themselves are ported)."""
    jh, th = diff_corpus
    ex = Executor(th, device="cpu")
    jex = JaxExecutor(jh, use_mesh=True)
    try:
        for q in ("Sum(field=a)", "Min(Row(b=1), field=b)", "Max(field=x)"):
            with pytest.raises(ExecutionError):
                ex.execute("d", q)
            with pytest.raises(ValueError):
                jex.execute("d", q)
    finally:
        ex.close()
        jex.close()


def test_default_device_is_cuda_and_never_falls_back(diff_corpus,
                                                     monkeypatch):
    _, th = diff_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(th)


def _bucket_fill(h, wide: bool):
    """Four shards whose packed fragments fall in different pow2 buckets
    of container count, payload, array entries and runs: shard 0 holds a
    handful of bits, shard 1 scattered bits over dozens of containers,
    shard 2 a full run and a bitmap container, shard 3 no ``b`` at all.
    Every shard's ``a`` reaches row 5 (row capacity 8); ``wide`` adds
    row 20 to shard 1 (capacity 32), a second capacity."""
    rng = np.random.default_rng(31)
    idx = h.create_index("g")
    a = idx.create_field("a")
    b = idx.create_field("b")
    W = SHARD_WIDTH
    for shard in range(4):
        a.import_bits([5, 0], [shard * W + 7, shard * W + 9])
    a.import_bits([1] * 5, np.arange(5) * 3)
    b.import_bits([0, 2], [4, 11])
    cols = W + rng.choice(W, 3000, replace=False)
    a.import_bits(rng.integers(0, 6, 3000), cols)
    b.import_bits(rng.integers(0, 4, 3000), cols)
    a.import_bits(np.full(70000, 2), 2 * W + np.arange(70000))
    cols = 2 * W + (5 << 16) + rng.choice(1 << 16, 40000, replace=False)
    a.import_bits(np.full(40000, 3), cols)
    b.import_bits(np.full(40000, 1), cols)
    a.import_bits(rng.integers(0, 6, 200),
                  3 * W + rng.choice(W, 200, replace=False))
    if wide:
        a.import_bits([20], [W + 5])


BUCKET_QUERIES = [
    "Count(Row(a=1))", "Count(Intersect(Row(a=3), Row(b=1)))",
    "Count(Union(Row(a=2), Row(b=0)))", "TopN(a, n=4)",
    "TopN(a, Row(b=1), n=3)", "TopN(b, Row(a=0), n=2)", "Rows(a)",
    "Rows(b, limit=3)", "GroupBy(Rows(a), Rows(b))",
    "GroupBy(Rows(b), Rows(a), Row(a=3))", "Row(a=5)",
    "Intersect(Row(a=2), Row(b=1))"]


@pytest.mark.parametrize("wide", [False, True])
def test_mixed_bucket_shards_form_one_group_per_row_capacity(wide,
                                                             residency):
    """Shards whose packs would fall in different pow2 buckets stack into
    ONE group per row capacity (two capacities, two groups), and the
    stacked answers equal the JAX executor's, shards without a ``b``
    fragment included."""
    jh, th = JaxHolder(None), Holder(None)
    _bucket_fill(jh, wide)
    _bucket_fill(th, wide)
    shards = list(range(4))
    frs = [th.fragment("g", "a", "standard", s) for s in shards]
    assert {fr.device_form() for fr in frs} == {residency}
    assert th.fragment("g", "b", "standard", 3) is None
    if residency == "compressed":
        from pilosa_tpu_torch.ops.containers import pow2_bucket
        buckets = {(pow2_bucket(p.keys.size), pow2_bucket(p.payload.size),
                    pow2_bucket(p.a_max), pow2_bucket(p.r_max))
                   for p in (fr.packed_host() for fr in frs)}
        assert len(buckets) == 4
    jex = JaxExecutor(jh, use_mesh=True)
    ex = Executor(th, device="cpu", stacked=True)
    try:
        groups = ex.stacked._placed_groups([("a", "standard")], th, "g",
                                           shards)
        assert len(groups) == (2 if wide else 1)
        assert sorted(s for g in groups for s in g[0]) == shards
        for q in BUCKET_QUERIES:
            assert _norm(ex.execute("g", q)) == _norm(jex.execute("g", q)), q
    finally:
        jex.close()
        ex.close()


# -- BSI calls -----------------------------------------------------------------

BSI_QUERIES = [
    "Sum(field=v)", "Min(field=v)", "Max(field=v)",
    "Sum(Row(a=3), field=v)", "Min(Row(b=2), field=v)",
    "Max(Row(b=2), field=v)", "Max(Row(a=11), field=v)",
    "Count(Row(v > 17))", "Count(Row(v >= -17))", "Count(Row(v < 0))",
    "Count(Row(v <= -499))", "Count(Row(v == 3))", "Count(Row(v != 3))",
    "Count(Row(v != null))", "Count(Row(v > 900))", "Count(Row(v < -900))",
    "Count(Row(-40 <= v <= 40))", "Count(Row(-600 < v < -450))",
    "Row(v == -3)", "Row(v > 480)",
    "Sum(Row(v > 100), field=v)", "Sum(Row(v < -100), field=v)",
    "Min(Row(v > 2000), field=v)",
    "TopN(a, Row(v > 0), n=3)",
    "GroupBy(Rows(b), Rows(a), Row(v < -250))",
    "Count(Intersect(Row(v > -100), Row(a=2)))",
]


@pytest.fixture(scope="module")
def bsi_want(diff_corpus):
    """The JAX answers to BSI_QUERIES, dense-resident (as
    ``diff_workload``)."""
    jh, _ = diff_corpus
    budget = jax_membudget.DEFAULT_BUDGET
    old = budget.limit_bytes
    budget.limit_bytes = None
    jex = JaxExecutor(jh, use_mesh=True)
    try:
        return [_norm(jex.execute("d", q)) for q in BSI_QUERIES]
    finally:
        jex.close()
        budget.limit_bytes = old


def test_bsi_calls_match_jax(diff_corpus, bsi_want, residency):
    """Sum / Min / Max, every BSI condition (the six ops, Between,
    negative values, out-of-range empty and full-range notnull), Count of
    a BSI predicate, TopN and GroupBy under a BSI filter: one call per
    request, on both port paths, equal to the JAX executor."""
    _, th = diff_corpus
    ports = _port_executors(th)
    try:
        for name, ex in ports.items():
            for q, w in zip(BSI_QUERIES, bsi_want):
                assert _norm(ex.execute("d", q)) == w, (name, q)
        assert th.fragment("d", "v", "bsig_v", 0).device_form() == residency
    finally:
        for ex in ports.values():
            ex.close()


# -- BASELINE config 4 at 3 shards ---------------------------------------------

N_CFG4_SHARDS = 3


@pytest.fixture(scope="module")
def cfg4_corpus():
    """Config 4 at its density (about 15.5k values a shard) and depth 20,
    cut to 3 shards: JAX holder, port holder, (cols, vals, segs)."""
    n = bsi64.N_VALUES * N_CFG4_SHARDS // bsi64.N_SHARDS
    jh, th = JaxHolder(None), Holder(None)
    bsi64.build(jh, np.random.default_rng(64), JaxFieldOptions,
                n_shards=N_CFG4_SHARDS, n_values=n)
    oracle = bsi64.build(th, np.random.default_rng(64),
                         n_shards=N_CFG4_SHARDS, n_values=n)
    return jh, th, oracle


def test_config4_matches_jax_and_the_oracle(cfg4_corpus, residency):
    """8 Sums a request (the grouped path on the stacked branch, call by
    call on the per-shard one), the GroupBy, and Min / Max / Count under
    the range predicate, against ``JaxExecutor(use_mesh=True)`` and the
    numpy oracle.  Compressed, each Sum decodes the 22-row BSI stack
    (the plain decode on the CPU)."""
    jh, th, (cols, vals, segs) = cfg4_corpus
    rng = np.random.default_rng(4)
    jex = JaxExecutor(jh, use_mesh=True)
    ports = _port_executors(th)
    try:
        frag = th.fragment(bsi64.INDEX, "v", "bsig_v", 0)
        assert th.field(bsi64.INDEX, "v").options.bit_depth == 20
        assert frag.max_row_id() == 21 and frag.device_form() == residency
        for _ in range(2):
            xs = rng.integers(0, bsi64.V_MAX, size=8)
            q = bsi64.sum_request(xs)
            want = bsi64.normalize(jex.execute(bsi64.INDEX, q))
            assert want == [bsi64.oracle_sum(vals, int(x)) for x in xs]
            for name, ex in ports.items():
                assert bsi64.normalize(ex.execute(bsi64.INDEX, q)) == \
                    want, name
        x = int(xs[0])
        q = (f"{bsi64.group_by_query(x)} Min(Row(v > {x}), field=v) "
             f"Max(Row(v > {x}), field=v) Count(Row(v > {x}))")
        want = bsi64.normalize(jex.execute(bsi64.INDEX, q))
        assert want == [bsi64.oracle_group_by(vals, segs, x),
                        bsi64.oracle_min_max(vals, x, False),
                        bsi64.oracle_min_max(vals, x, True),
                        int((vals > x).sum())]
        for name, ex in ports.items():
            assert bsi64.normalize(ex.execute(bsi64.INDEX, q)) == want, name
        assert ports["stacked"].prepared.hits >= 1
    finally:
        jex.close()
        for ex in ports.values():
            ex.close()


# -- the grouped multi-call path -------------------------------------------------

GROUPED_CALLS = [
    "Count(Row(a=1))", "Count(Row(a=2))", "Count(Row(a=40))",
    "Count(Intersect(Row(a=3), Row(b=1)))",
    "Count(Intersect(Row(a=4), Row(b=2)))",
    "Sum(Row(v > 10), field=v)", "Sum(Row(v > -200), field=v)",
    "Sum(Row(v < 0), field=v)", "Sum(Row(v > 300), field=v)",
    "Sum(Row(a=5), field=v)", "Sum(Row(a=6), field=v)",
    "Sum(field=v)",
    "TopN(a, Row(b=1), n=3)", "TopN(a, Row(b=4), n=0)",
    "TopN(a, Row(b=9), n=2)", "TopN(b, n=2)", "TopN(b, n=4)",
    "TopN(a, Row(v > 0), n=2)", "Min(Row(a=1), field=v)", "Rows(b)"]


@pytest.mark.parametrize("chunked", [False, True])
def test_grouped_path_matches_per_call_and_jax(diff_corpus, residency,
                                               chunked, monkeypatch):
    """One request of Count / Sum / TopN groups (filtered, filter-less,
    row ids past the rows, a BSI predicate of each sign) beside
    singletons and calls that never batch.  With ``chunked`` the batch
    temp budget is patched small so every filtered group splits into
    chunks of 1 (filter-less groups stay one chunk).  The answers equal
    the same calls run one by one and the JAX executor's.  The grouped
    path is reached with the whole-query program off."""
    jh, th = diff_corpus
    jex = JaxExecutor(jh, use_mesh=True)
    ex = Executor(th, device="cpu", whole_query=False)
    ex.prepared = None             # the grouped path itself, not a replay
    if chunked:
        monkeypatch.setattr(port_exmod, "BATCH_TEMP_BYTES", 1)
        monkeypatch.setattr(port_exmod, "BATCH_CHUNK_MIN", 1)
    try:
        request = " ".join(GROUPED_CALLS)
        want = _norm(jex.execute("d", request))
        n0 = ex.stacked.batch_chunks
        got = _norm(ex.execute("d", request))
        chunks = ex.stacked.batch_chunks - n0
        one_by_one = [_norm(ex.execute("d", c))[0] for c in GROUPED_CALLS]
        assert got == want == one_by_one
        # count groups: 2 (Row, Intersect); sum: 3 (v-pred, Row, none);
        # topn: 3 (Row(b) filter, none, and the BSI-filtered singleton
        # is not a group)
        assert chunks == (5 + 2 + 2 + 2 + 1 + 1 if chunked else 6)
    finally:
        jex.close()
        ex.close()


# -- prepared statements (the cases of tests/test_prepared.py) ------------------

def test_prepared_statements_match_jax(diff_corpus):
    """A template's first run builds the entry, repeats hit it (a Count,
    a multi-call batch, Sum and TopN under BSI predicates across every
    resolve branch), values that fail a guard fall back to the classic
    path, and a schema-epoch bump rebuilds the entry — every answer equal
    to the classic grouped path and to the JAX executor."""
    jh, th = diff_corpus
    jex = JaxExecutor(jh, use_mesh=True)
    cached = Executor(th, device="cpu")
    classic = Executor(th, device="cpu")
    classic.prepared = None
    prep = cached.prepared

    def check(qs):
        for q in qs:
            got = _norm(cached.execute("d", q))
            assert got == _norm(classic.execute("d", q)) == \
                _norm(jex.execute("d", q)), q

    try:
        check([f"Count(Row(a={r}))" for r in (1, 5, 0, 9, 400)])
        assert prep.hits == 4 and prep.misses == 1
        rng = np.random.default_rng(11)
        check([" ".join(f"Count(Intersect(Row(a={x}), Row(b={y})))"
                        for x, y in rng.integers(0, 8, size=(4, 2)))
               for _ in range(3)])
        check([f"Sum(Row(v > {x}), field=v) Sum(Row(v > {x + 7}), field=v)"
               for x in (0, 100, -100, 499)])
        check([f"TopN(a, Row(v > {x}), n=3)" for x in (0, 50, -50)])
        # the regimes of _resolve_bsi: the entry of a positive predicate
        # must not serve zero, negative, clamped or out-of-range values
        hits, guard = prep.hits, prep.guard_misses
        check([f"Count(Row(v < {x}))"
               for x in (5, 7, -5, 0, 499, 500, 501, -501, 1000, -1000)])
        assert prep.guard_misses > guard and prep.hits > hits
        check([f"Count(Row({lo} <= v <= {hi}))"
               for lo, hi in ((0, 10), (-10, 10), (-500, 500), (5, 5),
                              (600, 2000))])
        # a structural literal (n) change: an equality guard misses
        guard = prep.guard_misses
        check(["TopN(a, Row(v > 10), n=2)"])
        assert prep.guard_misses == guard + 1
        # a schema-epoch bump (DDL) drops the entry: rebuilt, not replayed
        q = "Count(Row(a=3))"
        check([q])
        misses = prep.misses
        th.index("d").create_field("tmp_epoch")
        th.index("d").delete_field("tmp_epoch")
        check([q])
        assert prep.misses == misses + 1
    finally:
        jex.close()
        cached.close()
        classic.close()


# -- the result cache ------------------------------------------------------------

def test_result_cache_hits_then_misses_after_a_write():
    """With a limit set, a repeat request is answered from the cache; a
    write bumps a fragment generation, so the next repeat misses and
    sees the write.  Off (limit 0) on a bare executor, as in JAX."""
    jh, th = _holders(_diff_fill)
    ex = Executor(th, device="cpu")
    jex = JaxExecutor(jh, use_mesh=True)
    cache = ex.result_cache
    try:
        assert cache.limit_bytes == 0
        q = "Count(Row(a=2)) Sum(Row(b=1), field=v) TopN(a, n=2)"
        ex.execute("d", q)
        assert (cache.hits, cache.misses) == (0, 0)
        cache.limit_bytes = 1 << 20
        first = ex.execute("d", q)
        assert (cache.hits, cache.misses) == (0, 1)
        assert ex.execute("d", q) == first
        assert cache.hits == 1
        for h in (th, jh):
            assert h.field("d", "a").set_bit(2, 12345)
        after = ex.execute("d", q)
        assert cache.misses == 2 and cache.invalidates == 1
        assert after[0] == first[0] + 1
        assert _norm(after) == _norm(jex.execute("d", q))
    finally:
        ex.close()
        jex.close()
