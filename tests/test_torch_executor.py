"""Differential tests of the PyTorch port's read path
(pilosa_tpu_torch/executor, parallel/stacked.py) against the JAX
package's ``Executor(use_mesh=True)`` — the executor the server and the
SSB bench legs build.

Two corpora, each built from a seed into a JAX holder and a port holder:
a 3-shard SSB star-schema corpus (pilosa_tpu_torch/ssb.py, the copy of
bench.build_ssb) queried with its three shapes, and the small corpus of
tests/test_differential.py queried with that file's generator pattern
(its BSI branches dropped: BSI is not in this slice of the port).  Every
query runs on the port's stacked and per-shard paths, dense-resident and
compressed-resident, and must equal the JAX answers (the JAX side runs
in both residencies on the SSB corpus, dense on the generated one).

Every comparison is EXACT (result ``to_dict()`` equality): answers are
integers and column ids, so there is no tolerance to state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import fragment as jax_fragment  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu_torch import ssb  # noqa: E402
from pilosa_tpu_torch.executor import ExecutionError, Executor  # noqa: E402
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage import fragment as port_fragment  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402

N_SSB_SHARDS = 3
N_QUERIES = 24


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


def _diff_fill(h):
    """tests/test_differential.py's corpus without its int field."""
    rng = np.random.default_rng(77)
    idx = h.create_index("d")
    a = idx.create_field("a")
    b = idx.create_field("b")
    n = 6000
    cols = rng.integers(0, 3 * SHARD_WIDTH, size=n)
    a.import_bits(rng.integers(0, 10, size=n), cols)
    b.import_bits(rng.integers(0, 6, size=n), cols)
    idx.add_existence(cols)


@pytest.fixture(scope="module")
def diff_corpus():
    jh, th = JaxHolder(None), Holder(None)
    _diff_fill(jh)
    _diff_fill(th)
    return jh, th


def gen_bitmap(rng, depth=0):
    """test_differential.gen_bitmap without the BSI conditions, plus Xor
    and Shift."""
    choice = rng.integers(0, 8 if depth < 2 else 2)
    if choice == 0:
        return f"Row(a={rng.integers(0, 12)})"   # sometimes empty rows
    if choice == 1:
        return f"Row(b={rng.integers(0, 8)})"
    if choice == 7:
        return f"Shift({gen_bitmap(rng, depth + 1)}, n={rng.integers(0, 70)})"
    kids = ", ".join(gen_bitmap(rng, depth + 1)
                     for _ in range(rng.integers(2, 4)))
    if choice == 2:
        return f"Intersect({kids})"
    if choice == 3:
        return f"Union({kids})"
    if choice == 4:
        return f"Difference({kids})"
    if choice == 5:
        return f"Xor({kids})"
    return f"Not({gen_bitmap(rng, depth + 1)})"


def gen_query(rng):
    kind = rng.integers(0, 8)
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
    jh, th = JaxHolder(None), Holder(None)
    _diff_fill(jh)
    _diff_fill(th)
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
    _, th = diff_corpus
    ex = Executor(th, device="cpu")
    with pytest.raises(ExecutionError):
        ex.execute("d", "Sum(field=a)")


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
