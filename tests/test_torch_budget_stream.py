"""Differential tests of the PyTorch port's over-budget shard schedule
(pilosa_tpu_torch/parallel/stacked.py ``shard_schedule`` /
``_ShardSchedule``, the whole-query ``streamed-working-set`` fallback,
the batcher's ``stream_fallbacks`` and the executor's slice-major
batched dispatch) against the JAX package (tests/test_budget_stream.py).

Both packages build the same seeded corpus; budgets are patched small
so that a few shards exceed them.  The JAX executor runs on the test
suite's 8 virtual CPU devices, so its schedule never cuts a slice below
8 shards; the port runs on one device and keeps that rule with
``n_devices`` = 1.  Where the slice cuts are compared, the sizes are
chosen so that both rules give the same cuts; elsewhere the port's own
cuts are checked against the reckoning in the test.

Every comparison is EXACT: answers are integers and column ids.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import fragment as jax_fragment  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu.parallel import mesh_exec as jax_mesh_exec  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.executor.executor import _batch_chunks  # noqa: E402
from pilosa_tpu_torch.executor.plan import (  # noqa: E402
    ReduceNode, parametrize)
from pilosa_tpu_torch.pql import parse  # noqa: E402
from pilosa_tpu_torch.parallel import stacked as port_stacked  # noqa: E402
from pilosa_tpu_torch.parallel.batcher import _Ticket  # noqa: E402
from pilosa_tpu_torch.parallel.wholequery import \
    WholeQueryUnsupported  # noqa: E402
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.storage import fragment as port_fragment  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402
from pilosa_tpu_torch.utils.deadline import (  # noqa: E402
    DeadlineExceeded, QueryContext, activate)
from pilosa_tpu_torch.utils.faults import FAULTS, FaultInjected  # noqa: E402

MB = 1 << 20


# The query generator of tests/test_differential.py (``gen_bitmap`` and
# ``gen_query``), copied so that this file imports no JAX test module:
# the same rng calls in the same order, so a seed gives the same queries.
@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def gen_bitmap(rng, depth=0):
    choice = rng.integers(0, 8 if depth < 2 else 4)
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
    kids = ", ".join(gen_bitmap(rng, depth + 1)
                     for _ in range(rng.integers(2, 4)))
    if choice == 4:
        return f"Intersect({kids})"
    if choice == 5:
        return f"Union({kids})"
    if choice == 6:
        return f"Difference({kids})"
    return f"Not({gen_bitmap(rng, depth + 1)})"


def gen_query(rng):
    kind = rng.integers(0, 8)
    bm = gen_bitmap(rng)
    if kind == 0:
        return bm
    if kind == 1:
        return f"Count({bm})"
    if kind == 2:
        return f"Sum({bm}, field=v)"
    if kind in (3, 4):
        which = "Min" if kind == 3 else "Max"
        return f"{which}({bm}, field=v)"
    if kind == 5:
        return f"TopN(a, {bm}, n={rng.integers(0, 6)})"
    if kind == 6:
        return f"Rows(a, limit={rng.integers(1, 12)})"
    return "GroupBy(Rows(b), Rows(a), " + bm + ")"


def _norm(r):
    if hasattr(r, "columns"):
        return ("row", tuple(int(c) for c in r.columns()))
    if isinstance(r, list):
        return tuple(_norm(x) for x in r)
    if hasattr(r, "to_dict"):
        return r.to_dict()
    return r

# 10 rows a shard -> row capacity 16 -> 2 MiB of dense words a shard
SHARD_MB = 2


def _wide(h, n_shards, field_options, seed=42):
    rng = np.random.default_rng(seed)
    idx = h.create_index("w", track_existence=False)
    f = idx.create_field("f")
    n = 2500 * n_shards
    f.import_bits(rng.integers(0, 10, size=n),
                  rng.integers(0, n_shards * SHARD_WIDTH, size=n))
    return h


def _with_bv(h, n_shards, field_options, seed=7):
    """Add the differential grammar's b / v fields and existence."""
    rng = np.random.default_rng(seed)
    idx = h.index("w")
    b = idx.create_field("b")
    v = idx.create_field("v", field_options(type="int", min=-500, max=500))
    n = 2000 * n_shards
    cols = rng.integers(0, n_shards * SHARD_WIDTH, size=n)
    b.import_bits(rng.integers(0, 6, size=n), cols)
    vcols = np.unique(cols[: n // 2])
    v.import_values(vcols, rng.integers(-500, 500, size=vcols.size))
    idx.add_existence(cols)
    return h


@pytest.fixture
def knobs():
    """Save and restore both packages' budgets, residency flags, the
    port's decode workspace and the failpoints."""
    budgets = [(b, b.limit_bytes)
               for b in (jax_membudget.DEFAULT_BUDGET, DEFAULT_BUDGET)]
    flags = [(m, m.COMPRESSED_RESIDENT)
             for m in (jax_fragment, port_fragment)]
    ws = port_stacked.DECODE_WORKSPACE_BYTES
    yield
    for b, old in budgets:
        b.limit_bytes = old
    for m, old in flags:
        m.COMPRESSED_RESIDENT = old
    port_stacked.DECODE_WORKSPACE_BYTES = ws
    FAULTS.disarm()


def _set_limit(limit):
    for b in (jax_membudget.DEFAULT_BUDGET, DEFAULT_BUDGET):
        b.limit_bytes = limit
        b.shrink_to_limit()


def _dense_only():
    jax_fragment.COMPRESSED_RESIDENT = False
    port_fragment.COMPRESSED_RESIDENT = False


# -- the slice cuts ---------------------------------------------------------

def test_shard_schedule_slices_and_orders_by_residency(knobs):
    """24 shards x 2 MiB against a 32 MiB budget: a 16 MiB target, so
    both schedules cut [0-7], [8-15], [16-23]; a staged second slice is
    drained first by both.  At a 12 MiB budget the port cuts 3-shard
    slices where the 8-device JAX mesh cannot go below 8 shards."""
    _dense_only()
    n = 24
    jh = _wide(JaxHolder(None), n, JaxFieldOptions)
    ph = _wide(Holder(None), n, FieldOptions)
    jx = JaxExecutor(jh, use_mesh=True)
    px = Executor(ph, device="cpu")
    me, st = jx.mesh_exec, px.stacked
    shards = list(range(n))
    keys = [("f", "standard")]
    try:
        assert ph.fragment("w", "f", "standard", 0).n_rows == 16
        _set_limit(None)
        assert st.shard_schedule(ph, "w", [keys], shards).slices == \
            [shards] == me.shard_schedule(jh, "w", [keys], shards).slices
        _set_limit(32 * MB)
        want = [shards[:8], shards[8:16], shards[16:]]
        jsched = me.shard_schedule(jh, "w", [keys], shards)
        psched = st.shard_schedule(ph, "w", [keys], shards)
        assert jsched.slices == want
        assert psched.slices == want
        assert psched.max_slice_len == jsched.max_slice_len == 8
        # stage the SECOND slice: both schedules drain it first
        me._placed_groups(keys, jh, "w", shards[8:16])
        st._placed_groups(keys, ph, "w", shards[8:16])
        reordered = [shards[8:16], shards[:8], shards[16:]]
        assert me.shard_schedule(jh, "w", [keys], shards).slices == \
            reordered
        assert st.shard_schedule(ph, "w", [keys], shards).slices == \
            reordered
        # a 12 MiB budget: 6 MiB target = 3 shards a slice on one device
        _set_limit(12 * MB)
        cuts = [len(sl) for sl in
                st.shard_schedule(ph, "w", [keys], shards).slices]
        assert cuts == [3] * 8
        # streamed execution over the schedule equals the unbudgeted run
        # and the JAX answer
        q = "Count(Union(Row(f=1), Row(f=3))) TopN(f, Row(f=2), n=4)"
        h0, m0 = (DEFAULT_BUDGET.prefetch_hits,
                  DEFAULT_BUDGET.prefetch_misses)
        got = [_norm(r) for r in px.execute("w", q)]
        assert DEFAULT_BUDGET.prefetch_hits + \
            DEFAULT_BUDGET.prefetch_misses > h0 + m0
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
        _set_limit(None)
        assert got == [_norm(r) for r in px.execute("w", q)] == \
            [_norm(r) for r in jx.execute("w", q)]
    finally:
        jx.close()
        px.close()


# -- budgeted-eviction differential ----------------------------------------

@pytest.mark.parametrize("form", ["dense", "compressed"])
def test_budgeted_run_matches_unbudgeted(knobs, form):
    """The differential query corpus under a budget that forces
    evictions (and, dense, streaming) mid-batch returns results
    identical to the unbudgeted run and to the JAX executor's; no pin
    outlives its dispatch."""
    if form == "dense":
        _dense_only()
    n = 16
    jh = _with_bv(_wide(JaxHolder(None), n, JaxFieldOptions), n,
                  JaxFieldOptions)
    ph = _with_bv(_wide(Holder(None), n, FieldOptions), n, FieldOptions)
    qrng = np.random.default_rng(4321)
    queries = [gen_query(qrng).replace("Row(a=", "Row(f=")
               .replace("Rows(a", "Rows(f").replace("TopN(a", "TopN(f")
               for _ in range(12)]
    batches, i = [], 0
    while i < len(queries):
        take = int(qrng.integers(1, 4))
        batches.append(" ".join(queries[i: i + take]))
        i += take
    jx = JaxExecutor(jh, use_mesh=True)
    px = Executor(ph, device="cpu")
    try:
        _set_limit(None)
        want = [_norm(r) for bt in batches for r in jx.execute("w", bt)]
        assert [_norm(r) for bt in batches
                for r in px.execute("w", bt)] == want
        _set_limit(12 * MB if form == "dense" else 1 * MB)
        ev0 = DEFAULT_BUDGET.evictions
        pf0 = DEFAULT_BUDGET.prefetch_hits + DEFAULT_BUDGET.prefetch_misses
        got = [_norm(r) for bt in batches for r in px.execute("w", bt)]
        assert got == want
        assert DEFAULT_BUDGET.evictions > ev0, \
            "budget never evicted: the differential exercised nothing"
        if form == "dense":
            assert DEFAULT_BUDGET.prefetch_hits + \
                DEFAULT_BUDGET.prefetch_misses > pf0, "nothing streamed"
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0, \
            "pins leaked past their dispatch"
    finally:
        jx.close()
        px.close()


def test_filterless_group_dispatches_single_chunk():
    mat = np.zeros((40000, 3), dtype=np.int32)
    chunks = list(_batch_chunks(mat, n_shards=0))
    assert [(lo, n) for lo, n, _ in chunks] == [(0, 40000)]
    # the port does not pad a chunk to a power of two (executor.py)
    assert chunks[0][2].shape[0] == 40000
    # with a filter (n_shards > 0) the cap still applies
    assert len(list(_batch_chunks(mat, n_shards=1))) > 1


# -- fallbacks ---------------------------------------------------------------

def test_whole_query_streamed_working_set_fallback_is_counted(knobs):
    """A request whose working set takes several slices falls back to
    the grouped path with ``streamed-working-set``, is counted, and
    answers as the JAX package does."""
    _dense_only()
    n = 8
    jh = _wide(JaxHolder(None), n, JaxFieldOptions)
    ph = _wide(Holder(None), n, FieldOptions)
    jx = JaxExecutor(jh, use_mesh=True)
    px = Executor(ph, device="cpu")
    q = "Count(Intersect(Row(f=1), Row(f=2))) TopN(f, Row(f=0), n=3)"
    try:
        _set_limit(None)
        want = [_norm(r) for r in jx.execute("w", q)]
        assert [_norm(r) for r in px.execute("w", q)] == want
        assert px.wq_fallbacks == 0
        _set_limit(8 * MB)
        assert [_norm(r) for r in px.execute("w", q)] == want
        assert px.wq_fallbacks == 1
        assert px.wq_last_fallback.startswith("streamed-working-set")
        # the grouped path does not stream through a batcher ticket: the
        # slice-major dispatch goes direct, so nothing was fused
        assert px.batcher.fused_launches == 0
    finally:
        jx.close()
        px.close()


def test_batcher_stream_fallbacks_are_counted(knobs):
    """A fused pack over a multi-slice working set streams each ticket
    down its direct path (reducer tickets) or fails with the runner's
    ``streamed-working-set`` (whole-query tickets); both count."""
    _dense_only()
    n = 8
    ph = _wide(Holder(None), n, FieldOptions)
    px = Executor(ph, device="cpu")
    shards = list(range(n))
    try:
        _set_limit(None)
        plans = [px._resolve("w", parse(f"Row(f={r})").calls[0])
                 for r in (1, 2)]
        want = [px.execute("w", f"Count(Row(f={r}))")[0] for r in (1, 2)]
        _set_limit(8 * MB)
        tickets = []
        for plan in plans:
            slotted, params = parametrize(plan)
            tickets.append(_Ticket(
                "count", ("count", repr(slotted), "w", tuple(shards)),
                params.reshape(1, -1), True,
                {"plan": plan, "slotted": slotted, "holder": ph,
                 "index": "w", "shards": shards}, False))
        b = px.batcher
        b._launch_fused("count", tickets)
        assert b.stream_fallbacks == 1
        got = [sum(int(x) for x in t.future.result()) for t in tickets]
        assert got == want
        snap = b.snapshot()
        assert snap["streamFallbacks"] == 1

        # matrix tickets (the grouped path's chunks) run slice by slice:
        # no dispatch stages more than a slice, and the parts of every
        # slice add up to the answer
        slotted, _ = parametrize(plans[0])
        mat = np.stack([parametrize(p)[1] for p in plans]).astype(np.int32)
        mtickets = [_Ticket(
            "count", ("count", repr(slotted), "w", tuple(shards)),
            mat[i:i + 1], False,
            {"slotted": slotted, "holder": ph, "index": "w",
             "shards": shards}, False) for i in range(2)]
        DEFAULT_BUDGET.reset_peak()
        pf0 = DEFAULT_BUDGET.prefetch_hits + DEFAULT_BUDGET.prefetch_misses
        b._launch_fused("count", mtickets)
        assert b.stream_fallbacks == 2
        parts = [t.future.result() for t in mtickets]
        assert len(parts[0]) == 4           # one part a slice
        assert [int(sum(p[0] for p in ps)) for ps in parts] == want
        assert DEFAULT_BUDGET.stats()["peakBytes"] <= 8 * MB
        assert DEFAULT_BUDGET.prefetch_hits + \
            DEFAULT_BUDGET.prefetch_misses > pf0

        # whole-query pack: the runner refuses the streamed working set
        runner = px.wholequery
        slotted, params = parametrize(plans[0])
        program = (ReduceNode("count", slotted),)
        mats = [params.reshape(1, -1)]
        wq = [_Ticket("wholequery", ("wholequery",), np.zeros((1, 0)),
                      False, {"runner": runner, "program": program,
                              "mats": mats, "holder": ph, "index": "w",
                              "shards": shards}, False)
              for _ in range(2)]
        b._launch_fused_whole(wq)
        assert b.stream_fallbacks == 3
        for t in wq:
            with pytest.raises(WholeQueryUnsupported):
                t.future.result()
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        px.close()


# -- gates between slices ---------------------------------------------------

def _sched(knobs_unused=None):
    n = 8
    ph = _wide(Holder(None), n, FieldOptions)
    px = Executor(ph, device="cpu")
    _set_limit(8 * MB)
    keys = [("f", "standard")]
    sched = px.stacked.shard_schedule(ph, "w", [keys], list(range(n)))
    assert len(sched.slices) == 4
    return px, sched


def test_failpoint_between_slices_raises_and_unpins(knobs):
    _dense_only()
    px, sched = _sched()
    try:
        it = iter(sched)
        next(it)
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] > 0
        FAULTS.arm("mesh.slice", "error", match="w")
        with pytest.raises(FaultInjected):
            next(it)
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
        # through the executor: the query fails, no pin is left
        with pytest.raises(Exception):
            px.execute("w", "Count(Row(f=1))")
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        FAULTS.disarm()
        px.close()


def test_expired_deadline_between_slices_raises_and_unpins(knobs):
    _dense_only()
    px, sched = _sched()
    try:
        ctx = QueryContext(30.0)
        with activate(ctx):
            it = iter(sched)
            next(it)
            assert DEFAULT_BUDGET.stats()["pinnedBytes"] > 0
            ctx.cancel()
            with pytest.raises(DeadlineExceeded):
                next(it)
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
        # an already expired deadline stops a streamed request
        ctx = QueryContext(0.001)
        time.sleep(0.01)
        with pytest.raises(DeadlineExceeded):
            px.execute("w", "Count(Row(f=1))", ctx=ctx)
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        px.close()


def _add_g(h, n_shards, seed=9):
    """A second 10-row field ``g`` (2 MiB of dense words a shard)."""
    rng = np.random.default_rng(seed)
    n = 2500 * n_shards
    h.index("w").create_field("g").import_bits(
        rng.integers(0, 10, size=n),
        rng.integers(0, n_shards * SHARD_WIDTH, size=n))
    return h


def _cuts(sched):
    return [len(sl) for sl in sched.slices]


def test_decode_workspace_slices_a_resident_packed_set(knobs):
    """A compressed working set far under the budget still slices when
    its decoded dense bytes exceed the decode workspace, with the JAX
    module's cuts: 32 shards of 2 MiB decoded a key, against a 32 MiB
    workspace, is 16 shards a slice for one key list and 8 for two
    lists of it (summed, as the JAX estimate sums them)."""
    port_fragment.COMPRESSED_RESIDENT = True
    jax_fragment.COMPRESSED_RESIDENT = True
    n = 32
    jh = _wide(JaxHolder(None), n, JaxFieldOptions)
    ph = _wide(Holder(None), n, FieldOptions)
    jx = JaxExecutor(jh, use_mesh=True)
    px = Executor(ph, device="cpu")
    me, st = jx.mesh_exec, px.stacked
    shards = list(range(n))
    keys = [("f", "standard")]
    q = "Count(Intersect(Row(f=1), Row(f=2))) TopN(f, Row(f=0), n=3)"
    ws = jax_mesh_exec.DECODE_WORKSPACE_BYTES
    try:
        _set_limit(None)
        want = [_norm(r) for r in jx.execute("w", q)]
        _set_limit(256 * MB)
        port_stacked.DECODE_WORKSPACE_BYTES = 32 * MB
        jax_mesh_exec.DECODE_WORKSPACE_BYTES = 32 * MB
        fr = ph.fragment("w", "f", "standard", 0)
        assert fr.device_form() == "compressed"
        assert fr.device_nbytes() < SHARD_MB * MB
        for kls, cut in (([keys], [16, 16]), ([keys, keys], [8] * 4)):
            assert _cuts(st.shard_schedule(ph, "w", kls, shards)) == \
                _cuts(me.shard_schedule(jh, "w", kls, shards)) == cut
        assert [_norm(r) for r in px.execute("w", q)] == want
        assert px.wq_last_fallback.startswith("streamed-working-set")
        # every slice's packed stack stayed resident: nothing evicted
        assert DEFAULT_BUDGET.stats()["compressedBytes"] > 0
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        jax_mesh_exec.DECODE_WORKSPACE_BYTES = ws
        jx.close()
        px.close()


def test_decode_workspace_skips_a_fused_row_count_primary(knobs):
    """A row-count primary that only ``fused_row_counts`` reads is never
    decoded, so the ceiling leaves it out: the port cuts TopN(g, f-filter)
    as the JAX module cuts the filter's key alone, where the JAX
    estimate of the whole key list slices.  A program that decodes both
    keys slices as the JAX one does."""
    port_fragment.COMPRESSED_RESIDENT = True
    jax_fragment.COMPRESSED_RESIDENT = True
    n = 32
    jh = _add_g(_wide(JaxHolder(None), n, JaxFieldOptions), n)
    ph = _add_g(_wide(Holder(None), n, FieldOptions), n)
    jx = JaxExecutor(jh, use_mesh=True)
    px = Executor(ph, device="cpu")
    me, st = jx.mesh_exec, px.stacked
    shards = list(range(n))
    f, g = ("f", "standard"), ("g", "standard")
    topn = "TopN(g, Row(f=1), n=4)"
    both = "Count(Intersect(Row(f=1), Row(g=2)))"
    ws = jax_mesh_exec.DECODE_WORKSPACE_BYTES
    try:
        _set_limit(None)
        want = [_norm(r) for r in jx.execute("w", f"{topn} {both}")]
        _set_limit(256 * MB)
        port_stacked.DECODE_WORKSPACE_BYTES = 64 * MB
        jax_mesh_exec.DECODE_WORKSPACE_BYTES = 64 * MB
        fplan = px._resolve("w", parse("Row(f=1)").calls[0])
        kl, fo = st.batch_keys(g, fplan), st.fused_only(g, fplan)
        assert kl == [g, f] and fo == {g}
        assert st.fused_only(f, fplan) == set()
        assert _cuts(st.shard_schedule(ph, "w", [kl], shards, [fo])) == \
            _cuts(me.shard_schedule(jh, "w", [[f]], shards)) == [32]
        assert _cuts(me.shard_schedule(jh, "w", [kl], shards)) == [16, 16]
        assert _cuts(st.shard_schedule(ph, "w", [kl], shards)) == [16, 16]
        # the whole-query precheck reads the program's fused-only keys
        assert [_norm(r) for r in px.execute("w", topn)] == want[:1]
        assert px.wq_fallbacks == 0
        assert [_norm(r) for r in px.execute("w", both)] == want[1:]
        assert px.wq_fallbacks == 1
        assert px.wq_last_fallback.startswith("streamed-working-set")
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        jax_mesh_exec.DECODE_WORKSPACE_BYTES = ws
        jx.close()
        px.close()
