"""Differential tests of the PyTorch port's device mesh
(pilosa_tpu_torch/parallel/stacked.py: each signature group's shard axis
cut into one block a device, the per-block reducers and the reductions
onto the primary; parallel/wholequery.py: one body and one graph a
device slot; executor.py ``resolve_devices``) against the JAX package's
``Executor(use_mesh=True)`` on the test suite's 8 virtual CPU devices.

The port runs on device lists of the CPU, ``Executor(h, device=["cpu"] *
n)`` for n in {1, 3, 8}: a list of n slots, whose blocks are ragged at 3
over 11 shards and partly empty at 8 over 2 or 3 shards.  The inputs
come from one numpy seed: the JAX holder is filled from it and the port
holder is built from the JAX holder's arrays through
``pilosa_tpu_torch/convert.py``.  Covered: the mesh cases of
tests/test_parallel.py; a differential over the query generator of
tests/test_torch_executor.py, dense- and compressed-resident, whole-query
on and off; per-slot CUDA graphs (stood in for on the CPU by the
``cpu_graphs`` fixture of tests/test_torch_devobs.py); the shard schedule
under a small budget (no slice below n shards, cuts equal to the JAX
schedule's on its 8 devices); the budget's accounting of a stack's blocks;
``resolve_devices``; and the launch counts by card and slot.

Every comparison is EXACT: answers are integers and column ids, so there
is no tolerance to state.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu_torch.convert import holder_from_arrays  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.executor.executor import (  # noqa: E402
    resolve_devices)
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.parallel.stacked import (  # noqa: E402
    StackedExecutor, split_blocks)
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402

from test_torch_budget_stream import (  # noqa: E402, F401
    MB, _dense_only, _set_limit, _wide, knobs)
from test_torch_devobs import cpu_graphs  # noqa: E402, F401
from test_torch_executor import _norm, gen_query, residency  # noqa: E402, F401
from test_torch_storage import _arrays_of_jax_holder  # noqa: E402

SLOTS = [1, 3, 8]
N_SHARDS = 11            # test_parallel's count: not a multiple of 3 or 8
N_QUERIES = 16


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_of(jh) -> Holder:
    """The port holder of the JAX holder's arrays (convert.py)."""
    return holder_from_arrays(*_arrays_of_jax_holder(jh))


def _mesh(th, n, **kw):
    return Executor(th, device=["cpu"] * n, **kw)


# -- the mesh cases of tests/test_parallel.py ---------------------------------

def _loaded():
    """test_parallel's ``loaded`` corpus: ``f`` (8 rows) and the int field
    ``v`` in [0, 1000) over 11 shards, from seed 9; (JAX holder, port
    holder)."""
    jh = JaxHolder(None)
    idx = jh.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", JaxFieldOptions(type="int", min=0, max=1000))
    rng = np.random.default_rng(9)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=5000)
    rows = rng.integers(0, 8, size=5000)
    f.import_bits(rows, cols)
    v.import_values(cols, rng.integers(0, 1000, size=5000))
    idx.add_existence(cols)
    return jh, _port_of(jh)


@pytest.fixture(scope="module")
def loaded():
    return _loaded()


MESH_QUERIES = [
    "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=0), Row(f=3), Row(f=7)))", "Count(Not(Row(f=1)))",
    "Count(Row(v > 500))", "Union(Row(f=1), Row(f=4))",
    "Sum(Row(f=1), field=v)", "Count(Row(f=500))",
    "Count(Difference(Row(f=1), Row(f=1)))",
    "TopN(f, n=3)", "TopN(f)", "TopN(f, Row(f=2), n=2)",
    "Min(field=v)", "Max(field=v)", "Min(Row(f=1), field=v)",
    "Max(Row(f=1), field=v)", "MinRow(field=f)", "MaxRow(field=f)",
    "Rows(f)", "Rows(f, limit=3)", "Rows(f, previous=2)",
    "GroupBy(Rows(f))", "GroupBy(Rows(f), limit=4)",
    "Count(Row(f=1)) Count(Row(v > 10)) Sum(field=v) TopN(f, n=2)"]


@pytest.fixture(scope="module")
def mesh_want(loaded):
    """The JAX mesh's answers to MESH_QUERIES."""
    jex = JaxExecutor(loaded[0], use_mesh=True)
    try:
        return [_norm(jex.execute("i", q)) for q in MESH_QUERIES]
    finally:
        jex.close()


@pytest.mark.parametrize("whole_query", [True, False])
@pytest.mark.parametrize("n", SLOTS)
def test_mesh_matches_jax_mesh(loaded, mesh_want, n, whole_query):
    """test_mesh_matches_pershard, _bitmap_segments, _sum_with_filter,
    _empty_and_missing_fragments and _topn_rows_minmax_match_pershard:
    every query on n slots equals the JAX mesh's answer."""
    _, th = loaded
    ex = _mesh(th, n, whole_query=whole_query)
    try:
        assert ex.stacked.n_devices == n
        for q, want in zip(MESH_QUERIES, mesh_want):
            assert _norm(ex.execute("i", q)) == want, q
        assert ex.execute("i", "Count(Row(f=500))") == [0]
        if whole_query:
            assert ex.wq_requests > 0
    finally:
        ex.close()


def _small(h, field_options, n_shards, seed, fields):
    """test_parallel's GroupBy and negative-BSI corpora."""
    idx = h.create_index("i")
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_shards * SHARD_WIDTH, size=1000 * n_shards)
    for name, rows in fields:
        if rows is None:
            fld = idx.create_field(name, field_options(
                type="int", min=-500, max=500))
            fld.import_values(cols, rng.integers(-500, 500, size=cols.size))
        else:
            idx.create_field(name).import_bits(
                rng.integers(0, rows, size=cols.size), cols)
    idx.add_existence(cols)
    return h


@pytest.mark.parametrize("n", [3, 8])
def test_mesh_groupby_two_fields_and_negative_bsi(n):
    """test_mesh_groupby_two_fields_and_filter (3 shards) and
    test_mesh_negative_bsi_values (2 shards): on 8 slots most blocks are
    empty."""
    for n_shards, seed, fields, queries in (
            (3, 3, [("a", 3), ("b", 4), ("g", 2)],
             ["GroupBy(Rows(a), Rows(b))",
              "GroupBy(Rows(a), Rows(b), Row(g=1))",
              "GroupBy(Rows(a), Rows(b), limit=5)"]),
            (2, 11, [("v", None)],
             ["Sum(field=v)", "Min(field=v)", "Max(field=v)",
              "Count(Row(v < 0))", "Count(Row(v >< [-100, 100]))"])):
        jh = _small(JaxHolder(None), JaxFieldOptions, n_shards, seed, fields)
        th = _port_of(jh)
        jex = JaxExecutor(jh, use_mesh=True)
        ex = _mesh(th, n)
        try:
            for q in queries:
                assert _norm(ex.execute("i", q)) == \
                    _norm(jex.execute("i", q)), q
        finally:
            jex.close()
            ex.close()


def test_mesh_single_shard_on_eight_slots():
    """test_mesh_single_shard: one shard, one non-empty block."""
    h = Holder(None)
    h.create_index("i").create_field("f").set_bit(1, 42)
    ex = _mesh(h, 8)
    try:
        assert ex.execute("i", "Count(Row(f=1))") == [1]
        assert ex.execute("i", "Row(f=1)")[0].columns().tolist() == [42]
        (b,) = ex.stacked._placed_groups([("f", "standard")], h, "i", [0])
        assert (b.slot, b[0]) == (0, [0])
    finally:
        ex.close()


def test_mesh_writes_then_reads_and_cache():
    """test_mesh_mixed_write_read_query_sequential,
    test_mesh_stack_cache_bounded and test_mesh_stack_cache_invalidation
    on 3 slots, against the JAX mesh after the same writes."""
    jh, th = _loaded()
    jex = JaxExecutor(jh, use_mesh=True)
    ex = _mesh(th, 3)
    try:
        before = ex.execute("i", "Count(Row(f=1))")[0]
        q = "Set(999999, f=1) Count(Row(f=1)) Count(Row(f=2))"
        out = ex.execute("i", q)
        assert out == jex.execute("i", q)
        assert out[1] == before + 1
        tokens = {k: v[0] for k, v in ex.stacked._stack_cache.items()}
        ex.execute("i", "Count(Row(f=2))")
        for k, v in ex.stacked._stack_cache.items():
            if k in tokens:
                assert v[0] == tokens[k]         # reused, not re-placed
        ex.stacked.stack_cache_max = 2
        for q in ["Count(Row(v > 3))", "Count(Intersect(Row(f=1), "
                  "Row(v > 2)))", "TopN(f, n=1)", "Count(Row(f=1))"]:
            assert _norm(ex.execute("i", q)) == _norm(jex.execute("i", q))
        assert len(ex.stacked._stack_cache) <= 2
    finally:
        jex.close()
        ex.close()


# -- the generated differential -----------------------------------------------

def _mesh_fill(h, field_options):
    """test_torch_executor's generated corpus (``a``, ``b`` and the int
    field ``v``) at 11 shards in index ``d``, and a 2-shard copy in
    ``two``: blocks ragged at 3 slots, empty at 8."""
    for name, n_shards in (("d", N_SHARDS), ("two", 2)):
        rng = np.random.default_rng(77)
        idx = h.create_index(name)
        a = idx.create_field("a")
        b = idx.create_field("b")
        v = idx.create_field("v", field_options(type="int", min=-500,
                                                max=500))
        n = 2000 * n_shards
        cols = rng.integers(0, n_shards * SHARD_WIDTH, size=n)
        a.import_bits(rng.integers(0, 10, size=n), cols)
        b.import_bits(rng.integers(0, 6, size=n), cols)
        vcols = np.unique(cols[: n // 2])
        v.import_values(vcols, rng.integers(-500, 500, size=vcols.size))
        idx.add_existence(cols)


@pytest.fixture(scope="module")
def mesh_workload():
    """(port holder, request batches, the JAX mesh's answers per index):
    the generator's requests, dense-resident on the JAX side (its
    compressed answers are held equal by its own tests)."""
    jh = JaxHolder(None)
    _mesh_fill(jh, JaxFieldOptions)
    th = _port_of(jh)
    rng = np.random.default_rng(2468)
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
        want = {ix: [_norm(jex.execute(ix, bt)) for bt in batches]
                for ix in ("d", "two")}
    finally:
        jex.close()
        budget.limit_bytes = old
    return th, batches, want


@pytest.mark.parametrize("whole_query", [True, False])
@pytest.mark.parametrize("n", SLOTS)
def test_generated_workload_on_slots_matches_jax(mesh_workload, residency,
                                                 n, whole_query):
    th, batches, want = mesh_workload
    ex = _mesh(th, n, whole_query=whole_query)
    try:
        for ix in ("d", "two"):
            for bt, w in zip(batches, want[ix]):
                assert _norm(ex.execute(ix, bt)) == w, (ix, bt)
        form = th.fragment("d", "a", "standard", 0).device_form()
        assert form == residency
        # every slot holds a block of the 11-shard index
        assert all(b > 0 for b in ex.stacked.slot_bytes())
    finally:
        ex.close()


def test_slot_graphs_capture_and_replay(mesh_workload, cpu_graphs):
    """On 3 slots a program is one graph a slot: eager on its first
    sighting, captured on its second, replayed after, every run equal to
    the JAX answer; the replay counts each slot's recorded launches."""
    th, batches, want = mesh_workload
    ex = _mesh(th, 3)
    try:
        for _ in range(3):
            for bt, w in zip(batches, want["d"]):
                assert _norm(ex.execute("d", bt)) == w, bt
        snap = ex.wholequery.snapshot()
        assert snap["captures"] > 0 and snap["replays"] > 0
        entry = next(iter(ex.stacked._graphs.values()))
        assert [g.slot for g in entry.graphs] == [0, 1, 2]
    finally:
        ex.close()


# -- blocks, schedule and budget ----------------------------------------------

def test_blocks_are_contiguous_and_ragged_by_at_most_one():
    for n, k in ((11, 3), (11, 8), (2, 8), (16, 8), (1, 1), (7, 1)):
        got = list(split_blocks(n, k))
        sizes = [hi - lo for _, lo, hi in got]
        assert sum(sizes) == n and max(sizes) - min(sizes) <= 1
        assert [lo for _, lo, _ in got] == [0] + list(np.cumsum(sizes[:-1]))
        assert [s for s, _, _ in got] == list(range(min(n, k)))


def test_slots_are_kept_by_index_not_by_device(loaded):
    """["cpu"] * 8 is a mesh of 8 slots: 8 blocks of one group, in shard
    order, whose partials add to the one-device answer."""
    _, th = loaded
    st = StackedExecutor(["cpu"] * 8)
    one = StackedExecutor("cpu")
    try:
        keys = [("f", "standard")]
        shards = list(range(N_SHARDS))
        blocks = st._placed_groups(keys, th, "i", shards)
        assert [b.slot for b in blocks] == list(range(8))
        assert [s for b in blocks for s in b[0]] == shards
        assert len({b.gid for b in blocks}) == 1
        assert st.stacked_per_device(N_SHARDS) == 2
        assert one.stacked_per_device(N_SHARDS) == N_SHARDS
        assert StackedExecutor(["cpu"] * 3).stacked_per_device(11) == 4
        assert st.row_counts("f", "standard", None, th, "i", shards) \
            .tolist() == one.row_counts("f", "standard", None, th, "i",
                                        shards).tolist()
    finally:
        st.close()
        one.close()


def test_schedule_never_cuts_below_n_and_matches_jax(knobs):
    """24 shards x 2 MiB under a 12 MiB budget: one device cuts 3-shard
    slices; 8 slots cut no slice below 8 shards, the JAX schedule's cuts
    on its 8 devices; the streamed answers equal the unbudgeted ones."""
    _dense_only()
    n = 24
    jh = _wide(JaxHolder(None), n, JaxFieldOptions)
    ph = _port_of(jh)
    jx = JaxExecutor(jh, use_mesh=True)
    px = _mesh(ph, 8)
    keys = [("f", "standard")]
    shards = list(range(n))
    q = "Count(Union(Row(f=1), Row(f=3))) TopN(f, Row(f=2), n=4)"
    try:
        _set_limit(None)
        want = _norm(jx.execute("w", q))
        _set_limit(12 * MB)
        cuts = px.stacked.shard_schedule(ph, "w", [keys], shards).slices
        assert all(len(sl) >= 8 for sl in cuts)
        assert cuts == jx.mesh_exec.shard_schedule(jh, "w", [keys],
                                                   shards).slices
        assert len(cuts) == 3
        assert _norm(px.execute("w", q)) == want
        assert DEFAULT_BUDGET.stats()["pinnedBytes"] == 0
    finally:
        jx.close()
        px.close()


def test_budget_charges_every_block_and_one_eviction_frees_all(loaded):
    """test_stacks_register_with_device_budget on 3 slots: one budget
    entry a stack, at the sum of its blocks' bytes; its eviction drops
    every block and every graph captured over them."""
    _, th = loaded
    ex = _mesh(th, 3, whole_query=False)
    try:
        ex.execute("i", "Count(Row(f=1))")
        st = ex.stacked
        (ckey,) = list(st._stack_cache)
        key = ("stack", id(st), ckey)
        per_slot = st.slot_bytes()
        assert len(per_slot) == 3 and all(b > 0 for b in per_slot)
        assert DEFAULT_BUDGET._entries[key][0] == sum(per_slot)
        DEFAULT_BUDGET._entries[key][1]()          # the eviction callback
        assert ckey not in st._stack_cache
        assert st.slot_bytes() == [0, 0, 0]
        DEFAULT_BUDGET.unregister(key)
        one = _mesh(th, 1)
        assert ex.execute("i", "Count(Row(f=1))") == \
            one.execute("i", "Count(Row(f=1))")
        one.close()
    finally:
        ex.close()


# -- device lists ----------------------------------------------------------------

def test_resolve_devices_on_lists_cpu_and_missing_cards(monkeypatch):
    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices(["cpu"] * 8) == [torch.device("cpu")] * 8
    assert resolve_devices(("cpu", "cpu")) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        resolve_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "cuda", "cuda:0", ["cpu", "cuda:7"], ["cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(Holder(None), device=["cpu", "cuda:7"])
    # a machine with two cards: cuda:7 is missing, cuda is both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices("cuda") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    assert resolve_devices(["cuda:1", "cuda:1"]) == \
        [torch.device("cuda", 1)] * 2
    for spec in ("cuda:7", ["cuda:0", "cuda:7"]):
        with pytest.raises(RuntimeError, match="has 2 CUDA"):
            resolve_devices(spec)
    with pytest.raises(ValueError):
        resolve_devices(["cpu", "cuda:1"])          # one type a list
    with pytest.raises(ValueError):
        resolve_devices(["cuda"])                  # cards by index


def test_a_rank_of_a_process_group_holds_one_device(monkeypatch):
    """A rank of a process group holds one device list, its own mesh: it
    stacks only its own shards, cut over its slots, and sizes batch
    chunks by the largest slot block of any rank.  Rank 1 of 2 here,
    with 3 slots against rank 0's 1; the collectives are stood in
    for."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    gathered = []

    def all_gather_object(out, obj, group=None):
        gathered.append(obj)
        out[:] = [1, obj]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    h = Holder(None)
    f = h.create_index("i", track_existence=False).create_field("f")
    f.import_bits([1] * 8, [s * SHARD_WIDTH + 5 for s in range(8)])
    st = StackedExecutor(["cpu"] * 3, group=object())
    try:
        assert st.multiprocess and st.n_devices == 3
        blocks = st._placed_groups([("f", "standard")], h, "i",
                                   list(range(8)))
        assert [(b[0], b.slot) for b in blocks] == \
            [([4, 5], 0), ([6], 1), ([7], 2)]
        # rank 0's 4 shards in its one slot, then rank 1's 4 over 3
        assert st.stacked_per_device(8, h, "i", list(range(8))) == 4
        assert st.stacked_per_device(4, h, "i", list(range(4, 8))) == 2
        assert gathered == [3]          # the slot counts, gathered once
    finally:
        st.close()


def test_launch_counts_by_card_and_slot():
    """A replay counts the launches its slot's graph recorded under its
    card and slot; a launch outside any slot counts by card only."""
    kernels.reset_launches()
    kernels.count_replay({"decode_block": 2, "fused_row_counts": 0}, 1, 3)
    kernels.count_replay({"decode_block": 1, "fused_row_counts": 4}, 0)
    assert kernels.LAUNCHES == {"decode_block": 3, "fused_row_counts": 4}
    assert kernels.LAUNCHES_BY_DEVICE == {
        ("decode_block", 1): 2, ("decode_block", 0): 1,
        ("fused_row_counts", 0): 4}
    assert kernels.LAUNCHES_BY_SLOT == {("decode_block", 3): 2}
    with kernels.on_slot(5):
        with kernels.on_slot(6):
            pass
        assert kernels._capture.slot == 5
    assert getattr(kernels._capture, "slot", None) is None
    kernels.reset_launches()
    assert kernels.LAUNCHES_BY_DEVICE == kernels.LAUNCHES_BY_SLOT == {}
