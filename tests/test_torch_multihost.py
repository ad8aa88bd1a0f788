"""The port's multi-process engine (pilosa_tpu_torch/parallel/multihost.py)
across real processes, against a numpy oracle and the JAX package's
single-process executor.

Two ranks join one ``torch.distributed`` process group over gloo on the
CPU (free localhost port), each importing only its half of an 8-shard
corpus — the corpus of tests/multihost_worker.py: a set field ``f`` of 6
rows and an int field ``v`` — and each holding a device list of its own,
``["cpu"] * k`` (the slots of the rank's mesh, parallel/stacked.py):
one slot a rank, as before, or (2, 3) and (3, 1) slots, the JAX
package's processes with different local device counts.  Each rank runs
the same requests in lockstep: Count, Intersect, Row, TopN, Sum, Min,
Max, Rows (also with ``column=``) and GroupBy, one at a time and as one
multi-call request (the grouped path's batched reducers), over every
shard and over shards 0-1 only (``SUBSET``: the first rank holds two of
them, fewer than three slots, and the second none), first
dense-resident and then compressed-resident (a device budget set, so
the sparse fragments stay packed and TopN goes through the
``fused_row_counts`` entry).  The parent checks that every rank's
answers equal the oracle over the data and the JAX package's
``Executor(use_mesh=True)`` on a holder of the full data.  Comparisons
are exact.  A rank also counts, by mesh slot, the calls of the two
kernel wrappers (on the CPU they run their plain versions, which count
nothing by themselves): each must run in every slot of every rank.

This file is also the rank's program:

    python tests/test_torch_multihost.py <port> <rank> <world> <slots>

``<slots>``: each rank's slot count, comma-separated (``2,3``).
"""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

N_SHARDS = 8
N_ROWS = 6
N_BITS = 20000
SEED = 21
RANK_TIMEOUT_S = 50
# the requests run again over these shards only
SUBSET = [0, 1]
QUERIES = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Row(f=1)",
    "TopN(f, n=3)",
    "TopN(f, Row(f=0), n=4)",
    "Sum(Row(f=2), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Min(Row(f=4), field=v)",
    "Rows(f)",
    "GroupBy(Rows(f), Rows(f))",
    "GroupBy(Rows(f), Rows(f), Row(f=5))",
    # the grouped path: same-shape Count / Sum / TopN calls batch
    "Count(Row(f=1)) Count(Row(f=2)) Sum(Row(f=1), field=v) "
    "Sum(Row(f=3), field=v) TopN(f, Row(f=1), n=2) TopN(f, Row(f=2), n=2)",
]


def corpus():
    """(rows, cols, vcols, vvals): the same stream on every process."""
    from pilosa_tpu_torch.core import SHARD_WIDTH
    rng = np.random.default_rng(SEED)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=N_BITS)
    rows = rng.integers(0, N_ROWS, size=N_BITS)
    vcols = np.unique(cols)[::3]
    vvals = rng.integers(1, 1000, size=vcols.size)
    return rows, cols, vcols, vvals


def column_query(cols) -> str:
    """``Rows(f, column=C)`` for a column in the second rank's half."""
    from pilosa_tpu_torch.core import SHARD_WIDTH
    c = int(cols[cols >= (N_SHARDS // 2) * SHARD_WIDTH][0])
    return f"Rows(f, column={c})"


def norm(results) -> list:
    """Executor results of either package as JSON-able plain values."""
    out = []
    for r in results:
        if hasattr(r, "columns"):
            out.append(sorted(int(c) for c in r.columns()))
        elif hasattr(r, "rows"):
            out.append([int(x) for x in r.rows])
        elif isinstance(r, list):
            out.append([[[fr.field, fr.row_id] for fr in g.group]
                        + [g.count] if hasattr(g, "group")
                        else [g.id, g.count] for g in r])
        elif hasattr(r, "val"):
            out.append([r.val, r.count])
        else:
            out.append(r)
    return out


def oracle(rows, cols, vcols, vvals, queries, shards=None) -> list:
    """The numpy answers of ``queries`` over the full data, or over the
    columns of ``shards`` only."""
    from pilosa_tpu_torch.core import SHARD_WIDTH
    col = int(column_query(cols).split("=")[1].rstrip(")"))
    if shards is not None:
        sel = np.isin(cols // SHARD_WIDTH, shards)
        rows, cols = rows[sel], cols[sel]
        sel = np.isin(vcols // SHARD_WIDTH, shards)
        vcols, vvals = vcols[sel], vvals[sel]
    by_row = {r: set(cols[rows == r].tolist()) for r in range(N_ROWS)}
    val_of = dict(zip(vcols.tolist(), vvals.tolist()))

    def topn(filt, n):
        counts = [(len(by_row[r] & filt) if filt is not None
                   else len(by_row[r]), r) for r in range(N_ROWS)]
        order = sorted((c for c in counts if c[0]), key=lambda x: (-x[0],
                                                                  x[1]))
        return [[r, c] for c, r in order[:n]]

    def sum_(filt):
        vs = [val_of[c] for c in filt if c in val_of]
        return [sum(vs), len(vs)]

    def extreme(filt, want_max):
        vs = [val_of[c] for c in (filt if filt is not None else val_of)
              if c in val_of]
        m = max(vs) if want_max else min(vs)
        return [m, vs.count(m)]

    def group_by(filt):
        out = []
        for a in range(N_ROWS):
            for b in range(N_ROWS):
                s = by_row[a] & by_row[b]
                if filt is not None:
                    s &= filt
                if s:
                    out.append([["f", a], ["f", b], len(s)])
        return out

    table = {
        "Count(Row(f=3))": [len(by_row[3])],
        "Count(Intersect(Row(f=1), Row(f=2)))": [len(by_row[1] & by_row[2])],
        "Row(f=1)": [sorted(by_row[1])],
        "TopN(f, n=3)": [topn(None, 3)],
        "TopN(f, Row(f=0), n=4)": [topn(by_row[0], 4)],
        "Sum(Row(f=2), field=v)": [sum_(by_row[2])],
        "Min(field=v)": [extreme(None, False)],
        "Max(field=v)": [extreme(None, True)],
        "Min(Row(f=4), field=v)": [extreme(by_row[4], False)],
        "Rows(f)": [sorted(r for r in by_row if by_row[r])],
        "GroupBy(Rows(f), Rows(f))": [group_by(None)],
        "GroupBy(Rows(f), Rows(f), Row(f=5))": [group_by(by_row[5])],
        QUERIES[-1]: [len(by_row[1]), len(by_row[2]), sum_(by_row[1]),
                      sum_(by_row[3]), topn(by_row[1], 2),
                      topn(by_row[2], 2)],
        f"Rows(f, column={col})": [sorted(r for r in by_row
                                          if col in by_row[r])],
    }
    return [table[q] for q in queries]


# -- the rank's program ------------------------------------------------------


def count_slot_calls():
    """Count each kernel wrapper's calls by mesh slot in
    ``kernels.LAUNCHES_BY_SLOT``, as a launch on the card counts: the
    stacked executor calls them through the module, under the block's
    ``on_slot``."""
    from pilosa_tpu_torch.ops import kernels

    def counted(name, fn):
        def call(*args, **kwargs):
            with kernels._launches_lock:
                kernels._count(name, 1, None,
                               getattr(kernels._capture, "slot", None))
            return fn(*args, **kwargs)
        return call

    for name in ("decode_block", "fused_row_counts"):
        setattr(kernels, name, counted(name, getattr(kernels, name)))


def rank_main(port: int, rank: int, world: int, slots: list) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel.multihost import (
        close_distributed, import_process_slice, import_process_values,
        init_distributed,
    )
    from pilosa_tpu_torch.storage import FieldOptions, Holder
    from pilosa_tpu_torch.storage import fragment as port_fragment
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET

    import torch
    # the ranks share the host: split its cores, or their intra-op
    # threads spin against each other while one waits in a collective
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    k = slots[rank]
    group, devices = init_distributed(f"localhost:{port}", world, rank,
                                      device=["cpu"] * k)
    assert devices == [torch.device("cpu")] * k, devices
    count_slot_calls()
    rows, cols, vcols, vvals = corpus()
    h = Holder(None)
    idx = h.create_index("mh", track_existence=False)
    f = idx.create_field("f")
    lo, hi = import_process_slice(f, rows, cols, N_SHARDS,
                                  max_row_id=N_ROWS - 1, group=group)
    assert hi - lo == N_SHARDS // world, (lo, hi)
    # the int field: this rank's values, empty fragments elsewhere at the
    # global bit depth
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
    import_process_values(v, vcols, vvals, N_SHARDS,
                          int(vvals.max()).bit_length(), group)

    queries = QUERIES + [column_query(cols)]
    answers = {}
    port_fragment.COMPRESSED_RESIDENT = True
    for residency, limit in (("dense", None), ("compressed", 64 << 20)):
        DEFAULT_BUDGET.limit_bytes = limit
        kernels.reset_launches()
        ex = Executor(h, device=devices, group=group)
        assert ex.wholequery is None and ex.multiprocess
        assert ex.stacked.n_devices == k
        answers[residency] = [norm(ex.execute("mh", q)) for q in queries]
        answers[residency + "_subset"] = [
            norm(ex.execute("mh", q, shards=SUBSET)) for q in QUERIES]
        frag = h.fragment("mh", "f", "standard", lo)
        assert frag.device_form() == residency, frag.device_form()
        if residency == "compressed":
            assert ex.stacked.fused_calls > 0   # TopN took the fused entry
            answers["calls_by_slot"] = {
                name: [kernels.LAUNCHES_BY_SLOT.get((name, s), 0)
                       for s in range(k)]
                for name in ("decode_block", "fused_row_counts")}
        # only this rank's shards were stacked, cut over its slots
        for (_index, _keys, shards), entry in list(
                ex.stacked._stack_cache.items()):
            assert all(lo <= s < hi for s in shards), shards
            assert all(b.slot < k and b.device == devices[b.slot]
                       for b in entry[1])
        ex.close()
    close_distributed()
    print("ANSWERS " + json.dumps(answers), flush=True)
    print(f"MULTIHOST OK rank={rank}", flush=True)
    return 0


# -- the test ------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@functools.lru_cache(maxsize=1)
def references() -> tuple:
    """(queries, oracle, JAX answers) over every shard, then over
    ``SUBSET``; the oracle and the JAX package must agree."""
    data = corpus()
    queries = QUERIES + [column_query(data[1])]
    want = oracle(*data, queries)
    want_sub = oracle(*data, QUERIES, shards=SUBSET)
    from pilosa_tpu.executor import Executor as JaxExecutor
    from pilosa_tpu.storage import FieldOptions as JaxFieldOptions
    from pilosa_tpu.storage import Holder as JaxHolder
    rows, cols, vcols, vvals = data
    h = JaxHolder(None)
    idx = h.create_index("mh", track_existence=False)
    idx.create_field("f").import_bits(rows, cols)
    idx.create_field("v", JaxFieldOptions(type="int", min=0, max=1000)
                     ).import_values(vcols, vvals)
    ex = JaxExecutor(h, use_mesh=True)
    try:
        jax_want = [norm(ex.execute("mh", q)) for q in queries]
        jax_sub = [norm(ex.execute("mh", q, shards=SUBSET))
                   for q in QUERIES]
    finally:
        ex.close()
    assert jax_want == want
    assert jax_sub == want_sub
    return queries, want, want_sub


@functools.lru_cache(maxsize=None)
def run_ranks(slots: tuple) -> list:
    """Run one rank process a slot count of ``slots``; returns each
    rank's ``ANSWERS`` record after the parent's references agree (one
    run a layout, which the tests below share)."""
    port = _free_port()
    env = dict(os.environ)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r),
         str(len(slots)), ",".join(map(str, slots))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(len(slots))]
    outs = []
    try:
        references()          # the parent's references while the ranks run
        for p in procs:
            try:
                out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"MULTIHOST OK rank={r}" in out, out[-2000:]
        line = next(x for x in out.splitlines() if x.startswith("ANSWERS "))
        recs.append(json.loads(line[len("ANSWERS "):]))
    return recs


@pytest.mark.parametrize("slots", [(1, 1), (2, 3), (3, 1)],
                         ids=["slots-1-1", "slots-2-3", "slots-3-1"])
def test_two_rank_engine_matches_oracle_and_jax(slots):
    """Every rank's answers, dense and compressed, over every shard and
    over ``SUBSET``, equal the oracle and the JAX executor's."""
    recs = run_ranks(slots)
    queries, want, want_sub = references()
    for r, got in enumerate(recs):
        for residency in ("dense", "compressed"):
            for q, g, w in zip(queries, got[residency], want):
                assert g == w, (slots, r, residency, q)
            for q, g, w in zip(QUERIES, got[residency + "_subset"],
                               want_sub):
                assert g == w, (slots, r, residency, "subset", q)


def test_grouped_mesh_launches_both_kernels_in_every_slot():
    """A grouped executor on a device list calls both kernel wrappers in
    every slot of every rank on the compressed corpus; a rank of one
    slot counts under slot 0."""
    slots = (2, 3)
    for r, got in enumerate(run_ranks(slots)):
        calls = got["calls_by_slot"]
        for name in ("decode_block", "fused_row_counts"):
            assert len(calls[name]) == slots[r]
            assert all(n > 0 for n in calls[name]), (r, name, calls)


if __name__ == "__main__":
    sys.exit(rank_main(int(sys.argv[1]), int(sys.argv[2]),
                       int(sys.argv[3]),
                       [int(x) for x in sys.argv[4].split(",")]))
