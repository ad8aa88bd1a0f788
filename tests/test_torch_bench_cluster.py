"""The port bench's cluster and robustness legs
(``python -m pilosa_tpu_torch.bench --leg config5d``, ``routing``,
``chaos``, ``slo``, ``wire``, ``tenant``, ``cache``, ``overload``,
``observability``, ``restart``) against the JAX package's ``bench.py``.

- Draws: each leg's data and corpus equal a copy, kept here, of the loop
  ``bench.py`` runs for the same leg, drawn from one seed.  No JAX test
  module is imported.
- ``BitsOracle``, which checks the robustness legs' answers, equals the
  JAX ``Executor(use_mesh=True)`` on the legs' query shapes.
- A differential: the config-5d leg at 8 shards runs through the port's
  four CPU nodes, and every reply it checks is also held against the JAX
  executor over a holder with the same words.
- One case a leg: ``bench.run(["--smoke", "--device", "cpu", "--leg",
  NAME])`` in-process passes and reports the leg's answer and behaviour
  gates (its timing gates are the card's: "skipped on cpu").
- A wrong 5d oracle fails the run, naming the leg on stderr.
- Hedges rescue sequential reads from a straggler whose abandoned RPCs
  fill the fan-out pool (the port's dedicated hedge pool).

Every answer comparison is exact.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH as JAX_SHARD_WIDTH  # noqa: E402
from pilosa_tpu.core import SHARD_WORDS as JAX_SHARD_WORDS  # noqa: E402
from pilosa_tpu.core import VIEW_STANDARD as JAX_VIEW  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server.handler import serialize_result  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch import bench, cfg5  # noqa: E402

SEED = 7
SHARDS_5D = 8


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the legs' client and server threads each
    run torch ops, and beside other test workers a full pool per thread
    spins against the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- copies of bench.py's draws ---------------------------------------------------

def _cfg5_batch(rng, B):
    """bench.py :405-412."""
    aa = rng.integers(0, 4, size=B)
    bb = (aa + 1 + rng.integers(0, 3, size=B)) % 4
    return " ".join(
        f"TopN(metric, Intersect(Row(seg={a}), Row(seg={b})), n=5)"
        for a, b in zip(aa, bb))


def jax_5d_draws(rng, n_shards):
    """bench.py :898-906 (words), :914-926 (a warm batch a node) and
    :955-961 (the mixed workload)."""
    words = {}
    for shard in range(n_shards):
        a = rng.integers(0, 1 << 32, size=(12, JAX_SHARD_WORDS),
                         dtype=np.uint32)
        b = rng.integers(0, 1 << 32, size=(12, JAX_SHARD_WORDS),
                         dtype=np.uint32)
        w = a & b
        w[4:] &= np.roll(b[4:], 7, axis=1)
        words[shard] = w
    warm = [_cfg5_batch(rng, 64) for _ in range(4)]
    mixed = [_cfg5_batch(rng, 4) for _ in range(12)]
    for i in range(16):
        a = int(rng.integers(0, 4))
        b = (a + 1 + int(rng.integers(0, 3))) % 4
        mixed.append(
            f"Count(Intersect(Row(seg={a}), Row(seg={b})))"
            if i % 2 else f"Row(seg={a})")
    return words, warm, mixed


def port_5d_draws(rng, n_shards):
    words = dict(cfg5.dist_words(rng, n_shards))
    warm = [cfg5._cfg5_batch(rng, 64) for _ in range(4)]
    return words, warm, bench.mixed5d(rng)


def jax_routing_draws(rng, n_cold_shards=6, wave_q=64, hot_bits=6000,
                      cold_bits=4000):
    """bench.py :1095-1123."""
    sets = []
    for name, n_shards, n_bits in (("hotidx", 2, hot_bits),
                                   ("coldidx", n_cold_shards, cold_bits)):
        cols = np.unique(rng.integers(0, n_shards * JAX_SHARD_WIDTH,
                                      size=n_bits))
        rows = rng.integers(0, 8, size=cols.size)
        sets.append((rows, cols))

    def gen_q():
        a = int(rng.integers(0, 8))
        b = (a + 1 + int(rng.integers(0, 6))) % 8
        hot = rng.random() < 0.8
        idx = "hotidx" if hot else "coldidx"
        kind = int(rng.integers(0, 4))
        if kind == 0:
            q = f"Count(Intersect(Row(a={a}), Row(a={b})))"
        elif kind == 1:
            q = f"Count(Row(a={a}))"
        elif kind == 2:
            q = f"Row(a={a})"
        else:
            q = "TopN(a, n=0)"
        return idx, q

    return sets, [gen_q() for _ in range(wave_q)]


def port_routing_draws(rng, n_cold_shards=6, wave_q=64, hot_bits=6000,
                       cold_bits=4000):
    sets = [bench.draw_set(rng, 2, hot_bits, 8),
            bench.draw_set(rng, n_cold_shards, cold_bits, 8)]
    return sets, bench.routing_corpus(rng, wave_q)


def jax_unique_set(rng, n_shards, n_bits, n_rows):
    """The chaos (:1265-1267, 5000 bits, 8 rows), SLO (:1431-1433, 3000,
    4; :1503-1504, 2 shards, 4000, 4) and tenant (:1865-1866, 8000, 8)
    legs' draw."""
    cols = np.unique(rng.integers(0, n_shards * JAX_SHARD_WIDTH,
                                  size=n_bits))
    rows = rng.integers(0, n_rows, size=cols.size)
    return rows, cols


def jax_wire_draws(rng, n_shards=4, dense_rows=6, dense_bits=320000,
                   sparse_rows=6, sparse_run=3000, wave_q=48):
    """bench.py :1651-1695."""
    span = n_shards * JAX_SHARD_WIDTH
    dense, sparse = [], []
    for r in range(dense_rows):
        dense.append(np.unique(rng.integers(0, span, size=dense_bits)))
    for r in range(sparse_rows):
        sparse.append(np.concatenate([
            np.arange(s * JAX_SHARD_WIDTH + r * sparse_run,
                      s * JAX_SHARD_WIDTH + (r + 1) * sparse_run)
            for s in range(n_shards)]))

    def gen_dense():
        a = int(rng.integers(0, dense_rows))
        b = (a + 1 + int(rng.integers(0, dense_rows - 1))) % dense_rows
        kind = int(rng.integers(0, 3))
        if kind == 0:
            q = f"Row(a={a})Row(a={b})"
        elif kind == 1:
            q = f"Union(Row(a={a}), Row(a={b}))Count(Row(a={a}))"
        else:
            q = f"Row(a={a})Intersect(Row(a={a}), Row(a={b}))"
        return "w1", q

    def gen_sparse():
        a = int(rng.integers(0, sparse_rows))
        b = (a + 1) % sparse_rows
        return "qx", f"Row(a={a})Row(a={b})"

    dense_corpus = [gen_dense() for _ in range(wave_q)]
    sparse_corpus = [gen_sparse() for _ in range(wave_q)]
    return dense, sparse, dense_corpus, sparse_corpus


def port_wire_draws(rng, n_shards=4, dense_rows=6, dense_bits=320000,
                    sparse_rows=6, sparse_run=3000, wave_q=48):
    bits = bench.wire_bits(rng, n_shards, dense_rows, dense_bits,
                           sparse_rows, sparse_run)
    return (bits["w1"], bits["qx"],
            bench.wire_dense_corpus(rng, wave_q, dense_rows),
            bench.wire_sparse_corpus(rng, wave_q, sparse_rows))


DRAWS = {
    "config5d": (lambda rng: jax_5d_draws(rng, 3),
                 lambda rng: port_5d_draws(rng, 3)),
    "routing": (jax_routing_draws, port_routing_draws),
    "routing_smoke": (
        lambda rng: jax_routing_draws(rng, 4, 24, 2500, 1500),
        lambda rng: port_routing_draws(rng, 4, 24, 2500, 1500)),
    "chaos": (lambda rng: jax_unique_set(rng, 8, 5000, 8),
              lambda rng: bench.draw_set(rng, 8, 5000, 8)),
    "slo": (lambda rng: (jax_unique_set(rng, 6, 3000, 4),
                         jax_unique_set(rng, 2, 4000, 4)),
            lambda rng: (bench.draw_set(rng, 6, 3000, 4),
                         bench.draw_set(rng, 2, 4000, 4))),
    "wire": (jax_wire_draws, port_wire_draws),
    "wire_smoke": (
        lambda rng: jax_wire_draws(rng, dense_rows=4, dense_bits=240000,
                                   sparse_run=1500, wave_q=16),
        lambda rng: port_wire_draws(rng, dense_rows=4, dense_bits=240000,
                                    sparse_run=1500, wave_q=16)),
    "tenant": (lambda rng: jax_unique_set(rng, 4, 8000, 8),
               lambda rng: bench.draw_set(rng, 4, 8000, 8)),
}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("leg", sorted(DRAWS))
def test_draws_equal_bench_py(leg):
    jax_fn, port_fn = DRAWS[leg]
    want = jax_fn(np.random.default_rng(SEED))
    got = port_fn(np.random.default_rng(SEED))
    _assert_same(got, want)
    if leg == "config5d":
        assert len(got[2]) == 28 and sum(q.startswith("Row(")
                                         for q in got[2]) == 8


# -- the oracle of the robustness legs --------------------------------------------

def test_bits_oracle_equals_jax():
    """``BitsOracle`` against the JAX executor on the routing, chaos,
    tenant, SLO and wire query shapes over one drawn field."""
    rows, cols = bench.draw_set(np.random.default_rng(SEED), 3, 6000, 8)
    h = JaxHolder(None)
    h.create_index("o", track_existence=False).create_field("a") \
        .import_bits(rows, cols)
    oracle = bench.BitsOracle(rows, cols)
    rng = np.random.default_rng(1)
    queries = [q for _i, q in bench.routing_corpus(rng, 24)]
    queries += [q for _i, q in bench.wire_dense_corpus(rng, 8, 6)]
    queries += ["TopN(a, n=0)", "TopN(a, n=3)", "Row(a=4)",
                "Count(Intersect(Row(a=1), Row(a=2)))", "Row(a=99)",
                "Count(Row(a=3)) Row(a=5)Union(Row(a=0), Row(a=7))"]
    ex = JaxExecutor(h, use_mesh=True)
    try:
        for q in queries:
            want = [serialize_result(r) for r in ex.execute("o", q)]
            assert oracle.answer(q) == want, q
    finally:
        ex.close()


# -- the legs, in-process ---------------------------------------------------------

def _jax_dist(words):
    h = JaxHolder(None)
    idx = h.create_index("dist", track_existence=False)
    views = [idx.create_field(f)._create_view_if_not_exists(JAX_VIEW)
             for f in ("seg", "metric")]
    for shard, w in words.items():
        seg = views[0].create_fragment_if_not_exists(shard)
        met = views[1].create_fragment_if_not_exists(shard)
        for r in range(cfg5.SEG_ROWS):
            seg.set_row(r, w[r])
        for r in range(cfg5.METRIC_ROWS):
            met.set_row(r, w[cfg5.SEG_ROWS + r])
    return JaxExecutor(h, use_mesh=True)


@pytest.fixture(scope="module")
def run5d():
    """The config-5d leg at 8 shards; every reply its oracle checks is
    also held against the JAX executor over the same words."""
    real_init = bench.Dist5dOracle.__init__
    real_check = bench.Dist5dOracle.check
    state = {"checked": 0, "want": {}, "queries": set()}

    def init(self, words):
        real_init(self, words)
        state["ex"] = _jax_dist(words)

    def check(self, leg, label, pql, body):
        real_check(self, leg, label, pql, body)
        if pql not in state["want"]:
            state["want"][pql] = state["ex"].execute("dist", pql)
        got = bench.parse_results(body)
        want = state["want"][pql]
        assert len(got) == len(want), label
        for g, w in zip(got, want):
            if isinstance(g, dict):
                np.testing.assert_array_equal(g["columns"], w.columns())
            else:
                assert g == serialize_result(w), (label, pql)
        state["checked"] += 1
        state["queries"].add(pql)

    mp = pytest.MonkeyPatch()
    mp.setattr(bench.Dist5dOracle, "__init__", init)
    mp.setattr(bench.Dist5dOracle, "check", check)
    try:
        out = bench.run(["--smoke", "--device", "cpu", "--leg",
                         "config5d"])
    finally:
        mp.undo()
        if "ex" in state:
            state["ex"].close()
    return out, state


def test_config5d_replies_equal_jax(run5d):
    out, state = run5d
    rec = out["configs"]["5d_intersect_topn_4node_cluster"]
    assert rec["shards"] == SHARDS_5D == bench.SMOKE.cfg5d_shards
    # 4 warm batches, the gate, 28 mixed queries, 2 untimed and
    # `repeats` timed passes of the corpus
    n = 4 + 1 + 28 + (2 + bench.SMOKE.repeats) * rec["corpus_queries"]
    assert state["checked"] == n
    kinds = {q.split("(")[0] for q in state["queries"]}
    assert kinds == {"TopN", "Count", "Row"}


GATES = {
    "config5d": lambda r: (
        r["answers"] == "pass" and r["gate"] == "pass"
        and r["corpus_queries"] >= 28 and r["corpus_rows"] == 8
        and r["truncated_skipped"] == 0 and r["calls_per_s"] > 0
        and r["breakdown_avg_ms"]["peer_exec"] is not None
        and r["reduced"]["shards"] == SHARDS_5D),
    "routing": lambda r: r["answers_identical"] and r["hot_shard_nodes"] > 1,
    "chaos": lambda r: (r["answers_identical"] and r["hedges"] > 0
                        and r["timing_gates"] == "skipped on cpu"),
    "slo": lambda r: (
        r["alert"]["fired"] and r["alert"]["evals_to_fire"] <= 2
        and r["alert"]["bundle_ok"] and r["alert"]["bundle_kb"] > 0
        and r["alert"]["budget_held"] and r["alert"]["resolved"]
        and r["answers_identical"] and r["evaluations_on"] > 0
        and r["qps_gate"] == "skipped on cpu"),
    "wire": lambda r: (r["answers_identical"]
                       and r["sparse_bytes_ratio"] > 1.5
                       and r["fallback"]["count"] >= 1),
    "tenant": lambda r: (
        r["answers_identical"] and r["isolation_on"]["fair"] is True
        and r["isolation_off"]["fair"] is False
        and r["isolation_on"]["total_sheds"] > 0
        and r["isolation_on"]["shed_attribution"] >= 0.95
        and r["isolation_on"]["polite_sheds"] == 0),
    "cache": lambda r: (r["answers"] == "pass" and r["hit_ratio"] == 1.0
                        and r["speedup_gate"] == "skipped on cpu"),
    "overload": lambda r: (r["burst_200"] >= 1 and r["burst_503"] >= 1
                           and r["burst_200"] + r["burst_503"] == 8),
    "observability": lambda r: (
        r["profile_stages"] > 0 and r["trace_spans"] > 0
        and r["slow_recorded"] >= 1 and r["timeseries_samples"] > 0
        and r["overhead_gate"] == "skipped on cpu"),
    "restart": lambda r: (r["replayed"] >= 1
                          and r["retraces_during_warm"] == 0
                          and r["answers"] == "pass"),
}


def test_gates_cover_the_new_legs():
    new = [leg for leg in bench.LEGS
           if leg not in bench.BASE_LEGS
           and leg not in ("config5", "config7", "ssb")]
    assert sorted(new) == sorted(GATES)


@pytest.mark.parametrize("leg", sorted(GATES))
def test_leg_smoke(leg, request, monkeypatch):
    # the SLO and observability legs' timed windows are sized for the
    # card's timing gates, which the CPU reports and never judges: run
    # them short here (every answer is still checked)
    monkeypatch.setattr(bench, "OBS_PER_CLIENT", 8)
    monkeypatch.setattr(bench, "SMOKE", dataclasses.replace(
        bench.SMOKE, slo=dict(bench.SMOKE.slo, overhead_q=40,
                              overhead_runs=1)))
    if leg == "config5d":
        out = request.getfixturevalue("run5d")[0]
    else:
        out = bench.run(["--smoke", "--device", "cpu", "--leg", leg])
    assert out["legs"] == [leg] and out["corpus"] is None
    configs = out["configs"]
    assert sorted(configs) == sorted(bench.LEGS[leg])
    rec = configs[bench.LEGS[leg][0]]
    assert rec["failures"] == 0 and rec["attempts"] > 0
    assert GATES[leg](rec), rec


def test_hedges_rescue_reads_past_abandoned_rpcs():
    """Sequential reads to node0 with one replica's responses delayed
    2 s and a 40 ms hedge delay: every read answers well inside the
    delay.  Each read leaves the straggler's RPC running for the whole
    delay; when hedges shared the fan-out pool with those losers, a
    hedge queued behind them and ``Count(Row)`` / ``Row`` reads waited
    the delay out (the chaos leg's hedged p99 was 0.85-0.95 of the
    injected delay on the CPU, over it on the card)."""
    b = bench.Bench(torch.device("cpu"), bench.SMOKE, SEED)
    rng = np.random.default_rng(SEED)
    with b.nodes(3, proxied=(1, 2), replica_n=2, read_routing="primary",
                 hedge_delay_ms=40.0) as (servers, proxies):
        coord = servers[0].cluster
        remote = [s for s in range(8)
                  if "node0" not in coord.placement.shard_nodes("h", s)]
        assert remote
        port = servers[0].port
        rows, cols = bench.draw_set(rng, 8, 5000, 8)
        bench.load_set(port, "h", "a", rows, cols)
        oracle = bench.BitsOracle(rows, cols)
        corpus = ["Count(Intersect(Row(a=1), Row(a=2)))", "TopN(a, n=0)",
                  "Count(Row(a=3))", "Row(a=4)"]
        for q in corpus:
            bench.ask_json("hedge", oracle, port, "h", q)
        straggler = coord.placement.shard_nodes("h", remote[0])[0]
        proxies[straggler].configure("down=latency:2.0")
        lats = []
        for i in range(12):
            t0 = time.perf_counter()
            bench.ask_json("hedge", oracle, port, "h", corpus[i % 4])
            lats.append(time.perf_counter() - t0)
        proxies[straggler].heal()
    assert max(lats) < 1.0, [round(x, 3) for x in lats]


def test_cold_coordinator_first_query_is_complete():
    """A node that took no import asks its peers for their shards on its
    first query.  With its peers' responses delayed past the 40 ms
    straggler grace, that first answer must still cover every shard:
    the coordinator has no remembered map of its peers yet, so it waits
    for their polls instead of answering from the shards it holds (it
    answered 48 of 189 on a loaded host when the grace applied from the
    first query on, as it does in the JAX package)."""
    b = bench.Bench(torch.device("cpu"), bench.SMOKE, SEED)
    rng = np.random.default_rng(SEED)
    with b.nodes(3, proxied=(0, 1), replica_n=1, read_routing="primary",
                 hedge_delay_ms=40.0) as (servers, proxies):
        coord = servers[0].cluster
        index = next(name for name in (f"cold{i}" for i in range(64))
                     if "node1" in {coord.placement.shard_nodes(name, s)[0]
                                    for s in range(8)})
        rows, cols = bench.draw_set(rng, 8, 3000, 4)
        bench.load_set(servers[0].port, index, "a", rows, cols)
        oracle = bench.BitsOracle(rows, cols)
        for proxy in proxies.values():
            proxy.configure("down=latency:0.6")
        try:
            for q in ("Count(Row(a=1))", "Row(a=2)"):
                bench.ask_json("cold", oracle, servers[2].port, index, q)
        finally:
            for proxy in proxies.values():
                proxy.heal()


def test_wrong_5d_oracle_fails_the_run(monkeypatch, capsys):
    real = bench.Dist5dOracle.topn
    monkeypatch.setattr(
        bench.Dist5dOracle, "topn",
        lambda self, a, b: [dict(p, count=p["count"] + 1)
                            for p in real(self, a, b)])
    with pytest.raises(bench.LegFailed, match="differs from the oracle"):
        bench.run(["--smoke", "--device", "cpu", "--leg", "config5d"])
    assert "bench: leg config5d failed" in capsys.readouterr().err
