"""The port's bench (``python -m pilosa_tpu_torch.bench``) and its
BASELINE corpus (pilosa_tpu_torch/baseline.py) against the JAX package —
the counterpart of tests/test_bench_smoke.py.

- ``baseline.build_indexes`` draws the corpus as the JAX ``bench.py``
  ``build_indexes`` (:129-176) does.  That function takes no sizes, so
  its loop is copied below with the sizes as arguments and run on a JAX
  holder; both holders, filled from one seed at a small size, must hold
  the same words in every fragment of every index.
- Configs 1-3 and the ``grid4`` GroupBy through the port's
  ``Executor(device="cpu")``, the JAX ``Executor(use_mesh=True)`` and
  ``baseline.Oracle``: exact answers.
- ``python -m pilosa_tpu_torch.bench --smoke --device cpu`` over the
  engine and single-node serving legs as a subprocess: exit 0, their
  ``configs`` keys in the last line and each leg's answer gate passed.
- A leg whose oracle is made wrong ends the run with an error naming the
  leg: no failure is swallowed.

Every comparison is exact: answers are integers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import SHARD_WIDTH as JAX_SHARD_WIDTH  # noqa: E402
from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.storage import FieldOptions as JaxFieldOptions  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu_torch import baseline, bench, bsi64  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SIZES = baseline.Sizes(star_per_row=30_000, lang_shards=2, lang_bits=40_000,
                       grid_shards=1, grid_bits=6000, bsi_shards=2,
                       bsi_values=6000)
SEED = 7


def jax_build_indexes(h, rng, sizes: baseline.Sizes):
    """bench.py ``build_indexes`` (:129-176) on a JAX holder, its loop
    copied with the sizes as arguments (the function itself takes
    none)."""
    star = h.create_index("startrace", track_existence=False)
    stargazer = star.create_field("stargazer")
    n_rows, per_row = 64, sizes.star_per_row
    stargazer.import_bits(
        np.repeat(np.arange(n_rows), per_row),
        rng.integers(0, JAX_SHARD_WIDTH, size=n_rows * per_row))

    lang = h.create_index("lang10m", track_existence=False)
    language = lang.create_field("language")
    stars = lang.create_field("stars")
    n_bits = sizes.lang_bits
    cols3 = rng.integers(0, sizes.lang_shards * JAX_SHARD_WIDTH, size=n_bits)
    language.import_bits(rng.integers(0, 50, size=n_bits), cols3)
    stars.import_bits(rng.integers(0, 16, size=n_bits), cols3)

    grid = h.create_index("grid4", track_existence=False)
    ga = grid.create_field("a")
    gb = grid.create_field("b")
    n_g = sizes.grid_bits
    gcols = rng.integers(0, sizes.grid_shards * JAX_SHARD_WIDTH, size=n_g)
    ga.import_bits(rng.integers(0, 128, size=n_g), gcols)
    gb.import_bits(rng.integers(0, 128, size=n_g), gcols)

    bsi_idx = h.create_index("bsi64", track_existence=False)
    v = bsi_idx.create_field("v", JaxFieldOptions(type="int", min=0,
                                                  max=1_000_000))
    seg = bsi_idx.create_field("seg")
    cols4 = np.unique(rng.integers(0, sizes.bsi_shards * JAX_SHARD_WIDTH,
                                   size=sizes.bsi_values))
    vals4 = rng.integers(0, 1_000_000, size=cols4.size)
    v.import_values(cols4, vals4)
    seg.import_bits(rng.integers(0, 8, size=cols4.size), cols4)
    return {"star_rows": n_rows, "cols4": cols4, "vals4": vals4}


@pytest.fixture(scope="module")
def corpora():
    jh = JaxHolder(None)
    jmeta = jax_build_indexes(jh, np.random.default_rng(SEED), SIZES)
    ph = Holder(None)
    pmeta = baseline.build_indexes(ph, np.random.default_rng(SEED), SIZES)
    return jh, jmeta, ph, pmeta


@pytest.fixture(scope="module")
def engines(corpora):
    jh, _jmeta, ph, pmeta = corpora
    jex = JaxExecutor(jh, use_mesh=True)
    pex = Executor(ph, device="cpu")
    yield jex, pex, baseline.Oracle(ph, pmeta)
    pex.close()
    jex.close()


FRAGMENTS = [("startrace", "stargazer", "standard"),
             ("lang10m", "language", "standard"),
             ("lang10m", "stars", "standard"),
             ("grid4", "a", "standard"), ("grid4", "b", "standard"),
             ("bsi64", "v", "bsig_v"), ("bsi64", "seg", "standard")]


@pytest.mark.parametrize("index,field,view", FRAGMENTS)
def test_corpus_words_equal_jax(corpora, index, field, view):
    jh, _jmeta, ph, _pmeta = corpora
    jv = jh.field(index, field).view(view)
    pv = ph.field(index, field).view(view)
    assert sorted(jv.fragments) == sorted(pv.fragments)
    assert len(pv.fragments) > 0
    for shard, jfr in jv.fragments.items():
        np.testing.assert_array_equal(pv.fragments[shard].words, jfr.words)


def test_corpus_draws_equal_jax(corpora):
    _jh, jmeta, _ph, pmeta = corpora
    np.testing.assert_array_equal(pmeta["cols4"], jmeta["cols4"])
    np.testing.assert_array_equal(pmeta["vals4"], jmeta["vals4"])
    assert pmeta["star_rows"] == jmeta["star_rows"] == baseline.STAR_ROWS


def _both(engines, index, pql):
    jex, pex, _o = engines
    got = baseline.normalize(pex.execute(index, pql))
    want = baseline.normalize(jex.execute(index, pql))
    assert got == want, pql
    return got


def test_config1_count_row(engines):
    o = engines[2]
    rows = np.random.default_rng(1).integers(0, baseline.STAR_ROWS, size=48)
    got = _both(engines, "startrace", baseline.count_row_query(rows))
    assert got == [o.count_row(r) for r in rows]
    assert min(got) > 0


@pytest.mark.parametrize("width", [2, 3, 8])
def test_config2_count_intersect(engines, width):
    """Config 2's 8-row intersections, and 2- and 3-row ones, whose
    counts are non-zero at this density."""
    o = engines[2]
    sets = baseline.rand_rows(np.random.default_rng(width),
                              baseline.STAR_ROWS, 24)[:, :width]
    pql = " ".join("Count(Intersect(" + ", ".join(
        f"Row(stargazer={int(r)})" for r in q) + "))" for q in sets)
    if width == 8:
        assert pql == baseline.intersect8_query(sets)
    got = _both(engines, "startrace", pql)
    assert got == o.count_intersect(sets)
    assert got == [int(np.bitwise_count(np.bitwise_and.reduce(
        o.star[q], axis=0)).sum()) for q in sets]
    if width == 2:
        assert min(got) > 0


def test_config3_topn_filtered(engines):
    o = engines[2]
    rs = np.random.default_rng(3).integers(0, baseline.STARS_ROWS, size=6)
    got = _both(engines, "lang10m", baseline.topn_query(rs))
    assert got == [o.topn_filtered(r) for r in rs]
    assert all(len(g) == baseline.LANG_ROWS for g in got)


@pytest.mark.parametrize("k", [1, 7])
def test_grid4_group_by(engines, k):
    o = engines[2]
    got = _both(engines, "grid4", baseline.grid_query(k))
    assert got == [o.grid(k)]
    assert len(got[0]) > 0


def test_config4_sum_and_group_by(engines):
    o = engines[2]
    xs = [0, 123_456, 500_000, 999_999]
    got = _both(engines, "bsi64", bsi64.sum_request(xs))
    assert got == [o.sum_gt(x) for x in xs]
    got = _both(engines, "bsi64", bsi64.group_by_query(400_000))
    assert got == [o.group_by_seg(400_000)]


def test_latency_record_tail():
    """The tail is the highest sample with ten beyond it; none until it
    lies above the median."""
    rec = bench.latency_record([i / 1000 for i in range(1, 41)])
    assert rec["samples"] == 40
    assert rec["tail_pct"] == 75.0
    assert rec["tail_ms"] == pytest.approx(30.0)
    assert rec["p50_ms"] == pytest.approx(20.5)
    assert bench.latency_record([0.001] * 20)["tail_ms"] is None


# the legs of the engine path and the serving layers over one node; the
# cluster and robustness legs have their own cases in
# tests/test_torch_bench_cluster.py
ENGINE_LEGS = ("config1", "config2", "config3", "config4", "wholequery",
               "http", "ingest", "config5", "config7", "ssb")


def test_smoke_subprocess():
    """Two intra-op threads: the smoke's client threads each run torch
    ops, and beside other test workers on the same cores a full pool of
    spinning threads per client slowed it past ten minutes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    legs = [a for leg in ENGINE_LEGS for a in ("--leg", leg)]
    proc = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.bench", "--smoke",
         "--device", "cpu", *legs], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == "engine_intersect8_count_qps_1M_cols"
    assert out["unit"] == "queries/sec" and out["value"] > 0
    assert out["corpus"]["gate"] == "pass"
    configs = out["configs"]
    keys = [k for leg in ENGINE_LEGS for k in bench.LEGS[leg]]
    assert sorted(configs) == sorted(keys)
    for key in ("1_count_row_1shard", "2_intersect8_1M_cols",
                "3_topn_filtered_10M_cols", "4_bsi_sum_gt_64shards",
                "5_topn_1B_cols_resident", "5_topn_1B_cols_budgeted",
                "2_http_path", "6_http_dynamic_batching",
                "8_streaming_ingest"):
        rec = configs[key]
        assert rec["failures"] == 0, key
        assert rec["answers"].startswith(("pass", "status 200",
                                          "streamed equal")), key
    for key, subs in (("7_topn_1B_cols_sparse_compressed",
                       ("resident", "dense", "compressed")),
                      ("14_ssb_star_schema", ("resident", "compressed"))):
        for sub in subs:
            assert configs[key][sub]["answers"] == "pass", (key, sub)
        assert configs[key]["compressed"]["compressed_mb"] > 0
    for sub in ("intersect8", "bsi_sum", "topn"):
        assert configs["9_whole_query"][sub]["answers"].startswith(
            "identical on and off")
    assert configs["9_whole_query"]["single_launch"] is True
    assert configs["5_topn_1B_cols_budgeted"]["evictions"] > 0
    assert configs["3_topn_filtered_10M_cols"]["wq_fallbacks"] >= 0


def test_wrong_oracle_fails_the_run(monkeypatch, capsys):
    """A leg whose answers disagree with its oracle raises out of the
    run, naming the leg; nothing reports it as a null field."""
    real = baseline.Oracle.count_row
    monkeypatch.setattr(baseline.Oracle, "count_row",
                        lambda self, r: real(self, r) + 1)
    with pytest.raises(bench.LegFailed, match="differ from the oracle"):
        bench.run(["--smoke", "--device", "cpu", "--leg", "config1"])
    assert "bench: leg config1 failed" in capsys.readouterr().err


def test_profile_needs_a_card():
    with pytest.raises(SystemExit):
        bench.parse_args(["--device", "cpu", "--profile"])
