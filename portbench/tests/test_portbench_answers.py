"""The generators, the reference and the port agree at a tiny size on
the CPU; the control and the planted faults come out as not correct."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import encode, mix as mixmod, run
from portbench.reference.histogram import build
from portbench.reference.pql import Evaluator, parse

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = BENCH["workloads"]
CPU = torch.device("cpu")
TINY = 2 * (1 << 20) + 12345        # two full shards and a partial one
SEED = 3_000_000_019                # above 2**31, as the driver's are


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _blocks(name, seed, facts=TINY):
    cfg = _cfg(name)
    gen = run._load("gen", cfg["name"])
    return cfg, list(gen.blocks(cfg, seed, CPU, facts))


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_repeats_from_its_seed(name):
    cfg, a = _blocks(name, SEED)
    _, b = _blocks(name, SEED)
    _, c = _blocks(name, SEED + 1)
    assert sum(x.n_facts for x in a) == TINY
    for x, y in zip(a, b):
        for k in x.columns:
            assert torch.equal(x.columns[k], y.columns[k])
    assert any(not torch.equal(x.columns[k], y.columns[k])
               for x, y in zip(a, c) for k in x.columns)
    for f in cfg["fields"]:
        col = torch.cat([x.columns[f["name"]] for x in a])
        hi = f["rows"] if f["type"] == "set" else f["max"] + 1
        assert int(col.min()) >= 0 and int(col.max()) < hi


def _brute(cfg, words, text):
    """Answers from the fragment words themselves (numpy popcounts)."""
    fields = {f["name"]: f for f in cfg["fields"]}

    def pop(w):
        return int(np.bitwise_count(w.view(np.uint32)).sum())

    def bitmap(c):
        if c.name == "Row":
            (f, v), = c.kwargs.items()
            return words[(f, "standard")][:, v]
        out = bitmap(c.args[0])
        for a in c.args[1:]:
            out = (out & bitmap(a)) if c.name == "Intersect" \
                else (out | bitmap(a))
        return out

    def filt(args):
        calls = [a for a in args if hasattr(a, "name") and a.name != "Rows"]
        if not calls:
            n = next(iter(words.values())).shape
            return np.full((n[0], n[2]), -1, dtype=np.int32)
        return bitmap(calls[0])

    out = []
    for c in parse(text):
        if c.name == "Count":
            out.append(pop(bitmap(c.args[0])))
        elif c.name == "Sum":
            f = c.kwargs["field"]
            w = words[(f, "bsig_" + f)]
            m = filt(c.args) & w[:, encode.EXISTS_ROW]
            val = sum(pop(m & w[:, encode.OFFSET_ROW + i]) << i
                      for i in range(w.shape[1] - encode.OFFSET_ROW))
            out.append({"value": val, "count": pop(m)})
        elif c.name == "TopN":
            f, m = c.args[0], filt(c.args[1:])
            counts = [pop(words[(f, "standard")][:, r] & m)
                      for r in range(fields[f]["rows"])]
            order = sorted((r for r in range(len(counts)) if counts[r]),
                           key=lambda r: (-counts[r], r))[:c.kwargs["n"]]
            out.append([{"id": r, "count": counts[r]} for r in order])
        elif c.name == "GroupBy":
            fs = [a.args[0] for a in c.args if a.name == "Rows"]
            m = filt(c.args)
            grid = []
            for combo in np.ndindex(*(fields[f]["rows"] for f in fs)):
                w = m
                for f, r in zip(fs, combo):
                    w = w & words[(f, "standard")][:, r]
                if pop(w):
                    grid.append({"group": [{"field": f, "rowID": int(r)}
                                           for f, r in zip(fs, combo)],
                                 "count": pop(w)})
            out.append(grid)
    return out


# Shapes the reader answers that no committed mix sends yet, drawn over
# the taxi table's fields.
OTHER_SHAPES = {"clients": 2, "shuffle": True, "deck": [
    {"name": "count", "copies": 4,
     "pql": "Count(Intersect(Row(cab_type={cab_type}), "
            "Row(pickup_year={pickup_year})))"},
    {"name": "union", "copies": 4,
     "pql": "Count(Union(Row(passenger_count={passenger_count}), "
            "Row(pickup_year={pickup_year})))"},
    {"name": "topn", "copies": 4,
     "pql": "TopN(passenger_count, Row(cab_type={cab_type}), n=5)"},
    {"name": "grid", "copies": 2,
     "pql": "GroupBy(Rows(cab_type), Rows(pickup_year), "
            "Row(passenger_count={passenger_count}))"},
    {"name": "sum", "copies": 2,
     "pql": "Sum(Intersect(Row(cab_type={cab_type}), "
            "Row(pickup_year={pickup_year})), field=total_amount)"}]}


def _brute_checks(cfg_name, mix):
    cfg, blocks = _blocks(cfg_name, SEED)
    parts = [encode.block_words(cfg, b) for b in blocks]
    words = {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}
    ev = Evaluator(build(cfg, blocks))
    seen = set()
    for _name, q in mixmod.deck(mix, cfg, SEED):
        if q in seen or len(seen) >= 24:
            continue
        seen.add(q)
        assert ev.request(q) == _brute(cfg, words, q), q


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_reference_agrees_with_a_brute_force_count(cell):
    _brute_checks(cell["config"], mixmod.load(cell["traffic"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_on_shapes_no_mix_sends_yet(name):
    _brute_checks(name, OTHER_SHAPES)


def test_uniform_draws_and_shuffle_repeat_from_the_seed():
    cfg = _cfg(CONFIGS[0])
    a = mixmod.deck(OTHER_SHAPES, cfg, SEED)
    assert a == mixmod.deck(OTHER_SHAPES, cfg, SEED)
    assert a != mixmod.deck(OTHER_SHAPES, cfg, SEED + 1)
    assert sorted(n for n, _ in a) == sorted(
        t["name"] for t in OTHER_SHAPES["deck"] for _ in range(t["copies"]))


@pytest.mark.parametrize("bad", [
    {"loop": "open"},
    {"deck": [{"name": "q", "draw": "zipf", "pql": "Count(Row(cab_type=0))"}]},
    {"deck": [{"name": "q", "rate": 5, "pql": "Count(Row(cab_type=0))"}]},
])
def test_a_mix_with_keys_the_harness_does_not_read_is_refused(bad, tmp_path,
                                                              monkeypatch):
    mix = dict(clients=1, shuffle=False,
               deck=[{"name": "q", "pql": "Count(Row(cab_type=0))"}])
    mix.update(bad)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "x.json").write_text(json.dumps(mix))
    monkeypatch.setattr(mixmod, "HERE", tmp_path)
    with pytest.raises(ValueError):
        mixmod.deck(mixmod.load("x"), _cfg(CONFIGS[0]), SEED)


def _run(cell, seconds=1.5, device="cpu", facts=TINY, trace=False):
    cfg = _cfg(cell["config"])
    mix = mixmod.load(cell["traffic"])
    names = [m["name"] for m in BENCH["per_layer"]]
    return run.run_cell(cell, cfg, mix, SEED, seconds, trace,
                        device=device, facts=facts, metric_names=names,
                        log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_the_port_answers_as_the_reference_does(cell):
    dev = "cpu" if cell["chips"] == 1 else ["cpu"] * cell["chips"]
    out = _run(cell, device=dev)
    assert out["attempted"] > 0
    assert out["checks"]["wrong_answers"]["value"] == 0, out["info"]
    assert out["checks"]["failed_requests"]["value"] == 0, out["info"]
    assert out["correct"]


def test_traced_run_reads_the_counters():
    out = _run(CELLS[0], trace=True)
    assert out["correct"]
    for m in ("wq_fallback_share", "batch_occupancy", "resident_mb"):
        assert m in out["layer"], out["layer"]
    # no card: nothing may stand under a device metric
    assert "kernel_roofline_share" not in out["layer"]
    assert "device_idle_share" not in out["layer"]


def test_run_path_loads_no_jax_and_reference_no_port():
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import torch
from portbench import run
cfg = json.load(open({str(ROOT / 'portbench/configs')!r} + '/' + {CELLS[0]['config']!r} + '.json'))
gen = run._load('gen', cfg['name'])
ref = run._load('reference', cfg['name'])
ev = ref.evaluator(cfg, gen.blocks(cfg, 7, torch.device('cpu'), 5000))
top = {{m.split('.')[0] for m in sys.modules}}
print(json.dumps(sorted(top & {{'jax', 'jaxlib', 'flax', 'pilosa_tpu', 'pilosa_tpu_torch'}})))
bench, cell, cfg, mix = run.load_cell({CELLS[0]['name']!r})
run.run_cell(cell, cfg, mix, 7, 0.5, False, device='cpu', facts=5000, log=lambda *a: None)
top = {{m.split('.')[0] for m in sys.modules}}
print(json.dumps(sorted(top & {{'jax', 'jaxlib', 'flax', 'pilosa_tpu'}})))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []      # the reference: no port, no JAX
    assert json.loads(lines[-1]) == []      # the run path: no JAX


def test_control_fails_at_the_cells_sizes():
    """float32 counting gets the taxi sums wrong; int64 gets them
    right."""
    cfg, blocks = _blocks("nyc-taxi-1b", SEED)
    ref = Evaluator(build(cfg, blocks))
    control = Evaluator(build(cfg, blocks, torch.float32))
    deck = mixmod.deck(mixmod.load("q1-q3"), cfg, SEED)
    assert sum(control.request(q) != ref.request(q) for _, q in deck) > 0


def _plant(monkeypatch, kind):
    from pilosa_tpu_torch.executor import executor as exmod
    orig = exmod.Executor.execute

    def half(self, index, query, shards=None, **kw):
        idx = self.holder.index(index)
        every = sorted(idx.available_shards())
        out = orig(self, index, query, every[::2], **kw)
        return [r * 2 if isinstance(r, int) else r for r in out]

    def altered(self, index, query, shards=None, **kw):
        out = orig(self, index, query, shards, **kw)
        r = out[0]
        if isinstance(r, int):
            out[0] = r + 1
        elif isinstance(r, list) and r:
            r[0].count += 1
        elif hasattr(r, "val"):
            r.val += 1
        return out

    monkeypatch.setattr(exmod.Executor, "execute",
                        {"half": half, "altered": altered}[kind])


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    _plant(monkeypatch, kind)
    dev = "cpu" if cell["chips"] == 1 else ["cpu"] * cell["chips"]
    out = _run(cell, seconds=1.0, device=dev)
    assert out["attempted"] > 0
    assert not out["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_control_on_the_card(cell, card):
    from portbench import control
    cfg = _cfg(cell["config"])
    gen = run._load("gen", cfg["name"])
    rec = control.readings(cfg, mixmod.load(cell["traffic"]), gen, SEED,
                           card, 1000)
    assert rec["wrong_answers"] > 0


@pytest.mark.parametrize("config,pql,rows", [
    ("nyc-taxi-1b", "Count(Intersect(Row(cab_type=1), Row(pickup_year=2)))",
     2),
    ("nyc-taxi-1b", "TopN(passenger_count, Row(cab_type=0), n=5)", 11),
    ("nyc-taxi-1b", "GroupBy(Rows(cab_type))", 2),
    ("nyc-taxi-1b", "Sum(Row(passenger_count=1), field=total_amount)", 19),
    ("nyc-taxi-1b", "GroupBy(Rows(passenger_count), Rows(pickup_year))", 17),
])
def test_cost_counts_each_input_row_once(config, pql, rows):
    from portbench import cost
    cfg = _cfg(config)
    assert cost.rows_read(pql, cfg) == rows
    pk = cost.peaks("NVIDIA H100 80GB HBM3")
    words = rows * -(-cfg["facts"] // 32)
    assert cost.least_seconds(pql, cfg, pk) == 4 * words / 3.35e12
