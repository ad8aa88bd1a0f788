"""BENCHMARK.json keeps to the contract's shapes, and every cell's files
are found by name."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "portbench"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for r in e.get("reduced", []):
            assert NAME.match(r)


def test_metric_rules():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
        # the harness reports every metric in every cell: a reader with
        # nothing to read returns None, so no entry lists its cells
        assert "workloads" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg_entry = next(c for c in BENCH["configs"]
                     if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert cfg["name"] == cell["config"]
    assert cell["chips"] in (1, 4)
    assert (PB / "gen" / f"{cfg['name']}.py").is_file()
    assert (PB / "reference" / f"{cfg['name']}.py").is_file()
    assert (PB / "traffic" / f"{cell['traffic']}.json").is_file()
    from portbench import mix as mixmod
    assert mixmod.deck(mixmod.load(cell["traffic"]), cfg, 1)
    for key in ("source", "reduced", "assumed", "guarantees"):
        assert key in cfg
    assert cfg["guarantees"]["answers"] == "exact"


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    src = (PB / "metrics" / f"{metric['name']}.py").read_text()
    assert "def read(" in src


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    p for p in PB.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_in_the_harness(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "pilosa_tpu"}


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "pilosa_tpu",
                                 "pilosa_tpu_torch"}
