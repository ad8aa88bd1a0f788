"""The span readers (``portbench/spans.py`` and the ``program_span``
metrics): a traced CPU run of the cut table gives a number for each,
its requests' ``api.Query`` spans time what the harness times, and a
port whose tracer has no sink gives none and does not raise."""

import json
import statistics
from pathlib import Path

import pytest

from portbench import mix as mixmod, run, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = BENCH["workloads"][0]
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] == "program_span"]
TINY = 2 * (1 << 20) + 12345
SEED = 3_000_000_019


def _run(trace=True):
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{CELL['config']}.json").read_text())
    return run.run_cell(CELL, cfg, mixmod.load(CELL["traffic"]), SEED, 1.5,
                        trace, device="cpu", facts=TINY,
                        metric_names=[m["name"] for m in BENCH["per_layer"]],
                        log=lambda *a: None)


def test_four_span_metrics_are_declared():
    assert sorted(SPAN_METRICS) == ["batcher_queue_ms", "device_wait_ms",
                                    "host_self_ms", "padded_row_share"]


def test_traced_run_reads_the_spans():
    from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER
    seen: list = []
    GLOBAL_TRACER.add_sink(seen)
    try:
        out = _run()
    finally:
        GLOBAL_TRACER.remove_sink(seen)
    assert out["correct"]
    for m in SPAN_METRICS:
        assert isinstance(out["layer"].get(m), float), (m, out["layer"])
    assert 0.0 <= out["layer"]["padded_row_share"] < 100.0
    assert out["layer"]["host_self_ms"] > 0.0
    # the window's requests are the last api.Query spans: the root
    # covers the request as the client times it
    n = out["info"]["requests"]
    roots = sorted((s for s in seen if s["name"] == "api.Query"),
                   key=lambda s: s["start"])[-n:]
    span_p50 = statistics.median(s["durationMS"] for s in roots)
    p50 = out["info"]["tail"]["p50_ms"]
    assert abs(span_p50 - p50) <= max(0.02 * p50, 0.5), (span_p50, p50)


def test_no_sink_reads_nothing(monkeypatch):
    from pilosa_tpu_torch.utils import tracing
    monkeypatch.delattr(tracing.Tracer, "add_sink")
    out = _run()
    assert out["correct"]
    for m in SPAN_METRICS:
        assert m not in out["layer"]


def test_readers_share_one_sink(monkeypatch):
    from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER
    monkeypatch.setattr(GLOBAL_TRACER, "_sinks", ())
    r = run.Run({}, {}, "cpu", 1)
    names = ("a", "b", "c")
    assert [spans.window(r, n) for n in names] == [None] * 3
    assert len(GLOBAL_TRACER._sinks) == 1
    with GLOBAL_TRACER.span("in"):
        pass
    got = [spans.window(r, n) for n in names]
    assert GLOBAL_TRACER._sinks == ()
    assert got[0] is got[1] is got[2]
    assert [s["name"] for s in got[0]] == ["in"]
    with GLOBAL_TRACER.span("out"):
        pass
    assert len(got[0]) == 1


def _span(name, trace, start, ms, **tags):
    return {"name": name, "traceID": trace, "spanID": f"{name}{start}",
            "parentID": None, "start": start, "durationMS": ms,
            "tags": tags}


def test_request_arithmetic():
    window = [
        _span("api.Query", "a", 0.0, 100.0),
        _span("batcher.submit", "a", 0.010, 50.0),
        _span("batcher.queue", "a", 0.011, 2.0),
        _span("executor.fetch", "a", 0.070, 25.0),
        _span("executor.fetch", "a", 0.090, 5.0),   # overlaps the last
        _span("api.Query", "b", 0.0, 10.0),
        _span("batcher.launch", "b", 0.001, 1.0, batchRows=3,
              paddedRows=4),
        _span("batcher.launch", "x", 0.001, 1.0, batchRows=4,
              paddedRows=4),
        _span("executor.fetch", "x", 0.0, 3.0),    # no api.Query: no request
    ]
    reqs = spans.requests(window)
    assert len(reqs) == 2
    a = next(r for r in reqs if r["api.Query"][0]["traceID"] == "a")
    assert spans.total_ms(a, "executor.fetch") == 30.0
    assert spans.covered_ms(a, ("batcher.submit", "executor.fetch")) == \
        pytest.approx(75.0)
    host = run._load("metrics", "host_self_ms")
    assert host.read(None, None, window) == pytest.approx(
        statistics.median([25.0, 10.0]))
    wait = run._load("metrics", "device_wait_ms")
    # a: its launch (submit less queue) and its fetches; b: neither
    assert wait.read(None, None, window) == pytest.approx(
        statistics.median([50.0 - 2.0 + 30.0, 0.0]))
    queue = run._load("metrics", "batcher_queue_ms")
    assert queue.read(None, None, window) == pytest.approx(1.0)
    padded = run._load("metrics", "padded_row_share")
    assert padded.read(None, None, window) == pytest.approx(12.5)
    assert padded.read(None, None, None) is None
