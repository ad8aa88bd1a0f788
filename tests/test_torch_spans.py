"""Tests of the port's request spans (pilosa_tpu_torch/utils/tracing.py
and the spans at the request's layer boundaries): the tracer's window
sink; the ``pilosa::<name>`` ranges a live span opens while
``torch.profiler`` records, and nothing while it does not; one trace a
served query, from ``api.Query`` down to the batcher's queue and launch
and the device fetch; one ``batcher.launch`` for a fused launch, naming
every ticket's trace; the padded rows of a replayed batch.

The corpus is a port holder of 3 shards (a 32-row set field and an int
field).  Every API is closed in its test, so no dispatcher thread
outlives it.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.api import API  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.storage import FieldOptions, Holder  # noqa: E402
from pilosa_tpu_torch.utils import tracing  # noqa: E402
from pilosa_tpu_torch.utils.tracing import (  # noqa: E402
    GLOBAL_TRACER, NopTracer, Tracer)

from test_torch_devobs import cpu_graphs  # noqa: E402, F401


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def holder():
    rng = np.random.default_rng(5)
    h = Holder(None)
    idx = h.create_index("s", track_existence=False)
    f = idx.create_field("f")
    f.import_bits(rng.integers(0, 32, size=4000),
                  rng.integers(0, 3 * SHARD_WIDTH, size=4000))
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
    cols = np.unique(rng.integers(0, 3 * SHARD_WIDTH, size=800))
    v.import_values(cols, rng.integers(0, 1000, size=cols.size))
    return h


@pytest.fixture
def sink():
    out: list = []
    GLOBAL_TRACER.add_sink(out)
    yield out
    GLOBAL_TRACER.remove_sink(out)


@pytest.fixture
def api(holder):
    a = API(holder, device="cpu")
    yield a
    a.executor.close()


def _traces(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["traceID"], []).append(s)
    return out


def _chain(spans, s) -> list[str]:
    """Names from ``s`` up to its trace's root."""
    by_id = {x["spanID"]: x for x in spans}
    names = []
    while s is not None:
        names.append(s["name"])
        s = by_id.get(s["parentID"])
    return names


# -- the tracer ---------------------------------------------------------------


def test_sink_takes_live_and_synthesized_spans_until_removed():
    tr = Tracer(max_spans=2)
    got: list = []
    tr.add_sink(got)
    with tr.span("live") as live:
        tr.record_span("made", live.trace_id, live.span_id, 0.002,
                       {"k": 1})
    tr.sample_rate = 0.0
    with tr.span("unsampled"):
        pass
    tr.sample_rate = 1.0
    for _ in range(3):          # past the ring's size
        with tr.span("more"):
            pass
    tr.remove_sink(got)
    with tr.span("after"):
        pass
    assert [s["name"] for s in got] == ["made", "live", "more", "more",
                                        "more"]
    assert got[0]["tags"] == {"k": 1}
    assert got[0]["parentID"] == got[1]["spanID"]
    assert abs(got[0]["durationMS"] - 2.0) < 1.0
    assert len(tr.spans()) == 2     # the ring is unchanged
    nop = NopTracer()
    nop.add_sink(got)
    with nop.span("nop"):
        pass
    assert len(got) == 5


def test_span_is_a_profiler_range_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("probe") as s:
            time.sleep(0.03)
        tr.record_span("synthesized", s.trace_id, s.span_id, 0.01)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pilosa::")]
    assert [e.name() for e in ranges] == ["pilosa::probe"]
    dur_s = (ranges[0].end_ns() - ranges[0].start_ns()) / 1e9
    assert abs(dur_s - s.duration) <= 0.1 * s.duration
    with tr.span("off"):        # the profiler is off again
        pass


def test_profiler_range_is_a_host_op_not_a_user_annotation():
    """A ``record_function`` user annotation gets a CUDA-typed mirror on
    the device's timeline; the span's range is a function-scope host op
    on its own thread, which gets none."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()

    def worker():
        with tr.span("worker"):
            torch.ones(64).sum()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with tr.span("main"):
            torch.ones(64).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pilosa::")}
    assert sorted(ranges) == ["pilosa::main", "pilosa::worker"]
    for e in ranges.values():
        assert e.device_type() == DeviceType.CPU
        assert not e.is_user_annotation()
    assert ranges["pilosa::main"].start_thread_id() != \
        ranges["pilosa::worker"].start_thread_id()


def test_profiler_off_never_enters_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    assert not tracing._torch_profiler._is_profiler_enabled
    tr = Tracer()
    with tr.span("plain") as s:
        with tr.span("child"):
            pass
    assert s.duration is not None


# -- spans of a served query --------------------------------------------------


def test_served_query_is_one_trace_down_to_the_fetch(api, sink):
    api.query("s", "Count(Row(f=3))")           # prepares the template
    sink.clear()
    api.query("s", "Count(Row(f=4))")
    traces = _traces(sink)
    root = next(s for s in sink if s["name"] == "api.Query")
    mine = traces[root["traceID"]]
    names = {s["name"] for s in mine}
    assert {"api.Query", "executor.execute", "prepared.attempt",
            "batcher.submit", "batcher.queue", "batcher.launch",
            "executor.fetch"} <= names, names
    assert "dispatch.fused_launch" not in {s["name"] for s in sink}
    for name in ("prepared.attempt", "batcher.submit", "executor.fetch"):
        s = next(x for x in mine if x["name"] == name)
        assert _chain(mine, s)[-2:] == ["executor.execute", "api.Query"]
    attempt = next(s for s in mine if s["name"] == "prepared.attempt")
    assert attempt["tags"]["outcome"] == "hit"
    assert attempt["tags"]["template"].startswith("prepared:")
    queue = next(s for s in mine if s["name"] == "batcher.queue")
    launch = next(s for s in mine if s["name"] == "batcher.launch")
    assert queue["tags"]["launch"] == launch["spanID"]
    assert launch["tags"]["batchRows"] == 1
    assert launch["tags"]["paddedRows"] == 1
    assert launch["tags"]["tickets"] == 1
    assert launch["tags"]["traces"] == [root["traceID"]]
    fetch = next(s for s in mine if s["name"] == "executor.fetch")
    assert fetch["tags"]["bytes"] > 0
    submit = next(s for s in mine if s["name"] == "batcher.submit")
    assert queue["durationMS"] <= submit["durationMS"] \
        <= root["durationMS"]


def test_two_templates_tag_two_signatures(api, sink):
    api.query("s", "Count(Row(f=1))")
    api.query("s", "Count(Row(f=2))")
    api.query("s", "Sum(Row(f=2), field=v)")
    sigs = [s["tags"]["template"] for s in sink
            if s["name"] == "prepared.attempt"]
    assert len(sigs) == 3
    assert sigs[0] == sigs[1] != sigs[2]


def _burst(api, queries):
    gate = threading.Barrier(len(queries))
    errs = []

    def one(q):
        gate.wait()
        try:
            api.query("s", q)
        except Exception as e:  # surfaced below
            errs.append(repr(e))

    ts = [threading.Thread(target=one, args=(q,)) for q in queries]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs


def test_fused_launch_is_one_span_naming_every_trace(api, sink):
    api.query("s", "Count(Row(f=7))")
    api.executor.batcher.window_s = 0.5      # the pair fuses
    sink.clear()
    _burst(api, ["Count(Row(f=8))", "Count(Row(f=9))"])
    roots = {s["traceID"] for s in sink if s["name"] == "api.Query"}
    assert len(roots) == 2
    launches = [s for s in sink if s["name"] == "batcher.launch"]
    assert len(launches) == 1, launches
    launch = launches[0]
    assert launch["tags"]["tickets"] == 2
    assert sorted(launch["tags"]["traces"]) == sorted(roots)
    assert launch["traceID"] in roots
    traces = _traces(sink)
    for tid in roots:
        queues = [s for s in traces[tid] if s["name"] == "batcher.queue"]
        assert len(queues) == 1
        assert queues[0]["tags"]["launch"] == launch["spanID"]
    assert not any(s["name"] == "dispatch.fused_launch" for s in sink)


def test_replayed_batch_of_three_runs_four_rows(api, sink, cpu_graphs):
    qs = [f"Count(Row(f={i}))" for i in (10, 11, 12)]
    api.query("s", qs[0])
    api.executor.batcher.window_s = 0.5
    for _ in range(3):       # captured at a second sighting, then replayed
        _burst(api, qs)
    launches = [s["tags"] for s in sink if s["name"] == "batcher.launch"
                and s["tags"]["tickets"] == 3]
    assert launches
    assert all(t["batchRows"] == 3 for t in launches)
    assert launches[-1]["paddedRows"] == 4
    assert not launches[-1]["compiled"]
