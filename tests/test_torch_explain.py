"""Query EXPLAIN on the PyTorch port (pilosa_tpu_torch/utils/explain.py):
the counterpart of tests/test_explain.py, with ``device="cpu"`` on every
server.  ``?explain=true`` assembles the per-query decision record —
plan lowering (whole-query program signature cross-checked against the
launch ledger), cache outcomes, device launches — with answers
byte-identical to explain-off; slow-log entries carry the record; trace
exemplars on /metrics resolve at /debug/traces, which also searches by
index, duration and status.

Differential: a JAX server and a port server loaded alike give the same
explain record for each query of ``EXPLAIN_QUERIES``, apart from the
fields of ``DEVICE_FIELDS`` (the program signature, its compile state
and its shard padding, which belong to each package's own device
program, wall times, and the process-wide epoch counters of the
result-cache key).
The explain record of a fan-out across replicas is covered by
tests/test_torch_cluster_obs.py.
"""

import re
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from test_torch_cluster import restore_knobs  # noqa: E402, F401
from test_torch_cluster_diff import jax_knobs  # noqa: E402, F401
from test_torch_cluster_obs import _req, make_server  # noqa: E402


@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    s = make_server(tmp_path_factory.mktemp("explain"),
                    result_cache_mb=16, slow_query_threshold=1e-9)
    p = s.port
    _req(p, "POST", "/index/ei", {})
    _req(p, "POST", "/index/ei/field/f", {})
    _req(p, "POST", "/index/ei/field/ranked",
         {"options": {"cacheType": "ranked", "cacheSize": 100}})
    _req(p, "POST", "/index/ei/query",
         "".join(f"Set({c}, f={r})" for r in range(4)
                 for c in range(0, 40, 3)))
    _req(p, "POST", "/index/ei/query",
         "".join(f"Set({c}, ranked={r})" for r in range(6)
                 for c in range(r * 7)))
    yield s
    s.close()


def test_explain_answers_byte_identical(srv):
    q = "Count(Intersect(Row(f=1), Row(f=2)))"
    plain, _ = _req(srv.port, "POST", "/index/ei/query", q)
    explained, _ = _req(srv.port, "POST", "/index/ei/query?explain=true",
                        q)
    assert explained["results"] == plain["results"]
    assert "explain" in explained
    assert "explain" not in plain
    # explain does not force the profile into the response
    assert "profile" not in explained


def test_explain_plan_names_program_sig_in_ledger(srv):
    out, _ = _req(srv.port, "POST", "/index/ei/query?explain=true",
                  "Count(Row(f=1))")
    plan = out["explain"]["plan"]
    assert plan[0]["mode"] == "wholequery"
    sig = plan[0]["program"]
    assert sig and sig.startswith("wholequery:")
    assert plan[0]["nodes"] == ["count"]
    # cross-check: the ledger recorded a launch under the SAME signature
    led, _ = _req(srv.port, "GET", "/debug/launches")
    assert any(e["sig"] == sig and e["kind"] == "wholequery"
               for e in led["entries"])


def test_explain_launches_assembled_from_profile(srv):
    out, _ = _req(srv.port, "POST", "/index/ei/query?explain=true",
                  "Count(Row(f=3))")
    launches = out["explain"]["launches"]
    assert launches, "launches section missing"
    ev = launches[0]
    assert ev["stage"] in ("device.launch", "batcher.launch")
    if ev["stage"] == "device.launch":
        assert "sig" in ev and "batchRows" in ev \
            and "decodeBytes" in ev


def test_explain_result_cache_outcomes(srv):
    q = "Count(Union(Row(f=0), Row(f=3)))"
    first, _ = _req(srv.port, "POST", "/index/ei/query?explain=true", q)
    second, _ = _req(srv.port, "POST", "/index/ei/query?explain=true", q)
    assert second["results"] == first["results"]

    def outcomes(resp):
        return [(c["cache"], c["outcome"])
                for c in resp["explain"].get("caches", [])]

    assert ("result", "miss") in outcomes(first)
    assert ("result", "hit") in outcomes(second)
    # key COMPONENTS are named, not an opaque blob
    entry = next(c for c in second["explain"]["caches"]
                 if c["cache"] == "result")
    assert entry["key"]["index"] == "ei"
    assert entry["key"]["shards"] >= 1


def test_explain_rank_cache_prune(srv):
    out, _ = _req(srv.port, "POST", "/index/ei/query?explain=true",
                  "TopN(ranked, n=3)")
    pairs = out["results"][0]
    assert [p["id"] for p in pairs] == [5, 4, 3]
    rank = [c for c in out["explain"].get("caches", [])
            if c["cache"] == "rank"]
    assert rank and rank[0]["outcome"] == "prune"
    assert rank[0]["candidates"] >= 3


def test_explain_legacy_mode_named_when_wholequery_off(tmp_path):
    s = make_server(tmp_path, name="legacy", whole_query=False,
                    slow_query_threshold=0)
    try:
        _req(s.port, "POST", "/index/li", {})
        _req(s.port, "POST", "/index/li/field/f", {})
        _req(s.port, "POST", "/index/li/query", "Set(1, f=1)")
        out, _ = _req(s.port, "POST", "/index/li/query?explain=true",
                      "Count(Row(f=1))")
        assert out["results"] == [1]
        modes = [p["mode"] for p in out["explain"]["plan"]]
        # the kill switch means NO whole-query program may be claimed;
        # the request ran prepared/legacy instead
        assert modes
        assert "wholequery" not in modes
        assert all(m.startswith(("legacy", "prepared")) for m in modes)
    finally:
        s.close()


def test_slow_log_entries_carry_explain(srv):
    _req(srv.port, "POST", "/index/ei/query", "Count(Row(f=1))")
    # post-response accounting: poll
    deadline = time.monotonic() + 5.0
    entries = []
    while not entries and time.monotonic() < deadline:
        slow, _ = _req(srv.port, "GET", "/debug/slow")
        entries = [e for e in slow["entries"] if e.get("index") == "ei"]
        if not entries:
            time.sleep(0.01)
    assert entries
    last = entries[-1]
    assert "explain" in last
    assert last["explain"]["plan"][0]["mode"] in (
        "wholequery", "legacy-grouped", "legacy-per-call")
    assert not last.get("textTruncated")


def test_slow_log_text_truncation_flag(tmp_path):
    s = make_server(tmp_path, name="trunc", slow_query_threshold=1e-9,
                    slow_log_text_max=16)
    try:
        _req(s.port, "POST", "/index/ti", {})
        _req(s.port, "POST", "/index/ti/field/f", {})
        long_q = "Count(Union(" + ", ".join(
            f"Row(f={i})" for i in range(40)) + "))"
        _req(s.port, "POST", "/index/ti/query", long_q)
        # the slow entry lands in post-response accounting: poll
        deadline = time.monotonic() + 5.0
        entries = []
        while not entries and time.monotonic() < deadline:
            slow, _ = _req(s.port, "GET", "/debug/slow")
            entries = [x for x in slow["entries"]
                       if x.get("index") == "ti"]
            if not entries:
                time.sleep(0.01)
        assert slow["textMax"] == 16
        e = entries[-1]
        assert e["textTruncated"] is True
        assert len(e["query"]) == 16
    finally:
        s.close()


# -- trace exemplars + search ------------------------------------------------


def _raw(port, path, accept=None):
    r = urllib.request.Request(f"http://localhost:{port}{path}")
    if accept is not None:
        r.add_header("Accept", accept)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.read().decode()


def test_metrics_exemplar_resolves_at_debug_traces(srv):
    _req(srv.port, "POST", "/index/ei/query", "Count(Row(f=1))")
    # exemplars attach in the handler's post-response accounting: poll.
    # They are OpenMetrics-only syntax, served only on the explicit
    # ?exemplars=true opt-in.
    rx = (r'pilosa_tpu_http_query_seconds_bucket\{le="[^"]+"\} \d+'
          r' # \{trace_id="([0-9a-f]+)"\} [0-9.e-]+ [0-9.]+')
    deadline = time.monotonic() + 5.0
    m = None
    while m is None and time.monotonic() < deadline:
        m = re.search(rx, _raw(srv.port, "/metrics?exemplars=true"))
        if m is None:
            time.sleep(0.02)
    assert m, "no exemplar on the http_query histogram"
    # a plain scrape — including one ADVERTISING OpenMetrics, as stock
    # Prometheus does by default — must NOT carry exemplars: a classic
    # 0.0.4 parser rejects the `# {...}` suffix and the scrape goes
    # dark, and this exposition's counter names predate the OpenMetrics
    # `_total` rule so answering the Accept with it would break too
    assert " # {trace_id=" not in _raw(srv.port, "/metrics")
    assert " # {trace_id=" not in _raw(
        srv.port, "/metrics",
        accept="application/openmetrics-text;version=1.0.0")
    tid = m.group(1)
    spans, _ = _req(srv.port, "GET", f"/debug/traces?trace={tid}")
    assert spans["spans"], f"exemplar trace {tid} did not resolve"
    assert all(s["traceID"] == tid for s in spans["spans"])


def test_debug_traces_search_by_index_duration_status(srv):
    _req(srv.port, "POST", "/index/ei/query", "Count(Row(f=1))")
    # the status tag is stamped by the handler's post-response
    # accounting — poll instead of read-once
    deadline = time.monotonic() + 5.0
    t = None
    while time.monotonic() < deadline:
        got, _ = _req(srv.port, "GET", "/debug/traces?index=ei")
        if got["traces"] and got["traces"][0].get("status") == 200:
            t = got["traces"][0]
            break
        time.sleep(0.02)
    assert t is not None, "no completed root span matched index=ei"
    assert t["index"] == "ei" and t["status"] == 200
    assert t["traceID"] and t["spans"] >= 1
    # a trace id from the summary resolves to its full tree
    full, _ = _req(srv.port, "GET",
                   f"/debug/traces?trace={t['traceID']}")
    assert full["spans"]
    # duration filter: nothing took 10 minutes
    none, _ = _req(srv.port, "GET",
                   "/debug/traces?index=ei&minMs=600000")
    assert none["traces"] == []
    # unknown index matches nothing
    none2, _ = _req(srv.port, "GET", "/debug/traces?index=nope")
    assert none2["traces"] == []


def test_section_cap_bounds_construction_via_wants():
    """The SECTION_MAX cap must bound CONSTRUCTION, not just storage:
    wants() flips False at capacity (the router's per-shard gate), and
    over-cap notes land in the record's `truncated` count."""
    from pilosa_tpu_torch.utils import explain as qexplain

    assert qexplain.wants("routing") is False  # no active record
    rec = qexplain.ExplainRecord()
    with qexplain.activate(rec):
        for i in range(qexplain.SECTION_MAX):
            assert qexplain.wants("routing")
            qexplain.note("routing", {"shard": i})
        assert qexplain.wants("routing") is False
        qexplain.note("routing", {"shard": -1})  # dropped, counted
    out = rec.to_dict()
    assert len(out["routing"]) == qexplain.SECTION_MAX
    assert out["truncated"]["routing"] == 1


# -- differential: the JAX server's explain record ----------------------------

EXPLAIN_QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "TopN(ranked, n=3)",
    "Count(Union(Row(f=0), Row(f=3)))",
    "Row(f=2)",
    "TopN(f, Row(f=1), n=2)",
    "Count(Row(f=1))",
]

# fields naming each package's own device program, its shard padding
# (the JAX package pads a launch to its mesh's device count, the port
# runs on one device) or a wall time, and the result-cache key's epoch
# and generation counters, which count what else the process did before
# (both are process-wide in both packages)
DEVICE_FIELDS = {"program", "compile", "sig", "compiled", "shardsPadded",
                 "durationMS", "queuedMs", "traceID", "genVector",
                 "schemaEpoch", "attrEpoch"}


def _strip_device(x):
    if isinstance(x, dict):
        return {k: _strip_device(v) for k, v in x.items()
                if k not in DEVICE_FIELDS}
    if isinstance(x, list):
        return [_strip_device(v) for v in x]
    return x


def _load_explain_index(p):
    _req(p, "POST", "/index/ei", {})
    _req(p, "POST", "/index/ei/field/f", {})
    _req(p, "POST", "/index/ei/field/ranked",
         {"options": {"cacheType": "ranked", "cacheSize": 100}})
    _req(p, "POST", "/index/ei/query",
         "".join(f"Set({c}, f={r})" for r in range(4)
                 for c in range(0, 40, 3)))
    _req(p, "POST", "/index/ei/query",
         "".join(f"Set({c}, ranked={r})" for r in range(6)
                 for c in range(r * 7)))


def test_explain_records_match_jax(tmp_path, jax_knobs):
    from pilosa_tpu.server import server as jax_server

    jsrv = jax_server.Server(jax_server.Config(
        data_dir=str(tmp_path / "jax"), bind="localhost:0",
        compile_cache_dir="off", warmup_top_n=0, timeseries_interval=0,
        flight_recorder_mb=0, metric_poll_interval=0,
        anti_entropy_interval=0, result_cache_mb=16))
    got = {}
    for tag, srv in (("jax", jsrv), ("port", None)):
        if srv is None:
            srv = make_server(tmp_path, name="port", result_cache_mb=16,
                              warmup_top_n=0, timeseries_interval=0,
                              flight_recorder_mb=0)
        else:
            srv.open()
        try:
            _load_explain_index(srv.port)
            got[tag] = [
                _req(srv.port, "POST", "/index/ei/query?explain=true",
                     q)[0] for q in EXPLAIN_QUERIES]
        finally:
            srv.close()
    assert [o["results"] for o in got["port"]] == \
        [o["results"] for o in got["jax"]]
    assert _strip_device([o["explain"] for o in got["port"]]) == \
        _strip_device([o["explain"] for o in got["jax"]])
    # the last query repeats the first: a result-cache hit in both
    assert ("result", "hit") in [(c["cache"], c["outcome"]) for c in
                                 got["port"][-1]["explain"]["caches"]]
