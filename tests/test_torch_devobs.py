"""Device-runtime observability on the PyTorch port (pilosa_tpu_torch/
utils/devobs.py, utils/timeseries.py, the /debug routes and /metrics
families of server/): the cases of tests/test_device_obs.py held to the
same assertions where the port behaves the same, and to the stated
deviation where it does not.

On the card a capture of a whole-query program into a CUDA graph is
the port's compile.  The CPU has no CUDA graphs, so the cases that need
captures use ``cpu_graphs``: it makes the runner take its graph path on
the CPU with a stand-in graph whose replay re-runs the captured body
into the captured outputs.  The runner's own bookkeeping — first
sighting eager, second captured, the LRU, the registry notes and the
retrace rule — runs unchanged.

The launch ledger's padding math must equal the JAX module's ``record``
on the same arguments, and the shard-subset retrace sequence of
tests/test_device_obs.py runs through both packages: the port's count
follows the rule its devobs docstring states (no shard-axis buckets,
capture on the second sighting), so the test pins both counts.  Every
comparison is exact: counts are integers.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.executor import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.server import server as jax_server  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage import membudget as jax_membudget  # noqa: E402
from pilosa_tpu.utils import devobs as jax_devobs  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.parallel import wholequery as wq  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET  # noqa: E402
from pilosa_tpu_torch.utils import devobs  # noqa: E402
from pilosa_tpu_torch.utils.devobs import (CompileRegistry,  # noqa: E402
                                           LaunchLedger)
from pilosa_tpu_torch.utils.timeseries import TimeSeriesRing  # noqa: E402

from test_observability import _parse_prometheus  # noqa: E402
from test_torch_server import restore_knobs  # noqa: E402, F401


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _EventLogger:
    """Collects Logger.event calls (the structured retrace lines)."""

    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))


# -- CUDA graphs stood in for on the CPU -------------------------------------


class _CpuGraph:
    """Stands for a captured CUDA graph: ``replay`` re-runs the captured
    body over the (updated) static params buffers and writes into the
    captured outputs, as a graph replay writes into its memory."""

    def __init__(self, fn, outputs):
        self.fn = fn
        self.outputs = outputs

    def replay(self):
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)


def _cpu_graph(self, fn, slot):
    with kernels.recording_launches() as rec:
        outputs = [o.clone() for o in fn()]
    return _CpuGraph(fn, outputs), outputs, rec


def _cpu_load_params(entry, pad_mats):
    for buf, m in zip(entry.params, pad_mats):
        for b, a in (zip(buf, m) if isinstance(m, tuple) else ((buf, m),)):
            if a.size:
                b.copy_(torch.from_numpy(a))


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The runner's graph path on the CPU (module docstring)."""
    monkeypatch.setattr(wq.WholeQueryRunner, "_use_graphs",
                        lambda self: True)
    monkeypatch.setattr(wq.WholeQueryRunner, "_open_pool",
                        lambda self, slot: None)
    monkeypatch.setattr(wq.WholeQueryRunner, "_graph", _cpu_graph)
    monkeypatch.setattr(wq.WholeQueryRunner, "_load_params",
                        staticmethod(_cpu_load_params))


# -- corpus ------------------------------------------------------------------

N_SHARDS = 16


def _fill(h):
    """16 shards of field ``a``: scattered rows 0-9 and a run-heavy row
    11, from one seed, into either package's holder."""
    rng = np.random.default_rng(99)
    idx = h.create_index("c")
    a = idx.create_field("a")
    n = 20_000
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n)
    a.import_bits(rng.integers(0, 10, size=n), cols)
    run_cols = np.concatenate([
        np.arange(s * SHARD_WIDTH + 1000, s * SHARD_WIDTH + 9000)
        for s in range(N_SHARDS)])
    a.import_bits(np.full(run_cols.size, 11), run_cols)
    return h


@pytest.fixture(scope="module")
def holders():
    return _fill(JaxHolder(None)), _fill(Holder(None))


# -- capture registry ---------------------------------------------------------


def test_compile_registry_unit():
    reg = CompileRegistry()
    log = _EventLogger()
    reg.logger = log
    # first capture of a signature: counted, not a retrace
    assert reg.note_call("wholequery:abc", "wholequery", 0.5,
                         "8x4:int32") is False
    t = reg.totals()
    assert t["compiles"] == 1 and t["retraces"] == 0
    # the same shapes over re-staged inputs: a capture, not a retrace
    assert reg.note_call("wholequery:abc", "wholequery", 0.25,
                         "8x4:int32") is False
    assert reg.totals()["retraces"] == 0
    # new shapes for the signature: a retrace, logged with the diff
    assert reg.note_call("wholequery:abc", "wholequery", 0.25,
                         "16x4:int32") is True
    t = reg.totals()
    assert t["compiles"] == 3 and t["retraces"] == 1
    assert t["compileSecondsTotal"] == pytest.approx(1.0)
    assert log.events == [("device.retrace", {
        "sig": "wholequery:abc", "kind": "wholequery", "compiles": 3,
        "compileS": 0.25, "prevShapes": "8x4:int32",
        "shapes": "16x4:int32"})]
    # a shape it was captured with before: no retrace; the same shape
    # after an LRU eviction over the same inputs: a retrace
    assert reg.note_call("wholequery:abc", "wholequery", 0.1,
                         "8x4:int32") is False
    assert reg.note_call("wholequery:abc", "wholequery", 0.1,
                         "8x4:int32", evicted=True) is True
    (entry,) = reg.snapshot()["entries"]
    assert entry["compiles"] == 5 and entry["retraces"] == 2
    assert entry["lastFingerprint"] == "8x4:int32"
    assert entry["lastCompileWall"] > 0


def test_compile_registry_entry_bound():
    reg = CompileRegistry()
    reg.MAX_ENTRIES = 4
    for i in range(10):
        reg.note_call(f"sig{i}", "wholequery", 0.01, "fp")
    snap = reg.snapshot()
    assert len(snap["entries"]) == 4          # LRU-bounded
    assert snap["compiles"] == 10             # totals keep counting
    assert [e["sig"] for e in snap["entries"]] == \
        ["sig6", "sig7", "sig8", "sig9"]


def test_fingerprint_and_sig_match_jax_format():
    t = torch.zeros((8, 4), dtype=torch.int32)
    a = np.zeros((16, 12), dtype=np.int32)
    assert devobs.fingerprint([t, a, 3]) == "8x4:int32|16x12:int32|int"
    assert devobs.fingerprint([a]) == jax_devobs.fingerprint([a])
    key = ("wholequery", "prog", (1, 2))
    assert devobs.sig_of(key) == jax_devobs.sig_of(key)


# -- launch ledger ------------------------------------------------------------

LEDGER_CASES = [
    dict(shards=3, shards_padded=4, batch_rows=1, batch_rows_padded=1),
    dict(shards=8, shards_padded=8, batch_rows=3, batch_rows_padded=4),
    dict(shards=256, shards_padded=256, batch_rows=24,
         batch_rows_padded=32),
    dict(shards=5, shards_padded=5, batch_rows=0, batch_rows_padded=0),
    dict(shards=2, shards_padded=1, batch_rows=7, batch_rows_padded=2),
    dict(shards=0, shards_padded=0, batch_rows=9, batch_rows_padded=16),
]


@pytest.mark.parametrize("case", range(len(LEDGER_CASES)))
def test_ledger_padding_math_equals_jax(case):
    """The port's ``record`` on the same arguments gives the JAX
    module's entry and aggregates, padding math included."""
    kw = dict(LEDGER_CASES[case], sig="s", kind="wholequery", queue_s=0.0,
              dispatch_s=0.001, decode_bytes=64, compiled=False,
              tickets=2, kernel_launches=3, kernel_tiles=48)
    ours, theirs = LaunchLedger(size=4), jax_devobs.LaunchLedger(size=4)
    for _ in range(3):
        ours.record(**kw)
        theirs.record(**kw)
    assert ours.aggregates() == theirs.aggregates()
    strip = [{k: v for k, v in e.items() if k != "wall"}
             for e in ours.snapshot()["entries"]]
    assert strip == [{k: v for k, v in e.items() if k != "wall"}
                     for e in theirs.snapshot()["entries"]]
    assert ours.padding_waste_ratio() == theirs.padding_waste_ratio()


def test_launch_ledger_ring_bound_and_padding_math():
    led = LaunchLedger(size=4)
    for i in range(10):
        led.record(sig=f"s{i}", kind="wholequery", shards=3,
                   shards_padded=4, batch_rows=1, batch_rows_padded=1,
                   queue_s=0.001, dispatch_s=0.002, decode_bytes=100,
                   compiled=(i == 0))
    snap = led.snapshot()
    assert snap["launches"] == 10
    assert len(snap["entries"]) == 4
    assert [e["sig"] for e in snap["entries"]] == ["s6", "s7", "s8", "s9"]
    assert snap["rowsActual"] == 30 and snap["rowsPadded"] == 10
    assert snap["paddingWasteRatio"] == pytest.approx(0.25)
    assert snap["decodePeakBytes"] == 100
    assert snap["decodeBytesTotal"] == 1000
    assert snap["launchS"]["count"] == 10
    led.resize(2)
    assert [e["sig"] for e in led.snapshot()["entries"]] == ["s8", "s9"]


def test_launch_ledger_populates_on_query(holders):
    _, ph = holders
    before = devobs.LEDGER.launches_total
    ex = Executor(ph, device="cpu")
    try:
        ex.execute("c", "Count(Row(a=2))", shards=list(range(3)))
    finally:
        ex.close()
    assert devobs.LEDGER.launches_total == before + 1
    entry = devobs.LEDGER.snapshot()["entries"][-1]
    assert entry["kind"] == "wholequery"
    assert entry["sig"].startswith("wholequery:")
    # one device, no mesh buckets: the shard axis is not padded
    assert entry["shards"] == 3 and entry["shardsPadded"] == 3
    assert entry["batchRows"] == 1 and entry["rowsPadded"] == 0
    assert entry["dispatchS"] > 0 and entry["compiled"] is False


def test_replay_rows_padded_to_pow2(holders, cpu_graphs):
    """A replay runs over ``pad_pow2_rows`` params: 3 Counts of one
    shape pad to 4 rows, and the ledger says so."""
    _, ph = holders
    ex = Executor(ph, device="cpu")
    q = "Count(Row(a=1)) Count(Row(a=2)) Count(Row(a=3))"
    try:
        want = ex.execute("c", q)
        for _ in range(2):
            assert ex.execute("c", q) == want
    finally:
        ex.close()
    first, second, third = devobs.LEDGER.snapshot()["entries"][-3:]
    assert (first["compiled"], second["compiled"],
            third["compiled"]) == (False, True, False)
    assert first["batchRowsPadded"] == 3 and first["rowsPadded"] == 0
    assert third["batchRows"] == 3 and third["batchRowsPadded"] == 4
    assert third["rowsPadded"] == N_SHARDS


# -- the retrace rule ---------------------------------------------------------


def _port_retraces(ex, q, seq, passes):
    before = devobs.COMPILES.totals()
    got = [ex.execute("c", q, shards=list(range(size)))[0]
           for _ in range(passes) for size in seq]
    after = devobs.COMPILES.totals()
    return got, after["retraces"] - before["retraces"], \
        after["compiles"] - before["compiles"]


def test_shard_subset_retraces_against_jax(holders, cpu_graphs):
    """tests/test_device_obs.py's sequence (16, 2, 9, 16, 1), twice,
    through both packages under a 256 MB budget.  The JAX package
    buckets 2 and 9 shards to its mesh widths 8 and 16 and retraces
    once; the port captures each subset on its second sighting with the
    shard count as shape (devobs docstring), so its first pass captures
    only the repeated 16 and its second captures 2, 9 and 1, three
    retraces.  Answers agree."""
    jh, ph = holders
    q = "Count(Intersect(Row(a=11), Row(a=2)))"
    seq = (16, 2, 9, 16, 1)
    old = (jax_membudget.DEFAULT_BUDGET.limit_bytes,
           DEFAULT_BUDGET.limit_bytes)
    jax_membudget.DEFAULT_BUDGET.limit_bytes = 256 << 20
    DEFAULT_BUDGET.limit_bytes = 256 << 20
    jex, pex = JaxExecutor(jh, use_mesh=True), Executor(ph, device="cpu")
    try:
        j0 = jax_devobs.COMPILES.totals()["retraces"]
        want = [jex.execute("c", q, shards=list(range(size)))[0]
                for _ in range(2) for size in seq]
        jax_retraces = jax_devobs.COMPILES.totals()["retraces"] - j0
        got, retraces, captures = _port_retraces(pex, q, seq, 2)
    finally:
        (jax_membudget.DEFAULT_BUDGET.limit_bytes,
         DEFAULT_BUDGET.limit_bytes) = old
        jex.close()
        pex.close()
    assert got == want
    assert jax_retraces == 1
    assert captures == 4 and retraces == 3


def test_recapture_after_ingest_is_not_a_retrace(cpu_graphs):
    """An ingest drops the graphs over the written shard's stack; the
    program captured again over the re-staged inputs has the same
    shapes, so it counts a capture and no retrace — the JAX package
    re-uses its executable there and counts none either."""
    h = _fill(Holder(None))
    ex = Executor(h, device="cpu")
    q = "Count(Row(a=11))"
    try:
        ex.execute("c", q)
        ex.execute("c", q)                  # captured
        before = devobs.COMPILES.totals()
        h.index("c").field("a").import_bits(np.array([11]),
                                            np.array([5]))
        n1 = ex.execute("c", q)[0]          # new stack: eager
        n2 = ex.execute("c", q)[0]          # captured again
        n3 = ex.execute("c", q)[0]          # replayed
        after = devobs.COMPILES.totals()
    finally:
        ex.close()
    assert n1 == n2 == n3
    assert after["compiles"] - before["compiles"] == 1
    assert after["retraces"] == before["retraces"]


def test_recapture_after_lru_eviction_is_a_retrace(holders, cpu_graphs):
    """With one graph kept, two programs evict each other; capturing an
    evicted one again over the same staged inputs is a retrace."""
    _, ph = holders
    ex = Executor(ph, device="cpu")
    ex.stacked.graphs_max = 1
    qa, qb = "Count(Row(a=1))", "Count(Row(a=1)) Count(Row(a=2))"
    try:
        for q in (qa, qa, qb, qb):          # capture a, capture b
            ex.execute("c", q)
        before = devobs.COMPILES.totals()
        want = ex.execute("c", qa)          # a captured again
        after = devobs.COMPILES.totals()
        assert ex.execute("c", qa) == want  # and replayed
    finally:
        ex.close()
    assert after["compiles"] - before["compiles"] == 1
    assert after["retraces"] - before["retraces"] == 1


# -- time-series ring ---------------------------------------------------------


def test_timeseries_ring_fake_clock():
    clock = [100.0]
    ring = TimeSeriesRing(interval_s=5.0, window_s=20.0,
                          now_fn=lambda: clock[0])
    assert ring.capacity == 5
    assert ring.sample({"v": 1}) is True
    assert ring.sample({"v": 2}) is False
    clock[0] += 2.0
    assert ring.sample({"v": 3}) is False
    clock[0] += 2.6
    assert ring.sample({"v": 4}) is True
    for i in range(10):
        clock[0] += 5.0
        assert ring.sample({"v": 10 + i}) is True
    snap = ring.snapshot()
    assert snap["samplesTotal"] == 12
    assert len(snap["samples"]) == 5
    assert [s["v"] for s in snap["samples"]] == [15, 16, 17, 18, 19]
    assert snap["coveredS"] == pytest.approx(20.0)
    assert snap["samples"][-1]["uptimeS"] == pytest.approx(54.6)
    assert ring.sample({"v": 99}, force=True) is True


# -- served surfaces ----------------------------------------------------------


def _req(port, method, path, data=None):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) else \
            json.dumps(data).encode()
    r = urllib.request.Request(f"http://localhost:{port}{path}",
                               method=method, data=body)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(
            f"http://localhost:{port}{path}", timeout=30) as resp:
        return resp.read(), dict(resp.headers)


def make_server(tmp_path, name="srv", **cfg):
    cfg.setdefault("anti_entropy_interval", 0)
    s = port_server.Server(port_server.Config(
        data_dir=str(tmp_path / name), bind="localhost:0", device="cpu",
        metric_poll_interval=0, **cfg))
    s.open()
    return s


def _wait(cond, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def test_debug_surfaces_served_and_probe_excluded(tmp_path, cpu_graphs):
    srv = make_server(tmp_path, timeseries_interval=0.05,
                      timeseries_window=0.5)
    p = srv.port
    try:
        _req(p, "POST", "/index/i", {})
        _req(p, "POST", "/index/i/field/f", {})
        _req(p, "POST", "/index/i/query", "Set(3, f=1)")
        for _ in range(2):  # the second sighting captures
            _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
        # post-request accounting runs after the response is sent
        assert _wait(lambda: srv.stats.snapshot()["timings"][
            "http.request"]["count"] >= 5)
        hist0 = srv.stats.snapshot()["timings"]["http.request"]["count"]
        comp = json.loads(_get(p, "/debug/compiles")[0])
        assert comp["compiles"] > 0 and comp["entries"]
        assert comp["entries"][-1]["sig"].startswith("wholequery:")
        lau = json.loads(_get(p, "/debug/launches")[0])
        assert lau["launches"] > 0 and lau["entries"]
        assert 0.0 <= lau["paddingWasteRatio"] <= 1.0
        assert _wait(lambda: len(json.loads(_get(
            p, "/debug/timeseries")[0])["samples"]) >= 3)
        ts = json.loads(_get(p, "/debug/timeseries")[0])
        assert ts["intervalS"] == 0.05
        sample = ts["samples"][-1]
        for field in ("hbmResidentBytes", "hbmCompressedBytes",
                      "admissionInUse", "batcherQueued", "compilesDelta",
                      "retracesDelta", "evictionsDelta",
                      "httpQueriesDelta", "deviceReservedBytes"):
            assert field in sample, f"time-series sample lacks {field}"
        body, headers = _get(p, "/debug/dashboard")
        assert headers["Content-Type"].startswith("text/html")
        assert b"/debug/timeseries" in body
        v = _req(p, "GET", "/debug/vars")
        assert v["device"]["compiles"]["compiles"] > 0
        assert v["device"]["launches"]["launches"] > 0
        assert v["timeseries"]["samplesTotal"] >= 3
        assert v["warmup"]["phase"] == "ready"
        assert v["alerts"]["enabled"] is True
        # all of the above is background traffic: the edge histograms
        # must not have moved
        hist1 = srv.stats.snapshot()["timings"]["http.request"]["count"]
        assert hist1 == hist0, "debug traffic leaked into http.request"
    finally:
        srv.close()


def test_retrace_visible_at_debug_compiles(tmp_path, cpu_graphs):
    """Two shard subsets of one program, each captured: the second
    capture has new shapes, so it shows as a retrace at /debug/compiles
    and as device_retraces_total at /metrics."""
    srv = make_server(tmp_path)
    p = srv.port
    try:
        _req(p, "POST", "/index/rt", {})
        _req(p, "POST", "/index/rt/field/f", {})
        _req(p, "POST", "/index/rt/field/f/import",
             {"rowIDs": [1] * 16,
              "columnIDs": [s * SHARD_WIDTH for s in range(16)]})
        before = json.loads(_get(p, "/debug/compiles")[0])
        shards = ",".join(str(s) for s in range(16))
        for path in (f"/index/rt/query?shards={shards}",) * 2 + \
                ("/index/rt/query?shards=0",) * 2:
            _req(p, "POST", path, "Count(Row(f=1))")
        after = json.loads(_get(p, "/debug/compiles")[0])
        assert after["retraces"] == before["retraces"] + 1
        assert any(e["compiles"] > 1 and e["retraces"] >= 1
                   for e in after["entries"])
        _, samples = _parse_prometheus(_get(p, "/metrics")[0].decode())
        assert samples[("pilosa_tpu_device_retraces_total",
                        frozenset())] >= 1
    finally:
        srv.close()


# the port's device families beyond the JAX server's: the per-kernel
# launch counts and the stack cache's stagings and overlays
PORT_ONLY_DEVICE_FAMILIES = {
    "pilosa_tpu_device_kernel_launches_decode_block",
    "pilosa_tpu_device_kernel_launches_fused_row_counts",
    "pilosa_tpu_device_stack_builds",
    "pilosa_tpu_device_stack_overlays",
}


def _device_families(text):
    types, samples = _parse_prometheus(text)
    return {n: t for n, t in types.items()
            if n.startswith("pilosa_tpu_device_")}, samples


def test_metrics_device_families_round_trip(tmp_path):
    """The port's ``pilosa_tpu_device_*`` families carry the JAX
    server's names and types, plus the port-only ones listed above, and
    parse as the JAX test parses them."""
    jsrv = jax_server.Server(jax_server.Config(
        data_dir=str(tmp_path / "jax"), bind="localhost:0",
        compile_cache_dir="off", warmup_top_n=0, timeseries_interval=0,
        flight_recorder_mb=0, metric_poll_interval=0))
    jsrv.open()
    srv = make_server(tmp_path)
    try:
        texts = []
        for s in (jsrv, srv):
            _req(s.port, "POST", "/index/i", {})
            _req(s.port, "POST", "/index/i/field/f", {})
            for _ in range(2):
                _req(s.port, "POST", "/index/i/query", "Count(Row(f=1))")
            texts.append(_get(s.port, "/metrics")[0].decode())
    finally:
        jsrv.close()
        srv.close()
    jax_fams, _ = _device_families(texts[0])
    port_fams, samples = _device_families(texts[1])
    assert jax_fams, "no device families on the JAX server"
    assert port_fams == dict(jax_fams, **{
        n: "gauge" for n in PORT_ONLY_DEVICE_FAMILIES})
    flat = {n: v for (n, ls), v in samples.items() if not ls}
    assert flat["pilosa_tpu_device_compiles_total"] >= 0
    assert flat["pilosa_tpu_device_retraces_total"] >= 0
    assert flat["pilosa_tpu_device_launches_total"] >= 1
    assert 0.0 <= flat["pilosa_tpu_device_padding_waste_ratio"] <= 1.0
    assert "pilosa_tpu_device_decode_workspace_peak_bytes" in flat
    assert flat["pilosa_tpu_device_decode_workspace_limit_bytes"] > 0
    fam = "pilosa_tpu_device_launch_seconds"
    assert port_fams[fam] == "histogram"
    buckets = [v for (n, ls), v in samples.items() if n == f"{fam}_bucket"]
    assert max(buckets) == samples[(f"{fam}_count", frozenset())]
    assert samples[(f"{fam}_count", frozenset())] >= 1


# -- cli top ------------------------------------------------------------------


def test_cli_top_renders_summary(tmp_path, capsys):
    from pilosa_tpu_torch import cli
    srv = make_server(tmp_path, timeseries_interval=0.05)
    p = srv.port
    try:
        _req(p, "POST", "/index/i", {})
        _req(p, "POST", "/index/i/field/f", {})
        _req(p, "POST", "/index/i/query", "Count(Row(f=1))")
        rc = cli.main(["top", "-host", f"localhost:{p}",
                       "--count", "2", "--interval", "0.1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "qps" in out and "hbm" in out and "retraces" in out
        assert "kernels: backend torch" in out
        assert out.count("pilosa-tpu top @") == 2
    finally:
        srv.close()
