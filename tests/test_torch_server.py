"""Differential tests of the PyTorch port's served path
(pilosa_tpu_torch/server, api.py, cli.py) against the JAX package's
server: the same seeded requests go to a JAX ``Server`` and a port
``Server(device="cpu")``, each on ``localhost:0`` in its own data
directory, and every response must carry the same status code and the
same body, byte for byte.

The scripted sequence: README's quick start; DDL of set, int, time,
mutex and bool fields; ``Set`` and ``Clear``; ``/import`` of bits and of
values; ``import-roaring`` of a generated fragment holding array, bitmap
and run containers; ``Count``, ``Intersect``, ``TopN`` with a filter,
``Rows``, ``GroupBy``, ``Sum``, ``Min``, ``Max`` and
``Options(columnAttrs=true)``; ``/export``; the ``wholeQuery`` and
``dispatchBatcher`` sections of ``/debug/vars`` (but for the batcher's
wall-clock ``windowWaitS``); the ``/schema`` round trip; and the error
cases of tests/test_server.py.  Then: data directories
written by either server reopen in the other with the same answers;
the refusals (no card, ``container_kernels``) and the cluster keys that
are now taken (``balancer``, cluster TLS); the
``import`` / ``ingest`` / ``export`` CLI against both; and 8 threads of
mixed queries and ingests against the port server, whose answers must
equal a serial run's.

Every comparison is exact: the bodies are compared as bytes.
"""

import contextlib
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import cli as jax_cli  # noqa: E402
from pilosa_tpu.server import server as jax_server  # noqa: E402
from pilosa_tpu.storage.roaring_io import pack_roaring  # noqa: E402
from pilosa_tpu_torch import cli as port_cli  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.ingest import wire  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402

N_SHARDS = 3


# -- process-wide state ----------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _knobs():
    """Every module global a Server of either package sets: both
    packages' budgets, fragment codec flags, batch and ingest limits,
    rank threshold, tracer rate and event journal, restored after each
    test so the other test files of the worker do not inherit them."""
    import pilosa_tpu.cache.rank as jrank
    import pilosa_tpu.executor.executor as jex
    import pilosa_tpu.ops.kernels as jkern
    import pilosa_tpu.parallel.mesh_exec as jmesh
    import pilosa_tpu.storage.fragment as jfrag
    import pilosa_tpu.storage.membudget as jmb
    import pilosa_tpu.utils.tracing as jtr
    import pilosa_tpu_torch.cache.rank as prank
    import pilosa_tpu_torch.executor.executor as pex
    import pilosa_tpu_torch.parallel.stacked as pstacked
    import pilosa_tpu_torch.storage.fragment as pfrag
    import pilosa_tpu_torch.storage.membudget as pmb
    import pilosa_tpu_torch.utils.tracing as ptr
    out = []
    for mb in (jmb, pmb):
        for b in (mb.DEFAULT_BUDGET, mb.HOST_STAGE_BUDGET):
            out += [(b, "limit_bytes"), (b, "tenant_quota_bytes")]
        out.append((mb, "INGEST_DELTA_LIMIT_BYTES"))
    for fr in (jfrag, pfrag):
        out += [(fr, a) for a in ("WAL_CRC", "QUARANTINE_ON_CORRUPTION",
                                  "COMPRESSED_RESIDENT",
                                  "COMPRESS_MAX_DENSITY")]
    out += [(jex, "BATCH_TEMP_BYTES"), (pex, "BATCH_TEMP_BYTES"),
            (jrank, "RANK_REBUILD_ROWS"), (prank, "RANK_REBUILD_ROWS"),
            (jtr.GLOBAL_TRACER, "sample_rate"),
            (ptr.GLOBAL_TRACER, "sample_rate"),
            (jmesh, "DECODE_WORKSPACE_BYTES"),
            (pstacked, "DECODE_WORKSPACE_BYTES"),
            (jkern, "CONTAINER_KERNELS")]
    return out


@pytest.fixture(autouse=True)
def restore_knobs():
    saved = [(o, a, getattr(o, a)) for o, a in _knobs()]
    yield
    for o, a, v in saved:
        setattr(o, a, v)


def _jax_cfg(data_dir, **kw):
    # the warm-start compile cache, sampler and flight recorder write
    # process-wide or extra state and change no answer
    return jax_server.Config(
        data_dir=str(data_dir), bind="localhost:0", compile_cache_dir="off",
        warmup_top_n=0, timeseries_interval=0, flight_recorder_mb=0,
        metric_poll_interval=0, **kw)


def _port_cfg(data_dir, **kw):
    # the same warm-start, sampler and flight-recorder settings as the
    # JAX server's, so /status compares whole
    return port_server.Config(data_dir=str(data_dir), bind="localhost:0",
                              device="cpu", metric_poll_interval=0,
                              warmup_top_n=0, timeseries_interval=0,
                              flight_recorder_mb=0, **kw)


@contextlib.contextmanager
def _serving(cfg_fn, module, data_dir, **kw):
    srv = module.Server(cfg_fn(data_dir, **kw))
    srv.open()
    try:
        yield srv
    finally:
        srv.close()


@contextlib.contextmanager
def _pair(tmp_path, jdir="jax", pdir="port", **kw):
    with _serving(_jax_cfg, jax_server, tmp_path / jdir, **kw) as j, \
            _serving(_port_cfg, port_server, tmp_path / pdir, **kw) as p:
        yield j, p


def _raw(srv, method, path, body=None, ctype="application/json"):
    """(status, Content-Type, body bytes) of one request."""
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    req = urllib.request.Request(f"http://localhost:{srv.port}{path}",
                                 data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def both(pair, method, path, body=None, ctype="application/json"):
    """Send one request to both servers; status, content type and body
    bytes must be identical.  Returns the body."""
    j, p = pair
    want = _raw(j, method, path, body, ctype)
    got = _raw(p, method, path, body, ctype)
    assert got == want, f"{method} {path}: port {got!r} != jax {want!r}"
    return want[2]


def query(pair, q: str, index: str = "i"):
    return json.loads(both(pair, "POST", f"/index/{index}/query",
                           q.encode()))


# -- the scripted sequence -------------------------------------------------


def _roaring_fragment(rng):
    """(rows, shard-local cols) of a fragment whose roaring form holds
    array, bitmap and run containers."""
    arr = rng.choice(1 << 16, size=40, replace=False)            # array
    bmp = (1 << 16) + rng.choice(1 << 16, size=9000, replace=False)
    run = np.arange(3 << 16, (3 << 16) + 20000)                 # run
    cols = np.concatenate([arr, bmp, run, arr + (5 << 16)])
    rows = np.concatenate([np.zeros(arr.size + bmp.size + run.size,
                                    np.int64),
                           np.full(arr.size, 2, np.int64)])
    return rows, cols


def _load(pair, rng):
    """DDL, writes and imports of the scripted sequence."""
    both(pair, "POST", "/index/i", {})
    for name, opts in (("s", {}), ("g", {}),
                       ("n", {"type": "int", "min": -1000, "max": 1000}),
                       ("t", {"type": "time", "timeQuantum": "YMD"}),
                       ("m", {"type": "mutex"}), ("b", {"type": "bool"})):
        both(pair, "POST", f"/index/i/field/{name}", {"options": opts})
    query(pair, "Set(3, s=1) Set(5, s=1) Set(7, s=2) Clear(3, s=1) "
                "Set(7, m=2) Set(7, m=4) Set(9, b=true) Set(11, b=false) "
                "Set(7, t=3, 2017-05-05T00:00) Set(5, n=-17) "
                "SetColumnAttrs(5, name=\"five\") SetColumnAttrs(7, k=1)")
    n = 600
    rows = rng.integers(0, 6, size=n)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n)
    both(pair, "POST", "/index/i/field/s/import",
         {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
    both(pair, "POST", "/index/i/field/g/import",
         {"rowIDs": rng.integers(0, 4, size=n).tolist(),
          "columnIDs": cols.tolist()})
    vcols = rng.choice(N_SHARDS * SHARD_WIDTH, size=200, replace=False)
    both(pair, "POST", "/index/i/field/n/import",
         {"columnIDs": vcols.tolist(),
          "values": rng.integers(-1000, 1000, size=200).tolist()})
    r, c = _roaring_fragment(rng)
    both(pair, "POST", "/index/i/field/g/import-roaring/1",
         pack_roaring(r, c), ctype="application/octet-stream")


QUERIES = [
    "Count(Row(s=1))",
    "Count(Intersect(Row(s=1), Row(g=0)))",
    "Intersect(Row(s=2), Row(g=1))",
    "Union(Row(s=3), Row(m=4))",
    "TopN(s, Row(g=0), n=3)",
    "TopN(g, n=5)",
    "Rows(s)",
    "GroupBy(Rows(s), Rows(g), Row(g=2))",
    "Sum(field=n)",
    "Sum(Row(s=1), field=n)",
    "Min(field=n) Max(field=n)",
    "Count(Row(n > 10)) Count(Row(g=0)) TopN(s, n=2)",
    "Row(t=3, from=2017-05-01T00:00, to=2017-06-01T00:00)",
    "Row(b=true) Row(b=false) Row(m=4)",
    "Options(Row(s=1), columnAttrs=true)",
    "Options(Union(Row(s=1), Row(s=2)), columnAttrs=true) Row(s=2)",
    "Count(Row(g=0)) Count(Row(g=2)) Row(g=2)",
]


def test_quick_start_bytes_equal(tmp_path):
    with _pair(tmp_path) as pair:
        for path, body in (
                ("/index/repository", {}),
                ("/index/repository/field/stargazer", {})):
            assert both(pair, "POST", path, body) == b"{}\n"
        query(pair, "Set(10, stargazer=1) Set(20, stargazer=1) "
                    "Set(10, stargazer=2)", "repository")
        out = both(pair, "POST", "/index/repository/query",
                   b"Count(Intersect(Row(stargazer=1), Row(stargazer=2)))")
        assert out == b'{"results": [1]}\n'
        for path in ("/", "/version", "/info", "/schema", "/index",
                     "/index/repository"):
            both(pair, "GET", path)
        # /status, the warm-start coordinator's report included
        j, p = pair
        sj = json.loads(_raw(j, "GET", "/status")[2])
        sp = json.loads(_raw(p, "GET", "/status")[2])
        assert sp == sj


def test_scripted_sequence_and_data_dirs(tmp_path):
    """The scripted sequence, byte for byte; then each server reopens the
    other's data directory and answers the same, and the /schema round
    trip runs there."""
    with _pair(tmp_path) as pair:
        _load(pair, np.random.default_rng(11))
        want = {q: query(pair, q) for q in QUERIES}
        # the multi-container roaring fragment reads back whole
        out = query(pair, "Count(Row(g=0)) Count(Row(g=2))")["results"]
        assert out[0] >= 9000 + 20000 and out[1] >= 40
        # recalculated rank caches answer the same TopN
        both(pair, "POST", "/recalculate-caches")
        query(pair, "TopN(s, n=4) TopN(g, Row(s=2), n=2)")
        for shard in range(N_SHARDS):
            both(pair, "GET", f"/export?index=i&field=s&shard={shard}")
            both(pair, "GET", f"/export?index=i&field=g&shard={shard}")
        both(pair, "GET", "/internal/shards/max")
        both(pair, "GET", "/internal/fragment/nodes?index=i&shard=1")
        # /debug/vars' whole-query and dispatch-batcher sections count
        # the same requests, fallbacks and launches; windowWaitS is a
        # wall-clock reading and is left out
        sections = []
        for srv in pair:
            snap = json.loads(_raw(srv, "GET", "/debug/vars")[2])
            snap["dispatchBatcher"].pop("windowWaitS")
            sections.append((snap["dispatchBatcher"], snap["wholeQuery"]))
        assert sections[1] == sections[0]
        assert sections[1][1]["requests"] and sections[1][1]["fallbacks"]
    # swap: the port serves the JAX server's directory and vice versa
    with _pair(tmp_path, jdir="port", pdir="jax") as pair:
        for q in QUERIES:
            assert query(pair, q) == want[q], q
        # /schema round trip: read, drop, re-apply, read again: the
        # fields come back with their options (not their data, views or
        # grown bit depths)
        schema = both(pair, "GET", "/schema")
        both(pair, "DELETE", "/index/i/field/t")
        both(pair, "DELETE", "/index/i")
        both(pair, "POST", "/schema", json.loads(schema))
        again = both(pair, "GET", "/schema")

        def opts(body):
            return [(f["name"], {k: v for k, v in f["options"].items()
                                 if k != "bitDepth"})
                    for ix in json.loads(body)["indexes"]
                    for f in ix["fields"]]
        assert opts(again) == opts(schema)


def test_error_cases_bytes_equal(tmp_path):
    """tests/test_server.py test_errors, plus a few more 4xx paths."""
    with _pair(tmp_path) as pair:
        both(pair, "POST", "/index/i/query", b"Row(f=1)")
        both(pair, "POST", "/index/i", {})
        both(pair, "POST", "/index/i", {})                # 409
        both(pair, "GET", "/index/nope")                  # 404
        both(pair, "POST", "/index/i/query", b"Row(f=")   # parse error
        both(pair, "POST", "/definitely-not-a-route")     # 404
        both(pair, "DELETE", "/schema")                   # 405
        both(pair, "POST", "/index/i/field/f", {"options": {"type": "x"}})
        both(pair, "POST", "/index/i/field/f", b"{not json")
        both(pair, "POST", "/index/i/field/nope/import",
             {"rowIDs": [1], "columnIDs": [2]})
        both(pair, "POST", "/index/i/query", b"Count(Row(nope=1))")
        both(pair, "DELETE", "/index/nope")
        both(pair, "POST", "/index/i/field/f", {})
        both(pair, "POST", "/index/i/field/f/import",
             {"rowIDs": [1, 2], "columnIDs": [2]})


def test_refusals(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.Server(port_server.Config(
            data_dir=str(tmp_path / "a"), bind="localhost:0"))
    # a cluster node takes ``balancer = true`` (the coordinator runs the
    # hot-shard balancer) and loads its TLS certificates for serving and
    # for its cluster client: missing files fail as they do in the JAX
    # server, at construction, with the same error type
    srv = port_server.Server(_port_cfg(tmp_path / "b",
                                       cluster_hosts=["localhost:1"],
                                       balancer=True,
                                       anti_entropy_interval=0))
    srv.open()
    try:
        assert srv.cluster.balancer_on and srv.cluster.is_coordinator
    finally:
        srv.close()
    with pytest.raises(FileNotFoundError):
        port_server.Server(_port_cfg(tmp_path / "b",
                                     cluster_hosts=["localhost:1"],
                                     tls_certificate="c.pem",
                                     tls_key="k.pem"))
    with pytest.raises(ValueError, match="container_kernels"):
        port_server.Server(_port_cfg(tmp_path / "c",
                                     container_kernels="jnp"))
    # the TOML form names the device; the CLI flag overrides it
    toml = tmp_path / "c.toml"
    toml.write_text('device = "cpu"\nbind = "localhost:0"\n'
                    'container-kernels = "auto"\n')
    cfg = port_server.Config.from_toml(str(toml))
    assert cfg.device == "cpu" and cfg.bind == "localhost:0"
    assert port_server.Config.from_toml(str(toml), device="cuda").device \
        == "cuda"
    # the port's Config is the JAX Config plus ``device``
    jf = {f.name: f.default for f in
          jax_server.Config.__dataclass_fields__.values()}
    pf = {f.name: f.default for f in
          port_server.Config.__dataclass_fields__.values()}
    assert pf.pop("device") == "cuda"
    assert pf.keys() == jf.keys()
    for k in jf:
        if not callable(jf[k]):
            assert pf[k] == jf[k], k


def _cli(main, capsys, argv) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_import_ingest_export(tmp_path, capsys):
    rng = np.random.default_rng(13)
    bits = tmp_path / "bits.csv"
    n = 400
    rows = rng.integers(0, 5, size=n)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n)
    bits.write_text("".join(f"{r},{c}\n" for r, c in zip(rows, cols)))
    vals = tmp_path / "vals.csv"
    vcols = rng.choice(SHARD_WIDTH * 2, size=50, replace=False)
    vals.write_text("".join(f"{c},{v}\n" for c, v in
                            zip(vcols, rng.integers(0, 900, size=50))))
    stream = tmp_path / "stream.tsv"
    scols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=n)
    stream.write_text("".join(f"{r}\t{c}\n" for r, c in
                              zip(rng.integers(0, 3, size=n), scols)))
    with _pair(tmp_path) as (j, p):
        outs = []
        for main, srv in ((jax_cli.main, j), (port_cli.main, p)):
            host = f"localhost:{srv.port}"
            out = _cli(main, capsys, [
                "import", "-host", host, "-i", "c", "-f", "f", "--create",
                str(bits)])
            out += _cli(main, capsys, [
                "import", "-host", host, "-i", "c", "-f", "v", "--create",
                "--field-type", "int", "--max", "1000", str(vals)])
            out += _cli(main, capsys, [
                "ingest", "-host", host, "-i", "c", "-f", "h", "--create",
                "--batch-size", "150", str(stream)])
            capsys.readouterr()
            for field in ("f", "h"):
                dest = tmp_path / f"{srv.port}-{field}.csv"
                _cli(main, capsys, ["export", "-host", host, "-i", "c",
                                    "-f", field, "-o", str(dest)])
                out += dest.read_text()
            outs.append(out)
        assert outs[1] == outs[0]
        assert len(outs[0].splitlines()) > n
        pair = (j, p)
        query(pair, "Sum(field=v) TopN(h, n=3) Count(Row(f=1))", "c")


def test_threads_match_serial(tmp_path):
    """8 threads of mixed queries and ingests on the port server get the
    answers of a serial run: reads of ``s``/``g`` while other threads
    stream into ``h``, then the ingested field read back."""
    rng = np.random.default_rng(14)
    with _serving(_port_cfg, port_server, tmp_path / "port",
                  ingest_flush_ms=5.0) as srv:
        def q(text):
            st, _, body = _raw(srv, "POST", "/index/i/query",
                               text.encode())
            assert st == 200, body
            return body

        _raw(srv, "POST", "/index/i", {})
        for name in ("s", "g", "h"):
            _raw(srv, "POST", f"/index/i/field/{name}", {})
        cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=800)
        for name in ("s", "g"):
            _raw(srv, "POST", f"/index/i/field/{name}/import",
                 {"rowIDs": rng.integers(0, 6, size=800).tolist(),
                  "columnIDs": cols.tolist()})
        reads = ["Count(Row(s=1))", "Count(Intersect(Row(s=1), Row(g=0)))",
                 "Intersect(Row(s=2), Row(g=1))", "TopN(s, Row(g=0), n=3)",
                 "TopN(g, n=5)", "Rows(s)",
                 "GroupBy(Rows(s), Rows(g), Row(g=2))",
                 "Count(Row(s=1)) Count(Row(s=2)) TopN(g, Row(s=3), n=2)"]
        serial = {x: q(x) for x in reads}
        frames = []
        for _ in range(8):
            r = rng.integers(0, 5, size=300)
            c = rng.integers(0, N_SHARDS * SHARD_WIDTH, size=300)
            frames.append((r, c, wire.encode_records(r, c,
                                                     frame_records=100)))
        errors = []

        def worker(k):
            try:
                for it in range(4):
                    for x in reads[(k + it) % len(reads)::3]:
                        assert q(x) == serial[x], x
                    if it == k % 4:
                        st, _, body = _raw(
                            srv, "POST", "/index/i/field/h/ingest",
                            frames[k][2], "application/octet-stream")
                        assert st == 200, body
            except Exception as e:  # reported after join
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            ts = [threading.Thread(target=worker, args=(k,))
                  for k in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in ts)
        assert not errors, errors
        # every acked ingest is read back exactly
        allr = np.concatenate([f[0] for f in frames])
        allc = np.concatenate([f[1] for f in frames])
        for row in range(5):
            want = sorted(set(allc[allr == row].tolist()))
            got = json.loads(q(f"Row(h={row})"))["results"][0]["columns"]
            assert got == want
        assert json.loads(q("Count(Row(h=0))"))["results"] == [
            len(set(allc[allr == 0].tolist()))]
