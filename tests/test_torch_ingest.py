"""Differential tests of the PyTorch port's streaming-ingest write path
(pilosa_tpu_torch/ingest, the journal and overlay branch of
storage/fragment.py, the stacked overlay refresh of parallel/stacked.py)
against the JAX package.

* The wire codec is a copy: both encoders give the same bytes, and each
  reader decodes the other's streams.
* ``apply_overlay`` (plain torch) equals the JAX ``apply_overlay`` on a
  dense mirror, with colliding indices across journal chunks; the
  stacked form equals it member by member.
* A resident fragment mirror absorbs a flush by overlay (no re-upload).
* The same frames through both servers' ``/ingest`` give byte-identical
  acks and, after the ack, byte-identical answers — dense-resident
  (overlay) and compressed-resident (re-pack) — and the same 400s for
  bad streams.
* A resident dense stack of the port's stacked executor refreshes by
  overlay, not by re-stage, and its answers equal the JAX server's.

Every comparison is exact.
"""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.ingest import delta as jax_delta  # noqa: E402
from pilosa_tpu.ingest import wire as jax_wire  # noqa: E402
from pilosa_tpu.storage.fragment import Fragment as JaxFragment  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH, SHARD_WORDS  # noqa: E402
from pilosa_tpu_torch.ingest import delta, wire  # noqa: E402
from pilosa_tpu_torch.ops.bitset import to_numpy  # noqa: E402
from pilosa_tpu_torch.server import server as port_server  # noqa: E402
from pilosa_tpu_torch.storage.fragment import Fragment  # noqa: E402

from test_torch_server import (  # noqa: E402
    _pair, _port_cfg, _raw, _serving, both, query, restore_knobs,
)

N_SHARDS = 3
_ = restore_knobs  # the autouse fixture, re-exported into this module


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: beside the other test workers on the same
    cores, a full pool of torch threads per worker spins against the
    rest and a case runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _records(rng, n, rows=6, shards=N_SHARDS):
    return (rng.integers(0, rows, size=n),
            rng.integers(0, shards * SHARD_WIDTH, size=n))


def test_wire_bytes_equal():
    rng = np.random.default_rng(21)
    r, c = _records(rng, 1000)
    ts = rng.integers(0, 2_000_000_000, size=1000)
    v = rng.integers(-(1 << 40), 1 << 40, size=1000)
    for kw in ({}, {"ts": ts}, {"values": v}):
        args = (None if "values" in kw else r, c)
        mine = wire.encode_records(*args, frame_records=300, **kw)
        theirs = jax_wire.encode_records(*args, frame_records=300, **kw)
        assert mine == theirs
        for enc, reader in ((theirs, wire.FrameReader),
                            (mine, jax_wire.FrameReader)):
            rd = reader(io.BytesIO(enc).read, len(enc))
            got = []
            while (item := rd.next_frame()) is not None:
                got.append(item[1])
            assert np.array_equal(np.concatenate(got)["col"], c)
    with pytest.raises(wire.FrameError, match="magic"):
        wire.FrameReader(io.BytesIO(b"BADMAGIC").read, 8).next_frame()


@pytest.mark.parametrize("rows", [4, 16])
def test_apply_overlay_matches_jax(rows):
    """Chunks with colliding word indices (within and across chunks)
    merge and OR into a dense mirror exactly as in the JAX package."""
    rng = np.random.default_rng(22 + rows)
    base = rng.integers(0, 1 << 32, size=(rows, SHARD_WORDS),
                        dtype=np.uint64).astype(np.uint32)
    base[rng.random(base.shape) < 0.9] = 0
    chunks = []
    for ep in range(1, 5):
        idx = rng.integers(0, rows * SHARD_WORDS, size=500)
        idx[:50] = idx[50:100]             # collisions inside a chunk
        if chunks:
            idx[100:150] = chunks[0][1][:50]   # and across chunks
        chunks.append((ep, idx.astype(np.int64),
                       rng.integers(0, 1 << 32, size=500,
                                    dtype=np.uint64).astype(np.uint32)))
    di, dv = delta.merge_chunks(chunks)
    ji, jv = jax_delta.merge_chunks(chunks)
    assert np.array_equal(di, ji) and np.array_equal(dv, jv)
    want = np.asarray(jax_delta.apply_overlay(base, ji, jv, SHARD_WORDS))
    mirror = torch.from_numpy(base.view(np.int32).copy())
    got = delta.apply_overlay(mirror, di, dv, SHARD_WORDS)
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(to_numpy(mirror), base)   # the old one stands
    # the stacked form: three members, each with its own merged words
    stack = torch.from_numpy(np.stack([base, base ^ 1, base]).view(np.int32)
                             .copy())
    members = np.concatenate([np.full(di.size, m, np.int64)
                              for m in (0, 2)])
    out = delta.apply_stack_overlay(stack, members, np.concatenate([di, di]),
                                    np.concatenate([dv, dv]), SHARD_WORDS)
    out = to_numpy(out)
    assert np.array_equal(out[0], want) and np.array_equal(out[2], want)
    assert np.array_equal(out[1], base ^ 1)


def test_fragment_mirror_overlay():
    """A resident mirror absorbs an ingest flush through the journal (a
    new tensor, no re-upload), equal to the JAX fragment's mirror."""
    rng = np.random.default_rng(23)
    frs = (Fragment(None, "i", "f", "standard", 0),
           JaxFragment(None, "i", "f", "standard", 0))
    r0, c0 = rng.integers(0, 8, size=300), rng.integers(0, SHARD_WIDTH,
                                                        size=300)
    for fr in frs:
        fr.bulk_import(r0, c0)
    m0 = frs[0].device("cpu")
    frs[1].device()
    uploads = frs[0].budget.upload_bytes
    for _ in range(3):
        r, c = rng.integers(0, 8, size=200), rng.integers(0, SHARD_WIDTH,
                                                          size=200)
        for fr in frs:
            assert fr.ingest_apply(r, c) > 0
    assert frs[0].device_gen != frs[0].gen and frs[0].delta_bytes() > 0
    m1 = frs[0].device("cpu")
    assert m1 is not m0 and frs[0].budget.upload_bytes == uploads
    assert np.array_equal(to_numpy(m1), np.asarray(frs[1].device()))
    assert np.array_equal(to_numpy(m1), frs[0].to_dense())
    # a fold re-anchors the device form at the current generation
    assert frs[0].fold_delta() and frs[0].device_gen == frs[0].gen
    assert np.array_equal(to_numpy(frs[0].device("cpu")), frs[0].to_dense())


def _ingest(pair, path, body):
    return both(pair, "POST", path, body, "application/octet-stream")


@pytest.mark.parametrize("residency", ["dense", "compressed"])
def test_ingest_served_equal(tmp_path, residency):
    """The same frames through both servers' /ingest: identical acks,
    then identical answers (overlay on dense fragments, re-pack on
    compressed ones)."""
    kw = {"ingest_flush_ms": 10.0}
    if residency == "compressed":
        kw["device_budget_mb"] = 64
    rng = np.random.default_rng(24)
    with _pair(tmp_path, **kw) as pair:
        both(pair, "POST", "/index/i", {})
        for name, opts in (("s", {}), ("g", {}),
                           ("v", {"type": "int", "min": 0, "max": 5000}),
                           ("t", {"type": "time", "timeQuantum": "YM"})):
            both(pair, "POST", f"/index/i/field/{name}", {"options": opts})
        r, c = _records(rng, 800)
        both(pair, "POST", "/index/i/field/s/import",
             {"rowIDs": r.tolist(), "columnIDs": c.tolist()})
        both(pair, "POST", "/index/i/field/g/import",
             {"rowIDs": (r % 3).tolist(), "columnIDs": c.tolist()})
        reads = "Count(Row(s=1)) TopN(s, Row(g=0), n=4) Row(s=2) " \
                "Count(Intersect(Row(s=3), Row(g=1)))"
        query(pair, reads)                     # stage the device forms
        for k in range(3):
            r, c = _records(rng, 700)
            ack = _ingest(pair, "/index/i/field/s/ingest",
                          wire.encode_records(r, c, frame_records=256))
            assert json.loads(ack) == {"frames": 3, "records": 700,
                                       "forwarded": 0}
            query(pair, reads)
        vc = rng.choice(N_SHARDS * SHARD_WIDTH, size=300, replace=False)
        _ingest(pair, "/index/i/field/v/ingest", wire.encode_records(
            None, vc, values=rng.integers(0, 5000, size=300)))
        ts = np.full(300, 1_500_000_000) + rng.integers(0, 10**7, size=300)
        r, c = _records(rng, 300, rows=3)
        _ingest(pair, "/index/i/field/t/ingest",
                wire.encode_records(r, c, ts=ts))
        query(pair, "Sum(field=v) Count(Row(v > 2500)) Row(t=1) "
                    "Row(t=2, from=2017-01-01T00:00, to=2018-01-01T00:00)")
        # bad streams are refused the same way, before any record lands
        _ingest(pair, "/index/i/field/s/ingest", b"NOTMAGIC")
        _ingest(pair, "/index/i/field/s/ingest", wire.encode_records(
            None, c[:5], values=c[:5]))
        _ingest(pair, "/index/i/field/s/ingest", wire.encode_records(
            -r[:5] - 1, c[:5]))
        _ingest(pair, "/index/i/field/nope/ingest",
                wire.encode_records(r[:5], c[:5]))
        query(pair, reads)


def test_stack_refreshes_by_overlay(tmp_path):
    """A dense stack resident in the port's stacked executor absorbs
    acked ingest flushes as overlays — no re-stage — and answers as the
    JAX server does."""
    rng = np.random.default_rng(25)
    with _pair(tmp_path, ingest_flush_ms=10.0) as pair:
        both(pair, "POST", "/index/i", {})
        for name in ("s", "g"):
            both(pair, "POST", f"/index/i/field/{name}", {})
        r, c = _records(rng, 900)
        for name in ("s", "g"):
            both(pair, "POST", f"/index/i/field/{name}/import",
                 {"rowIDs": r.tolist(), "columnIDs": c.tolist()})
        reads = "Count(Row(s=1)) TopN(s, Row(g=2), n=3) " \
                "Count(Intersect(Row(s=4), Row(g=4)))"
        query(pair, reads)
        st = pair[1].api.executor.stacked
        builds, overlays = st.stack_builds, st.overlays
        for k in range(3):
            r, c = _records(rng, 500)
            _ingest(pair, "/index/i/field/s/ingest",
                    wire.encode_records(r, c))
            query(pair, reads)
        assert st.stack_builds == builds
        assert st.overlays > overlays
        # a non-ingest write supersedes the journal: one re-stage
        query(pair, "Set(1, s=1)")
        query(pair, reads)
        assert st.stack_builds > builds
        _raw(pair[1], "GET", "/debug/vars")


def test_port_ingest_fold_budget(tmp_path):
    """With the delta budget at 0 there is no overlay: every flush
    re-anchors the device form, and the answers still follow the acks."""
    rng = np.random.default_rng(26)
    with _serving(_port_cfg, port_server, tmp_path / "p",
                  ingest_delta_mb=0, ingest_flush_ms=0) as srv:
        _raw(srv, "POST", "/index/i", {})
        _raw(srv, "POST", "/index/i/field/s", {})
        want = set()
        for _ in range(3):
            r, c = _records(rng, 200, rows=1)
            st, _, body = _raw(srv, "POST", "/index/i/field/s/ingest",
                               wire.encode_records(r, c),
                               "application/octet-stream")
            assert st == 200, body
            want |= set(c.tolist())
            st, _, body = _raw(srv, "POST", "/index/i/query",
                               b"Count(Row(s=0))")
            assert json.loads(body)["results"] == [len(want)]
        assert srv.api.executor.stacked.overlays == 0
        assert srv.committer.snapshot()["journalFragments"] == 0
