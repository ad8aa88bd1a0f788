"""The PyTorch port's event journal (pilosa_tpu_torch/utils/events.py):
the counterpart of tests/test_events.py, with ``device="cpu"`` on every
server.  Ring and cursor semantics, the framed on-disk log's torn-tail
recovery, emission from real state-transition sites (breaker,
backpressure, drain) and the /debug/events endpoint.

Differential: the same emissions, with the wall clock pinned, leave the
same ring entries and the same on-disk log bytes in both packages'
journals; and the same breaker and backpressure transitions emit the
same event names and fields in both packages.

Left out: the three ``event-names`` analyzer cases of
tests/test_events.py, which lint a tree laid out as the JAX package
with the JAX analyzer.  The port's analyzer rules, ``event-names``
among them, are covered by tests/test_torch_analysis.py.  The
``/debug/events`` cursor across a cluster is covered by
tests/test_torch_cluster_obs.py.
"""

import os

import pytest

pytest.importorskip("torch")

from pilosa_tpu.utils import events as jevents  # noqa: E402
from pilosa_tpu_torch.utils import events as pevents  # noqa: E402
from pilosa_tpu_torch.utils.events import (  # noqa: E402
    EVENT_LOG_MAGIC, EVENTS, EventJournal)

from test_torch_cluster import restore_knobs  # noqa: E402, F401
from test_torch_cluster_obs import _req, make_server  # noqa: E402


# -- ring + cursor -----------------------------------------------------------


def test_emit_seq_and_since_cursor():
    j = EventJournal(size=16)
    j.node_id = "nodeX"
    first = j.emit("breaker.open", host="h1", fails=5)
    assert first["seq"] == 1
    assert first["node"] == "nodeX"
    assert first["event"] == "breaker.open"
    for i in range(4):
        j.emit("node.down", peer=f"n{i}", reason="r")
    assert j.last_seq() == 5
    # cursor: strictly-after semantics, oldest first
    tail = j.since(1)
    assert [e["seq"] for e in tail] == [2, 3, 4, 5]
    assert j.since(5) == []
    # limit keeps the OLDEST entries: a cursor-advancing reader (the
    # fleet rollup) resumes losslessly from the last seq it folded,
    # instead of skipping the burst's middle forever
    lim = j.since(0, limit=2)
    assert [e["seq"] for e in lim] == [1, 2]
    assert [e["seq"] for e in j.since(2, limit=2)] == [3, 4]
    assert j.since(0, limit=0) == []


def test_ring_bound_and_resize():
    j = EventJournal(size=4)
    for i in range(10):
        j.emit("node.up", peer=f"n{i}")
    snap = j.snapshot()
    assert len(snap["events"]) == 4
    assert snap["emitted"] == 10
    assert [e["seq"] for e in snap["events"]] == [7, 8, 9, 10]
    j.resize(2)
    assert [e["seq"] for e in j.snapshot()["events"]] == [9, 10]
    # None-valued fields are dropped, not serialized as null
    e = j.emit("node.down", peer="n1", reason=None)
    assert "reason" not in e


def test_emit_never_raises_on_dead_log(tmp_path):
    j = EventJournal(size=8)
    j.open_log(str(tmp_path / "nodir" / "deeper" / "events.log"))
    assert j.write_errors == 1  # open failed, counted
    e = j.emit("server.drain", budgetS=1.0)  # ring still records
    assert e["seq"] == 1


# -- framed on-disk log ------------------------------------------------------


def test_log_round_trip_and_reopen(tmp_path):
    path = str(tmp_path / "events.log")
    j = EventJournal(size=8)
    j.open_log(path)
    j.emit("breaker.open", host="h", fails=3)
    j.emit("breaker.close", host="h")
    j.close_log()
    got = EventJournal.read_log(path)
    assert [e["event"] for e in got] == ["breaker.open", "breaker.close"]
    assert got[0]["fails"] == 3
    # reopen appends after the existing frames
    j2 = EventJournal(size=8)
    j2.open_log(path)
    j2.emit("node.up", peer="n2")
    j2.close_log()
    assert [e["event"] for e in EventJournal.read_log(path)] == \
        ["breaker.open", "breaker.close", "node.up"]


def test_log_torn_tail_truncates_at_frame_boundary(tmp_path):
    path = str(tmp_path / "events.log")
    j = EventJournal(size=8)
    j.open_log(path)
    j.emit("node.down", peer="a", reason="x")
    j.emit("node.up", peer="a")
    j.close_log()
    whole = os.path.getsize(path)
    # tear mid-frame: drop the last 3 bytes of the final frame
    with open(path, "r+b") as f:
        f.truncate(whole - 3)
    j2 = EventJournal(size=8)
    j2.open_log(path)
    j2.emit("server.drain", budgetS=2.0)
    j2.close_log()
    events = EventJournal.read_log(path)
    # the torn second frame is gone; the valid prefix + new frame remain
    assert [e["event"] for e in events] == ["node.down", "server.drain"]


def test_log_corrupt_byte_truncates(tmp_path):
    path = str(tmp_path / "events.log")
    j = EventJournal(size=8)
    j.open_log(path)
    j.emit("node.down", peer="a", reason="x")
    j.emit("node.up", peer="a")
    j.close_log()
    data = open(path, "rb").read()
    # flip one payload byte of frame 2 -> CRC mismatch -> truncate there
    flip_at = len(data) - 4
    with open(path, "r+b") as f:
        f.seek(flip_at)
        b = f.read(1)
        f.seek(flip_at)
        f.write(bytes([b[0] ^ 0xFF]))
    assert [e["event"] for e in EventJournal.read_log(path)] == \
        ["node.down"]
    j2 = EventJournal(size=8)
    j2.open_log(path)  # truncates the bad tail durably
    j2.close_log()
    assert os.path.getsize(path) < len(data)
    data2 = open(path, "rb").read()
    assert data2.startswith(EVENT_LOG_MAGIC)


def test_garbage_file_rewritten(tmp_path):
    path = str(tmp_path / "events.log")
    with open(path, "wb") as f:
        f.write(b"not an event log at all")
    j = EventJournal(size=8)
    j.open_log(path)
    j.emit("node.up", peer="z")
    j.close_log()
    assert [e["event"] for e in EventJournal.read_log(path)] == \
        ["node.up"]


# -- real emission sites -----------------------------------------------------


def test_breaker_transitions_emit_events():
    from pilosa_tpu_torch.parallel.cluster import (CircuitOpenError,
                                                   InternalClient)
    seq0 = EVENTS.last_seq()
    c = InternalClient(breaker_threshold=2)
    try:
        for _ in range(2):
            c._breaker_failure("hostA:1")
        names = [e["event"] for e in EVENTS.since(seq0)]
        assert "breaker.open" in names
        # open breaker: fail fast, no new transition event
        with pytest.raises(CircuitOpenError):
            c._breaker_allow("hostA:1")
        # the probe's trial admission is the half-open transition
        c._breaker_allow("hostA:1", trial=True)
        c._breaker_success("hostA:1")
        names = [e["event"] for e in EVENTS.since(seq0)]
        assert names.count("breaker.open") == 1
        assert "breaker.half_open" in names
        assert "breaker.close" in names
    finally:
        c.close()


def test_backpressure_engage_release_events(tmp_path):
    from pilosa_tpu_torch.ingest.committer import GroupCommitter
    from pilosa_tpu_torch.storage import Holder
    holder = Holder(str(tmp_path / "h"))
    holder.open()
    try:
        com = GroupCommitter(holder, flush_ms=0, high_water_bytes=64)
        seq0 = EVENTS.last_seq()
        idx = holder.create_index("i")
        idx.create_field("f")
        com.submit("i", "f", rows=list(range(16)), cols=list(range(16)))
        assert com.wait_capacity(timeout=0.01) is False  # over high-water
        names = [e["event"] for e in EVENTS.since(seq0)]
        assert names.count("ingest.backpressure_engage") == 1
        # second refusal in the same episode: no duplicate engage event
        assert com.wait_capacity(timeout=0.01) is False
        names = [e["event"] for e in EVENTS.since(seq0)]
        assert names.count("ingest.backpressure_engage") == 1
        com.wait_flushed(com._submit_seq)  # inline flush drains it
        names = [e["event"] for e in EVENTS.since(seq0)]
        assert "ingest.backpressure_release" in names
        com.close()
    finally:
        holder.close()


def test_server_drain_event_and_debug_events_endpoint(tmp_path):
    srv = make_server(tmp_path, slow_query_threshold=0)
    p = srv.port
    try:
        seq0 = EVENTS.last_seq()
        EVENTS.emit("node.up", peer="synthetic")
        out, _ = _req(p, "GET", f"/debug/events?since={seq0}")
        assert [e["event"] for e in out["events"]] == ["node.up"]
        assert out["seq"] >= seq0 + 1
        # no cursor: full snapshot shape
        full, _ = _req(p, "GET", "/debug/events")
        assert full["size"] == srv.config.event_journal_size
        assert any(e["event"] == "node.up" for e in full["events"])
        # limit applies
        lim, _ = _req(p, "GET", "/debug/events?limit=1")
        assert len(lim["events"]) == 1
    finally:
        seq1 = EVENTS.last_seq()
        srv.close()
    assert any(e["event"] == "server.drain"
               for e in EVENTS.since(seq1 - 1))


def test_event_log_knob_persists_across_restart(tmp_path):
    srv = make_server(tmp_path, name="n", event_log=True,
                      slow_query_threshold=0)
    try:
        EVENTS.emit("node.down", peer="x", reason="test")
        path = os.path.join(os.path.expanduser(srv.config.data_dir),
                            "events.log")
        assert os.path.exists(path)
    finally:
        srv.close()
    events = EventJournal.read_log(path)
    assert any(e["event"] == "node.down" and e["peer"] == "x"
               for e in events)
    assert any(e["event"] == "server.drain" for e in events)


# -- differential: the JAX package's journal ---------------------------------


def _emit_script(j):
    j.node_id = "nodeX"
    j.emit("breaker.open", host="h1", fails=5)
    for i in range(3):
        j.emit("node.down", peer=f"n{i}", reason="r" if i else None)
    j.emit("server.drain", budgetS=1.5)
    j.emit("node.up", peer="é")


def test_journal_entries_and_log_bytes_match_jax(tmp_path, monkeypatch):
    got = {}
    for tag, mod in (("jax", jevents), ("port", pevents)):
        monkeypatch.setattr(mod, "_wall_stamp", lambda: 1700000000.25)
        path = str(tmp_path / f"{tag}.log")
        j = mod.EventJournal(size=4)
        j.open_log(path)
        _emit_script(j)
        j.close_log()
        with open(path, "rb") as f:
            raw = f.read()
        got[tag] = (j.snapshot(), j.since(2, limit=2), raw,
                    mod.EventJournal.read_log(path))
    assert got["port"] == got["jax"]


def _strip(entries):
    return [{k: v for k, v in e.items() if k not in ("wall", "seq", "node")}
            for e in entries]


def test_breaker_and_backpressure_events_match_jax(tmp_path):
    from pilosa_tpu.ingest.committer import GroupCommitter as JaxCommitter
    from pilosa_tpu.parallel.cluster import InternalClient as JaxClient
    from pilosa_tpu.storage import Holder as JaxHolder
    from pilosa_tpu_torch.ingest.committer import GroupCommitter
    from pilosa_tpu_torch.parallel.cluster import InternalClient
    from pilosa_tpu_torch.storage import Holder

    got = {}
    for tag, mod, client_cls, holder_cls, com_cls in (
            ("jax", jevents, JaxClient, JaxHolder, JaxCommitter),
            ("port", pevents, InternalClient, Holder, GroupCommitter)):
        seq0 = mod.EVENTS.last_seq()
        c = client_cls(breaker_threshold=2)
        try:
            for _ in range(2):
                c._breaker_failure("hostA:1")
            c._breaker_allow("hostA:1", trial=True)
            c._breaker_success("hostA:1")
        finally:
            c.close()
        holder = holder_cls(str(tmp_path / tag))
        holder.open()
        try:
            com = com_cls(holder, flush_ms=0, high_water_bytes=64)
            holder.create_index("i").create_field("f")
            com.submit("i", "f", rows=list(range(16)),
                       cols=list(range(16)))
            assert com.wait_capacity(timeout=0.01) is False
            com.wait_flushed(com._submit_seq)
            com.close()
        finally:
            holder.close()
        got[tag] = _strip(mod.EVENTS.since(seq0))
    assert [e["event"] for e in got["port"]] == [
        "breaker.open", "breaker.half_open", "breaker.close",
        "ingest.backpressure_engage", "ingest.backpressure_release"]
    assert got["port"] == got["jax"]
