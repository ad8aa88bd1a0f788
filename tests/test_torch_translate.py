"""Key translation in the PyTorch port (pilosa_tpu_torch/storage/
translate.py, the executor's keyed paths and the cluster's remote
stores): the counterpart of tests/test_translate.py, with
``device="cpu"`` on every API and server.

Differential: the same seeded key sequence, with repeats and a reopen
of the append-only log, gets the same IDs from the port's
``TranslateStore`` as from the JAX package's; and the same keyed
writes through each package's ``API`` leave the same column and row
translation entries.  The keyed-query, restart and cluster cases of
tests/test_translate.py run on the port as they are.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.api import API as JaxAPI  # noqa: E402
from pilosa_tpu.storage import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.storage.translate import (  # noqa: E402
    TranslateStore as JaxTranslateStore)
from pilosa_tpu_torch.api import API  # noqa: E402
from pilosa_tpu_torch.storage import Holder  # noqa: E402
from pilosa_tpu_torch.storage.translate import TranslateStore  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _req, make_cluster, query, restore_knobs)


def _api(holder):
    return API(holder, device="cpu")


# -- store ------------------------------------------------------------------

def test_store_roundtrip(tmp_path):
    s = TranslateStore(str(tmp_path / "keys"))
    a = s.translate_key("alpha")
    b = s.translate_key("beta")
    assert (a, b) == (1, 2)
    assert s.translate_key("alpha") == a  # stable
    assert s.translate_id(a) == "alpha"
    assert s.translate_id(99) is None
    assert s.find_key("beta") == b
    assert s.find_key("nope") is None
    s.close()

    # replay from the append-only log
    s2 = TranslateStore(str(tmp_path / "keys"))
    assert s2.translate_id(1) == "alpha"
    assert s2.translate_key("beta") == 2
    assert s2.translate_key("gamma") == 3
    s2.close()


def test_store_entries_from(tmp_path):
    s = TranslateStore(None)
    for k in ("a", "b", "c"):
        s.translate_key(k)
    assert s.entries_from(1) == [(2, "b"), (3, "c")]
    assert s.entries_from(3) == []


def _key_sequence(seed, n=400):
    rng = np.random.default_rng(seed)
    words = [f"user{i}" for i in range(120)] + ["", "é", "a b", "x\ny"]
    return [words[int(i)] for i in rng.integers(0, len(words), n)]


def test_store_ids_match_jax(tmp_path):
    """One seeded key sequence, half before and half after a reopen, in
    batches and one at a time: the same IDs and the same log bytes."""
    keys = _key_sequence(3)
    got = {}
    for tag, cls in (("jax", JaxTranslateStore), ("port", TranslateStore)):
        path = str(tmp_path / tag)
        s = cls(path)
        ids = [s.translate_key(k) for k in keys[:150]]
        ids += list(s.translate_keys(keys[150:200]))
        s.close()
        s = cls(path)
        ids += [s.translate_key(k) for k in keys[200:]]
        back = [s.translate_id(i) for i in ids]
        got[tag] = (ids, back, s.entries_from(0))
        s.close()
        with open(path, "rb") as f:
            got[tag] += (f.read(),)
    assert got["port"] == got["jax"]
    assert got["port"][1] == keys


def test_keyed_api_translation_matches_jax():
    """The same keyed writes and imports through each package's API
    leave the same column and row entries and the same answers."""
    rng = np.random.default_rng(8)
    cols = _key_sequence(5, n=60)
    roles = ["admin", "dev", "ops", "qa"]
    writes = [f'Set("{c}", f="{roles[int(r)]}")'
              for c, r in zip(cols, rng.integers(0, 4, len(cols)))
              if c and "\n" not in c]
    out = {}
    for tag, api in (("jax", JaxAPI(JaxHolder(None))),
                     ("port", _api(Holder(None)))):
        api.create_index("ki", keys=True)
        api.create_field("ki", "f", {"keys": True})
        for w in writes:
            api.query("ki", w)
        api.import_bits("ki", "f", row_keys=["r1", "r1", "r2"],
                        column_keys=["c1", cols[0], "c3"])
        idx = api.holder.index("ki")
        [topn] = api.query("ki", "TopN(f, n=3)")
        out[tag] = (idx.translate_store().entries_from(0),
                    idx.field("f").translate_store().entries_from(0),
                    [(p.key, p.count) for p in topn])
        if tag == "port":
            api.executor.close()
    assert out["port"] == out["jax"]


# -- single-node keyed queries ---------------------------------------------

@pytest.fixture
def keyed_api():
    api = _api(Holder(None))
    api.create_index("ki", keys=True)
    api.create_field("ki", "f", {"keys": True})
    api.create_field("ki", "plain", {})
    api.create_field("ki", "b", {"type": "bool"})
    yield api
    api.executor.close()


def test_keyed_set_and_row(keyed_api):
    api = keyed_api
    [changed] = api.query("ki", 'Set("user123", f="admin")')
    assert changed is True
    [row] = api.query("ki", 'Row(f="admin")')
    assert row.keys == ["user123"]
    [count] = api.query("ki", 'Count(Row(f="admin"))')
    assert count == 1
    # same keys translate to the same ids on re-use
    api.query("ki", 'Set("user456", f="admin")')
    [row] = api.query("ki", 'Row(f="admin")')
    assert sorted(row.keys) == ["user123", "user456"]


def test_keyed_topn_and_rows(keyed_api):
    api = keyed_api
    for user, role in [("u1", "admin"), ("u2", "admin"), ("u3", "dev"),
                       ("u4", "admin"), ("u5", "dev"), ("u6", "ops")]:
        api.query("ki", f'Set("{user}", f="{role}")')
    [topn] = api.query("ki", "TopN(f, n=2)")
    assert [(p.key, p.count) for p in topn] == [("admin", 3), ("dev", 2)]
    [rows] = api.query("ki", "Rows(f)")
    assert sorted(rows.keys) == ["admin", "dev", "ops"]


def test_keyed_groupby(keyed_api):
    api = keyed_api
    api.query("ki", 'Set("u1", f="admin") Set("u2", f="admin")')
    [groups] = api.query("ki", "GroupBy(Rows(f))")
    assert groups[0].group[0].row_key == "admin"
    assert groups[0].count == 2


def test_unknown_read_key_is_empty(keyed_api):
    [count] = keyed_api.query("ki", 'Count(Row(f="nobody"))')
    assert count == 0


def test_bool_row_translation(keyed_api):
    api = keyed_api
    api.query("ki", 'Set("u1", b=true) Set("u2", b=false)')
    [row_t] = api.query("ki", "Row(b=true)")
    assert row_t.keys == ["u1"]
    [row_f] = api.query("ki", "Row(b=false)")
    assert row_f.keys == ["u2"]


def test_string_keys_rejected_when_disabled():
    api = _api(Holder(None))
    try:
        api.create_index("plain")
        api.create_field("plain", "f", {})
        with pytest.raises(ValueError, match="keys"):
            api.query("plain", 'Set("user", f=1)')
        with pytest.raises(ValueError, match="keys"):
            api.query("plain", 'Row(f="admin")')
    finally:
        api.executor.close()


def test_non_string_rejected_when_keys_enabled(keyed_api):
    with pytest.raises(ValueError, match="must be a string"):
        keyed_api.query("ki", "Set(5, f=1)")


def test_clear_keyed(keyed_api):
    api = keyed_api
    api.query("ki", 'Set("u1", f="admin")')
    [changed] = api.query("ki", 'Clear("u1", f="admin")')
    assert changed is True
    [count] = api.query("ki", 'Count(Row(f="admin"))')
    assert count == 0


def test_keyed_import(keyed_api):
    api = keyed_api
    api.import_bits("ki", "f", row_keys=["r1", "r1", "r2"],
                    column_keys=["c1", "c2", "c3"])
    [row] = api.query("ki", 'Row(f="r1")')
    assert sorted(row.keys) == ["c1", "c2"]


def test_keys_persist_across_restart(tmp_path):
    h = Holder(str(tmp_path / "d"))
    h.open()
    api = _api(h)
    api.create_index("ki", keys=True)
    api.create_field("ki", "f", {"keys": True})
    api.query("ki", 'Set("user123", f="admin")')
    api.executor.close()
    h.close()

    h2 = Holder(str(tmp_path / "d"))
    h2.open()
    api2 = _api(h2)
    [row] = api2.query("ki", 'Row(f="admin")')
    assert row.keys == ["user123"]
    # new keys continue the sequence, not restart it
    assert h2.index("ki").translate_store().translate_key("userX") > 1
    api2.executor.close()
    h2.close()


# -- cluster round-trip over HTTP ------------------------------------------

def test_keyed_cluster_roundtrip(tmp_path):
    servers = make_cluster(tmp_path, n=3, replica_n=2)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ki", {"options": {"keys": True}})
        _req(p0, "POST", "/index/ki/field/f",
             {"options": {"keys": True}})
        # write via a NON-coordinator node: translation routes to node0
        p1 = servers[1].port
        [changed] = query(p1, "ki", 'Set("user123", f="admin")')
        assert changed is True
        query(p1, "ki", 'Set("user456", f="admin") Set("user789", f="dev")')
        for srv in servers:
            [row] = query(srv.port, "ki", 'Row(f="admin")')
            assert sorted(row["keys"]) == ["user123", "user456"]
            [topn] = query(srv.port, "ki", "TopN(f, n=2)")
            assert [(p["key"], p["count"]) for p in topn] == \
                [("admin", 2), ("dev", 1)]
        # keyed import over HTTP through a replica
        _req(p1, "POST", "/index/ki/field/f/import",
             {"rowKeys": ["ops", "ops"], "columnKeys": ["userA", "userB"]})
        [cnt] = query(servers[2].port, "ki", 'Count(Row(f="ops"))')
        assert cnt == 2
    finally:
        for s in servers:
            s.close()


def test_replica_translate_streaming_catchup(tmp_path):
    """Anti-entropy pulls new key entries to replicas in one stream
    (holder.go:812 holderTranslateStoreReplicator): after a sync, reads
    of coordinator-written keys need no per-key round trips."""
    from pilosa_tpu_torch.parallel.cluster import RemoteTranslateStore

    servers = make_cluster(tmp_path, n=2, replica_n=2)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ki", {"options": {"keys": True}})
        _req(p0, "POST", "/index/ki/field/f", {"options": {"keys": True}})
        query(p0, "ki", 'Set("u1", f="admin") Set("u2", f="dev")')
        idx1 = servers[1].holder.index("ki")
        col_ts = idx1.translate_store()
        row_ts = idx1.field("f").translate_store()
        assert isinstance(col_ts, RemoteTranslateStore)
        assert col_ts.find_key("u1") is None
        servers[1].cluster.sync_holder()
        assert col_ts.find_key("u1") is not None
        assert col_ts.find_key("u2") is not None
        assert row_ts.find_key("admin") is not None
        # incremental: only NEW entries stream on the next pass
        query(p0, "ki", 'Set("u3", f="admin")')
        assert col_ts.sync_entries() == 1
        assert col_ts.sync_entries() == 0
    finally:
        for s in servers:
            s.close()


def test_remote_translate_batches_requests():
    """N uncached keys or ids translate in ONE coordinator POST."""
    from pilosa_tpu_torch.parallel.cluster import RemoteTranslateStore

    calls = []

    class FakeClient:
        def _json(self, host, method, path, body):
            calls.append(body)
            if "keys" in body:
                return {"ids": [100 + i for i, _ in
                                enumerate(body["keys"])]}
            return {"keys": [f"k{i}" for i in body["ids"]]}

    st = RemoteTranslateStore(FakeClient(), "h", "i", None)
    ids = st.translate_keys(["a", "b", "c", "a"])
    assert len(calls) == 1 and calls[0] == {"keys": ["a", "b", "c"]}
    assert ids[0] == ids[3]
    st.translate_keys(["a", "c"])
    assert len(calls) == 1
    # id -> key batches the uncached subset only
    st.translate_ids([7, 8, ids[0]])
    assert len(calls) == 2 and calls[1] == {"ids": [7, 8]}
    st.translate_ids([7, 8])
    assert len(calls) == 2
