"""Crash-consistent, self-healing storage in the PyTorch port
(pilosa_tpu_torch/storage/fragment.py, roaring_io.py, attrs.py and the
server's degraded surfaces): the counterpart of
tests/test_durability.py, with ``device="cpu"`` on every server.

Differential: the snapshot codec writes the JAX package's bytes; a
fragment written by the port is byte-identical on disk to one written
by the JAX package from the same operations; and every truncated or
bit-flipped snapshot and WAL of the fuzz cases (every offset) is opened
by both packages, which must recover the same bits and reach the same
quarantine outcome.  The legacy-format, close-ordering, quarantine
lifecycle, server degraded-serving and 2-node repair cases run on the
port as they are.  The process-level kill -9 harness is in
tests/test_torch_crash.py.
"""

import json
import os
import shutil
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.storage import fragment as jfragment  # noqa: E402
from pilosa_tpu.storage import roaring_io as jroaring  # noqa: E402
from pilosa_tpu_torch.core import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.server import Server  # noqa: E402
from pilosa_tpu_torch.storage import fragment as fragment_mod  # noqa: E402
from pilosa_tpu_torch.storage.fragment import (  # noqa: E402
    Fragment,
    FragmentQuarantinedError,
    storage_events,
)
from pilosa_tpu_torch.storage.roaring_io import (  # noqa: E402
    SnapshotFormatError,
    pack_snapshot,
    unpack_snapshot,
)
from pilosa_tpu_torch.utils.faults import FAULTS  # noqa: E402

from test_torch_cluster import _free_ports, restore_knobs  # noqa: E402, F401
from test_torch_cluster_obs import Config  # noqa: E402


SHARD_WORDS = SHARD_WIDTH // 32


def _mk_fragment(path, cls=Fragment, **kw):
    kw.setdefault("max_op_n", 10 ** 6)
    return cls(path, "i", "f", "standard", 0, **kw)


def _bits(frag, rows=range(12)):
    """Bitmap as a comparable set of (row, col) pairs."""
    out = set()
    for r in rows:
        for c in frag.row_columns(r).tolist():
            out.add((r, c))
    return out


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    FAULTS.disarm()


# -- snapshot codec ---------------------------------------------------------

def test_snapshot_codec_roundtrip():
    idx = np.array([0, 5, SHARD_WORDS + 3, 7 * SHARD_WORDS], dtype=np.int64)
    val = np.array([1, 0xFFFFFFFF, 2, 9], dtype=np.uint32)
    blob = pack_snapshot(8, idx, val, SHARD_WORDS)
    assert blob == jroaring.pack_snapshot(8, idx, val, SHARD_WORDS)
    cap, ridx, rval = unpack_snapshot(blob, SHARD_WORDS)
    assert cap == 8
    assert ridx.tolist() == idx.tolist()
    assert rval.tolist() == val.tolist()
    # empty store round-trips too
    cap, ridx, rval = unpack_snapshot(
        pack_snapshot(0, idx[:0], val[:0], SHARD_WORDS), SHARD_WORDS)
    assert (cap, ridx.size, rval.size) == (0, 0, 0)


def test_snapshot_codec_detects_every_byte_flip():
    """Every single-byte corruption of a v4 snapshot must raise
    SnapshotFormatError — header flips via the header CRC (before nnz is
    trusted), payload flips via the trailer CRC, CRC-byte flips via
    their own mismatch."""
    idx = np.arange(10, dtype=np.int64) * 3
    val = np.arange(1, 11, dtype=np.uint32)
    blob = pack_snapshot(4, idx, val, SHARD_WORDS)
    for off in range(len(blob)):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        with pytest.raises(SnapshotFormatError):
            unpack_snapshot(bytes(bad), SHARD_WORDS)


def test_snapshot_codec_detects_truncation_and_garbage():
    blob = pack_snapshot(4, np.array([1], dtype=np.int64),
                         np.array([7], dtype=np.uint32), SHARD_WORDS)
    for cut in range(len(blob)):
        with pytest.raises(SnapshotFormatError):
            unpack_snapshot(blob[:cut], SHARD_WORDS)
    with pytest.raises(SnapshotFormatError):
        unpack_snapshot(blob + b"\x00", SHARD_WORDS)  # appended garbage


# -- byte-level corruption fuzz over Fragment.open(), both packages -------

def _seed_fragment_dir(tmp_path, wal_bits=0, cls=Fragment, tag="seed"):
    """A fragment dir with a snapshotted prefix and (optionally) a framed
    WAL of `wal_bits` single-op frames.  Returns (path, snapshot_state,
    per-op (row, col) list)."""
    path = str(tmp_path / tag / "frag")
    f = _mk_fragment(path, cls)
    for c in range(10):
        f.set_bit(c % 3, 17 * c + 1)
    f.snapshot()
    snap_state = _bits(f)
    ops = []
    for i in range(wal_bits):
        row, col = 5 + (i % 2), 1000 + i
        f.set_bit(row, col)
        ops.append((row, col))
    f._wal_file.flush()
    del f
    return path, snap_state, ops


def _fuzz_open(path, cls=Fragment):
    """Open a (possibly corrupted) fragment the way the server does.
    The contract under test: NEVER an exception, whatever the bytes.
    Returns (fragment, recovered bits, WAL size right after open) — the
    size is captured BEFORE close(), which snapshots replayed ops and
    truncates the WAL to a fresh magic."""
    frag = _mk_fragment(path, cls)
    got = _bits(frag)
    wal_size = os.path.getsize(path + ".wal") \
        if os.path.exists(path + ".wal") else None
    frag.close()
    return frag, got, wal_size


def _copy_seed(seed_path, tmp_path, case):
    dst = str(tmp_path / f"case{case}" / "frag")
    os.makedirs(os.path.dirname(dst))
    shutil.copy(seed_path, dst)
    if os.path.exists(seed_path + ".wal"):
        shutil.copy(seed_path + ".wal", dst + ".wal")
    return dst


def _damage(path, which, cut=None, flip=None):
    target = path + ".wal" if which == "wal" else path
    if cut is not None:
        with open(target, "r+b") as fh:
            fh.truncate(cut)
    else:
        off, mask = flip
        blob = bytearray(open(target, "rb").read())
        blob[off] ^= mask
        with open(target, "wb") as fh:
            fh.write(bytes(blob))


def _open_both(seed, tmp_path, case, which, **damage):
    """The same damage applied to two copies of the seed, one opened by
    each package: the quarantine outcome, the recovered bits, the WAL
    size after open and every file left behind must be equal.  Returns
    the port's (fragment, bits, WAL size)."""
    out = {}
    for tag, cls in (("jax", jfragment.Fragment), ("port", Fragment)):
        path = _copy_seed(seed, tmp_path, f"{case}-{tag}")
        _damage(path, which, **damage)
        frag, got, wal_size = _fuzz_open(path, cls)
        d = os.path.dirname(path)
        # the quarantine marker names its own path
        files = {fn: open(os.path.join(d, fn), "rb").read().replace(
                     d.encode(), b"<dir>") for fn in sorted(os.listdir(d))}
        out[tag] = (frag, got, wal_size)
        out[tag + "_cmp"] = (frag.quarantined is None, got, wal_size, files)
    assert out["port_cmp"] == out["jax_cmp"], (case, damage)
    return out["port"]


def test_fragment_files_match_jax(tmp_path):
    """The same operations write byte-identical snapshot and WAL files
    in both packages."""
    files = {}
    for tag, cls in (("jax", jfragment.Fragment), ("port", Fragment)):
        seed, _, _ = _seed_fragment_dir(tmp_path, 6, cls, tag)
        files[tag] = (open(seed, "rb").read(),
                      open(seed + ".wal", "rb").read())
    assert files["port"] == files["jax"]


def test_snapshot_truncation_fuzz(tmp_path):
    seed, snap_state, _ = _seed_fragment_dir(tmp_path)
    size = os.path.getsize(seed)
    for cut in range(size + 1):
        frag, got, _ = _open_both(seed, tmp_path, f"t{cut}", "snap",
                                  cut=cut)
        if cut == size:
            assert frag.quarantined is None and got == snap_state
        else:
            # a truncated snapshot has lost data: quarantine, never a
            # partial answer and never a crash
            assert frag.quarantined is not None, cut
            assert got == set()
            assert os.path.exists(frag.path + ".quarantine"), cut


def test_snapshot_bitflip_fuzz(tmp_path):
    seed, snap_state, _ = _seed_fragment_dir(tmp_path)
    for off in range(os.path.getsize(seed)):
        frag, got, _ = _open_both(seed, tmp_path, f"f{off}", "snap",
                                  flip=(off, 1 << (off % 8)))
        # CRC32 catches every single-bit flip: always quarantined
        assert frag.quarantined is not None, off
        assert got == set()


def test_wal_truncation_fuzz(tmp_path):
    """Truncation at EVERY WAL offset: open() recovers the longest valid
    frame prefix, durably truncates the tail, and never raises.  The
    recovered bitmap must be exactly snapshot + that prefix — nothing
    dropped before the tear, nothing invented after it."""
    seed, snap_state, ops = _seed_fragment_dir(tmp_path, wal_bits=6)
    wal = open(seed + ".wal", "rb").read()
    frame = (len(wal) - 8) // len(ops)  # fixed per-op frame size
    assert 8 + frame * len(ops) == len(wal)
    for cut in range(len(wal) + 1):
        frag, got, wal_size = _open_both(seed, tmp_path, f"w{cut}", "wal",
                                         cut=cut)
        assert frag.quarantined is None, cut
        n_frames = max(0, (cut - 8) // frame)
        assert got == snap_state | set(ops[:n_frames]), cut
        # the torn tail was truncated at the last valid frame boundary
        assert wal_size == 8 + n_frames * frame, cut


def test_wal_bitflip_fuzz(tmp_path):
    """A flipped bit at EVERY WAL offset: open() never raises, and the
    outcome is always one of (a) quarantined (mid-log corruption), (b) a
    valid frame prefix (tail frame corrupt -> truncated), or (c)
    everything (flip in the final frame detected as tail)."""
    seed, snap_state, ops = _seed_fragment_dir(tmp_path, wal_bits=6)
    valid = [snap_state | set(ops[:k]) for k in range(len(ops) + 1)]
    for off in range(os.path.getsize(seed + ".wal")):
        frag, got, _ = _open_both(seed, tmp_path, f"b{off}", "wal",
                                  flip=(off, 1 << (off % 8)))
        if frag.quarantined is not None:
            assert got == set(), off
        else:
            assert got in valid, off


def test_midlog_wal_corruption_quarantines(tmp_path):
    """A bad frame with valid frames AFTER it must quarantine, not
    truncate: the later frames are acknowledged writes, and dropping
    them silently would violate the durability contract."""
    seed, _, ops = _seed_fragment_dir(tmp_path, wal_bits=6)
    wal = bytearray(open(seed + ".wal", "rb").read())
    frame = (len(wal) - 8) // len(ops)
    wal[8 + frame + 10] ^= 0xFF  # inside frame #2's payload
    with open(seed + ".wal", "wb") as fh:
        fh.write(bytes(wal))
    frag, got, _ = _fuzz_open(seed)
    assert frag.quarantined is not None
    assert "CRC mismatch" in frag.quarantined
    assert got == set()


# -- legacy (pre-checksum) format compatibility -----------------------------

def _write_legacy_v3(path, cap_rows, idx, val):
    """The exact v3 writer this PR replaced: bare header + arrays, no
    CRCs anywhere."""
    with open(path, "wb") as f:
        f.write(struct.pack("<8sIIQ", b"PTPUFRG3", cap_rows, SHARD_WORDS,
                            idx.size))
        idx.astype("<u8").tofile(f)
        val.astype("<u4").tofile(f)


def _write_legacy_wal(path, ops):
    """The pre-framing WAL: a bare stream of <u8 op, i64 row, i64 col>
    records, no magic, no CRCs."""
    with open(path, "wb") as f:
        for op, row, col in ops:
            f.write(struct.pack("<Bqq", op, row, col))


def test_legacy_files_load_leniently(tmp_path):
    path = str(tmp_path / "legacy" / "frag")
    os.makedirs(os.path.dirname(path))
    idx = np.array([0, SHARD_WORDS * 2 + 1], dtype=np.int64)
    val = np.array([0b101, 7], dtype=np.uint32)
    _write_legacy_v3(path, 4, idx, val)
    _write_legacy_wal(path + ".wal", [(0, 9, 50), (0, 9, 51), (1, 9, 50)])
    frag = _mk_fragment(path)
    assert frag.quarantined is None
    assert set(frag.row_columns(0).tolist()) == {0, 2}
    assert set(frag.row_columns(9).tolist()) == {51}
    # appends keep the file's own legacy format (no mixed files) ...
    frag.set_bit(9, 52)
    frag._wal_file.flush()
    assert not open(path + ".wal", "rb").read().startswith(b"PTPUWAL1")
    # ... and the next snapshot truncation upgrades both files
    frag.snapshot()
    assert open(path, "rb").read(8) == b"PTPUFRG4"
    assert open(path + ".wal", "rb").read() == b"PTPUWAL1"
    frag.close()
    reopened = _mk_fragment(path)
    assert set(reopened.row_columns(9).tolist()) == {51, 52}


def test_legacy_torn_tail_still_dropped(tmp_path):
    """The legacy bare stream keeps its old recovery semantics: a
    trailing partial record is a torn write, dropped on replay."""
    path = str(tmp_path / "legacy2" / "frag")
    os.makedirs(os.path.dirname(path))
    _write_legacy_wal(path + ".wal", [(0, 1, 10), (0, 1, 11)])
    with open(path + ".wal", "ab") as f:
        f.write(b"\x00\x05")  # torn partial record
    frag = _mk_fragment(path)
    assert frag.quarantined is None
    assert set(frag.row_columns(1).tolist()) == {10, 11}


def test_wal_crc_on_off_differential(tmp_path):
    """The same op sequence with wal-crc on vs off must produce
    byte-identical query results, and both must survive a reopen."""
    states = {}
    for crc in (True, False):
        old = fragment_mod.WAL_CRC
        fragment_mod.WAL_CRC = crc
        try:
            path = str(tmp_path / f"crc{crc}" / "frag")
            f = _mk_fragment(path)
            rng = np.random.default_rng(11)
            rows = rng.integers(0, 8, size=200)
            cols = rng.integers(0, SHARD_WIDTH, size=200)
            f.bulk_import(rows[:120], cols[:120])
            f.set_bit(3, 12345)
            f.bulk_import(rows[:40], cols[:40], clear=True)
            f.snapshot()
            f.bulk_import(rows[120:], cols[120:])
            f.clear_bit(3, 12345)
            f._wal_file.flush()
            del f  # crash-style: no close, reopen replays the WAL
            g = _mk_fragment(path)
            assert g.quarantined is None
            framed = open(path + ".wal", "rb").read(8) == b"PTPUWAL1"
            assert framed is crc
            states[crc] = (g.pairs()[0].tobytes(), g.pairs()[1].tobytes())
            g.close()
        finally:
            fragment_mod.WAL_CRC = old
    assert states[True] == states[False]


# -- Fragment.close() ordering ----------------------------------------------

def test_close_fsyncs_wal_before_failed_snapshot(tmp_path):
    """close() must put the WAL on stable storage BEFORE attempting the
    snapshot: if the snapshot fails (disk full, injected fault), every
    acknowledged append still replays on reopen."""
    path = str(tmp_path / "c1" / "frag")
    f = _mk_fragment(path)
    f.set_bit(1, 10)
    f.set_bit(2, 20)
    before = _bits(f)
    FAULTS.arm("fragment.snapshot", "error")
    try:
        with pytest.raises(OSError):
            f.close()
    finally:
        FAULTS.disarm()
    # WAL handle was released even though the snapshot failed
    assert f._wal_file is None
    g = _mk_fragment(path)
    assert _bits(g) == before  # differential: identical bitmap


def test_close_kill_window_reopen_differential(tmp_path):
    """A crash in the close+kill window (WAL flushed, snapshot not yet
    rewritten) replays to the identical bitmap."""
    path = str(tmp_path / "c2" / "frag")
    f = _mk_fragment(path)
    rng = np.random.default_rng(5)
    f.bulk_import(rng.integers(0, 6, size=50),
                  rng.integers(0, SHARD_WIDTH, size=50))
    f.snapshot()
    f.set_bit(7, 77)
    f.clear_bit(7, 77)
    f.set_bit(7, 78)
    before = _bits(f)
    f._wal_file.flush()
    # simulate kill -9 mid-close: copy the on-disk state as-is
    frozen = str(tmp_path / "c2-frozen" / "frag")
    os.makedirs(os.path.dirname(frozen))
    shutil.copy(path, frozen)
    shutil.copy(path + ".wal", frozen + ".wal")
    g = _mk_fragment(frozen)
    assert _bits(g) == before


# -- quarantine lifecycle ---------------------------------------------------

def test_quarantine_lifecycle_and_repair(tmp_path):
    path = str(tmp_path / "q" / "frag")
    f = _mk_fragment(path)
    f.set_bit(2, 7)
    f.set_bit(9, 100)
    f.snapshot()
    f.close()
    blob_good = bytearray(open(path, "rb").read())
    blob_good[-2] ^= 0x10
    with open(path, "wb") as fh:
        fh.write(bytes(blob_good))

    ev0 = storage_events()
    g = _mk_fragment(path)
    assert g.quarantined is not None
    assert storage_events()["quarantine"] == ev0["quarantine"] + 1
    # reads answer EMPTY (degraded), never raise
    assert g.row_columns(9).size == 0
    assert g.to_dense().sum() == 0
    # writes are refused with the retryable error
    with pytest.raises(FragmentQuarantinedError):
        g.set_bit(1, 1)
    with pytest.raises(FragmentQuarantinedError):
        g.bulk_import(np.array([1]), np.array([1]))
    # sidecar marker persists the state across restarts without
    # re-parsing the corrupt bytes
    assert os.path.exists(path + ".quarantine")
    g2 = _mk_fragment(path)
    assert g2.quarantined is not None

    # replica repair: verified blob swaps in, marker clears, generation
    # bumps (derived caches must invalidate), writes work again
    donor = _mk_fragment(str(tmp_path / "donor" / "frag"))
    donor.set_bit(2, 7)
    donor.set_bit(9, 100)
    blob = donor.snapshot_bytes()
    gen0 = g2.gen
    g2.restore_snapshot_bytes(blob)
    assert g2.quarantined is None
    assert g2.gen != gen0
    assert not os.path.exists(path + ".quarantine")
    assert open(path, "rb").read() == blob  # byte-identical to source
    assert set(g2.row_columns(9).tolist()) == {100}
    assert g2.set_bit(1, 1)
    assert storage_events()["repair"] == ev0["repair"] + 1
    # corrupt bytes in flight must NOT launder into a repaired fragment
    g2.close()
    g3 = _mk_fragment(path)
    bad = bytearray(blob)
    bad[30] ^= 0xFF
    with pytest.raises(SnapshotFormatError):
        g3.restore_snapshot_bytes(bytes(bad))


def test_quarantine_off_is_fail_stop(tmp_path):
    """quarantine-on-corruption = false restores fail-stop opens (the
    offline check/inspect tools and single-node forensics)."""
    path = str(tmp_path / "fs" / "frag")
    f = _mk_fragment(path)
    f.set_bit(0, 1)
    f.snapshot()
    f.close()
    with open(path, "r+b") as fh:
        fh.truncate(10)
    old = fragment_mod.QUARANTINE_ON_CORRUPTION
    fragment_mod.QUARANTINE_ON_CORRUPTION = False
    try:
        with pytest.raises(ValueError):
            _mk_fragment(path)
    finally:
        fragment_mod.QUARANTINE_ON_CORRUPTION = old
    assert not os.path.exists(path + ".quarantine")
    # a sidecar left by a previous quarantining run must NOT satisfy a
    # fail-stop open either: check/inspect would report corrupt data as
    # an empty-but-healthy fragment
    g = _mk_fragment(path)  # quarantines (writes the sidecar)
    assert g.quarantined is not None
    assert os.path.exists(path + ".quarantine")
    fragment_mod.QUARANTINE_ON_CORRUPTION = False
    try:
        with pytest.raises(ValueError):
            _mk_fragment(path)
    finally:
        fragment_mod.QUARANTINE_ON_CORRUPTION = old


def test_corrupt_attr_store_resets_and_surfaces(tmp_path):
    """A corrupt attr-store JSON must not kill startup: the bad bytes
    move aside (.corrupt), the store restarts empty (attr anti-entropy
    re-pulls from peers), and the reset is DATA — an event counter and
    a /debug/vars listing, not just a moved file."""
    from pilosa_tpu_torch.storage.attrs import AttrStore
    from pilosa_tpu_torch.storage.holder import Holder

    ev0 = storage_events()["attr_corrupt"]
    path = str(tmp_path / "attrs.json")
    with open(path, "w") as f:
        f.write('{"1": {"name": "ok"}')  # truncated JSON
    store = AttrStore(path)
    assert store.corrupt is not None
    assert store.attrs(1) == {}
    assert os.path.exists(path + ".corrupt")
    assert not os.path.exists(path)
    assert storage_events()["attr_corrupt"] == ev0 + 1
    # holder-level surface (what /debug/vars storage.corruptAttrStores
    # serves)
    holder = Holder(str(tmp_path / "holder"))
    holder.open()
    holder.create_index("ai")
    bad = os.path.join(str(tmp_path / "holder"), "ai", ".column_attrs")
    holder.indexes["ai"].column_attrs.set_attrs(3, {"k": "v"})
    holder.close()
    with open(bad, "w") as f:
        f.write("not json at all {{{")
    holder2 = Holder(str(tmp_path / "holder"))
    holder2.open()
    listed = holder2.corrupt_attr_stores()
    assert listed and listed[0]["index"] == "ai"
    assert listed[0]["field"] is None
    holder2.close()


# -- server-level degraded surfaces -----------------------------------------

def _req(port, method, path, data=None):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) else json.dumps(
            data).encode()
    r = urllib.request.Request(
        f"http://localhost:{port}{path}", method=method, data=body)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return json.loads(resp.read())


def _raw(port, path):
    with urllib.request.urlopen(
            f"http://localhost:{port}{path}", timeout=60) as resp:
        return resp.read().decode()


def _frag_files(data_dir):
    out = []
    for dirpath, _dirnames, filenames in os.walk(data_dir):
        if os.path.basename(dirpath) != "fragments":
            continue
        for fn in filenames:
            if not fn.endswith((".wal", ".quarantine", ".tmp")):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def test_server_degraded_serving(tmp_path):
    """A corrupt fragment on a single node: the server starts (degraded,
    not down), reads answer with an explicit degraded flag, writes to the
    quarantined fragment get a retryable 503, and /debug/vars + /metrics
    carry the quarantine state."""
    from pilosa_tpu_torch.server.server import Server

    data_dir = str(tmp_path / "node")
    (port,) = _free_ports(1)
    cfg = Config(data_dir=data_dir, bind=f"localhost:{port}",
                 anti_entropy_interval=0, repair_interval=0)
    srv = Server(cfg)
    srv.open()
    try:
        _req(srv.port, "POST", "/index/di", {})
        _req(srv.port, "POST", "/index/di/field/f", {})
        _req(srv.port, "POST", "/index/di/query", "Set(5, f=1)")
        q = _req(srv.port, "POST", "/index/di/query", "Row(f=1)")
        assert "degraded" not in q
    finally:
        srv.close()

    # target field f's fragment specifically — the index also carries an
    # internal _exists field whose fragment file sorts first
    frag_file = [p for p in _frag_files(data_dir) if "/fields/f/" in p][0]
    with open(frag_file, "r+b") as fh:
        fh.seek(28)
        b = fh.read(1)
        fh.seek(28)
        fh.write(bytes([b[0] ^ 0xFF]))

    (port2,) = _free_ports(1)
    srv = Server(Config(data_dir=data_dir, bind=f"localhost:{port2}",
                        anti_entropy_interval=0, repair_interval=0))
    srv.open()  # startup must NOT die on the corrupt file
    try:
        st = _req(srv.port, "GET", "/status")
        assert st["storage"]["degraded"] is True
        assert st["storage"]["quarantinedFragments"] == 1
        # reads serve (empty from the quarantined fragment) + say so
        q = _req(srv.port, "POST", "/index/di/query", "Row(f=1)")
        assert q["results"][0]["columns"] == []
        assert q["degraded"]["quarantinedFragments"] >= 1
        # writes are refused with a retryable 503
        with pytest.raises(urllib.error.HTTPError) as err:
            _req(srv.port, "POST", "/index/di/query", "Set(6, f=1)")
        assert err.value.code == 503
        body = json.loads(err.value.read())
        assert body["retryable"] is True
        assert err.value.headers["Retry-After"]
        # observability surfaces
        dv = _req(srv.port, "GET", "/debug/vars")
        assert dv["storage"]["quarantined"][0]["index"] == "di"
        assert dv["storage"]["events"]["quarantine"] >= 1
        metrics = _raw(srv.port, "/metrics")
        assert "storage_quarantined_fragments 1" in metrics
    finally:
        srv.close()


# -- 2-node replica repair convergence --------------------------------------

def _make_pair(tmp_path, tag=""):
    from pilosa_tpu_torch.server.server import Server

    ports = _free_ports(2)
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, p in enumerate(ports):
        cfg = Config(data_dir=str(tmp_path / f"{tag}node{i}"),
                     bind=f"localhost:{p}", node_id=f"node{i}",
                     cluster_hosts=hosts, replica_n=2,
                     anti_entropy_interval=0, repair_interval=0)
        srv = Server(cfg)
        srv.open()
        servers.append(srv)
    return servers


def test_two_node_repair_convergence(tmp_path):
    """The acceptance scenario: corrupt a replica's fragment on disk,
    restart it -> quarantined; one repair pass re-fetches the fragment
    wholesale from the healthy peer, checksum-verified, atomically
    swapped in, generation bumped — and the node's on-disk bytes equal
    the source's snapshot exactly."""
    from pilosa_tpu_torch.server.server import Server

    servers = _make_pair(tmp_path)
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ri", {})
        _req(p0, "POST", "/index/ri/field/f", {})
        rng = np.random.default_rng(3)
        cols = np.unique(rng.integers(0, 2 * SHARD_WIDTH, size=800))
        rows = rng.integers(0, 5, size=cols.size)
        _req(p0, "POST", "/index/ri/field/f/import",
             {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
        oracle = {r: set(cols[rows == r].tolist()) for r in range(5)}
        [got] = _req(p0, "POST", "/index/ri/query", "Row(f=2)")["results"]
        assert set(got["columns"]) == oracle[2]

        # restart node1 with a corrupted fragment file
        node1_cfg = servers[1].config
        servers[1].close()
        victims = [p for p in _frag_files(node1_cfg.data_dir)
                   if "/ri/" in p and "/fields/f/" in p]
        victim = victims[0]
        blob = bytearray(open(victim, "rb").read())
        blob[35] ^= 0x40
        with open(victim, "wb") as fh:
            fh.write(bytes(blob))
        servers[1] = Server(node1_cfg)
        servers[1].open()
        p1 = servers[1].port

        st = _req(p1, "GET", "/status")
        assert st["storage"]["degraded"] is True
        quarantined = servers[1].holder.quarantined_fragments()
        assert len(quarantined) == 1 and quarantined[0]["index"] == "ri"
        shard = quarantined[0]["shard"]
        frag = servers[1].holder.fragment("ri", "f", "standard", shard)
        gen0 = frag.gen

        # node0 must see node1 as READY again before repair can route
        servers[0].cluster.probe_peers()
        servers[1].cluster.probe_peers()

        repaired = servers[1].cluster.repair_quarantined()
        assert repaired == 1
        assert frag.quarantined is None
        assert frag.gen != gen0  # result caches keyed on gens invalidate

        # byte-identical to the source replica's snapshot
        src = servers[0].holder.fragment("ri", "f", "standard", shard)
        assert open(victim, "rb").read() == src.snapshot_bytes()
        assert not os.path.exists(victim + ".quarantine")

        # converged: both nodes answer the oracle, degraded flag gone
        for port in (servers[0].port, p1):
            [got] = _req(port, "POST", "/index/ri/query",
                         "Row(f=2)")["results"]
            assert set(got["columns"]) == oracle[2]
        q = _req(p1, "POST", "/index/ri/query", "Row(f=2)")
        assert "degraded" not in q
        st = _req(p1, "GET", "/status")
        assert st["storage"]["degraded"] is False

        # repair is visible as data: counter + metrics line
        dv = _req(p1, "GET", "/debug/vars")
        assert dv["counts"].get("antientropy.repairs", 0) >= 1
        assert dv["storage"]["events"]["repair"] >= 1
        # writes accepted again post-repair
        _req(p1, "POST", "/index/ri/query",
             f"Set({int(shard) * SHARD_WIDTH + 9}, f=2)")
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_antientropy_errors_surface_as_data(tmp_path):
    """Anti-entropy loop failures are counters + last-error
    state in /debug/vars, not just a log line — and a healthy pass
    stamps last-success."""
    servers = _make_pair(tmp_path, tag="ae")
    try:
        p0 = servers[0].port
        _req(p0, "POST", "/index/ae", {})
        _req(p0, "POST", "/index/ae/field/f", {})
        _req(p0, "POST", "/index/ae/query", "Set(1, f=1)")

        servers[0].cluster.sync_holder()
        dv = _req(p0, "GET", "/debug/vars")
        ae = dv["storage"]["antiEntropy"]
        assert ae["lastSuccessTs"] is not None
        assert dv["counts"].get("antientropy.runs", 0) >= 1
        errs0 = dv["counts"].get("antientropy.errors", 0)

        # every internal request to node1 fails at the transport level
        FAULTS.arm("client.request", "error",
                   match=servers[1].config.bind)
        try:
            servers[0].cluster.sync_holder()
        finally:
            FAULTS.disarm()
        dv = _req(p0, "GET", "/debug/vars")
        ae = dv["storage"]["antiEntropy"]
        assert dv["counts"].get("antientropy.errors", 0) > errs0
        assert ae["lastError"] is not None
        assert ae["lastErrorTs"] is not None
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass
