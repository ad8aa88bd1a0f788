"""Fragment: one (field, view, shard) bitmap, host-sparse with dense
device mirrors under an HBM budget.

The reference's fragment (fragment.go:100-159) is an mmap'd roaring file
with an append-only op log and background snapshot rewrites.  Here the
authoritative copy is a SPARSE word store: sorted flat indices
(``row * SHARD_WORDS + word``) with their non-zero uint32 word values —
the in-memory form of the snapshot format itself.  Host memory is
proportional to set bits (a 954-shard index with a few bits per row loads
in megabytes, where a dense ``[rows, 32768]`` tensor per fragment would
need terabytes), replacing roaring's array/run containers as the sparsity
mechanism (roaring/roaring.go:64-69).

The device mirror takes one of two forms, chosen per fragment by a
density heuristic (``device_form``).  Dense fragments materialise the
full ``uint32[cap_rows, SHARD_WORDS]`` tensor — dense tiles are what the
TPU bit-kernels operate on (see core.py).  Sparse fragments (under a
configured device budget) stay HBM-resident in COMPRESSED form instead: a
packed array/bitmap/run container stream (ops/containers.py, the
word-granularity analog of roaring/roaring.go:64-69) that the mesh
executor decodes to dense tiles ON DEVICE at op time, inside the query's
own XLA program.  Residency then costs compressed bytes — ~8 bytes per
non-zero word, a few words per run — so over-budget dense working sets
become resident compressed ones (docs/memory-budget.md).  The heuristic
falls back to dense where density warrants (``compress-max-density``), so
dense corpora never pay decode cost or the ~1x "compression" of
all-bitmap streams.  Mirrors and packed streams register with a
DeviceBudget: under a configured limit the least-recently-used entries
are evicted and transparently re-staged on next use (the HBM analog of
the reference's mmap paging + syswrap map caps, syswrap/mmap.go:46).

Mutations update the sparse store immediately and append to a write-ahead
op log; snapshots rewrite the on-disk file and truncate the WAL after
``max_op_n`` ops (fragment.go:84 MaxOpN, :2311 snapshot).  Row capacity
grows by doubling so device executable shapes change rarely.

Port of the JAX package's ``storage/fragment.py``.  The sparse host
store, the WAL, snapshots, quarantine, the packed form
(``packed_host``, ``device_form``, ``staged_dense``) and the rank-cache
hooks are copied.  ``device()`` is rewritten to keep one torch mirror per
device, and ``device_sig`` takes the device whose container-kernel
backend ("cuda" or "torch") it records; a compressed fragment's
signature drops the JAX package's pow2 buckets (see ``device_sig``).
The ingest delta overlay is carried: ``ingest_apply`` journals a flush's
new words, ``delta_chunks`` / ``fold_delta`` read and retire the
journal, and ``device()`` ORs unseen chunks into a resident mirror
(ingest/delta.py) — so ``device_gen`` lags ``gen`` while a journal is
live, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import struct

import numpy as np

from ..core import (
    DEFAULT_FRAGMENT_MAX_OP_N,
    DEFAULT_MAX_ROW_ID,
    HASH_BLOCK_SIZE,
    SHARD_WIDTH,
    SHARD_WORDS,
)
from ..ops import bitset, bsi
from ..utils import events
from ..utils.durable import checksum, durable_replace, fsync_dir, fsync_file
from ..utils.faults import FAULTS
from ..utils.locks import make_lock, make_rlock
from . import membudget as _membudget
from .membudget import DEFAULT_BUDGET, HOST_STAGE_BUDGET, INGEST_DELTA_BUDGET
from .roaring_io import SnapshotFormatError, pack_snapshot, unpack_snapshot

# On-disk snapshot format: see storage/roaring_io.py (pack_snapshot /
# unpack_snapshot) — v4 (PTPUFRG4) carries header + payload CRCs; the
# unchecksummed v2/v3 predecessors load leniently.

# WAL record: op(u8) row(i64) col(i64)  (roaring.go:4359 opType add/remove;
# batch ops are written as runs of single records).
_OP = struct.Struct("<Bqq")
_OP_SET, _OP_CLEAR = 0, 1
# numpy view of the same record layout for vectorized batch serialization
# (a 1M-bit import must not do 1M struct.packs in a Python loop)
_OP_DTYPE = np.dtype([("op", "u1"), ("row", "<i8"), ("col", "<i8")])
assert _OP_DTYPE.itemsize == _OP.size

# CRC-framed WAL (docs/robustness.md "Durability & recovery"): the file
# opens with an 8-byte magic, then frames of <u32 payload_len, u32
# payload_crc> + payload, where payload is 1..N op records appended in ONE
# write() call (a kill -9 can therefore only tear a frame at the OS/crash
# level, never interleave them).  Files without the magic are legacy bare
# record streams and keep appending in that format until the next
# snapshot truncation upgrades them.
_WAL_MAGIC = b"PTPUWAL1"
_WAL_FRAME = struct.Struct("<II")
_WAL_MAX_FRAME = 1 << 30

# Process-wide storage knobs, set from the server config (the same
# most-recent-Server-wins convention as membudget.DEFAULT_BUDGET and
# cache.rank.RANK_REBUILD_ROWS).  WAL_CRC: frame new WAL files with
# length+CRC records (off = write the legacy bare stream, for
# differential testing and old-reader compatibility).
# QUARANTINE_ON_CORRUPTION: a corrupt snapshot/WAL quarantines the
# fragment (serve-empty + refuse writes + heal from a replica) instead of
# raising out of open().
WAL_CRC = True
QUARANTINE_ON_CORRUPTION = True

# Compressed-resident device mirrors (docs/memory-budget.md "Compressed
# residency"): under a configured device budget, fragments whose packed
# container stream is small enough stay HBM-resident compressed and are
# decoded to dense tiles on device at op time.  COMPRESSED_RESIDENT
# disables the path wholesale; COMPRESS_MAX_DENSITY is the fallback
# knob — a fragment compresses only when its estimated packed bytes are
# at most this fraction of its dense footprint (dense corpora pack into
# all-bitmap streams at ~1.01x dense and must stay on the dense path).
# Process-wide, set from the server config like WAL_CRC above.
COMPRESSED_RESIDENT = True
COMPRESS_MAX_DENSITY = 0.5

# Storage-event counters (surfaced at /debug/vars and /metrics via
# Server.update_storage_gauges): process-wide, like the knobs above.
_EVENTS = {"quarantine": 0, "torn_tail_recovered": 0, "repair": 0,
           "attr_corrupt": 0}
_EVENTS_LOCK = make_lock("fragment-events")

# True once ANY fragment in this process has entered quarantine
# (including sidecar re-detection, which doesn't count an event).
# Holder.quarantined_fragments fast-outs on this so the per-query /
# per-probe / per-scrape degraded checks stay O(1) in the healthy case
# instead of scanning every fragment of every index.  Never reset:
# after a quarantine the full scan is the price of accuracy.
QUARANTINE_SEEN = False


def _bump(event: str, n: int = 1):
    with _EVENTS_LOCK:
        _EVENTS[event] += n


def storage_events() -> dict:
    """Snapshot of the process-wide storage event counters."""
    with _EVENTS_LOCK:
        return dict(_EVENTS)


class FragmentQuarantinedError(RuntimeError):
    """Write refused: this fragment is quarantined after on-disk
    corruption.  RETRYABLE — replica-driven repair (anti-entropy /
    repair-interval) restores the fragment from a healthy peer, after
    which writes succeed again; the HTTP layer maps this to 503 +
    Retry-After."""


_MIN_ROWS = 4


def _pairs_to_words(rows: np.ndarray, cols: np.ndarray):
    """Aggregate (row, col) bit pairs into unique sorted flat word indices
    + OR-combined word values."""
    flat = rows.astype(np.int64) * SHARD_WORDS + (cols >> 5)
    bit = (np.uint32(1) << (cols & 31).astype(np.uint32))
    uniq, inv = np.unique(flat, return_inverse=True)
    out = np.zeros(uniq.size, dtype=np.uint32)
    np.bitwise_or.at(out, inv, bit)
    return uniq, out


def _expand_words(idx: np.ndarray, val: np.ndarray):
    """Inverse of _pairs_to_words: (rows, shard-local cols) of every set
    bit, ordered by (row, col)."""
    rows_out, cols_out = [], []
    for b in range(32):
        sel = (val >> np.uint32(b)) & np.uint32(1) > 0
        if sel.any():
            f = idx[sel]
            rows_out.append(f // SHARD_WORDS)
            cols_out.append((f % SHARD_WORDS) * 32 + b)
    if not rows_out:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    rows = np.concatenate(rows_out)
    cols = np.concatenate(cols_out)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


class Fragment:
    """One (index, field, view, shard) bitmap."""

    def __init__(self, path: str | None, index: str, field: str, view: str,
                 shard: int, max_op_n: int = DEFAULT_FRAGMENT_MAX_OP_N,
                 row_id_cap: int | None = None, budget=None):
        self.path = path  # None = purely in-memory (tests)
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.max_op_n = max_op_n
        # Guard against hostile row ids forcing terabyte-scale dense
        # allocations (core.DEFAULT_MAX_ROW_ID); threaded per-instance from
        # the server config (Holder -> Index -> Field -> View) so multiple
        # servers in one process keep independent caps.
        if row_id_cap is not None:
            self.row_id_cap = row_id_cap
        self.budget = budget if budget is not None else DEFAULT_BUDGET

        # sparse word store: sorted flat indices + non-zero word values
        self._idx = np.zeros(0, dtype=np.int64)
        self._val = np.zeros(0, dtype=np.uint32)
        self._cap_rows = 0        # device-shape row capacity (pow2 growth)
        self._mirrors = {}        # torch.device -> cached int32 mirror
        # Data-generation stamp: unique across all fragments and bumped on
        # every mutation.  Derived caches (mesh stacked blocks) key their
        # validity on this instead of mirror identity, so they need not pin
        # mirrors alive (and a recreated fragment can never alias a stale
        # cache entry).
        self.gen = next(self._GEN)
        # Ingest delta overlay (docs/ingest.md): device_gen is the gen the
        # device-resident forms (mirrors, stacked blocks, packed streams)
        # reflect.  Ingest flushes (ingest_apply) update the sparse store
        # and bump gen WITHOUT invalidating device state — the new bits
        # ride in the journal, a list of (epoch, flat word idx, word val)
        # chunks OR'd into resident device tensors as overlays.  Any other
        # mutation (or a fold) clears the journal and re-anchors
        # device_gen = gen, so device consumers see exactly one of: a
        # current form, a current-at-device_gen form plus the journal that
        # upgrades it, or a dirty flag.
        self.device_gen = self.gen
        self.ingest_epoch = 0
        self._journal: list[tuple[int, np.ndarray, np.ndarray]] = []
        self._journal_bytes = 0
        self._mirror_epoch: dict = {}
        # Corruption quarantine (docs/robustness.md): non-None = the
        # reason string.  Quarantined fragments answer reads as EMPTY,
        # refuse writes with FragmentQuarantinedError, and are healed
        # wholesale from a replica by the anti-entropy repair pass.
        self.quarantined: str | None = None
        # whether the open WAL file is CRC-framed (decided by the file's
        # own leading magic at open; new/truncated files follow WAL_CRC)
        self._wal_framed = WAL_CRC
        # Per-fragment rank cache (cache/rank.py RankCache), attached by
        # the owning View for fields with cacheType ranked/lru; None for
        # cacheType none, BSI views, and bare test fragments.  Maintained
        # incrementally by the mutators below via _note_rank /
        # _rank_invalidate.
        self.rank_cache = None
        # host-side dense staging cache: (gen, dense block) — see
        # staged_dense()
        self._stage = None
        # packed container stream cache: (gen, ops.containers.Packed) —
        # see packed_host(); _comp_est is the (gen, bytes) estimate the
        # density heuristic uses without packing
        self._packed = None
        self._comp_est = None
        self._device_dirty = True
        self._op_n = 0
        self._dirty_data = False  # mutated since last snapshot?
        self._wal_file = None
        self._lock = make_rlock("fragment")

        if path is not None:
            self._open_storage()

    # -- lifecycle ---------------------------------------------------------

    def _wal_path(self) -> str:
        return (self.path or "<memory>") + ".wal"

    def _quarantine_path(self) -> str:
        return (self.path or "<memory>") + ".quarantine"

    def _open_storage(self):
        """Load snapshot + replay WAL (fragment.go:311 openStorage).

        NEVER raises on corrupt on-disk state (with the default
        quarantine-on-corruption config): a torn WAL tail is truncated at
        the last valid frame boundary and serving continues; anything
        worse quarantines the fragment (empty reads, refused writes,
        replica repair heals it)."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        if QUARANTINE_ON_CORRUPTION and \
                os.path.exists(self._quarantine_path()):
            # quarantined by a previous run: don't re-parse known-bad
            # files; the sidecar carries the original reason.  With
            # quarantine OFF (fail-stop: cli check/inspect forensics,
            # quarantine-on-corruption=false servers) the sidecar is
            # ignored and the files re-parse so the REAL error raises —
            # an integrity tool must never report corrupt data as an
            # empty-but-healthy fragment.
            try:
                with open(self._quarantine_path()) as f:
                    reason = json.load(f).get("reason", "unknown")
            except (OSError, ValueError):
                reason = "unreadable quarantine marker"
            self._enter_quarantine(reason, persist=False, count=False)
            return
        try:
            self._load_files()
        except (ValueError, OSError) as e:
            # SnapshotFormatError is a ValueError; OSError covers I/O
            # faults reading either file
            if not QUARANTINE_ON_CORRUPTION:
                raise
            self._enter_quarantine(str(e))
            return
        self._wal_file = self._open_wal_append()

    def _load_files(self):
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            try:
                cap_rows, idx, val = unpack_snapshot(
                    data, SHARD_WORDS, self.row_id_cap)
            except SnapshotFormatError as e:
                raise SnapshotFormatError(f"{self.path}: {e}") from e
            self._idx, self._val, self._cap_rows = idx, val, cap_rows
        if os.path.exists(self._wal_path()):
            with open(self._wal_path(), "rb") as f:
                buf = f.read()
            if buf.startswith(_WAL_MAGIC):
                self._wal_framed = True
                keep, ops = self._replay_framed_wal(buf)
                if keep < len(buf):
                    self._truncate_wal(keep)
                self._op_n = ops
            elif buf:
                # legacy bare record stream (pre-CRC files): replay as
                # before, keep appending in the same format so a mixed
                # file never exists; the next snapshot truncation
                # upgrades it
                self._wal_framed = False
                self._replay_wal(buf)
                keep = len(buf) - len(buf) % _OP.size
                if keep < len(buf):
                    # a torn trailing record (or a torn magic write
                    # shorter than one record) was DROPPED by replay —
                    # truncate it on disk too, or the next append lands
                    # after the garbage and shifts every later record
                    self._truncate_wal(keep)
                self._op_n = keep // _OP.size

    def _open_wal_append(self):
        fresh = not os.path.exists(self._wal_path()) \
            or os.path.getsize(self._wal_path()) == 0
        f = open(self._wal_path(), "ab", buffering=0)
        if fresh:
            self._wal_framed = WAL_CRC
            if self._wal_framed:
                f.write(_WAL_MAGIC)
        return f

    def _replay_framed_wal(self, buf: bytes) -> tuple[int, int]:
        """Replay a CRC-framed WAL.  Returns (keep_offset, op_count):
        keep_offset < len(buf) means a torn/garbage tail was detected
        after the last valid frame and the file must be truncated there.
        Raises ValueError on MID-log corruption (a bad frame with valid
        data after it — truncating would silently drop acknowledged
        writes, so the fragment quarantines instead)."""
        off = len(_WAL_MAGIC)
        ops = 0
        n = len(buf)
        while off < n:
            if n - off < _WAL_FRAME.size:
                break  # torn frame header
            plen, crc = _WAL_FRAME.unpack_from(buf, off)
            if plen == 0 or plen % _OP.size or plen > _WAL_MAX_FRAME:
                # an all-zero tail is the classic torn-write artifact
                # (journal replay after power loss); anything else in a
                # length field is corruption we cannot skip safely
                if any(buf[off:]):
                    raise ValueError(
                        f"corrupt WAL {self._wal_path()}: bad frame "
                        f"header at byte {off}")
                break
            end = off + _WAL_FRAME.size + plen
            if end > n:
                break  # incomplete final append
            payload = buf[off + _WAL_FRAME.size: end]
            if checksum(payload) != crc:
                if end == n:
                    break  # torn/garbage final frame
                raise ValueError(
                    f"corrupt WAL {self._wal_path()}: frame CRC mismatch "
                    f"at byte {off} with valid data after it")
            self._apply_wal_records(payload)
            ops += plen // _OP.size
            off = end
        return off, ops

    def _apply_wal_records(self, payload: bytes):
        """Apply one frame's op records in order (vectorized per
        same-op run)."""
        recs = np.frombuffer(payload, dtype=_OP_DTYPE)
        op_arr = recs["op"]
        rows = recs["row"].astype(np.int64)
        cols = recs["col"].astype(np.int64)
        if not bool(np.all((op_arr == _OP_SET) | (op_arr == _OP_CLEAR))):
            raise ValueError(
                f"corrupt WAL {self._wal_path()}: unknown op code")
        if rows.size and (int(rows.min()) < 0 or int(cols.min()) < 0
                          or int(cols.max()) >= SHARD_WIDTH):
            raise ValueError(
                f"corrupt WAL {self._wal_path()}: record out of range")
        starts = [0] + (np.nonzero(np.diff(op_arr))[0] + 1).tolist() \
            + [rows.size]
        for a, b in zip(starts[:-1], starts[1:]):
            if a == b:
                continue
            try:
                self._apply_bits(rows[a:b], cols[a:b],
                                 clear=(op_arr[a] == _OP_CLEAR))
            except ValueError as e:
                raise ValueError(
                    f"replaying WAL {self._wal_path()}: {e}; raise "
                    f"max_row_id if this data was written with a larger "
                    f"cap") from e

    def _replay_wal(self, buf: bytes):
        """Apply legacy (unframed) WAL records in order, batching
        consecutive same-op runs.  Corrupt records (unknown op,
        out-of-range row/col) raise ValueError rather than silently
        mis-importing; a trailing partial record (torn write on crash) is
        dropped."""
        n = len(buf) - len(buf) % _OP.size
        run_op, run_rows, run_cols = None, [], []

        def flush():
            nonlocal run_rows, run_cols
            if not run_rows:
                return
            rows = np.asarray(run_rows, dtype=np.int64)
            cols = np.asarray(run_cols, dtype=np.int64)
            try:
                self._apply_bits(rows, cols, clear=(run_op == _OP_CLEAR))
            except ValueError as e:
                raise ValueError(
                    f"replaying WAL {self._wal_path()}: {e}; raise "
                    f"max_row_id if this data was written with a larger "
                    f"cap") from e
            run_rows, run_cols = [], []

        for off in range(0, n, _OP.size):
            op, row, col = _OP.unpack_from(buf, off)
            if op not in (_OP_SET, _OP_CLEAR):
                raise ValueError(
                    f"corrupt WAL {self._wal_path()}: unknown op {op} at "
                    f"byte {off}")
            if row < 0 or col < 0 or col >= SHARD_WIDTH:
                raise ValueError(
                    f"corrupt WAL {self._wal_path()}: record ({row}, {col}) "
                    f"out of range at byte {off}")
            if op != run_op:
                flush()
                run_op = op
            run_rows.append(row)
            run_cols.append(col)
        flush()

    def _truncate_wal(self, keep: int):
        """Truncate a torn/garbage WAL tail at the last valid frame
        boundary, durably (the recovery itself must survive a crash —
        a re-run replays the same valid prefix and truncates again)."""
        FAULTS.hit("fragment.wal.truncate", key=self.path or "")
        with open(self._wal_path(), "r+b") as f:
            f.truncate(keep)
            os.fsync(f.fileno())
        fsync_dir(os.path.dirname(self._wal_path()) or ".")
        _bump("torn_tail_recovered")

    # -- quarantine (docs/robustness.md "Corruption quarantine") -----------

    def _enter_quarantine(self, reason: str, persist: bool = True,
                          count: bool = True):
        """Reset to the quarantined state: empty store, no WAL handle, a
        sidecar marker so restarts skip re-parsing the corrupt files.
        The corrupt snapshot/WAL bytes stay on disk for forensics until
        repair replaces them."""
        global QUARANTINE_SEEN
        QUARANTINE_SEEN = True
        self.quarantined = reason
        self._idx = np.zeros(0, dtype=np.int64)
        self._val = np.zeros(0, dtype=np.uint32)
        self._cap_rows = 0
        self._op_n = 0
        self._dirty_data = False
        self._device_dirty = True
        self.gen = next(self._GEN)  # derived caches must not serve stale
        self.device_gen = self.gen
        self._clear_journal()
        self._stage = None
        if self._wal_file is not None:
            try:
                self._wal_file.close()
            except OSError:
                pass
            self._wal_file = None
        self._rank_invalidate()
        if persist and self.path is not None:
            tmp = self._quarantine_path() + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"reason": reason}, f)
                    fsync_file(f)
                durable_replace(tmp, self._quarantine_path())
            except OSError:
                pass  # marker is an optimization; reopen re-detects
        if count:
            _bump("quarantine")
            # journaled state transition (docs/observability.md "Cluster
            # plane"); sidecar reloads (count=False) are not new events
            events.emit("storage.quarantine", index=self.index,
                        field=self.field, view=self.view,
                        shard=self.shard, reason=str(reason)[:160])

    def _check_writable(self):
        if self.quarantined is not None:
            raise FragmentQuarantinedError(
                f"fragment {self.index}/{self.field}/{self.view}/"
                f"{self.shard} is quarantined ({self.quarantined}); "
                f"writes are refused until replica repair restores it")

    def snapshot_bytes(self) -> bytes:
        """Serialize the CURRENT in-memory state (snapshot + replayed
        WAL) to checksummed v4 snapshot bytes — the payload of
        /internal/fragment/fetch (replica repair)."""
        with self._lock:
            return pack_snapshot(self._cap_rows, self._idx, self._val,
                                 SHARD_WORDS)

    def restore_snapshot_bytes(self, blob: bytes):
        """Replace this fragment's entire contents from checksummed
        snapshot bytes (replica repair receive path).  Verifies the CRCs
        BEFORE touching anything, swaps the file in via the durable
        tmp+rename path, truncates the WAL, clears the quarantine
        marker, and bumps the generation so every derived cache (device
        mirrors, mesh stacks, result caches) invalidates."""
        cap_rows, idx, val = unpack_snapshot(blob, SHARD_WORDS,
                                             self.row_id_cap)
        with self._lock:
            if self.path is not None:
                tmp = self.path + ".repair"
                with open(tmp, "wb") as f:
                    f.write(blob)
                    fsync_file(f)
                durable_replace(tmp, self.path)
                if self._wal_file is not None:
                    try:
                        self._wal_file.close()
                    except OSError:
                        pass
                    self._wal_file = None
                try:
                    os.remove(self._quarantine_path())
                except FileNotFoundError:
                    pass
                fsync_dir(os.path.dirname(self.path) or ".")
            self._idx, self._val, self._cap_rows = idx, val, cap_rows
            self.quarantined = None
            self._op_n = 0
            self._dirty_data = False
            self._stage = None
            self._mark_device_dirty()
            self._dirty_data = False  # state matches the file just written
            self._rank_invalidate()
            if self.path is not None:
                self._wal_file = open(self._wal_path(), "wb", buffering=0)
                self._wal_framed = WAL_CRC
                if self._wal_framed:
                    self._wal_file.write(_WAL_MAGIC)
        _bump("repair")

    def close(self):
        with self._lock:
            if self._wal_file is not None:
                # flush+fsync the WAL FIRST: even if the snapshot below
                # fails (disk full, injected fault), every acknowledged
                # append is on stable storage and a reopen replays to the
                # identical bitmap
                try:
                    fsync_file(self._wal_file)
                except OSError:
                    pass
                try:
                    if self._dirty_data or self._op_n:
                        self.snapshot()
                finally:
                    if self._wal_file is not None:
                        self._wal_file.close()
                        self._wal_file = None
            self._drop_mirrors()
            self._drop_stage()

    def snapshot(self):
        """Rewrite the snapshot file (checksummed v4) and truncate the
        WAL (fragment.go:2311 snapshot)."""
        with self._lock:
            if self.quarantined is not None:
                return  # nothing trustworthy to persist
            if self.path is None:
                self._op_n = 0
                return
            tmp = self.path + ".snapshotting"
            FAULTS.hit("fragment.snapshot", key=self.path)
            with open(tmp, "wb") as f:
                f.write(pack_snapshot(self._cap_rows, self._idx, self._val,
                                      SHARD_WORDS))
                # fsync BEFORE the rename: the write lands in the page
                # cache, and a crash after os.replace would otherwise lose
                # an acknowledged snapshot (the WAL it replaced is
                # truncated)
                fsync_file(f)
            FAULTS.hit("fragment.snapshot.rename", key=self.path)
            durable_replace(tmp, self.path)
            self._dirty_data = False
            if self._wal_file is not None:
                self._wal_file.close()
            self._wal_file = open(self._wal_path(), "wb", buffering=0)
            # truncation is the format upgrade point for legacy WALs
            self._wal_framed = WAL_CRC
            if self._wal_framed:
                self._wal_file.write(_WAL_MAGIC)
            self._op_n = 0

    # -- geometry ----------------------------------------------------------

    @property
    def n_rows(self) -> int:
        """Device-shape row capacity (doubling growth)."""
        return self._cap_rows

    def max_row_id(self) -> int:
        """Highest row with any bit set (fragment.go maxRow)."""
        return int(self._idx[-1] // SHARD_WORDS) if self._idx.size else 0

    def host_bytes(self) -> int:
        """Host memory held by the sparse store."""
        return int(self._idx.nbytes + self._val.nbytes)

    # Default cap when none is threaded in (class fallback keeps in-memory
    # test fragments working without plumbing).
    row_id_cap = DEFAULT_MAX_ROW_ID

    def _ensure_rows(self, row_id: int):
        if row_id < self._cap_rows:
            return
        if row_id > self.row_id_cap:
            raise ValueError(
                f"row id {row_id} exceeds the configured maximum "
                f"{self.row_id_cap} (max_row_id)")
        new_rows = max(_MIN_ROWS, self._cap_rows)
        while new_rows <= row_id:
            new_rows *= 2
        self._cap_rows = new_rows
        self._mark_device_dirty()

    _GEN = itertools.count(1)

    def _mark_device_dirty(self):
        self._device_dirty = True
        self._dirty_data = True
        self.gen = next(self._GEN)
        # any non-ingest mutation (or an explicit fold) supersedes the
        # overlay journal: device forms rebuild from the sparse store,
        # which already holds every journaled bit
        self.device_gen = self.gen
        self._clear_journal()

    def _clear_journal(self):
        if self._journal:
            self._journal.clear()
            self._journal_bytes = 0
            INGEST_DELTA_BUDGET.unregister(("delta", id(self)))
        self._mirror_epoch.clear()

    def _fold_journal_locked(self):
        """Merge step: device forms rebuild from the (already-current)
        sparse store on next use.  NOT a data mutation — gen is
        unchanged, so result caches keyed on it stay valid; only the
        device-residency anchor moves."""
        self._device_dirty = True
        self.device_gen = self.gen
        self._clear_journal()

    def _note_rank(self, rows):
        """Incremental rank-cache maintenance after a successful mutation
        touching ``rows`` (called under self._lock)."""
        if self.rank_cache is not None:
            self.rank_cache.note_write(self, rows)

    def _rank_invalidate(self):
        """Bulk mutation whose touched rows aren't cheaply known (row
        stores, mutex imports): rebuild the rank cache lazily."""
        if self.rank_cache is not None:
            self.rank_cache.invalidate()

    # -- sparse store primitives -------------------------------------------

    def _locate(self, nidx: np.ndarray):
        """(positions, exists-mask) of nidx in the store."""
        pos = np.searchsorted(self._idx, nidx)
        if self._idx.size:
            exists = (pos < self._idx.size) & \
                (self._idx[np.minimum(pos, self._idx.size - 1)] == nidx)
        else:
            exists = np.zeros(nidx.shape, dtype=bool)
        return pos, exists

    def _or_words(self, nidx: np.ndarray, nval: np.ndarray) -> int:
        """OR word values into the store; returns changed-bit count."""
        pos, exists = self._locate(nidx)
        changed = 0
        upd = pos[exists]
        if upd.size:
            old = self._val[upd]
            new = old | nval[exists]
            changed += int(np.bitwise_count(new & ~old).sum())
            self._val[upd] = new
        ins = ~exists
        if ins.any():
            changed += int(np.bitwise_count(nval[ins]).sum())
            self._idx = np.insert(self._idx, pos[ins], nidx[ins])
            self._val = np.insert(self._val, pos[ins], nval[ins])
        return changed

    def _andnot_words(self, nidx: np.ndarray, nval: np.ndarray) -> int:
        """Clear word bits; returns changed-bit count."""
        pos, exists = self._locate(nidx)
        upd = pos[exists]
        if not upd.size:
            return 0
        old = self._val[upd]
        new = old & ~nval[exists]
        changed = int(np.bitwise_count(old & ~new).sum())
        if changed:
            self._val[upd] = new
            keep = self._val != 0
            if not keep.all():
                self._idx, self._val = self._idx[keep], self._val[keep]
        return changed

    def _apply_bits(self, rows, cols, clear: bool) -> int:
        if rows.size == 0:
            return 0
        if clear:
            # Rows at/above capacity cannot hold set bits: drop them rather
            # than growing capacity (which would change the device tensor
            # shape and force a recompile for a guaranteed no-op), and never
            # raise on row ids beyond the cap — clearing them is a no-op.
            keep = rows < self._cap_rows
            if not keep.all():
                rows, cols = rows[keep], cols[keep]
            if rows.size == 0:
                return 0
        else:
            self._ensure_rows(int(rows.max()))
        nidx, nval = _pairs_to_words(rows, cols)
        n = self._andnot_words(nidx, nval) if clear \
            else self._or_words(nidx, nval)
        if n:
            self._mark_device_dirty()
        return n

    def _delete_range(self, lo: int, hi: int):
        """Remove stored words with lo <= flat < hi."""
        a = np.searchsorted(self._idx, lo)
        b = np.searchsorted(self._idx, hi)
        if b > a:
            self._idx = np.delete(self._idx, slice(a, b))
            self._val = np.delete(self._val, slice(a, b))

    def _column_mask_clear(self, cols: np.ndarray, max_row=None) -> int:
        """AND-out the given shard-local columns' bits from every stored
        word (optionally only rows < max_row); returns changed bits."""
        if self._idx.size == 0 or cols.size == 0:
            return 0
        w, bit = bitset.word_bit_np(cols)
        mask = np.zeros(SHARD_WORDS, dtype=np.uint32)
        np.bitwise_or.at(mask, w, bit)
        w_of = (self._idx % SHARD_WORDS).astype(np.int64)
        sel = mask[w_of] != 0
        if max_row is not None:
            sel &= (self._idx // SHARD_WORDS) < max_row
        if not sel.any():
            return 0
        old = self._val[sel]
        new = old & ~mask[w_of[sel]]
        changed = int(np.bitwise_count(old & ~new).sum())
        if changed:
            self._val[sel] = new
            keep = self._val != 0
            if not keep.all():
                self._idx, self._val = self._idx[keep], self._val[keep]
        return changed

    # -- mutation ----------------------------------------------------------

    def _frame(self, payload: bytes) -> bytes:
        """Wrap a batch of op records in one length+CRC frame (or pass
        through bare for legacy-format files).  Header and payload go to
        the file in ONE write() call — frames are never interleaved or
        split by the process itself."""
        if not self._wal_framed:
            return payload
        return _WAL_FRAME.pack(len(payload), checksum(payload)) + payload

    def _log_op(self, op: int, row: int, col: int):
        if self._wal_file is not None:
            FAULTS.hit("fragment.wal", key=self.path or "")
            self._wal_file.write(self._frame(_OP.pack(op, row, col)))
        self._op_n += 1
        if self._op_n >= self.max_op_n:
            if self._wal_file is not None:
                self._wal_file.flush()
            self.snapshot()

    def _log_ops(self, op: int, rows: np.ndarray, cols: np.ndarray):
        """Vectorized batch append: one record-array build + one write
        (one CRC frame per batch — the group-commit framing unit)."""
        if self._wal_file is not None:
            FAULTS.hit("fragment.wal", key=self.path or "")
            recs = np.empty(rows.size, dtype=_OP_DTYPE)
            recs["op"] = op
            recs["row"] = rows
            recs["col"] = cols
            payload = recs.tobytes()
            # replay rejects frames beyond _WAL_MAX_FRAME as corrupt, so
            # the writer must chunk giant imports below it
            step = (_WAL_MAX_FRAME // _OP.size) * _OP.size
            for i in range(0, len(payload), step):
                self._wal_file.write(self._frame(payload[i:i + step]))
        self._op_n += rows.size
        if self._op_n >= self.max_op_n:
            self.snapshot()

    def set_bit(self, row: int, col: int) -> bool:
        """Set one bit; col is shard-local.  Returns True if changed
        (fragment.go:647 setBit)."""
        with self._lock:
            self._check_writable()
            changed = self._apply_bits(np.asarray([row], dtype=np.int64),
                                       np.asarray([col], dtype=np.int64),
                                       clear=False) > 0
            if changed:
                self._note_rank([row])
                self._log_op(_OP_SET, row, col)
            return changed

    def clear_bit(self, row: int, col: int) -> bool:
        with self._lock:
            self._check_writable()
            changed = self._apply_bits(np.asarray([row], dtype=np.int64),
                                       np.asarray([col], dtype=np.int64),
                                       clear=True) > 0
            if changed:
                self._note_rank([row])
                self._log_op(_OP_CLEAR, row, col)
            return changed

    def bulk_import(self, rows: np.ndarray, cols: np.ndarray,
                    clear: bool = False) -> int:
        """Batched import of shard-local (row, col) bits
        (fragment.go:1997 bulkImport / 2053 importPositions).  Returns the
        number of changed bits."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size == 0:
            return 0
        with self._lock:
            self._check_writable()
            n_changed = self._apply_bits(rows, cols, clear=clear)
            if n_changed:
                self._note_rank(rows)
                self._log_ops(_OP_CLEAR if clear else _OP_SET, rows, cols)
            return n_changed

    def mutex_import(self, rows: np.ndarray, cols: np.ndarray) -> int:
        """Batched import with mutex semantics: at most one row per column,
        last write in the batch wins (fragment.go:2106 bulkImportMutex).
        Returns changed-bit count."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size == 0:
            return 0
        # keep the last occurrence of each column
        last = {}
        for i in range(rows.size):
            last[int(cols[i])] = int(rows[i])
        ucols = np.fromiter(last.keys(), dtype=np.int64, count=len(last))
        urow = np.fromiter(last.values(), dtype=np.int64, count=len(last))
        with self._lock:
            self._check_writable()
            self._ensure_rows(int(urow.max()))
            # Winner bits already set are cleared by _column_mask_clear and
            # re-set by _apply_bits; they are no-ops and must not count
            # (fragment.go:2106 bulkImportMutex reports real changes only).
            nidx, nval = _pairs_to_words(urow, ucols)
            pos, exists = self._locate(nidx)
            pre_winner = int(np.bitwise_count(
                self._val[pos[exists]] & nval[exists]).sum())
            gen0, dev_dirty0, data_dirty0 = \
                self.gen, self._device_dirty, self._dirty_data
            cleared = self._column_mask_clear(ucols)
            set_changed = self._apply_bits(urow, ucols, clear=False)
            n_changed = cleared + set_changed - 2 * pre_winner
            if n_changed:
                self._rank_invalidate()  # cleared rows aren't enumerated
                self._mark_device_dirty()
                if self._wal_file is not None:
                    self.snapshot()
            else:
                # idempotent re-import: the store's final state equals its
                # initial state — restore the stamps so downstream caches
                # (device mirrors, mesh stacks) are not invalidated
                self.gen = gen0
                self._device_dirty = dev_dirty0
                self._dirty_data = data_dirty0
            return n_changed

    def set_row(self, row: int, seg: np.ndarray | None):
        """Replace an entire row's bits (Store/SetRow, fragment.go setRow)."""
        with self._lock:
            self._check_writable()
            self._ensure_rows(row)
            base = row * SHARD_WORDS
            self._delete_range(base, base + SHARD_WORDS)
            if seg is not None:
                seg = np.asarray(seg, dtype=np.uint32)
                nz = np.nonzero(seg)[0]
                if nz.size:
                    self._or_words(base + nz.astype(np.int64), seg[nz])
            self._note_rank([row])
            self._mark_device_dirty()
            self.snapshot()  # row stores bypass the op log

    # -- BSI mutation (int fields) ----------------------------------------

    def bit_depth(self) -> int:
        return max(0, self._cap_rows - bsi.OFFSET_ROW)

    def set_value(self, col: int, bit_depth: int, value: int) -> bool:
        """Set a column's integer value (fragment.go:977 setValueBase).
        Grows depth rows as needed; clears stale magnitude bits.  Only the
        bits that actually change are applied AND logged — the old
        log-everything-on-any-change scheme bloated the WAL toward
        premature snapshots (r3 verdict)."""
        with self._lock:
            self._check_writable()
            self._ensure_rows(bsi.OFFSET_ROW + bit_depth - 1)
            mag = abs(value)
            want = {bsi.EXISTS_ROW}
            for i in range(bit_depth):
                if (mag >> i) & 1:
                    want.add(bsi.OFFSET_ROW + i)
            if value < 0:
                want.add(bsi.SIGN_ROW)
            managed = sorted({bsi.EXISTS_ROW, bsi.SIGN_ROW} | {
                bsi.OFFSET_ROW + i for i in range(bit_depth)})
            # targeted probe of only the managed rows' words — NOT a full
            # rows_with_bit scan (O(log nnz) per row vs O(nnz) per write)
            mrows = np.asarray(managed, dtype=np.int64)
            w = col >> 5
            bit = np.uint32(1 << (col & 31))
            pos, exists = self._locate(mrows * SHARD_WORDS + w)
            has = np.zeros(mrows.size, dtype=bool)
            has[exists] = (self._val[pos[exists]] & bit) > 0
            cur = {int(r) for r, h in zip(mrows, has) if h}
            to_set = sorted(want - cur)
            to_clear = sorted(cur - want)
            if to_set:
                rows = np.asarray(to_set, dtype=np.int64)
                cols = np.full(rows.size, col, dtype=np.int64)
                self._apply_bits(rows, cols, clear=False)
                self._log_ops(_OP_SET, rows, cols)
            if to_clear:
                rows = np.asarray(to_clear, dtype=np.int64)
                cols = np.full(rows.size, col, dtype=np.int64)
                self._apply_bits(rows, cols, clear=True)
                self._log_ops(_OP_CLEAR, rows, cols)
            return bool(to_set or to_clear)

    def import_values(self, cols: np.ndarray, values: np.ndarray,
                      bit_depth: int) -> None:
        """Batched setValue (fragment.go:2205 importValue)."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        with self._lock:
            self._check_writable()
            self._ensure_rows(bsi.OFFSET_ROW + bit_depth - 1)
            # clear all target columns' bits first (stale values)
            self._column_mask_clear(cols, max_row=bsi.OFFSET_ROW + bit_depth)
            packed = bsi.pack_values(cols, values, depth=bit_depth,
                                     words=SHARD_WORDS)
            flat = packed.reshape(-1)
            nz = np.nonzero(flat)[0]
            if nz.size:
                self._or_words(nz.astype(np.int64), flat[nz])
            self._mark_device_dirty()
            self.snapshot()

    def clear_values(self, cols: np.ndarray) -> None:
        """Remove columns' values entirely (exists+sign+magnitude cleared) —
        the clear half of importValue (fragment.go:2205 importValue with
        clear)."""
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 0 or self._idx.size == 0:
            return
        with self._lock:
            self._check_writable()
            if self._column_mask_clear(cols):
                self._mark_device_dirty()
            self.snapshot()

    # -- reads -------------------------------------------------------------

    def row(self, row_id: int) -> np.ndarray:
        """Host copy of one row's segment (fragment.go:602 row)."""
        with self._lock:
            out = np.zeros(SHARD_WORDS, dtype=np.uint32)
            if row_id >= self._cap_rows:
                return out
            base = row_id * SHARD_WORDS
            a = np.searchsorted(self._idx, base)
            b = np.searchsorted(self._idx, base + SHARD_WORDS)
            if b > a:
                out[self._idx[a:b] - base] = self._val[a:b]
            return out

    def row_columns(self, row_id: int) -> np.ndarray:
        return bitset.unpack_columns(self.row(row_id))

    def rows_with_bit(self, col: int) -> np.ndarray:
        """Sorted row ids whose bit at shard-local ``col`` is set (the
        column read under mutex/bool semantics and BSI value())."""
        with self._lock:
            if self._idx.size == 0:
                return np.zeros(0, dtype=np.int64)
            w = col >> 5
            bit = np.uint32(1 << (col & 31))
            sel = (self._idx % SHARD_WORDS == w) & (self._val & bit > 0)
            return (self._idx[sel] // SHARD_WORDS).astype(np.int64)

    def row_counts_host(self, rows: np.ndarray) -> np.ndarray:
        """Exact per-row set-bit counts for the given rows, from the host
        sparse store (no device touch).  Popcounts only each requested
        row's word range (O(log nnz) locate + O(row words) per row) —
        this runs on EVERY single-bit write of a rank-cached field, so a
        whole-store scan here would make writes O(nnz)."""
        rows = np.asarray(rows, dtype=np.int64)
        with self._lock:
            out = np.zeros(rows.size, dtype=np.int64)
            if self._idx.size == 0 or rows.size == 0:
                return out
            a = np.searchsorted(self._idx, rows * SHARD_WORDS)
            b = np.searchsorted(self._idx, (rows + 1) * SHARD_WORDS)
            for i in range(rows.size):
                if b[i] > a[i]:
                    out[i] = int(np.bitwise_count(
                        self._val[a[i]: b[i]]).sum())
            return out

    def row_counts_all_host(self) -> tuple[np.ndarray, np.ndarray]:
        """(row ids, exact counts) of every row with any set bit, from the
        host sparse store — the rank-cache rebuild scan (O(nnz))."""
        with self._lock:
            if self._idx.size == 0:
                z = np.zeros(0, dtype=np.int64)
                return z, z
            rows_of = self._idx // SHARD_WORDS
            pops = np.bitwise_count(self._val).astype(np.int64)
            uniq, start = np.unique(rows_of, return_index=True)
            return uniq, np.add.reduceat(pops, start)

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, shard-local cols) of every set bit, (row, col)-ordered —
        the export/iteration surface (fragment.go:2771 rowIterator)."""
        with self._lock:
            return _expand_words(self._idx, self._val)

    def to_dense(self) -> np.ndarray:
        """Materialise the dense [cap_rows, SHARD_WORDS] tensor (device
        upload + compatibility paths).  O(cap_rows x 128KB) — transient."""
        with self._lock:
            out = np.zeros((self._cap_rows, SHARD_WORDS), dtype=np.uint32)
            if self._idx.size:
                out.reshape(-1)[self._idx] = self._val
            return out

    @property
    def words(self) -> np.ndarray:
        """Dense view for compatibility/oracle paths; materialises on each
        access — do not use on hot paths."""
        return self.to_dense()

    def staged_dense(self) -> np.ndarray:
        """Dense block via the host staging cache.  After an HBM eviction
        the re-upload reads this cached expansion instead of re-running
        the sparse->dense scatter — under budget pressure the expansion,
        not the transfer, dominates cold re-stages.  Keyed by the data
        generation (any mutation invalidates); HOST_STAGE_BUDGET bounds
        total cached host bytes LRU-wise (limit 0 disables caching).
        With no device-budget limit nothing is ever evicted, so there is
        no re-upload to accelerate — caching would only grow host RSS —
        and the expansion stays transient like to_dense().

        The returned array is SHARED — callers must treat it read-only
        (device uploads and stacked-block fills copy out of it)."""
        if HOST_STAGE_BUDGET.limit_bytes == 0 or \
                self.budget.limit_bytes is None:
            return self.to_dense()
        with self._lock:
            st = self._stage
            if st is not None and st[0] == self.gen:
                HOST_STAGE_BUDGET.touch(("stage", id(self)))
                return st[1]
            dense = self.to_dense()
            self._stage = (self.gen, dense)
            HOST_STAGE_BUDGET.register(("stage", id(self)), dense.nbytes,
                                       self._evict_stage)
            return dense

    def _evict_stage(self):
        # host-stage budget callback: drop the cached expansion only
        self._stage = None

    def _drop_stage(self):
        HOST_STAGE_BUDGET.unregister(("stage", id(self)))
        HOST_STAGE_BUDGET.unregister(("packed", id(self)))
        INGEST_DELTA_BUDGET.unregister(("delta", id(self)))
        self._stage = None
        self._packed = None

    # -- compressed-resident form (ops/containers.py) ----------------------

    def packed_host(self):
        """This fragment's packed container stream (array/bitmap/run
        containers over the sparse word store), built host-side WITHOUT
        materialising the dense tensor and cached by data generation —
        snapshot load + packing never allocates cap_rows x 128KB.  The
        cache registers with HOST_STAGE_BUDGET like the dense stage (a
        re-stage accelerator, evictable under host pressure; limit 0
        disables caching and the pack stays transient)."""
        from ..ops import containers
        with self._lock:
            p = self._packed
            if p is not None and p[0] == self.device_gen:
                HOST_STAGE_BUDGET.touch(("packed", id(self)))
                return p[1]
            packed = containers.pack_words(self._idx, self._val)
            # exact packed bytes supersede the census upper bound as the
            # density-heuristic input, for free.  Keyed by device_gen, not
            # gen: while an ingest journal is active the device-facing
            # pack/estimate are FROZEN at the journal's base so stack
            # tokens stay stable between folds (a compressed fragment
            # never journals, so packing sees an empty journal, where
            # the two gens agree).
            self._comp_est = (self.device_gen, packed.nbytes)
            if HOST_STAGE_BUDGET.limit_bytes != 0:
                self._packed = (self.device_gen, packed)
                HOST_STAGE_BUDGET.register(("packed", id(self)),
                                           packed.nbytes,
                                           self._evict_packed)
            return packed

    def _evict_packed(self):
        # host-stage budget callback: drop the cached pack only
        self._packed = None

    def _compressed_est(self) -> int:
        """Gen-cached upper bound on the packed stream's bytes (cheap:
        container census over the sparse indices, no packing)."""
        from ..ops import containers
        with self._lock:
            e = self._comp_est
            if e is not None and e[0] == self.device_gen:
                return e[1]
            est = containers.estimate_packed_bytes(self._idx)
            self._comp_est = (self.device_gen, est)
            return est

    def device_form(self) -> str:
        """'compressed' | 'dense': which device-resident form this
        fragment's data warrants.  Compressed only under a configured
        device budget (with unlimited HBM the dense mirror is strictly
        faster — no decode per launch — exactly as staged_dense only
        caches under a limit) and only when the density heuristic says
        the packed stream actually undercuts the dense footprint."""
        from ..ops.containers import MAX_COMPRESSED_ROWS
        if not COMPRESSED_RESIDENT or self.budget.limit_bytes is None:
            return "dense"
        dense = self._cap_rows * SHARD_WORDS * 4
        if dense == 0 or self._cap_rows > MAX_COMPRESSED_ROWS:
            return "dense"
        return "compressed" \
            if self._compressed_est() <= COMPRESS_MAX_DENSITY * dense \
            else "dense"

    def device_nbytes(self) -> int:
        """Bytes this fragment's device-resident form occupies — the
        residency unit the budget and the shard-slice planner account
        (compressed bytes for compressed-form fragments, the dense
        tensor for the rest)."""
        if self.device_form() == "compressed":
            return self.packed_host().nbytes
        return self._cap_rows * SHARD_WORDS * 4

    def device_sig(self, device) -> tuple:
        """Stacked-group shape signature for the stacked executor: dense
        fragments keep the (rows, words) tensor shape; compressed ones
        are ('z', rows, backend).  The trailing element is the
        container-kernel backend RESOLVED from ``device`` (ops/kernels.py:
        "cuda" for a CUDA device, "torch" for the plain version on the
        CPU), so stacks built for one device are never replayed on the
        other.

        Deviation from the JAX package, whose compressed signature also
        carries pow2 buckets of container, payload, array-entry and run
        counts so that one bucket's fragments stack into one rectangular
        group of static shape for XLA: the port's kernels take a ragged
        stack (ops/containers.py PackedStack), so the buckets would only
        split one launch into many.  The signature no longer reads the
        pack, so it needs no cache of its own; the stack token's
        ``device_gen`` still changes with every write."""
        if self.device_form() == "dense":
            return (self.n_rows, SHARD_WORDS)
        from ..ops import kernels
        return ("z", self.n_rows, kernels.resolve(device))

    def packed_stats(self) -> dict | None:
        """Container-type histogram of the CURRENT packed stream, or
        None when no current pack exists (never packs on demand — this
        feeds metric scrapes, which must stay O(1) per fragment)."""
        with self._lock:
            p = self._packed
            if p is None or p[0] != self.device_gen:
                return None
            return p[1].type_histogram()

    # -- ingest delta overlay (docs/ingest.md) -----------------------------

    def ingest_apply(self, rows: np.ndarray, cols: np.ndarray) -> int:
        """Group-commit apply of a flush's set bits for this fragment:
        ONE sparse-store merge, ONE WAL frame, ONE generation bump, ONE
        rank-cache touch — and, when a device-resident form exists, the
        new words land in the overlay journal instead of invalidating it
        (mirrors/stacks OR the journal in at next use; the sparse store
        is the source of truth either way, so every host read is current
        immediately).  Returns the changed-bit count; a fully idempotent
        re-ingest (no bit changed) is a no-op — no WAL frame, no gen
        bump — which is what makes client retries after a 503 safe."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size == 0:
            return 0
        with self._lock:
            self._check_writable()
            limit = _membudget.INGEST_DELTA_LIMIT_BYTES
            if int(rows.max()) >= self._cap_rows:
                # capacity growth changes the device tensor shape — no
                # overlay can cover that; _ensure_rows folds the journal
                self._ensure_rows(int(rows.max()))
            # Overlay only for dense-form fragments: compressed packed
            # streams cannot absorb a scatter — those fold per flush (the
            # flush is still one gen bump, the win over per-call
            # bulk_import remains).  A dirty device state doesn't matter:
            # consumers built later stage from the sparse store (already
            # current) and record the epochs they captured.
            overlay = limit > 0 and self.device_form() == "dense"
            nidx, nval = _pairs_to_words(rows, cols)
            changed = self._or_words(nidx, nval)
            if changed == 0:
                return 0
            if not overlay:
                self._mark_device_dirty()
            else:
                self._dirty_data = True
                self.gen = next(self._GEN)
                self.ingest_epoch += 1
                self._journal.append((self.ingest_epoch, nidx, nval))
                self._journal_bytes += int(nidx.nbytes + nval.nbytes)
                INGEST_DELTA_BUDGET.register(
                    ("delta", id(self)), self._journal_bytes,
                    lambda: None)  # accounting-only; folds are cooperative
                # per-fragment share of the delta budget: one hot
                # fragment must not monopolise it before the committer's
                # cross-fragment merge pass can react
                if self._journal_bytes > max(limit // 8, 1 << 20):
                    self._fold_journal_locked()
            self._note_rank(rows)
            self._log_ops(_OP_SET, rows, cols)
            return changed

    def delta_chunks(self, after_epoch: int) -> list:
        """Journal chunks newer than ``after_epoch`` — what a device
        consumer (mirror, stacked block) must OR in to reach the current
        generation.  Chunks are immutable once appended; the list copy
        makes iteration safe outside the lock."""
        with self._lock:
            return [c for c in self._journal if c[0] > after_epoch]

    def delta_bytes(self) -> int:
        return self._journal_bytes

    def fold_delta(self) -> bool:
        """Fold the overlay journal into a plain device-dirty state (the
        background-merge step): the next staging rebuilds mirrors/stacks
        and the packed form from the sparse store, which already holds
        every journaled bit.  Returns True if there was anything to
        fold."""
        with self._lock:
            if not self._journal:
                return False
            self._fold_journal_locked()
            return True

    def device(self, target):
        """The device-resident dense mirror on ``target`` (a torch device;
        uploads if stale): int32 words holding the uint32 bit patterns,
        ``[cap_rows, SHARD_WORDS]``.  This is the per-shard query path's
        input — equivalent to the mmap'd storage the reference queries
        against (fragment.go:311).  Mirrors are cached per device.

        A compressed-form fragment ships its packed container stream
        (compressed bytes on the wire) and decodes it to the dense mirror
        ON the device (ops/containers.py upload_decode, which goes through
        the decode kernel on a CUDA device); the rest upload the host
        dense block.  A resident mirror that has not seen every journaled
        ingest flush absorbs the unseen chunks as one indexed OR
        (ingest/delta.py ``apply_overlay``) instead of a re-upload.  Every
        mirror registers with the fragment's DeviceBudget at its dense
        bytes; under a configured limit the LRU mirror is dropped and
        re-uploaded on next use."""
        import torch

        target = torch.device(target)
        with self._lock:
            if self._device_dirty:
                self._drop_mirrors()
                self._device_dirty = False
            mirror = self._mirrors.get(target)
            key = (id(self), target)
            if mirror is not None and \
                    self._mirror_epoch.get(target, 0) < self.ingest_epoch \
                    and self._journal:
                # OR the journal chunks this mirror hasn't seen into it
                # ON the device — a flush's worth of words travels
                # instead of the whole dense tensor
                from ..ingest.delta import apply_overlay, merge_chunks
                chunks = self.delta_chunks(self._mirror_epoch.get(target, 0))
                didx, dval = merge_chunks(chunks)
                if didx.size:
                    mirror = apply_overlay(mirror, didx, dval, SHARD_WORDS)
                    self._mirrors[target] = mirror
                self._mirror_epoch[target] = self.ingest_epoch
            if mirror is None:
                if self.device_form() == "compressed":
                    from ..ops.containers import upload_decode
                    mirror = upload_decode(self.packed_host(),
                                           self._cap_rows, target)
                else:
                    from ..ops.bitset import from_numpy
                    mirror = from_numpy(self.staged_dense(), target)
                self._mirrors[target] = mirror
                # fresh uploads stage from the sparse store, which holds
                # every journaled bit already
                self._mirror_epoch[target] = self.ingest_epoch
                self.budget.register(
                    key, self._cap_rows * SHARD_WORDS * 4,
                    lambda t=target: self._evict_mirror(t))
            else:
                self.budget.touch(key)
            return mirror

    def _evict_mirror(self, target):
        # budget eviction callback: drop our reference only (in-flight
        # computations keep theirs)
        self._mirrors.pop(target, None)

    def _drop_mirrors(self):
        for target in list(self._mirrors):
            self.budget.unregister((id(self), target))
        self._mirrors.clear()

    # -- anti-entropy block checksums (fragment.go:1778 Blocks) ------------

    def blocks(self) -> dict[int, bytes]:
        """Checksum per HASH_BLOCK_SIZE-row block of non-empty rows."""
        out = {}
        with self._lock:
            if self._idx.size == 0:
                return out
            block_of = self._idx // (HASH_BLOCK_SIZE * SHARD_WORDS)
            for blk_id in np.unique(block_of):
                blk = self._dense_block(int(blk_id))
                out[int(blk_id)] = hashlib.blake2b(
                    blk.tobytes(), digest_size=16).digest()
        return out

    def _dense_block(self, block_id: int) -> np.ndarray:
        """Dense HASH_BLOCK_SIZE-row block (padded, digest-stable)."""
        base = block_id * HASH_BLOCK_SIZE * SHARD_WORDS
        a = np.searchsorted(self._idx, base)
        b = np.searchsorted(self._idx, base + HASH_BLOCK_SIZE * SHARD_WORDS)
        blk = np.zeros((HASH_BLOCK_SIZE, SHARD_WORDS), dtype=np.uint32)
        if b > a:
            blk.reshape(-1)[self._idx[a:b] - base] = self._val[a:b]
        return blk

    def block_data(self, block_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(rows, cols) pairs of one block (fragment.go:1859 blockData)."""
        with self._lock:
            start = block_id * HASH_BLOCK_SIZE
            base = start * SHARD_WORDS
            a = np.searchsorted(self._idx, base)
            b = np.searchsorted(self._idx,
                                base + HASH_BLOCK_SIZE * SHARD_WORDS)
            r, c = _expand_words(self._idx[a:b] - base, self._val[a:b])
            return r + start, c
