"""Pilosa 64-bit roaring file format codec (import/export compatibility).

Implements the reference's serialization (roaring/roaring.go:1046 WriteTo,
docs/architecture.md "Roaring bitmap storage format"): little-endian,
cookie = 12348 (low 16 bits) | version<<16 | flags<<24, container count u32,
then per container a descriptive header (key u64, type u16, cardinality-1
u16), an offset header (u32 per container), and container data:

* array (type 1): cardinality x u16
* bitmap (type 2): 1024 x u64
* run (type 3): run count u16 then [start, last] u16 pairs (inclusive)

A fragment's bit (row, col) maps to position pos = row*SHARD_WIDTH + col;
roaring keys are pos >> 16 and containers hold the low 16 bits
(fragment.go:3087 pos, roaring key split).

All parsing is vectorized numpy — container payloads are decoded with
frombuffer/unpackbits, so the Python-level loop is per container, not per
bit.

Port copy of the JAX package's ``storage/roaring_io.py``: the PyTorch
port keeps its own copy so that it imports nothing of the JAX package.
One change: a run container's runs expand in one vectorized step, where
the JAX module loops over runs (the served load of the SSB corpus spent
most of its unpack time in that loop); the positions are the same.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core import SHARD_WIDTH, SHARD_WIDTH_EXP
from ..utils.durable import checksum

MAGIC = 12348
# official-roaring interop cookies (roaring.go:5020; the reference's
# UnmarshalBinary accepts both its own and the official format)
OFFICIAL_NO_RUNS = 12346
OFFICIAL_RUNS = 12347
TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

ARRAY_MAX_SIZE = 4096  # roaring.go:1927
RUN_MAX_SIZE = 2048    # roaring.go:1930


class RoaringFormatError(ValueError):
    pass


# -- fragment snapshot codec (docs/robustness.md "Durability & recovery") --
#
# The native snapshot file for Fragment's sparse word store.  Version
# history:
#   v2 (PTPUFRG2): header + nnz LE (flat u32, word u32) pairs — legacy,
#       read-only, no checksums.
#   v3 (PTPUFRG3): header + nnz LE u64 flat indices + nnz LE u32 words —
#       legacy, read-only, no checksums (tall sparse fragments).
#   v4 (PTPUFRG4): checksummed.  Layout:
#       [0:24)   header  <8sIIQ>  magic, cap_rows, words/row, nnz
#       [24:28)  <I> CRC of the header bytes — verified BEFORE nnz is
#                trusted, so a flipped bit in nnz cannot drive a huge
#                allocation or a bogus payload read
#       [28:28+12*nnz)  payload: nnz LE u64 flat indices, nnz LE u32 words
#       trailer  <I> CRC of the payload bytes
#   The total size is fully determined by the header, so truncation and
#   appended garbage are both detected by a length check alone.
#
# All versions go through unpack_snapshot(), which raises
# SnapshotFormatError on ANY malformed input (the caller decides whether
# that quarantines the fragment or propagates).

SNAP_MAGIC_V2 = b"PTPUFRG2"
SNAP_MAGIC_V3 = b"PTPUFRG3"
SNAP_MAGIC_V4 = b"PTPUFRG4"
SNAP_HEADER = struct.Struct("<8sIIQ")
_SNAP_CRC = struct.Struct("<I")


class SnapshotFormatError(ValueError):
    """Malformed/corrupt fragment snapshot bytes."""


def pack_snapshot(cap_rows: int, idx: np.ndarray, val: np.ndarray,
                  words_per_row: int) -> bytes:
    """Serialize a sparse word store to the checksummed v4 format."""
    header = SNAP_HEADER.pack(SNAP_MAGIC_V4, cap_rows, words_per_row,
                              idx.size)
    idx_b = idx.astype("<u8").tobytes()
    val_b = val.astype("<u4").tobytes()
    return b"".join((
        header,
        _SNAP_CRC.pack(checksum(header)),
        idx_b,
        val_b,
        _SNAP_CRC.pack(checksum(val_b, checksum(idx_b))),
    ))


def unpack_snapshot(data: bytes, words_per_row: int,
                    row_id_cap: int | None = None
                    ) -> tuple[int, np.ndarray, np.ndarray]:
    """Parse any snapshot version into (cap_rows, idx int64, val uint32).

    Checksums are verified for v4; v2/v3 predate them and get structural
    validation only (exact length, sorted indices, in-range values) —
    the lenient-load path for files written before this format existed.
    Raises SnapshotFormatError on anything malformed."""
    try:
        return _unpack_snapshot(data, words_per_row, row_id_cap)
    except SnapshotFormatError:
        raise
    except (struct.error, ValueError, OverflowError) as e:
        raise SnapshotFormatError(f"malformed snapshot: {e}")


def _unpack_snapshot(data, words_per_row, row_id_cap):
    if len(data) < SNAP_HEADER.size:
        raise SnapshotFormatError(
            f"snapshot too short ({len(data)} bytes)")
    magic, cap_rows, words, nnz = SNAP_HEADER.unpack_from(data, 0)
    if magic not in (SNAP_MAGIC_V2, SNAP_MAGIC_V3, SNAP_MAGIC_V4):
        raise SnapshotFormatError(f"bad snapshot magic {magic!r}")
    if magic == SNAP_MAGIC_V4:
        # header CRC first: nnz must not be trusted before this passes
        if len(data) < SNAP_HEADER.size + _SNAP_CRC.size:
            raise SnapshotFormatError("snapshot header truncated")
        (hcrc,) = _SNAP_CRC.unpack_from(data, SNAP_HEADER.size)
        if checksum(data[:SNAP_HEADER.size]) != hcrc:
            raise SnapshotFormatError("snapshot header CRC mismatch")
    if words != words_per_row:
        raise SnapshotFormatError(
            f"snapshot has {words} words/row, expected {words_per_row}")
    if row_id_cap is not None and cap_rows > 2 * (row_id_cap + 1):
        # row capacity doubles, so a legitimately-written snapshot never
        # declares more than 2*(cap+1) rows; beyond that the header is
        # corrupt or was written under a larger max_row_id config
        raise SnapshotFormatError(
            f"snapshot declares {cap_rows} rows, above the configured "
            f"max_row_id {row_id_cap}; raise max_row_id if this data "
            f"was written with a larger cap")
    if magic == SNAP_MAGIC_V2:
        want = SNAP_HEADER.size + 8 * nnz
        if len(data) != want:
            raise SnapshotFormatError(
                f"snapshot is {len(data)} bytes, v2 header implies {want}")
        pairs = np.frombuffer(data, dtype="<u4", count=2 * nnz,
                              offset=SNAP_HEADER.size)
        idx = pairs[0::2].astype(np.int64)
        val = pairs[1::2].astype(np.uint32)
    else:
        off = SNAP_HEADER.size
        if magic == SNAP_MAGIC_V4:
            off += _SNAP_CRC.size
        want = off + 12 * nnz
        if magic == SNAP_MAGIC_V4:
            want += _SNAP_CRC.size
        if len(data) != want:
            raise SnapshotFormatError(
                f"snapshot is {len(data)} bytes, header implies {want}")
        idx_b = data[off: off + 8 * nnz]
        val_b = data[off + 8 * nnz: off + 12 * nnz]
        if magic == SNAP_MAGIC_V4:
            (pcrc,) = _SNAP_CRC.unpack_from(data, want - _SNAP_CRC.size)
            if checksum(val_b, checksum(idx_b)) != pcrc:
                raise SnapshotFormatError("snapshot payload CRC mismatch")
        idx = np.frombuffer(idx_b, dtype="<u8").astype(np.int64)
        val = np.frombuffer(val_b, dtype="<u4").astype(np.uint32)
    # structural validation (cheap; the load-bearing defense for the
    # un-checksummed legacy versions): indices sorted/unique/in-range,
    # or every downstream searchsorted silently mis-answers
    if idx.size:
        if int(idx[0]) < 0 or int(idx[-1]) >= cap_rows * words_per_row:
            raise SnapshotFormatError("snapshot index out of range")
        if idx.size > 1 and not bool(np.all(np.diff(idx) > 0)):
            raise SnapshotFormatError(
                "snapshot indices not strictly increasing")
    keep = val != 0
    if not keep.all():
        idx, val = idx[keep], val[keep]
    return cap_rows, idx, val


def unpack_roaring(data: bytes, row_id_cap: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Parse a pilosa-roaring blob into (rows, shard-local cols) int64
    arrays (roaring/roaring.go:1258 newRoaringIterator).  Raises
    RoaringFormatError (a ValueError) on any malformed input.
    ``row_id_cap`` bounds the highest implied row id (defaults to the
    process-wide DEFAULT_MAX_ROW_ID)."""
    try:
        return _unpack_roaring(data, row_id_cap)
    except RoaringFormatError:
        raise
    except (struct.error, IndexError, OverflowError, ValueError) as e:
        # ValueError: np.frombuffer on a truncated payload
        raise RoaringFormatError(f"malformed roaring data: {e}")


def _unpack_roaring(data: bytes, row_id_cap: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    if len(data) < 8:
        raise RoaringFormatError("roaring data too short")
    cookie = struct.unpack_from("<I", data, 0)[0]
    if cookie & 0xFFFF in (OFFICIAL_NO_RUNS, OFFICIAL_RUNS):
        rows, cols = _unpack_official(data, cookie)
        # apply the same row-id allocation guard as the pilosa path
        # (official keys are u16, but configured caps can sit below the
        # row 4095 a max key implies)
        if row_id_cap is None:
            from ..core import DEFAULT_MAX_ROW_ID
            row_id_cap = DEFAULT_MAX_ROW_ID
        if rows.size and int(rows.max()) > row_id_cap:
            raise RoaringFormatError(
                f"roaring data implies a row id {int(rows.max())} above "
                f"the configured maximum {row_id_cap}")
        return rows, cols
    if cookie & 0xFFFF != MAGIC:
        raise RoaringFormatError(
            f"bad roaring cookie: {cookie & 0xFFFF} (want {MAGIC})")
    n_containers = struct.unpack_from("<I", data, 4)[0]
    header_off = 8
    offsets_off = header_off + n_containers * 12
    if len(data) < offsets_off + n_containers * 4:
        raise RoaringFormatError(
            f"roaring data truncated: {n_containers} containers declared, "
            f"{len(data)} bytes")

    # Container keys are the high 48 bits of a bit position; reject any key
    # implying a row id above the configured cap BEFORE the signed shift —
    # a key >= 2**47 would overflow int64 and silently alias into valid
    # rows, bypassing the cap (and the allocation guard behind it).
    if row_id_cap is None:
        from ..core import DEFAULT_MAX_ROW_ID
        row_id_cap = DEFAULT_MAX_ROW_ID

    max_key = (((row_id_cap + 1) << SHARD_WIDTH_EXP) - 1) >> 16

    positions = []
    for i in range(n_containers):
        key, ctype, n_minus1 = struct.unpack_from(
            "<QHH", data, header_off + i * 12)
        if key > max_key:
            raise RoaringFormatError(
                f"roaring container key {key} implies a row id above the "
                f"configured maximum {row_id_cap}")
        n = n_minus1 + 1
        off = struct.unpack_from("<I", data, offsets_off + i * 4)[0]
        base = np.int64(key) << 16
        if ctype == TYPE_ARRAY:
            vals = np.frombuffer(data, dtype="<u2", count=n, offset=off)
            positions.append(base + vals.astype(np.int64))
        elif ctype == TYPE_BITMAP:
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=off)
            bits = np.unpackbits(
                words.view(np.uint8), bitorder="little")
            positions.append(base + np.nonzero(bits)[0].astype(np.int64))
        elif ctype == TYPE_RUN:
            run_count = struct.unpack_from("<H", data, off)[0]
            runs = np.frombuffer(data, dtype="<u2", count=run_count * 2,
                                 offset=off + 2).reshape(run_count, 2)
            # every run's [start, last] at once (a run with last <
            # start is empty, as np.arange makes it)
            first = runs[:, 0].astype(np.int64)
            lens = np.maximum(runs[:, 1].astype(np.int64) - first + 1, 0)
            skip = np.cumsum(lens) - lens
            positions.append(base + np.repeat(first - skip, lens)
                             + np.arange(int(lens.sum())))
        else:
            raise RoaringFormatError(f"unknown container type {ctype}")

    if not positions:
        return (np.zeros(0, dtype=np.int64),) * 2
    pos = np.concatenate(positions)
    return pos // SHARD_WIDTH, pos % SHARD_WIDTH


def _unpack_official(data: bytes, cookie: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Official-roaring (32-bit) interop: cookie 12346 (arrays/bitmaps,
    with offset table) or 12347 (run containers flagged in a bitset) —
    roaring.go:5024 readOfficialHeader, :1343
    officialRoaringIterator.Next.  Official run pairs are
    (start, length-1); pilosa's are (start, last).

    Divergence from the reference, on purpose: per the official spec the
    runs cookie also carries an offset table once there are
    NO_OFFSET_THRESHOLD (4) or more containers; the reference assumes
    run-cookie files are always sequential and would misparse such files
    from stock CRoaring/Java writers.  Array containers hold up to 4096
    values INCLUSIVE officially (bitmap only above), where the
    reference's typer uses a strict <, silently misreading a 4096-card
    array (8192 bytes) as a bitmap."""
    NO_OFFSET_THRESHOLD = 4
    pos_off = 4
    if cookie & 0xFFFF == OFFICIAL_NO_RUNS:
        n = struct.unpack_from("<I", data, pos_off)[0]
        pos_off += 4
        run_flags = None
    else:
        n = (cookie >> 16) + 1
        flag_bytes = (n + 7) // 8
        run_flags = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8, count=flag_bytes,
                          offset=pos_off), bitorder="little")
        pos_off += flag_bytes
    if n > (1 << 16):
        raise RoaringFormatError(
            "more than 2^16 containers in official roaring header")
    headers = np.frombuffer(data, dtype="<u2", count=n * 2,
                            offset=pos_off).reshape(n, 2)
    pos_off += n * 4
    offsets = None
    if run_flags is None or n >= NO_OFFSET_THRESHOLD:
        offsets = np.frombuffer(data, dtype="<u4", count=n, offset=pos_off)
        pos_off += n * 4

    positions = []
    cur = pos_off
    for i in range(n):
        key = int(headers[i, 0])
        card = int(headers[i, 1]) + 1
        is_run = run_flags is not None and i < run_flags.size \
            and run_flags[i]
        off = int(offsets[i]) if offsets is not None else cur
        base = np.int64(key) << 16
        if is_run:
            run_count = struct.unpack_from("<H", data, off)[0]
            runs = np.frombuffer(data, dtype="<u2", count=run_count * 2,
                                 offset=off + 2).reshape(run_count, 2)
            for start, length1 in runs.astype(np.int64):
                positions.append(base + np.arange(start,
                                                  start + length1 + 1))
            cur = off + 2 + run_count * 4
        elif card <= ARRAY_MAX_SIZE:
            vals = np.frombuffer(data, dtype="<u2", count=card, offset=off)
            positions.append(base + vals.astype(np.int64))
            cur = off + card * 2
        else:
            words = np.frombuffer(data, dtype="<u8", count=1024, offset=off)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            positions.append(base + np.nonzero(bits)[0].astype(np.int64))
            cur = off + 8192
    if not positions:
        return (np.zeros(0, dtype=np.int64),) * 2
    pos = np.concatenate(positions)
    return pos // SHARD_WIDTH, pos % SHARD_WIDTH


def _count_runs(vals: np.ndarray) -> int:
    """Number of runs in a sorted unique u16 array (roaring.go:2200
    countRuns)."""
    if vals.size == 0:
        return 0
    return int(np.count_nonzero(np.diff(vals.astype(np.int64)) != 1)) + 1


def _choose_container(vals: np.ndarray) -> tuple[int, int, bytes]:
    """(type, cardinality, payload) for one container's sorted unique u16
    values, per the optimize heuristic (roaring.go:2232): runs when run
    count <= RUN_MAX_SIZE and <= N/2, else array when N < ARRAY_MAX_SIZE,
    else bitmap."""
    n = int(vals.size)
    n_runs = _count_runs(vals)
    if n_runs <= RUN_MAX_SIZE and n_runs <= n // 2:
        v = vals.astype(np.int64)
        brk = np.nonzero(np.diff(v) != 1)[0]
        starts = np.concatenate(([v[0]], v[brk + 1]))
        lasts = np.concatenate((v[brk], [v[-1]]))
        payload = struct.pack("<H", n_runs) + np.column_stack(
            (starts, lasts)).astype("<u2").tobytes()
        return TYPE_RUN, n, payload
    if n < ARRAY_MAX_SIZE:
        return TYPE_ARRAY, n, vals.astype("<u2").tobytes()
    words = np.zeros(1024, dtype="<u8")
    v = vals.astype(np.int64)
    np.bitwise_or.at(words, v >> 6,
                     np.uint64(1) << (v & 63).astype(np.uint64))
    return TYPE_BITMAP, n, words.tobytes()


def _assemble(containers: list[tuple[int, int, int, bytes]]) -> bytes:
    """Assemble (key, type, cardinality, payload) containers into a
    pilosa-roaring blob (roaring.go:1046 WriteTo layout)."""
    out = bytearray()
    out += struct.pack("<I", MAGIC)
    out += struct.pack("<I", len(containers))
    for key, ctype, n, _ in containers:
        out += struct.pack("<QHH", key, ctype, n - 1)
    offset = 8 + len(containers) * 12 + len(containers) * 4
    for _, _, _, payload in containers:
        out += struct.pack("<I", offset)
        offset += len(payload)
    for _, _, _, payload in containers:
        out += payload
    return bytes(out)


def pack_roaring(rows: np.ndarray, cols: np.ndarray) -> bytes:
    """Serialize (row, shard-local col) bits to the pilosa-roaring format,
    choosing the cheapest container per key with the reference's optimize
    heuristic (see _choose_container)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    pos = np.unique(rows * SHARD_WIDTH + cols)
    keys = pos >> 16
    low = (pos & 0xFFFF).astype("<u2")
    containers = []
    for key in np.unique(keys):
        ctype, n, payload = _choose_container(low[keys == key])
        containers.append((int(key), ctype, n, payload))
    return _assemble(containers)


def pack_roaring_words(words: np.ndarray) -> bytes:
    """Serialize a dense [rows, SHARD_WORDS] uint32 words block without
    expanding to bit pairs (bulk loaders / bench fixtures).  Dense
    windows (the bitmap-container regime) are memcpy'd straight from the
    word block — a 65536-column window's bitmap payload IS its 8KB word
    slice; sparse/runny windows go through the same per-container
    chooser as pack_roaring."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n_rows = words.shape[0]
    per_row = SHARD_WIDTH >> 16  # 65536-col windows per row
    blocks = words.reshape(n_rows * per_row, 2048)
    cards = np.bitwise_count(blocks).sum(axis=1)
    containers = []
    for bi in np.nonzero(cards)[0]:
        key = int(bi)  # key = row * per_row + window, in row-major order
        card = int(cards[bi])
        if card >= ARRAY_MAX_SIZE:
            # candidate bitmap: verify runs don't win without unpacking
            w = blocks[bi].view("<u8")
            shifted = (w << np.uint64(1))
            shifted[1:] |= (w[:-1] >> np.uint64(63))
            n_runs = int(np.bitwise_count(w & ~shifted).sum())
            if not (n_runs <= RUN_MAX_SIZE and n_runs <= card // 2):
                containers.append(
                    (key, TYPE_BITMAP, card, blocks[bi].tobytes()))
                continue
        bits = np.unpackbits(blocks[bi].view(np.uint8),
                             bitorder="little")
        vals = np.nonzero(bits)[0].astype("<u2")
        ctype, n, payload = _choose_container(vals)
        containers.append((key, ctype, n, payload))
    return _assemble(containers)
