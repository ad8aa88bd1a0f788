"""Ingest wire format: length-prefixed CRC-framed binary record streams.

The JSON import surface parses every row id through a Python dict; at
millions of events per second the parse IS the bottleneck (and base64
roaring bodies pay a 4/3 blowup on top).  The ingest endpoint speaks a
binary stream instead, built from the same two primitives as the framed
WAL (storage/fragment.py): an 8-byte magic, then frames of

    <u32 payload_len, u32 payload_crc> payload

where ``payload_crc`` is ``utils.durable.checksum`` (zlib crc32) over the
payload and the payload is one record-type byte followed by fixed-width
packed records:

    type 0  "bits"       <i64 row, i64 col>            set bits
    type 1  "bits+ts"    <i64 row, i64 col, i64 ts>    timestamped set
                         bits (ts = unix seconds; 0 = untimed)
    type 2  "values"     <i64 col, i64 value>          BSI int values

Columns are GLOBAL column ids — the server routes each record to its
shard's owners via the cluster placement.  A frame is the unit of
acknowledgement: the server's 200 response means every frame it read was
group-committed to the WAL (docs/ingest.md).  Frames are idempotent (set
bits / last-write-wins values), so a client that got a 503 or lost the
connection mid-stream can safely resend the whole stream.

Numpy record-dtype views keep encode and decode a single memcpy-shaped
operation per frame — no per-record Python loop on either side.

Port copy of the JAX package's ``ingest/wire.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.durable import checksum

MAGIC = b"PTPUING1"
FRAME = struct.Struct("<II")

REC_BITS = 0
REC_BITS_TS = 1
REC_VALS = 2

# fixed record layouts per type (little-endian, like the WAL)
_DTYPES = {
    REC_BITS: np.dtype([("row", "<i8"), ("col", "<i8")]),
    REC_BITS_TS: np.dtype([("row", "<i8"), ("col", "<i8"), ("ts", "<i8")]),
    REC_VALS: np.dtype([("col", "<i8"), ("value", "<i8")]),
}

# Server-side per-frame ceiling (ingest-max-frame-mb overrides): a frame
# must be buffered whole for its CRC, so it bounds per-connection memory.
DEFAULT_MAX_FRAME_BYTES = 32 << 20


class FrameError(ValueError):
    """Malformed ingest stream (bad magic, CRC mismatch, bad record
    type, oversized or truncated frame).  The server answers 400 and
    closes the connection — mid-stream garbage cannot be resynced."""


def pack_bits(rows, cols, ts=None) -> bytes:
    """Pack (row, col[, ts]) arrays into one frame payload."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    rectype = REC_BITS if ts is None else REC_BITS_TS
    recs = np.empty(rows.size, dtype=_DTYPES[rectype])
    recs["row"] = rows
    recs["col"] = cols
    if ts is not None:
        recs["ts"] = np.asarray(ts, dtype=np.int64)
    return bytes([rectype]) + recs.tobytes()


def pack_values(cols, values) -> bytes:
    """Pack (col, value) arrays into one REC_VALS frame payload."""
    cols = np.asarray(cols, dtype=np.int64)
    recs = np.empty(cols.size, dtype=_DTYPES[REC_VALS])
    recs["col"] = cols
    recs["value"] = np.asarray(values, dtype=np.int64)
    return bytes([REC_VALS]) + recs.tobytes()


def encode_frame(payload: bytes) -> bytes:
    """One framed payload (no magic — the stream carries it once)."""
    return FRAME.pack(len(payload), checksum(payload)) + payload


def encode_records(rows, cols, ts=None, values=None,
                   frame_records: int = 65536,
                   magic: bool = True) -> bytes:
    """Whole-stream convenience encoder (clients, tests, the bench):
    magic + records split into frames of at most ``frame_records``."""
    out = [MAGIC] if magic else []
    n = len(cols)
    for lo in range(0, max(n, 1), frame_records):
        hi = min(lo + frame_records, n)
        if hi <= lo:
            break
        if values is not None:
            payload = pack_values(cols[lo:hi], values[lo:hi])
        else:
            payload = pack_bits(rows[lo:hi], cols[lo:hi],
                                None if ts is None else ts[lo:hi])
        out.append(encode_frame(payload))
    return b"".join(out)


def decode_payload(payload: bytes) -> tuple[int, np.ndarray]:
    """(record type, structured record array) of one verified payload."""
    if not payload:
        raise FrameError("empty ingest frame")
    rectype = payload[0]
    dt = _DTYPES.get(rectype)
    if dt is None:
        raise FrameError(f"unknown ingest record type {rectype}")
    body = payload[1:]
    if len(body) % dt.itemsize:
        raise FrameError(
            f"ingest frame length {len(body)} is not a multiple of the "
            f"type-{rectype} record size {dt.itemsize}")
    return rectype, np.frombuffer(body, dtype=dt)


class FrameReader:
    """Incremental frame parser over a ``read(n)`` source (the HTTP
    request's rfile).  Reads AT MOST ``limit`` total bytes (the request's
    Content-Length) and never buffers more than one frame — the server
    must not materialise a multi-GB stream to parse it.

    ``next_frame()`` returns ``(rectype, records, frame_bytes)`` or
    ``None`` at the end of the stream; malformed input raises
    ``FrameError``."""

    def __init__(self, read, limit: int,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self._read = read
        self.remaining = limit
        self.max_frame_bytes = max_frame_bytes
        self._magic_read = False

    def _read_exact(self, n: int) -> bytes:
        if n > self.remaining:
            raise FrameError("ingest stream truncated (frame runs past "
                             "Content-Length)")
        chunks = []
        got = 0
        while got < n:
            chunk = self._read(min(n - got, 1 << 20))
            if not chunk:
                raise FrameError("ingest stream truncated (connection "
                                 "closed mid-frame)")
            chunks.append(chunk)
            got += len(chunk)
        self.remaining -= n
        return b"".join(chunks)

    def next_frame(self):
        if not self._magic_read:
            if self.remaining < len(MAGIC):
                raise FrameError("ingest stream shorter than its magic")
            if self._read_exact(len(MAGIC)) != MAGIC:
                raise FrameError(
                    f"bad ingest stream magic (expected {MAGIC!r})")
            self._magic_read = True
        if self.remaining == 0:
            return None
        if self.remaining < FRAME.size:
            raise FrameError("truncated ingest frame header")
        plen, crc = FRAME.unpack(self._read_exact(FRAME.size))
        if plen == 0 or plen > self.max_frame_bytes:
            raise FrameError(
                f"ingest frame of {plen} bytes outside (0, "
                f"{self.max_frame_bytes}] (ingest-max-frame-mb)")
        payload = self._read_exact(plen)
        if checksum(payload) != crc:
            raise FrameError("ingest frame CRC mismatch")
        rectype, recs = decode_payload(payload)
        return rectype, recs, FRAME.size + plen
