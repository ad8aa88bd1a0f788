"""Binary /internal/query wire: CRC-framed roaring query transport.

The cluster fan-out's JSON envelope zlib+base64-encodes every row
segment as a FULL dense 2^20-bit bitmap string (128 KiB of words per
shard before the 4/3 base64 blowup) and round-trips every result through
``json.dumps``/``loads`` — at fan-out rates the envelope IS the hop
(the reference ships protobuf, encoding/proto/proto.go).  This
module speaks a length-prefixed CRC-framed binary stream instead, built
from the same two primitives as the ingest wire (ingest/wire.py) and the
framed WAL: an 8-byte magic, then frames of

    <u32 payload_len, u32 payload_crc> payload

where ``payload_crc`` is ``utils.durable.checksum`` (zlib crc32) over
the payload.  The first payload byte is the record type; records that
carry packed arrays follow it with an explicit endianness tag byte
(``ENDIAN_LE``) so a future big-endian or u64-word peer is rejected
loudly instead of silently mis-merging (the old JSON segment codec left
byte order implicit in ``tobytes()``).

Word order (the frame spec the endianness tag guards): segments travel
as ``SHARD_WORDS`` uint32 words, little-endian bytes within each word,
word ``i`` covering bits ``[32*i, 32*(i+1))`` of the shard span with the
lowest bit in the word's least-significant position — exactly the dense
layout of ``ops/bitset.py`` (uint32 words carrying the reference's u64
semantics two words at a time).

Request stream (client -> server): magic, then exactly two frames —
``REC_CALLS`` (endian tag + the JSON call batch, the ``pql.wire`` call
dicts verbatim: the AST is pointer-shaped and tiny, the win is in the
results) and ``REC_SHARDS`` (endian tag + the pinned shard list as a
packed ``<i8`` array).

Response stream (server -> client): magic, one typed frame per result,
then exactly one ``REC_TRAILER`` frame — the compact-JSON piggybacks
(execS, gens, quarantined, load, spans) the routing/result-cache/tracing
folds already consume, doubled as the end-of-stream marker so truncation
at a frame boundary is detected by its absence.  Result records:

    REC_JSONRES   the JSON ``result_to_wire`` dict (groups, raw values,
                  and any shape the typed encoders decline)
    REC_ROW       row segments, each roaring-packed through the existing
                  ``ops/containers.pack_words`` codec (wire bytes scale
                  with cardinality) with a raw-dense-words fallback per
                  segment, whichever is smaller
    REC_VALCOUNT  one packed (val, count) scalar pair
    REC_ROWIDS    row ids as one packed ``<i8`` array (+ JSON keys)
    REC_PAIRS     TopN pairs as packed ``<i8`` id and count arrays
                  (+ JSON keys) — no per-element Python on either side

Malformed input raises ``FrameError`` (bad magic, CRC mismatch, bad
record type, bad endian tag, truncated or oversized frame); the server
answers 400 and the client falls back to the JSON wire.  Negotiation and
fallback semantics live in ``parallel/cluster.py`` (InternalClient) and
docs/cluster.md "Internal query wire".

Port copy of the JAX package's ``parallel/qwire.py``.  Row segments
reach it as host numpy ``uint32`` words (the stacked executor fetches
and views device words before a ``RowResult`` is built), and it packs
them with the port's ``ops/containers.pack_words``, so its frames are
byte-identical to the JAX package's for the same results
(tests/test_torch_qwire.py).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..core import SHARD_WORDS
from ..executor.results import Pair, RowIdentifiers, RowResult, ValCount
from ..ops import containers
from ..utils.durable import checksum

MAGIC = b"PTPUQRY1"
FRAME = struct.Struct("<II")

# wire-mode names (the /status capability advertisement + the
# internal-wire knob vocabulary)
WIRE_JSON = "json"
WIRE_BIN1 = "bin1"

# Content type of a PTPUQRY1 request/response body.  An old peer answers
# a POST of this type 400 ("invalid JSON body"); a new peer with
# internal-wire=json answers 415 — either way the client downgrades.
CONTENT_TYPE = "application/x-ptpu-query"

# Explicit byte-order tag (see module docstring for the word order it
# guards).  The only defined value today; a decoder seeing anything else
# must reject the stream rather than byte-swap-guess.
ENDIAN_LE = 0

# result record types (first payload byte)
REC_JSONRES = 0
REC_ROW = 1
REC_VALCOUNT = 2
REC_ROWIDS = 3
REC_PAIRS = 4
REC_TRAILER = 9
# request record types
REC_CALLS = 16
REC_SHARDS = 17

# per-segment encodings inside a REC_ROW record
SEG_RAW = 0      # SHARD_WORDS uint32 dense words verbatim
SEG_PACKED = 1   # ops/containers Packed stream (keys/types/counts/
#                  offsets int32 tables + uint32 payload words)

# Frame ceiling: a response frame carries ONE result, which for a row
# over a large pinned shard group is bounded by group size x 128 KiB
# dense; 256 MiB is far above any real group and still bounds a
# corrupted length field.
MAX_FRAME_BYTES = 256 << 20

_SEG_HEAD = struct.Struct("<QBI")   # shard id, encoding, byte length
_PACKED_HEAD = struct.Struct("<II")  # container count, payload words
_VALCOUNT = struct.Struct("<qq")
_U32 = struct.Struct("<I")

_RAW_SEG_BYTES = SHARD_WORDS * 4


class FrameError(ValueError):
    """Malformed query wire stream (bad magic, CRC mismatch, bad record
    type or endian tag, oversized or truncated frame).  The server
    answers 400; the client counts ``cluster.wire_fallback`` and retries
    the idempotent read over the JSON wire."""


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def encode_frame(payload: bytes) -> bytes:
    """One framed payload (no magic — the stream carries it once)."""
    return FRAME.pack(len(payload), checksum(payload)) + payload


def iter_frames(data: bytes):
    """Yield each verified frame payload of one complete stream.

    The whole body is already in memory (the HTTP client/handler read
    it), so this is a zero-copy walk over memoryview slices; any
    malformed byte raises FrameError."""
    if len(data) < len(MAGIC):
        raise FrameError("query wire stream shorter than its magic")
    view = memoryview(data)
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise FrameError(f"bad query wire magic (expected {MAGIC!r})")
    off = len(MAGIC)
    n = len(data)
    while off < n:
        if n - off < FRAME.size:
            raise FrameError("truncated query wire frame header")
        plen, crc = FRAME.unpack_from(data, off)
        off += FRAME.size
        if plen == 0 or plen > MAX_FRAME_BYTES:
            raise FrameError(
                f"query wire frame of {plen} bytes outside (0, "
                f"{MAX_FRAME_BYTES}]")
        if n - off < plen:
            raise FrameError("truncated query wire frame")
        payload = view[off: off + plen]
        if checksum(payload) != crc:
            raise FrameError("query wire frame CRC mismatch")
        off += plen
        yield payload


def _check_endian(payload, what: str):
    if len(payload) < 2:
        raise FrameError(f"{what} record shorter than its header")
    if payload[1] != ENDIAN_LE:
        raise FrameError(
            f"{what} record byte order {payload[1]} is not little-endian "
            f"({ENDIAN_LE}); refusing to byte-swap-guess")


# -- segments ---------------------------------------------------------------

def encode_segment(seg) -> tuple[int, bytes]:
    """(encoding, blob) for one dense segment: the roaring Packed stream
    when it is smaller than the raw words, the raw words otherwise (a
    dense-majority segment never pays container overhead).  The cheap
    index-count bound skips packing entirely when it cannot win."""
    words = np.ascontiguousarray(np.asarray(seg, dtype="<u4"))
    if words.size != SHARD_WORDS:
        raise ValueError(f"bad segment size {words.size}")
    idx = np.flatnonzero(words)
    # estimate_packed_bytes is an upper bound that ignores run
    # containers, so on its own it would skip packing exactly the
    # clustered data runs exist for (Store'd full rows compress to a
    # few runs per container); a low word-level transition count is the
    # cheap tell that runs will win even when the array/bitmap bound
    # says dense.
    run_friendly = idx.size > 0 and \
        int(np.count_nonzero(np.diff(words.astype(np.int64)))) \
        < SHARD_WORDS // 64
    if run_friendly or containers.estimate_packed_bytes(idx) \
            + _PACKED_HEAD.size < _RAW_SEG_BYTES:
        p = containers.pack_words(idx.astype(np.int64), words[idx])
        blob = b"".join((
            _PACKED_HEAD.pack(p.keys.size, p.payload.size),
            p.keys.astype("<i4", copy=False).tobytes(),
            p.types.astype("<i4", copy=False).tobytes(),
            p.counts.astype("<i4", copy=False).tobytes(),
            p.offsets.astype("<i4", copy=False).tobytes(),
            p.payload.astype("<u4", copy=False).tobytes(),
        ))
        if len(blob) < _RAW_SEG_BYTES:
            return SEG_PACKED, blob
    return SEG_RAW, words.tobytes()


def decode_segment(enc: int, blob) -> np.ndarray:
    """Dense uint32[SHARD_WORDS] words of one segment blob."""
    if enc == SEG_RAW:
        if len(blob) != _RAW_SEG_BYTES:
            raise FrameError(f"bad raw segment size {len(blob)}")
        return np.frombuffer(blob, dtype="<u4")
    if enc != SEG_PACKED:
        raise FrameError(f"unknown segment encoding {enc}")
    if len(blob) < _PACKED_HEAD.size:
        raise FrameError("packed segment shorter than its header")
    c, pw = _PACKED_HEAD.unpack_from(blob, 0)
    want = _PACKED_HEAD.size + 16 * c + 4 * pw
    if len(blob) != want:
        raise FrameError(
            f"packed segment length {len(blob)} != expected {want}")
    off = _PACKED_HEAD.size
    tables = []
    for _ in range(4):
        tables.append(np.frombuffer(blob, dtype="<i4", count=c,
                                    offset=off))
        off += 4 * c
    keys, types, counts, offsets = tables
    payload = np.frombuffer(blob, dtype="<u4", count=pw, offset=off)
    if c and (int(keys.min()) < 0
              or int(keys.max()) >= SHARD_WORDS // containers.CONTAINER_WORDS):
        raise FrameError("packed segment container key out of range")
    p = containers.Packed(keys, types, counts, offsets, payload,
                          a_max=0, r_max=0)
    try:
        return containers.unpack_packed(p, 1, SHARD_WORDS)[0]
    except (IndexError, ValueError) as e:
        # CRC-clean but inconsistent tables (an encoder bug, not line
        # noise) must still reject, never mis-merge
        raise FrameError(f"packed segment tables inconsistent: {e}")


# -- results ----------------------------------------------------------------

def _enc_row(r: RowResult) -> bytes:
    parts = [bytes((REC_ROW, ENDIAN_LE)), _U32.pack(len(r.segments))]
    for shard in sorted(r.segments):
        enc, blob = encode_segment(r.segments[shard])
        parts.append(_SEG_HEAD.pack(int(shard), enc, len(blob)))
        parts.append(blob)
    attrs = _dumps(r.attrs) if r.attrs else b""
    parts.append(_U32.pack(len(attrs)))
    parts.append(attrs)
    return b"".join(parts)


def _dec_row(payload) -> RowResult:
    _check_endian(payload, "row")
    off = 2
    if len(payload) < off + 4:
        raise FrameError("row record truncated")
    (nsegs,) = _U32.unpack_from(payload, off)
    off += 4
    segments = {}
    for _ in range(nsegs):
        if len(payload) < off + _SEG_HEAD.size:
            raise FrameError("row segment header truncated")
        shard, enc, nbytes = _SEG_HEAD.unpack_from(payload, off)
        off += _SEG_HEAD.size
        if len(payload) < off + nbytes:
            raise FrameError("row segment truncated")
        segments[int(shard)] = decode_segment(
            enc, payload[off: off + nbytes])
        off += nbytes
    if len(payload) < off + 4:
        raise FrameError("row attrs header truncated")
    (alen,) = _U32.unpack_from(payload, off)
    off += 4
    if len(payload) != off + alen:
        raise FrameError("row record length mismatch")
    attrs = json.loads(bytes(payload[off:])) if alen else None
    return RowResult(segments, attrs=attrs)


def _enc_valcount(r: ValCount) -> bytes | None:
    if not isinstance(r.count, (int, np.integer)):
        return None
    flags = 0
    val = 0
    if r.val is not None:
        if isinstance(r.val, (bool, np.bool_)) \
                or not isinstance(r.val, (int, float, np.integer,
                                          np.floating)):
            return None
        flags |= 1
        if isinstance(r.val, (float, np.floating)):
            flags |= 2
            val = struct.unpack("<q", struct.pack("<d", float(r.val)))[0]
        else:
            val = int(r.val)
    return bytes((REC_VALCOUNT, ENDIAN_LE, flags)) \
        + _VALCOUNT.pack(val, int(r.count))


def _dec_valcount(payload) -> ValCount:
    _check_endian(payload, "valcount")
    if len(payload) != 3 + _VALCOUNT.size:
        raise FrameError("valcount record length mismatch")
    flags = payload[2]
    raw, count = _VALCOUNT.unpack_from(payload, 3)
    val = None
    if flags & 1:
        val = struct.unpack("<d", struct.pack("<q", raw))[0] \
            if flags & 2 else raw
    return ValCount(val, count)


def _enc_rowids(r: RowIdentifiers) -> bytes | None:
    try:
        rows = np.asarray(list(r.rows), dtype="<i8")
    except (TypeError, ValueError, OverflowError):
        return None
    keys = _dumps(list(r.keys)) if r.keys else b""
    return bytes((REC_ROWIDS, ENDIAN_LE)) + _U32.pack(rows.size) \
        + rows.tobytes() + keys


def _dec_rowids(payload) -> RowIdentifiers:
    _check_endian(payload, "rowids")
    if len(payload) < 6:
        raise FrameError("rowids record truncated")
    (n,) = _U32.unpack_from(payload, 2)
    off = 6
    if len(payload) < off + 8 * n:
        raise FrameError("rowids record truncated")
    rows = np.frombuffer(payload, dtype="<i8", count=n,
                         offset=off).tolist()
    rest = bytes(payload[off + 8 * n:])
    keys = json.loads(rest) if rest else []
    return RowIdentifiers(rows=rows, keys=keys)


def _enc_pairs(r: list) -> bytes | None:
    try:
        ids = np.asarray([p.id for p in r], dtype="<i8")
        counts = np.asarray([p.count for p in r], dtype="<i8")
    except (TypeError, ValueError, OverflowError):
        return None  # keyed pairs with no numeric id ride the JSON record
    keys = [p.key for p in r]
    has_keys = any(keys)  # Pair.key defaults to "" (falsy), not None
    blob = _dumps(keys) if has_keys else b""
    return bytes((REC_PAIRS, ENDIAN_LE, 1 if has_keys else 0)) \
        + _U32.pack(ids.size) + ids.tobytes() + counts.tobytes() + blob


def _dec_pairs(payload) -> list:
    _check_endian(payload, "pairs")
    if len(payload) < 7:
        raise FrameError("pairs record truncated")
    has_keys = payload[2]
    (n,) = _U32.unpack_from(payload, 3)
    off = 7
    if len(payload) < off + 16 * n:
        raise FrameError("pairs record truncated")
    ids = np.frombuffer(payload, dtype="<i8", count=n, offset=off).tolist()
    off += 8 * n
    counts = np.frombuffer(payload, dtype="<i8", count=n,
                           offset=off).tolist()
    off += 8 * n
    if has_keys:
        keys = json.loads(bytes(payload[off:]))
        if len(keys) != n:
            raise FrameError("pairs key list length mismatch")
    else:
        if len(payload) != off:
            raise FrameError("pairs record length mismatch")
        keys = [""] * n  # Pair.key default — matches the JSON wire
    return [Pair(i, c, k) for i, c, k in zip(ids, counts, keys)]


def encode_result(r) -> bytes:
    """One result record payload.  Typed encoders cover the hot shapes;
    anything they decline (GroupCounts, raw values, surprise shapes)
    rides REC_JSONRES carrying the exact JSON-wire dict, so the two
    wires can never disagree on what a result means."""
    payload = None
    if isinstance(r, RowResult):
        payload = _enc_row(r)
    elif isinstance(r, ValCount):
        payload = _enc_valcount(r)
    elif isinstance(r, RowIdentifiers):
        payload = _enc_rowids(r)
    elif isinstance(r, list) and r and isinstance(r[0], Pair):
        payload = _enc_pairs(r)
    if payload is None:
        # deferred import: cluster.py owns the JSON result codec and
        # imports this module at its top — the cycle resolves at call
        # time, long after both modules are loaded
        from .cluster import result_to_wire
        payload = bytes((REC_JSONRES,)) + _dumps(result_to_wire(r))
    return payload


def decode_result(payload):
    if not payload:
        raise FrameError("empty query wire frame")
    rectype = payload[0]
    if rectype == REC_ROW:
        return _dec_row(payload)
    if rectype == REC_VALCOUNT:
        return _dec_valcount(payload)
    if rectype == REC_ROWIDS:
        return _dec_rowids(payload)
    if rectype == REC_PAIRS:
        return _dec_pairs(payload)
    if rectype == REC_JSONRES:
        from .cluster import result_from_wire
        try:
            return result_from_wire(json.loads(bytes(payload[1:])))
        except (ValueError, KeyError, TypeError) as e:
            raise FrameError(f"bad JSON result record: {e}")
    raise FrameError(f"unknown query wire record type {rectype}")


# -- request/response streams -----------------------------------------------

def encode_request(calls_wire: list[dict], shards) -> bytes:
    """Magic + REC_CALLS frame (JSON call batch) + REC_SHARDS frame
    (packed <i8 shard list; flag 0 = unpinned/None)."""
    head = bytes((REC_CALLS, ENDIAN_LE)) + _dumps(calls_wire)
    if shards is None:
        sh = bytes((REC_SHARDS, ENDIAN_LE, 0))
    else:
        arr = np.asarray([int(s) for s in shards], dtype="<i8")
        sh = bytes((REC_SHARDS, ENDIAN_LE, 1)) + _U32.pack(arr.size) \
            + arr.tobytes()
    return MAGIC + encode_frame(head) + encode_frame(sh)


def decode_request(data: bytes) -> tuple[list[dict], list[int] | None, int]:
    """(call batch dicts, pinned shards or None, frame count)."""
    frames = list(iter_frames(data))
    if len(frames) != 2:
        raise FrameError(
            f"query wire request has {len(frames)} frames, expected 2")
    head, sh = frames
    if head[0] != REC_CALLS:
        raise FrameError(f"first request frame is type {head[0]}, "
                         f"expected calls ({REC_CALLS})")
    _check_endian(head, "calls")
    try:
        calls_wire = json.loads(bytes(head[2:]))
    except ValueError as e:
        raise FrameError(f"bad call batch JSON: {e}")
    if not isinstance(calls_wire, list):
        raise FrameError("call batch is not a list")
    if sh[0] != REC_SHARDS:
        raise FrameError(f"second request frame is type {sh[0]}, "
                         f"expected shards ({REC_SHARDS})")
    _check_endian(sh, "shards")
    if len(sh) < 3:
        raise FrameError("shards record truncated")
    if sh[2] == 0:
        if len(sh) != 3:
            raise FrameError("shards record length mismatch")
        return calls_wire, None, len(frames)
    if len(sh) < 7:
        raise FrameError("shards record truncated")
    (n,) = _U32.unpack_from(sh, 3)
    if len(sh) != 7 + 8 * n:
        raise FrameError("shards record length mismatch")
    shards = np.frombuffer(sh, dtype="<i8", count=n, offset=7).tolist()
    return calls_wire, shards, len(frames)


def encode_response(results: list, trailer: dict) -> tuple[bytes, int]:
    """(body, frame count): magic + one frame per result + the trailer
    frame (compact-JSON piggybacks, REQUIRED last — it doubles as the
    end-of-stream marker)."""
    frames = [encode_frame(encode_result(r)) for r in results]
    frames.append(encode_frame(bytes((REC_TRAILER,)) + _dumps(trailer)))
    return MAGIC + b"".join(frames), len(frames)


def decode_response(data: bytes) -> tuple[list, dict, int]:
    """(results, trailer piggybacks, frame count)."""
    results = []
    trailer = None
    nframes = 0
    for payload in iter_frames(data):
        nframes += 1
        if trailer is not None:
            raise FrameError("frame after the response trailer")
        if payload[0] == REC_TRAILER:
            try:
                trailer = json.loads(bytes(payload[1:]))
            except ValueError as e:
                raise FrameError(f"bad response trailer JSON: {e}")
            if not isinstance(trailer, dict):
                raise FrameError("response trailer is not an object")
            continue
        results.append(decode_result(payload))
    if trailer is None:
        raise FrameError(
            "query wire response truncated (no trailer frame)")
    return results, trailer, nframes
