"""Durable signature corpus: what this process compiles, persisted
(docs/warmup.md "Corpus format").

A restarted process can only warm what it remembers.  The compile
registry (utils/devobs.py) knows every program signature this process
traced — but its signatures are digests of process-local cache keys
(plan reprs, exec sequence numbers) and cannot be replayed after a
restart.  What CAN be replayed is the query text that produced them:
feeding the text back through the real executor rebuilds the same plans,
compiles the same programs (now against the persistent compile cache —
warmup/compile_cache.py), and repopulates the prepared-statement cache
as a side effect.

So the corpus records, per (index, template) — the template is the
prepared-cache fingerprint with literals slotted out, i.e. the params
schema: a sample query text, the last whole-query program signature it
launched, the registry's shape fingerprint + compile seconds for that
signature, a hit count, and a last-used wall stamp.  Storage is the
PR 6/9/15 frame discipline: a ``PTPUSIG1`` magic prefix then
length+CRC framed JSON records, one record per frame, torn tail
truncated at the last valid frame boundary on open.  Corruption beyond
the frame scan (bad JSON, wrong schema version, missing keys) drops the
RECORD, never the process: a warm start is an optimization, so every
read path here degrades to "fewer records" and ultimately to a cold
start — ``load`` never raises.

Compaction rewrites the log to the top-N records by traffic via the
atomic tmp+fsync+rename pattern (storage WAL checkpoint discipline), so
the log stays bounded no matter how long the process serves.

Port copy of the JAX package's ``warmup/corpus.py``.  The ``PTPUSIG1``
framing and the record schema are the JAX package's byte for byte, so a
corpus written by a JAX server warms a port server and the reverse.  On
the port the ``sig`` of a record is the whole-query program signature
of its last launch and ``fp`` / ``compileS`` come from the capture
registry (utils/devobs.py): a capture stands where a compile stands.
The persistent compile cache the JAX text names has no counterpart
(warmup/__init__.py).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time

from ..utils.durable import checksum
from ..utils.locks import make_lock

CORPUS_MAGIC = b"PTPUSIG1"
_FRAME_HDR = struct.Struct("<II")  # payload length, crc32(payload)

# Bump when the record shape changes incompatibly; loaders drop records
# whose "v" doesn't match (stale-schema corpus degrades to cold start).
SCHEMA_VERSION = 1


def _wall_stamp() -> float: return time.time()  # display-only wall clock


def _frame(payload: bytes) -> bytes:
    # header + payload in ONE write (the WAL frame discipline): a torn
    # write truncates at a frame boundary, never interleaves
    return _FRAME_HDR.pack(len(payload), checksum(payload)) + payload


def _scan_valid(data: bytes) -> int:
    """Byte offset of the end of the valid frame prefix (magic
    included); len(magic) when the magic itself is wrong."""
    if not data.startswith(CORPUS_MAGIC):
        return len(CORPUS_MAGIC)
    pos = len(CORPUS_MAGIC)
    while pos + _FRAME_HDR.size <= len(data):
        ln, crc = _FRAME_HDR.unpack_from(data, pos)
        end = pos + _FRAME_HDR.size + ln
        if end > len(data) or checksum(data[pos + _FRAME_HDR.size:
                                            end]) != crc:
            break
        pos = end
    return pos


class SignatureCorpus:
    """Framed on-disk signature log, append + atomic compaction.

    Mirrors EventJournal's log handling (utils/events.py): open
    truncates the torn tail, appends are flushed per batch but not
    fsynced (the corpus is telemetry-grade — losing the last few
    seconds of hit counts costs nothing), compaction IS fsynced because
    it replaces the whole file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = make_lock("warmup-corpus")
        self._fh = None
        self.frames_appended = 0
        self.write_errors = 0

    # -- lifecycle ---------------------------------------------------------

    def open(self):
        """Open (or create) the log, truncating any torn tail.  A
        garbage prefix (wrong magic) rewrites the file empty — better an
        empty corpus than a refused warm start.  Never raises."""
        try:
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    data = f.read()
                valid_end = _scan_valid(data)
                fh = open(self.path, "r+b")
                if not data.startswith(CORPUS_MAGIC):
                    fh.truncate(0)
                    fh.write(CORPUS_MAGIC)
                else:
                    fh.truncate(valid_end)
                    fh.seek(valid_end)
            else:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                fh = open(self.path, "w+b")
                fh.write(CORPUS_MAGIC)
            fh.flush()
        except OSError:
            # a read-only data dir costs durability, never the caller
            self.write_errors += 1
            return
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
            self._fh = fh

    def close(self):
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    # -- writes ------------------------------------------------------------

    def append(self, records: list[dict]):
        """Append one frame per record; flush once.  Never raises."""
        if not records:
            return
        with self._lock:
            fh = self._fh
            if fh is None:
                return
            try:
                buf = b"".join(
                    _frame(json.dumps(r).encode()) for r in records)
                fh.write(buf)
                fh.flush()
                self.frames_appended += len(records)
            except (OSError, ValueError, TypeError):
                self.write_errors += 1

    def compact(self, records: list[dict]):
        """Atomically rewrite the log to exactly ``records``:
        tmp + fsync + rename so a crash mid-compaction leaves either
        the old log or the new one, never a hybrid.  Never raises."""
        tmp = self.path + ".compact"
        try:
            with open(tmp, "wb") as f:
                f.write(CORPUS_MAGIC)
                for r in records:
                    f.write(_frame(json.dumps(r).encode()))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except (OSError, ValueError, TypeError):
            self.write_errors += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        # swap the append handle onto the new file
        self.open()
        with self._lock:
            self.frames_appended = len(records)

    # -- reads -------------------------------------------------------------

    @staticmethod
    def read(path: str) -> list[dict]:
        """Raw records in the valid frame prefix, append order.  Stops
        at the first bad frame; a CRC-valid frame holding non-JSON (a
        writer bug, not corruption) is skipped.  Never raises."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return []
        out: list[dict] = []
        if not data.startswith(CORPUS_MAGIC):
            return out
        pos = len(CORPUS_MAGIC)
        while pos + _FRAME_HDR.size <= len(data):
            ln, crc = _FRAME_HDR.unpack_from(data, pos)
            end = pos + _FRAME_HDR.size + ln
            payload = data[pos + _FRAME_HDR.size: end]
            if end > len(data) or checksum(payload) != crc:
                break
            try:
                rec = json.loads(payload)
                if isinstance(rec, dict):
                    out.append(rec)
            except ValueError:
                pass
            pos = end
        return out

    @staticmethod
    def load(path: str) -> dict[tuple, dict]:
        """Folded view keyed by (index, template): the latest record per
        key wins (each frame is a full snapshot, not a delta).  Records
        with a mismatched schema version or missing required keys are
        dropped — a stale-schema corpus is a cold start, not a crash."""
        folded: dict[tuple, dict] = {}
        for rec in SignatureCorpus.read(path):
            try:
                if rec.get("v") != SCHEMA_VERSION:
                    continue
                index, template = rec["index"], rec["template"]
                query, hits = rec["query"], int(rec["hits"])
                if not (isinstance(index, str) and isinstance(template, str)
                        and isinstance(query, str)):
                    continue
            except (KeyError, TypeError, ValueError):
                continue
            folded[(index, template)] = rec
        return folded


def top_n(records, n: int) -> list[dict]:
    """The n records with the most traffic (hits, then recency) — the
    warmup replay order and the compaction survivor set."""
    ranked = sorted(records, key=lambda r: (int(r.get("hits", 0)),
                                            float(r.get("lastUsed", 0.0))),
                    reverse=True)
    return ranked[:max(int(n), 0)]


class CorpusRecorder:
    """In-memory (index, template) -> record accumulator fed by the
    executor's success paths, flushed to a SignatureCorpus periodically.

    The executor calls ``note_sig`` where a whole-query launch knows its
    program signature (staged on a thread-local — request execution is
    synchronous on the calling thread) and ``note`` at its success
    return sites.  ``flush`` joins the staged records against the
    compile registry's per-signature entries for the shape fingerprint
    and compile seconds, appends the dirty ones, and compacts when the
    log outgrows its survivor set."""

    # compact when the on-disk log holds this many times the survivor
    # set — bounds the log without compacting on every flush
    COMPACT_FACTOR = 8

    def __init__(self, keep_n: int = 128):
        self.keep_n = max(int(keep_n), 1)
        self._lock = make_lock("warmup-recorder")
        self._local = threading.local()
        self._records: dict[tuple, dict] = {}
        self._dirty: set = set()
        self.noted = 0

    # -- executor-facing hooks (hot path: one dict update) -----------------

    def note_sig(self, sig: str | None):
        self._local.sig = sig

    def note(self, index: str, qtext: str):
        """Fold one successfully served read-only string query.  Never
        raises — recording must not fail the query that fed it."""
        sig = getattr(self._local, "sig", None)
        self._local.sig = None
        try:
            from ..executor.prepared import fingerprint
            template, _ = fingerprint(qtext)
        # lint: allow(swallowed-exception) — a fingerprint failure on an
        # exotic query costs one corpus record, never the query itself
        except Exception:
            return
        key = (index, template)
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                rec = {"v": SCHEMA_VERSION, "index": index,
                       "template": template, "query": qtext, "sig": "",
                       "fp": "", "hits": 0, "lastUsed": 0.0,
                       "compileS": 0.0}
                self._records[key] = rec
            rec["hits"] = int(rec["hits"]) + 1
            rec["lastUsed"] = round(_wall_stamp(), 3)
            rec["query"] = qtext
            if sig:
                rec["sig"] = sig
            self._dirty.add(key)
            self.noted += 1

    # -- lifecycle ---------------------------------------------------------

    def seed(self, folded: dict[tuple, dict]):
        """Carry hit counts across restarts: the loaded corpus becomes
        the starting state, so compaction ranks long-run traffic, not
        just this process's uptime."""
        with self._lock:
            for key, rec in folded.items():
                self._records.setdefault(key, dict(rec))

    def flush(self, corpus: SignatureCorpus):
        """Enrich dirty records from the compile registry, append them,
        compact if the log has outgrown its bound.  Never raises."""
        from ..utils.devobs import COMPILES
        with self._lock:
            dirty = [dict(self._records[k]) for k in self._dirty
                     if k in self._records]
            self._dirty.clear()
        if dirty:
            by_sig = {e["sig"]: e
                      for e in COMPILES.snapshot().get("entries", [])}
            for rec in dirty:
                e = by_sig.get(rec.get("sig"))
                if e is not None:
                    rec["fp"] = e.get("lastFingerprint", "")
                    rec["compileS"] = round(
                        float(e.get("totalCompileS", 0.0)), 4)
                with self._lock:
                    live = self._records.get((rec["index"],
                                              rec["template"]))
                    if live is not None:
                        live["fp"] = rec.get("fp", "")
                        live["compileS"] = rec.get("compileS", 0.0)
            corpus.append(dirty)
        if corpus.frames_appended > self.keep_n * self.COMPACT_FACTOR:
            with self._lock:
                records = [dict(r) for r in self._records.values()]
            corpus.compact(top_n(records, self.keep_n))

    def snapshot(self) -> dict:
        with self._lock:
            return {"templates": len(self._records), "noted": self.noted,
                    "dirty": len(self._dirty)}
