"""Durable event journal: the cluster's state-transition timeline
(docs/observability.md "Cluster plane").

Every consequential state transition the system makes — a breaker
opening, a node flipping DOWN, a fragment entering quarantine, an
overlay handoff, a resize epoch, a retrace, backpressure engaging —
already logs a line or bumps a counter somewhere, but counters have no
order and log lines have no structure: reconstructing "what happened to
the fleet between 14:02 and 14:05" meant grepping N nodes' stderr.
This module gives those transitions one ordered, structured, queryable
home:

* a bounded in-process ring (``event-journal-size`` entries) served at
  ``GET /debug/events?since=<seq>`` — the cursor form the fleet rollup
  (parallel/rollup.py) uses to merge per-node journals into one fleet
  timeline on ``/debug/cluster``;
* an optional on-disk log (``event-log = true``): length+CRC framed
  JSON records, one frame per event (the PR 6 WAL frame discipline) so
  a torn tail is detected and truncated at a frame boundary on reopen.
  Events are telemetry, not acked data — the log is flushed per event
  but not fsynced, and a corrupt tail truncates instead of quarantining.

Every event carries a monotonically increasing per-process ``seq`` (the
``since`` cursor), a display-only wall stamp, the emitting node's id,
and the event's structured fields.  Emission must never fail the caller:
file errors count ``writeErrors`` and drop the disk copy only.

The event-name namespace is cataloged in docs/observability.md (the
``events-catalog`` markers) under the same two-way analyzer lint as the
metrics catalog (``event-names`` rule): an uncataloged emit site and a
dangling catalog row are both findings.

Port copy of the JAX package's ``utils/events.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import struct
import time
from collections import deque

from .durable import checksum
from .locks import make_lock

EVENT_LOG_MAGIC = b"PTPUEVT1"
_FRAME_HDR = struct.Struct("<II")  # payload length, crc32(payload)


def _wall_stamp() -> float: return time.time()  # display-only wall clock


class EventJournal:
    """Bounded ring of structured state-transition events + optional
    framed on-disk log.  One leaf lock guards the ring, the sequence
    counter, and the file handle; emission sites are rare state
    transitions, never per-query hot paths."""

    def __init__(self, size: int = 512):
        self.size = max(int(size), 1)
        self._ring: deque = deque(maxlen=self.size)
        self._lock = make_lock("events")
        self.seq = 0
        self.emitted = 0
        self.write_errors = 0
        # stamped onto every event so merged fleet timelines keep
        # attribution; the Server sets it (standalone emitters stay
        # unattributed rather than guessing)
        self.node_id: str | None = None
        self._fh = None
        self._path: str | None = None

    def resize(self, size: int):
        """Apply event-journal-size (most recent Server's config wins,
        like the launch ledger); keeps the newest entries."""
        size = max(int(size), 1)
        with self._lock:
            if size != self.size:
                self._ring = deque(self._ring, maxlen=size)
                self.size = size

    # -- on-disk log -------------------------------------------------------

    def open_log(self, path: str):
        """Open (or create) the framed on-disk log, truncating any torn
        tail at the last valid frame boundary.  Unlike the fragment WAL,
        mid-log corruption also truncates: events are telemetry — better
        a shortened history than a refused journal."""
        valid_end = len(EVENT_LOG_MAGIC)
        try:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
                if not data.startswith(EVENT_LOG_MAGIC):
                    valid_end = len(EVENT_LOG_MAGIC)  # rewrite garbage
                else:
                    pos = len(EVENT_LOG_MAGIC)
                    while pos + _FRAME_HDR.size <= len(data):
                        ln, crc = _FRAME_HDR.unpack_from(data, pos)
                        end = pos + _FRAME_HDR.size + ln
                        if end > len(data) \
                                or checksum(data[pos + _FRAME_HDR.size:
                                                 end]) != crc:
                            break
                        pos = end
                    valid_end = pos
                fh = open(path, "r+b")
                fh.truncate(valid_end)
                fh.seek(valid_end)
                if valid_end == len(EVENT_LOG_MAGIC) \
                        and not data.startswith(EVENT_LOG_MAGIC):
                    fh.seek(0)
                    fh.truncate(0)
                    fh.write(EVENT_LOG_MAGIC)
            else:
                fh = open(path, "w+b")
                fh.write(EVENT_LOG_MAGIC)
            fh.flush()
        except OSError:
            # journaling is best-effort: a read-only data dir costs the
            # disk copy, never the ring or the emitting caller
            self.write_errors += 1
            return
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
            self._fh = fh
            self._path = path

    def close_log(self):
        with self._lock:
            fh, self._fh, self._path = self._fh, None, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    @staticmethod
    def read_log(path: str) -> list[dict]:
        """Decode a framed log's valid prefix (tests, offline forensic
        reads); stops at the first bad frame like open_log's truncation
        scan."""
        with open(path, "rb") as f:
            data = f.read()
        out: list[dict] = []
        if not data.startswith(EVENT_LOG_MAGIC):
            return out
        pos = len(EVENT_LOG_MAGIC)
        while pos + _FRAME_HDR.size <= len(data):
            ln, crc = _FRAME_HDR.unpack_from(data, pos)
            end = pos + _FRAME_HDR.size + ln
            payload = data[pos + _FRAME_HDR.size: end]
            if end > len(data) or checksum(payload) != crc:
                break
            out.append(json.loads(payload))
            pos = end
        return out

    # -- emission ----------------------------------------------------------

    def emit(self, name: str, **fields) -> dict:
        """Append one structured event; returns the stamped record.
        Never raises — a journal failure must not fail a breaker
        transition or a quarantine."""
        entry = {"event": name, "wall": round(_wall_stamp(), 3)}
        if self.node_id is not None:
            entry["node"] = self.node_id
        for k, v in fields.items():
            if v is not None:
                entry[k] = v
        with self._lock:
            self.seq += 1
            self.emitted += 1
            entry["seq"] = self.seq
            self._ring.append(entry)
            fh = self._fh
            if fh is not None:
                try:
                    payload = json.dumps(entry).encode()
                    # header + payload in ONE write (the group-commit
                    # frame discipline): a torn write truncates at a
                    # frame boundary, never interleaves
                    fh.write(_FRAME_HDR.pack(len(payload),
                                             checksum(payload)) + payload)
                    fh.flush()
                except (OSError, ValueError):
                    self.write_errors += 1
        return entry

    # -- queries -----------------------------------------------------------

    def since(self, seq: int, limit: int | None = None) -> list[dict]:
        """Events with seq > ``seq``, oldest first — the /debug/events
        cursor contract (a restarted reader passes 0 and gets whatever
        the ring still holds).  ``limit`` keeps the OLDEST entries: a
        cursor-advancing reader (the fleet rollup) resumes losslessly
        from the last seq it folded, instead of skipping the burst's
        middle forever."""
        with self._lock:
            out = [e for e in self._ring if e["seq"] > seq]
        if limit is not None and len(out) > limit:
            out = out[:max(limit, 0)]
        return out

    def last_seq(self) -> int:
        with self._lock:
            return self.seq

    def snapshot(self) -> dict:
        """GET /debug/events: config + counters + the ring, oldest
        first."""
        with self._lock:
            return {"size": self.size, "emitted": self.emitted,
                    "seq": self.seq, "writeErrors": self.write_errors,
                    "logPath": self._path,
                    "events": list(self._ring)}


# Process-wide singleton like FAULTS/COMPILES/LEDGER: one journal per
# process, resized/attached by the most recent Server's config.
EVENTS = EventJournal()


def emit(name: str, **fields) -> dict:
    """Module-level emission front door — ``events.emit("breaker.open",
    host=...)``.  The ``event-names`` analyzer rule collects these
    literals against the docs catalog."""
    return EVENTS.emit(name, **fields)
