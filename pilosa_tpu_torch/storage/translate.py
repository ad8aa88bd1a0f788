"""Key translation: string key <-> uint64 id stores (translate.go:35-70
TranslateStore interface, :195-381 in-memory implementation,
boltdb/translate.go:48-397 persistent store).

A store maps string keys to sequentially-allocated ids starting at 1.
``translate_key`` auto-creates missing keys — exactly like the reference's
``TranslateKey`` — so reads of unknown keys produce fresh (empty) ids
rather than errors.  Persistence is an append-only log of key records;
the id IS the record's ordinal, so replay rebuilds both directions.

Cluster note: the reference writes keys on the primary only and streams
the log to replicas (holder.go:812 holderTranslateStoreReplicator).  The
TPU-native cluster routes translation to the coordinator via
RemoteTranslateStore (parallel/cluster.py) with a read-through cache —
lazy replication over the same internal RPC plane.

Port copy of the JAX package's ``storage/translate.py``: the PyTorch
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import struct

from ..utils.locks import make_rlock

_REC = struct.Struct("<I")  # key byte-length; key bytes follow


class TranslateStore:
    """In-memory bidirectional map + append-only log file."""

    def __init__(self, path: str | None):
        self.path = path
        self._key_to_id: dict[str, int] = {}
        self._id_to_key: dict[int, str] = {}
        self._file = None
        self._lock = make_rlock("translate")
        if path is not None:
            self._open()

    def _open(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                buf = f.read()
            off = 0
            while off + _REC.size <= len(buf):
                (klen,) = _REC.unpack_from(buf, off)
                off += _REC.size
                if off + klen > len(buf):
                    break  # truncated tail record (partial write) — drop
                key = buf[off:off + klen].decode("utf-8", errors="replace")
                off += klen
                self._append_mem(key)
        self._file = open(self.path, "ab", buffering=0)

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def _append_mem(self, key: str) -> int:
        new_id = len(self._key_to_id) + 1
        self._key_to_id[key] = new_id
        self._id_to_key[new_id] = key
        return new_id

    def __len__(self) -> int:
        return len(self._key_to_id)

    # -- the TranslateStore interface (translate.go:35) --------------------

    def translate_key(self, key: str) -> int:
        """key -> id, creating if missing (translate.go TranslateKey)."""
        with self._lock:
            kid = self._key_to_id.get(key)
            if kid is not None:
                return kid
            kid = self._append_mem(key)
            if self._file is not None:
                data = key.encode()
                self._file.write(_REC.pack(len(data)) + data)
            return kid

    def translate_keys(self, keys) -> list[int]:
        return [self.translate_key(k) for k in keys]

    def translate_id(self, kid: int) -> str | None:
        """id -> key; None when unknown (translate.go TranslateID)."""
        with self._lock:
            return self._id_to_key.get(kid)

    def translate_ids(self, ids) -> list[str | None]:
        with self._lock:
            return [self._id_to_key.get(i) for i in ids]

    def find_key(self, key: str) -> int | None:
        """Lookup without create (used by replicas' read-through cache)."""
        with self._lock:
            return self._key_to_id.get(key)

    # -- replication support (translate.go:82 TranslateEntryReader) --------

    def entries_from(self, after_id: int,
                     limit: int | None = None) -> list[tuple[int, str]]:
        """Up to ``limit`` (id, key) pairs with id > after_id, in order —
        the replication/stream payload (paginated so one request neither
        holds the store lock for a full-table copy nor exceeds a response
        timeout)."""
        with self._lock:
            hi = len(self._id_to_key) + 1
            if limit is not None:
                hi = min(hi, after_id + 1 + limit)
            return [(i, self._id_to_key[i])
                    for i in range(after_id + 1, hi)]
