"""Crash-durable file replacement.

``buffering=0`` / plain writes land in the page cache; ``os.replace``
orders the rename but not the data, so a crash shortly after an
acknowledged snapshot could surface an empty or stale file.  The durable
sequence is: flush+fsync the temp file, rename, then fsync the DIRECTORY
so the rename itself is on stable storage (the same discipline the
reference gets from bolt/roaring file syncs).

Port copy of the JAX package's ``utils/durable.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import os
import zlib


def checksum(data, crc: int = 0) -> int:
    """File-format checksum for snapshots and WAL frames
    (docs/robustness.md "Durability & recovery").

    zlib's CRC-32 (IEEE polynomial): the only C-speed CRC in the
    stdlib — a pure-Python CRC32C (Castagnoli) table loop would cap
    snapshot verification at a few MB/s, and the container bakes in no
    crc32c package.  Detection power is equivalent for the corruptions
    this layer guards against (torn writes, bit rot, truncation).
    Chainable: ``checksum(b, checksum(a))`` == ``checksum(a + b)``.
    Accepts any buffer (bytes, memoryview, numpy array data)."""
    return zlib.crc32(data, crc) & 0xFFFFFFFF


def fsync_file(f):
    """Flush a writable file object's data to stable storage."""
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str):
    """fsync a directory so a completed rename within it is durable.
    Best-effort: platforms/filesystems that refuse O_RDONLY-dir fsync
    (some network mounts) degrade to the pre-fsync behavior."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_replace(tmp: str, path: str):
    """``os.replace(tmp, path)`` + directory fsync (the temp file must
    already be fsynced by the writer — see fsync_file)."""
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")
