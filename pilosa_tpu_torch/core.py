"""Core constants and position arithmetic for the TPU-native bitmap index.

The data model mirrors the reference engine exactly (see SURVEY.md §2 and the
reference's ``fragment.go:50-63``, ``shardwidth/20.go``): the column space of an
index is cut into fixed-width *shards* of ``2**20`` columns; a (field, view,
shard) triple is a *fragment*.  Inside a fragment a bit is addressed by
``pos = row_id * SHARD_WIDTH + (col % SHARD_WIDTH)``.

Where the reference stores a fragment as a 64-bit roaring bitmap (adaptive
array/bitmap/run containers, ``roaring/roaring.go:64-69``), this engine stores
it as a dense ``uint32[n_rows, SHARD_WORDS]`` bitset tensor: TPU VPUs operate
on 32-bit lanes natively and ``SHARD_WORDS = 32768 = 256*128`` keeps the minor
dimension a multiple of the 128-wide lane tiling so XLA never pads.
Container-level sparsity collapses to dense tiles in HBM — the round-trip and
branching cost of adaptive representations dwarfs the bandwidth saving on TPU.

Port copy of the JAX package's ``core.py``: the PyTorch port keeps its
own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import re

# Shard geometry — compile-time constant, like the reference's build-tag
# selected exponent (shardwidth/20.go: Exponent = 20).
SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP

# Bitset word geometry.  The reference uses []uint64; TPU vector units are
# 32-bit, so we use uint32 words.
WORD_BITS = 32
WORD_BITS_EXP = 5
SHARD_WORDS = SHARD_WIDTH // WORD_BITS  # 32768 = 256 * 128

# A roaring "container" covers 2^16 bits (roaring/roaring.go:64); we keep the
# same granularity for block-level bookkeeping (checksums, sparsity masks).
CONTAINER_BITS = 1 << 16
CONTAINER_WORDS = CONTAINER_BITS // WORD_BITS  # 2048
CONTAINERS_PER_SHARD = SHARD_WIDTH // CONTAINER_BITS  # 16

# Anti-entropy block size in rows (fragment.go:81 HashBlockSize = 100).
HASH_BLOCK_SIZE = 100

# Default number of ops buffered in the write-ahead log before a snapshot
# rewrite (fragment.go:84 DefaultFragmentMaxOpN = 10000).
DEFAULT_FRAGMENT_MAX_OP_N = 10000

# Highest row id a fragment will accept (configurable via
# Config.max_row_id / PILOSA_TPU_MAX_ROW_ID).  The dense representation
# allocates n_rows*SHARD_WORDS*4 bytes per fragment, so an unbounded row id
# from a hostile import (rowIDs=[2**40]) would attempt a terabyte-scale
# allocation; the reference is sparse in row space and has no such hazard
# (roaring row keys are just u48 container keys).  2^20 rows caps a single
# fragment's dense worst case at 128 GiB logical — combined with doubling
# growth and sparse snapshots, real indexes stay far below it; raise the
# cap explicitly for wider row spaces.
DEFAULT_MAX_ROW_ID = (1 << 20) - 1

# Reserved existence-field name (index.go: existenceFieldName "_exists").
EXISTENCE_FIELD_NAME = "_exists"

# View name constants (view.go:37-41).
VIEW_STANDARD = "standard"
VIEW_BSI_GROUP_PREFIX = "bsig_"

# Cluster-level partitioning (cluster.go:44 defaultPartitionN).
DEFAULT_PARTITION_N = 256


# Process-wide schema generation counter.  Bumped on any DDL (index/field
# create or delete) and on BSI bit-depth growth; the prepared-statement cache
# (executor/prepared.py) keys its entries to it so a resolved plan is never
# replayed against a changed schema.  Over-invalidation (one counter for all
# holders) only costs a re-prepare.
_schema_epoch = 0


def bump_schema_epoch():
    global _schema_epoch
    _schema_epoch += 1


def schema_epoch() -> int:
    return _schema_epoch


# Process-wide attribute generation counter.  Row/column attributes ride
# query results (Row attrs, Options(columnAttrs)) but live outside the
# fragment stores, so their writes bump no fragment gen; the result cache
# (cache/results.py) keys entries to this counter instead so an attr write
# invalidates structurally like any other mutation.
_attr_epoch = 0


def bump_attr_epoch():
    global _attr_epoch
    _attr_epoch += 1


def attr_epoch() -> int:
    return _attr_epoch


_NAME_RE = re.compile(r"[a-z][a-z0-9_-]*")


def validate_name(name: str, kind: str = "name") -> str:
    """Index/field name rule (reference pilosa.go validateName:
    ^[a-z][a-z0-9_-]*$, max 64 chars)."""
    if not _NAME_RE.fullmatch(name) or len(name) > 64:
        raise ValueError(f"invalid {kind}: {name!r}")
    return name


def pos(row_id: int, col: int) -> int:
    """Bit position of (row, column) inside the column's shard
    (fragment.go:3087-3092)."""
    return (row_id << SHARD_WIDTH_EXP) + (col & (SHARD_WIDTH - 1))


def shard_of(col: int) -> int:
    """Which shard a column id falls in."""
    return col >> SHARD_WIDTH_EXP


def col_in_shard(col: int) -> int:
    """Column offset within its shard."""
    return col & (SHARD_WIDTH - 1)
