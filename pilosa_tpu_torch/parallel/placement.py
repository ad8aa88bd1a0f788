"""Shard placement: shard -> partition -> owner ring (cluster.go:871-959).

The same placement logic serves two layers:

* cluster level — shards to *nodes* (hosts), with ReplicaN successors on the
  ring, exactly like the reference;
* device level — a node's local shards to *TPU devices* in its mesh, where
  the "nodes" are device ordinals.

partition = FNV-1a(index, shard BE bytes) mod partition_n (cluster.go:871);
partition -> node via jump consistent hash (cluster.go:951 jmphasher), then
ReplicaN successors (cluster.go:902 partitionNodes).

Port copy of the JAX package's ``parallel/placement.py``.  The device
level does not arise on one GPU; the cluster level places shards on the
port's nodes exactly as the JAX package places them on its own.
"""

from __future__ import annotations

import struct

from ..core import DEFAULT_PARTITION_N

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & _MASK64
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash: key -> bucket in [0, n)
    (cluster.go:951-959 jmphasher.Hash)."""
    key &= _MASK64
    b, j = -1, 0
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * ((1 << 31) / ((key >> 33) + 1)))
    return b


class ModHasher:
    """Deterministic key%n hasher for tests (test/cluster.go:18 ModHasher)."""

    def hash(self, key: int, n: int) -> int:
        return key % n


class JmpHasher:
    def hash(self, key: int, n: int) -> int:
        return jump_hash(key, n)


class Placement:
    """Maps (index, shard) to an ordered owner list over a node list."""

    def __init__(self, nodes: list[str], replica_n: int = 1,
                 partition_n: int = DEFAULT_PARTITION_N, hasher=None):
        if not nodes:
            raise ValueError("placement requires at least one node")
        self.nodes = list(nodes)
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.hasher = hasher or JmpHasher()

    def partition(self, index: str, shard: int) -> int:
        """(cluster.go:871 partition)"""
        data = index.encode() + struct.pack(">Q", shard)
        return fnv1a64(data) % self.partition_n

    def partition_nodes(self, partition_id: int) -> list[str]:
        """(cluster.go:902 partitionNodes)"""
        n = len(self.nodes)
        replica_n = min(self.replica_n, n) or 1
        start = self.hasher.hash(partition_id, n)
        return [self.nodes[(start + i) % n] for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> list[str]:
        """Ordered owners (primary first) of a shard (cluster.go:883)."""
        return self.partition_nodes(self.partition(index, shard))

    def primary(self, index: str, shard: int) -> str:
        return self.shard_nodes(index, shard)[0]

    def owns_shard(self, node: str, index: str, shard: int) -> bool:
        """(cluster.go:895 ownsShard)"""
        return node in self.shard_nodes(index, shard)

    def owned_shards(self, node: str, index: str,
                     shards) -> list[int]:
        """Shards (incl. replicas) this node holds
        (cluster.go:927 containsShards)."""
        return [s for s in shards if self.owns_shard(node, index, s)]

    def shards_by_node(self, index: str, shards) -> dict[str, list[int]]:
        """Group shards by primary owner (executor.go:2435 shardsByNode)."""
        out: dict[str, list[int]] = {}
        for s in shards:
            out.setdefault(self.primary(index, s), []).append(s)
        return out
