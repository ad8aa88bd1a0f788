"""Blocks of generated facts and the seeds they are drawn from.

A table of ``facts`` columns fills ``ceil(facts / 2^20)`` shards; a
generator draws it in blocks of ``block_shards`` consecutive shards, each
block from its own ``torch.Generator`` seeded from the run's ``--seed``
and the block's first shard, so any block can be drawn again alone (the
reference does, after the window) and every seed gives the same sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SHARD_WIDTH = 1 << 20
_MASK64 = (1 << 64) - 1


@dataclass
class Block:
    shard0: int          # first shard of the block
    k_shards: int        # shards in the block
    n_facts: int         # facts in the block (the last shard may be partial)
    device: torch.device
    columns: dict        # field -> int64 [n_facts]: a row id or a value


def mix64(*parts: int) -> int:
    """splitmix64 over ``parts``: a seed for ``torch.Generator``."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        x = z ^ (z >> 31)
    return x


def n_shards(facts: int) -> int:
    return -(-facts // SHARD_WIDTH)


def spans(facts: int, block_shards: int):
    """(first shard, shards, facts) of each block."""
    total = n_shards(facts)
    for s0 in range(0, total, block_shards):
        k = min(block_shards, total - s0)
        yield s0, k, min(facts - s0 * SHARD_WIDTH, k * SHARD_WIDTH)


def generator(seed: int, shard0: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix64(seed, shard0))
    return g


def categorical(probs, n: int, g: torch.Generator, device) -> torch.Tensor:
    """``n`` row ids drawn with the given probabilities (inverse CDF)."""
    cdf = torch.cumsum(torch.tensor(probs, dtype=torch.float64), 0)
    cdf = (cdf / cdf[-1]).to(torch.float32).to(device)
    u = torch.rand(n, generator=g, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(probs) - 1)
