"""Generated columns -> the port's fragments, on the device.

A generator (``gen/<config>.py``) yields blocks of consecutive facts:
for every set field the row id of each fact, for every int field its
value.  ``fragments`` turns one block into the sparse word stores the
port's storage holds (``pilosa_tpu_torch.convert.holder_from_arrays``:
sorted flat word indices ``row * SHARD_WORDS + word`` and their non-zero
words), building the words with one ``index_add_`` a field on the device
and copying only the non-zero words to the host.

The bits of one word are distinct powers of two, so their int32 sum is
their OR; bit 31 is the one negative term, so no partial sum leaves the
int32 range.
"""

from __future__ import annotations

import time

import numpy as np
import torch

SHARD_WIDTH = 1 << 20
SHARD_WORDS = SHARD_WIDTH // 32
EXISTS_ROW, SIGN_ROW, OFFSET_ROW = 0, 1, 2   # a BSI view's leading rows


def bit_depth(v: int) -> int:
    return max(1, int(v).bit_length())


def cap_rows(n_rows: int) -> int:
    """A fragment's row capacity: 4, doubled until it holds ``n_rows``."""
    cap = 4
    while cap < n_rows:
        cap *= 2
    return cap


def _bit_values(pos: torch.Tensor) -> torch.Tensor:
    table = torch.tensor([1 << b for b in range(31)] + [-(1 << 31)],
                         dtype=torch.int32, device=pos.device)
    return table[pos & 31]


def field_words(rows: torch.Tensor, n_rows: int, k_shards: int,
                pos: torch.Tensor, shard: torch.Tensor,
                bits: torch.Tensor) -> torch.Tensor:
    """int32 words ``[k_shards, n_rows, SHARD_WORDS]``: fact i sets bit
    ``pos[i] & 31`` of word ``pos[i] >> 5`` in row ``rows[i]`` of its
    block-local ``shard[i]``; a negative row sets nothing."""
    out = torch.zeros(k_shards * n_rows * SHARD_WORDS, dtype=torch.int32,
                      device=rows.device)
    keep = rows >= 0
    flat = ((shard * n_rows + rows) * SHARD_WORDS) + (pos >> 5)
    out.index_add_(0, flat[keep], bits[keep])
    return out.view(k_shards, n_rows, SHARD_WORDS)


def bsi_words(values: torch.Tensor, depth: int, k_shards: int,
              pos: torch.Tensor, shard: torch.Tensor,
              bits: torch.Tensor) -> torch.Tensor:
    """A BSI view's words ``[k_shards, OFFSET_ROW + depth, SHARD_WORDS]``
    for non-negative ``values``: the exists row, an empty sign row and
    one row a magnitude bit."""
    n_rows = OFFSET_ROW + depth
    out = torch.zeros(k_shards * n_rows * SHARD_WORDS, dtype=torch.int32,
                      device=values.device)
    base = shard * n_rows * SHARD_WORDS + (pos >> 5)
    out.index_add_(0, base + EXISTS_ROW * SHARD_WORDS, bits)
    for i in range(depth):
        on = ((values >> i) & 1).to(torch.int32)
        out.index_add_(0, base + (OFFSET_ROW + i) * SHARD_WORDS, bits * on)
    return out.view(k_shards, n_rows, SHARD_WORDS)


def block_words(cfg: dict, block) -> dict:
    """{(field, view): words [k, rows, SHARD_WORDS]} of one block."""
    n = block.n_facts
    dev = block.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    shard, pos = i >> 20, i & (SHARD_WIDTH - 1)
    bits = _bit_values(pos)
    out = {}
    for f in cfg["fields"]:
        col = block.columns[f["name"]]
        if f["type"] == "set":
            out[(f["name"], "standard")] = field_words(
                col, f["rows"], block.k_shards, pos, shard, bits)
        else:
            out[(f["name"], "bsig_" + f["name"])] = bsi_words(
                col, bit_depth(f["max"]), block.k_shards, pos, shard, bits)
    return out


def sparse_stores(words: torch.Tensor):
    """The per-shard sparse word stores of ``words [k, rows, W]``:
    ``[(idx int64, val uint32)]``, one host pair a shard."""
    k = words.shape[0]
    flat = words.reshape(k, -1)
    nz = flat != 0
    counts = nz.sum(dim=1).cpu().numpy()
    where = torch.nonzero(nz)                      # row-major: sorted
    idx = where[:, 1].cpu().numpy()
    val = flat[nz].cpu().numpy().view(np.uint32)
    cut = np.cumsum(counts)[:-1]
    return list(zip(np.split(idx, cut), np.split(val, cut)))


class FragmentStream:
    """The ``fragments`` mapping of ``holder_from_arrays`` as a stream:
    ``items()`` generates block after block on the device, so the host
    holds one block's stores beside the port's copies.  ``gen_s`` sums
    the time spent generating and copying to the host; the rest of the
    load is the port's."""

    def __init__(self, cfg: dict, blocks):
        self.cfg = cfg
        self.blocks = blocks
        self.gen_s = 0.0
        self.words = 0

    def items(self):
        index = self.cfg["index"]
        it = iter(self.blocks)
        while True:
            t0 = time.perf_counter()
            block = next(it, None)
            if block is None:
                return
            out = []
            for (field, view), words in block_words(self.cfg, block).items():
                cap = cap_rows(words.shape[1])
                for j, (idx, val) in enumerate(sparse_stores(words)):
                    self.words += idx.size
                    out.append(((index, field, view, block.shard0 + j),
                                (idx, val, cap)))
                del words
            self.gen_s += time.perf_counter() - t0
            yield from out
