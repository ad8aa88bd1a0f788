"""Dense bitset ops over torch — the port of the JAX package's
``ops/bitset.py`` (the replacement for the reference engine's roaring
container op matrix, roaring/roaring.go:3160-4770).

Representation
--------------
A *segment* is one shard-row of bits as ``SHARD_WORDS`` 32-bit words
(little-endian within each word: shard-column ``c`` lives at word
``c >> 5``, bit ``c & 31``).  A *fragment tensor* stacks rows:
``[n_rows, SHARD_WORDS]``; the stacked executor adds a leading shard axis.

Words are **int32 tensors holding the uint32 bit patterns**.  Torch has no
uint32 shifts on the CPU, and int32 ``>>`` is arithmetic, so every right
shift here masks off the sign extension (``_shr``).  Arithmetic is kept
free of int32 overflow (the sign bit is counted apart in the popcount,
masks are built in int64 and narrowed with ``_narrow``).  The host
boundary is ``from_numpy`` / ``to_numpy``: a ``.view`` between numpy
uint32 and int32, exact and copy-free.

Torch has no popcount op, so ``popcount_words`` is the SWAR count; and no
scatter-OR, so ``set_bits`` / ``clear_bits`` dedupe the bit positions and
``scatter_add`` the distinct single-bit values (a sum of distinct bits is
their OR).

The numpy pack/unpack helpers at the bottom are copied from the JAX
module; they are the import/export boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import SHARD_WORDS, WORD_BITS, WORD_BITS_EXP

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_LOW31 = 0x7FFFFFFF


def from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> host numpy uint32 (same bits)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def _narrow(t64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32
    bits (explicit wrap, no reliance on narrowing-conversion behaviour)."""
    return torch.where(t64 >= (1 << 31), t64 - (1 << 32),
                       t64).to(torch.int32)


def _shr(a: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words by a static 0 < n < 32."""
    return (a >> n) & ((1 << (WORD_BITS - n)) - 1)


def word_bit_np(cols):
    """Column ids -> (word index, single-bit mask) on host (numpy).  The one
    place the word geometry (WORD_BITS_EXP) is spelled out for packing."""
    cols = np.asarray(cols)
    w = cols >> WORD_BITS_EXP
    bit = np.uint32(1) << (cols & (WORD_BITS - 1)).astype(np.uint32)
    return w, bit


# ---------------------------------------------------------------------------
# Boolean algebra (roaring/roaring.go:3160 intersect, :3382 union, :3828
# difference, :4175 xor).  The operators also serve numpy uint32 operands
# (results.RowResult combines host segments through these).
# ---------------------------------------------------------------------------

def intersect(a, b):
    return a & b


def union(a, b):
    return a | b


def difference(a, b):
    return a & ~b


def xor(a, b):
    return a ^ b


def union_many(segs: torch.Tensor) -> torch.Tensor:
    """n-way union (roaring/roaring.go:739 unionInPlace) of a stacked
    ``[n, ...]`` tensor along axis 0."""
    out = segs[0].clone()
    for i in range(1, segs.shape[0]):
        out |= segs[i]
    return out


# ---------------------------------------------------------------------------
# Population counts (roaring/roaring.go:407 Count, :436 CountRange, :3021
# intersectionCount).
# ---------------------------------------------------------------------------

def popcount_words(a: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts (int32) by the SWAR method.  The sign bit
    is counted apart so that every intermediate stays non-negative and no
    int32 operation overflows."""
    top = (a < 0).to(torch.int32)
    x = a & _LOW31
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + top


def count(seg: torch.Tensor) -> torch.Tensor:
    """Total set bits over every axis (int64 scalar tensor)."""
    return popcount_words(seg).sum(dtype=torch.int64)


def count_np(seg) -> int:
    """Total set bits of a host segment (numpy)."""
    return int(np.bitwise_count(np.asarray(seg, dtype=np.uint32)).sum())


def row_counts(frag: torch.Tensor) -> torch.Tensor:
    """Per-row popcount over the last axis -> int32[...]."""
    return popcount_words(frag).sum(dim=-1, dtype=torch.int32)


def intersection_count(a, b) -> torch.Tensor:
    """popcount(a & b) (roaring/roaring.go:3021-3158)."""
    return count(a & b)


# Words of the [chunk, m, W] temporary intersection_counts_matrix builds
# per step (64 Mi words = 256 MiB).
_PAIR_TEMP_WORDS = 1 << 26


def intersection_counts_matrix(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection counts ``[n, W] x [m, W] -> int32[n, m]`` (the
    GroupBy pair loop of executor.go:3058).  The ``[n, m, W]`` broadcast
    temporary is chunked along n so it stays under ``_PAIR_TEMP_WORDS``."""
    n, m, w = a.shape[0], b.shape[0], a.shape[-1]
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    step = max(1, _PAIR_TEMP_WORDS // max(1, m * w))
    for lo in range(0, n, step):
        blk = a[lo: lo + step, None, :] & b[None, :, :]
        out[lo: lo + step] = row_counts(blk)
    return out


# ---------------------------------------------------------------------------
# Range masks and ranged ops (roaring/roaring.go:436 CountRange, :2982 flip,
# :562 OffsetRange).
# ---------------------------------------------------------------------------

def _low_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 mask of the low ``h`` bits, h in [0, 32]."""
    return (torch.ones_like(h) << h) - 1


def _range_mask(start: int, end: int, words: int = SHARD_WORDS,
                device=None) -> torch.Tensor:
    """int32[words] mask with bits [start, end) set; start/end in
    [0, words*32]."""
    base = torch.arange(words, dtype=torch.int64, device=device) * WORD_BITS
    lo = (int(start) - base).clamp(0, WORD_BITS)
    hi = (int(end) - base).clamp(0, WORD_BITS)
    return _narrow(_low_bits(hi) & ~_low_bits(lo) & 0xFFFFFFFF)


def count_range(seg, start, end):
    """Count bits in [start, end) (roaring/roaring.go:436)."""
    return count(seg & _range_mask(start, end, seg.shape[-1], seg.device))


def flip(seg, start, end):
    """Toggle bits in [start, end) (roaring/roaring.go:2982)."""
    return seg ^ _range_mask(start, end, seg.shape[-1], seg.device)


def keep_range(seg, start, end):
    """Zero every bit outside [start, end)."""
    return seg & _range_mask(start, end, seg.shape[-1], seg.device)


# ---------------------------------------------------------------------------
# Shift (roaring/roaring.go:4288): move every bit up by n columns.  Bits
# shifted past the shard boundary are dropped (row.go:248 Shift).
# ---------------------------------------------------------------------------

def _pad_front(seg: torch.Tensor, k: int) -> torch.Tensor:
    """Shift words toward higher indices by k along the last axis,
    zero-filling (the jnp.pad(...)[..., :w] of the JAX module)."""
    w = seg.shape[-1]
    out = torch.zeros_like(seg)
    if k < w:
        out[..., k:] = seg[..., : w - k]
    return out


def shift(seg: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift bits toward higher column ids by static ``n`` >= 0."""
    if n == 0:
        return seg
    word_shift, bit_shift = divmod(n, WORD_BITS)
    if word_shift:
        seg = _pad_front(seg, word_shift)
    if bit_shift:
        lo = seg << bit_shift
        carry = _pad_front(_shr(seg, WORD_BITS - bit_shift), 1)
        seg = lo | carry
    return seg


# ---------------------------------------------------------------------------
# Batched mutation.  No scatter-OR exists, so the bit positions are
# deduplicated and the distinct single-bit values scatter_add'ed: within one
# word they are distinct powers of two, so their sum is their OR.
# ---------------------------------------------------------------------------

def _word_masks(frag: torch.Tensor, rows, cols) -> torch.Tensor:
    """Flat int32 OR-mask over ``frag`` of the (rows[i], cols[i]) bits.
    Entries with row < 0 (padding) or row >= n_rows are dropped, as the
    JAX module's out-of-bounds scatter drops them."""
    n_rows, n_words = frag.shape[-2], frag.shape[-1]
    rows = torch.as_tensor(rows, dtype=torch.int64, device=frag.device)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=frag.device)
    valid = (rows >= 0) & (rows < n_rows)
    pos = torch.unique(rows[valid] * (n_words * WORD_BITS) + cols[valid])
    word = pos >> WORD_BITS_EXP
    bit = _narrow(torch.ones_like(pos) << (pos & (WORD_BITS - 1)))
    masks = torch.zeros(frag.numel(), dtype=torch.int32, device=frag.device)
    masks.scatter_add_(0, word, bit)
    return masks.view(frag.shape)


def set_bits(frag: torch.Tensor, rows, cols) -> torch.Tensor:
    """Set bits (rows[i], cols[i]) in fragment ``[n, W]``; returns a new
    tensor.  Duplicate positions and positions sharing a word are
    handled; padding entries may use row == -1 (ignored)."""
    return frag | _word_masks(frag, rows, cols)


def clear_bits(frag: torch.Tensor, rows, cols) -> torch.Tensor:
    """Clear bits (rows[i], cols[i]); same duplicate/padding semantics as
    set_bits."""
    return frag & ~_word_masks(frag, rows, cols)


# ---------------------------------------------------------------------------
# Host-side packing (numpy) — the import/export boundary, copied from the
# JAX module.  Mirrors the role of roaring's serializer
# (roaring/roaring.go:1046 WriteTo / 1258 iterator).
# ---------------------------------------------------------------------------

def pack_columns(cols: np.ndarray, words: int = SHARD_WORDS) -> np.ndarray:
    """Sorted-or-not shard-local column ids -> uint32[words] bitset."""
    out = np.zeros(words, dtype=np.uint32)
    w, bit = word_bit_np(np.asarray(cols, dtype=np.int64))
    np.bitwise_or.at(out, w, bit)
    return out


def pack_fragment(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                  words: int = SHARD_WORDS) -> np.ndarray:
    """(row, col) pairs -> uint32[n_rows, words] fragment tensor."""
    out = np.zeros((n_rows, words), dtype=np.uint32)
    rows = np.asarray(rows, dtype=np.int64)
    w, bit = word_bit_np(np.asarray(cols, dtype=np.int64))
    np.bitwise_or.at(out, (rows, w), bit)
    return out


def unpack_columns(seg: np.ndarray) -> np.ndarray:
    """uint32[words] bitset -> sorted int64 column ids."""
    seg = np.ascontiguousarray(np.asarray(seg, dtype=np.uint32))
    bits = np.unpackbits(seg.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)


def unpack_fragment(frag: np.ndarray):
    """uint32[n, words] -> (row_ids, col_ids) int64 arrays, row-major order."""
    frag = np.ascontiguousarray(np.asarray(frag, dtype=np.uint32))
    n, w = frag.shape
    bits = np.unpackbits(frag.view(np.uint8),
                         bitorder="little").reshape(n, w * 32)
    r, c = np.nonzero(bits)
    return r.astype(np.int64), c.astype(np.int64)
