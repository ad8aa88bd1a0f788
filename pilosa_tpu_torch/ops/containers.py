"""Compressed container streams — the port of the JAX package's
``ops/containers.py`` (roaring's array/bitmap/run container algebra,
word-granular).

A fragment's device form need not be the dense ``[rows, SHARD_WORDS]``
tensor: it can stay resident as a *packed container stream* — per-container
key/type/count/offset tables plus one payload word buffer — and be decoded
to dense words on the device at op time.  Container forms (a container
covers ``CONTAINER_WORDS`` = 2048 words = 2^16 bits):

* **array** (type 0): ``count`` (word-slot, word-value) entries — payload
  is ``count`` slot indices followed by ``count`` word values.
* **bitmap** (type 1): the container's 2048 words verbatim.
* **run** (type 2): ``count`` bit-level [start, end) pairs within the
  container's 2^16-bit span.

Copied from the JAX module: the host codec (``pow2_bucket``, ``Packed``,
``pack_words``, ``estimate_packed_bytes``, ``unpack_packed`` — the numpy
decode oracle — and ``pad_packed``).  ``pack_words`` is vectorised over
the whole fragment here, where the JAX module loops over containers; its
output is the JAX module's to the byte (same forms, tables, payload and
dtypes).  New here: ``PackedStack``, the
ragged layout both CUDA kernels take (ops/kernels.py), its host builder
``stack_packed``, ``decode_block``, the plain PyTorch decode that is the
plain version of the CUDA decode kernel, and ``upload_decode`` over
torch.

A PackedStack lays S shards' streams end to end at their exact sizes:
the JAX package pads every fragment to pow2 buckets so that XLA sees
static shapes, and stacks only fragments of one bucket; here one stack
holds shards of any container count and payload size.  Words are int32
tensors holding the uint32 bit patterns (ops/bitset.py).  Payload reads
past the buffer read as zero, like the JAX decode's fill mode; keys past
the fragment's tiles are dropped when the stack is built, like its drop
mode.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import CONTAINER_WORDS, SHARD_WORDS, WORD_BITS
from .bitset import _narrow

# Container type codes (device-side selectors; padding rows use -1).
TYPE_ARRAY = 0
TYPE_BITMAP = 1
TYPE_RUN = 2

# Array form wins while 2 payload words per entry undercut the bitmap's
# CONTAINER_WORDS; at >= CONTAINER_WORDS // 2 non-zero words the bitmap
# copy is smaller AND decodes cheaper.
ARRAY_WORDS_MAX = CONTAINER_WORDS // 2 - 1  # 1023

# Run containers are only chosen up to this many runs: device decode
# costs O(runs x CONTAINER_WORDS) per container (each run contributes a
# masked OR over the tile), so unbounded run counts would trade HBM for
# unbounded VPU work.  Clustered data this form exists for (Store'd
# rows, range ingests) sits at 1-16 runs.
RUN_MAX = 64

# Dense fragments beyond this many rows never compress: the decode
# scatter's flat int32 indices must stay below 2^31 (rows * SHARD_WORDS).
MAX_COMPRESSED_ROWS = (1 << 31) // SHARD_WORDS - 1


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (0 stays 0) — the shape-bucketing unit
    that keeps one compiled decode executable serving many fragments."""
    return 0 if n <= 0 else 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Packed:
    """One fragment's packed container stream (host arrays, built from
    the sparse word store without materialising the dense tensor)."""
    keys: np.ndarray      # int32[C] container ids (flat_word // 2048), sorted
    types: np.ndarray     # int32[C] TYPE_*
    counts: np.ndarray    # int32[C] entries (array) / words (bitmap) / runs
    offsets: np.ndarray   # int32[C] payload word offset
    payload: np.ndarray   # uint32[P]
    a_max: int            # largest array-container entry count
    r_max: int            # largest run-container run count

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes + self.types.nbytes +
                   self.counts.nbytes + self.offsets.nbytes +
                   self.payload.nbytes)

    def type_histogram(self) -> dict[str, int]:
        t = self.types
        return {"array": int(np.count_nonzero(t == TYPE_ARRAY)),
                "bitmap": int(np.count_nonzero(t == TYPE_BITMAP)),
                "run": int(np.count_nonzero(t == TYPE_RUN))}


def _bit_positions(masks: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Bit positions within their container of the set bits of
    ``masks`` (uint32 words at container word ``slots``), in word order
    then bit order."""
    bits = np.unpackbits(masks.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    row, bit = np.nonzero(bits)
    return slots[row].astype(np.int64) * WORD_BITS + bit


def estimate_packed_bytes(idx: np.ndarray) -> int:
    """Upper bound on pack_words' output size from the sparse indices
    alone (run containers only shrink it) — the cheap density-heuristic
    input that decides compressed vs dense residency without packing."""
    if idx.size == 0:
        return 0
    _, cnt = np.unique(idx // CONTAINER_WORDS, return_counts=True)
    payload_words = int(np.minimum(2 * cnt, CONTAINER_WORDS).sum())
    return 4 * payload_words + 16 * cnt.size


def pack_words(idx: np.ndarray, val: np.ndarray) -> Packed:
    """Pack a fragment's sparse word store (sorted flat indices + word
    values, storage/fragment.py) into a container stream, choosing the
    cheapest form per container (the optimize heuristic of
    roaring.go:2232, word-granular).

    Whole-fragment numpy passes over the stored words, no loop over
    containers.  A container is a run container when its word-run count
    (slot-adjacent groups of stored words, the JAX module's candidacy
    prefilter) and its bit-run count are both at most RUN_MAX and 2 x
    its bit runs undercut min(2 x words, CONTAINER_WORDS); else an array
    container up to ARRAY_WORDS_MAX words; else a bitmap.  Bit runs are
    found word by word: a word's run starts are its set bits whose lower
    neighbour is clear, the neighbour of bit 0 being the top bit of the
    slot-adjacent stored word below it (clear at a container's edge or
    past a gap); run ends likewise from above."""
    cid = idx // CONTAINER_WORDS
    uniq, start, cnt = np.unique(cid, return_index=True,
                                 return_counts=True)
    keys = uniq.astype(np.int32)
    if keys.size == 0:
        e = np.empty(0, dtype=np.int32)
        return Packed(keys, e, e.copy(), e.copy(),
                      np.zeros(0, dtype=np.uint32), 0, 0)
    seg = np.repeat(np.arange(keys.size), cnt)  # container of each word
    slot = (idx % CONTAINER_WORDS).astype(np.uint32)
    w = val.astype(np.uint32)  # the words as a bitmap container holds them
    # adj[j]: stored word j sits in the slot right after word j - 1's
    adj = np.zeros(idx.size, dtype=bool)
    adj[1:] = (np.diff(idx) == 1) & (slot[1:] != 0)
    below = np.zeros_like(w)
    below[1:] = np.where(adj[1:], w[:-1] >> 31, 0)
    above = np.zeros_like(w)
    above[:-1] = np.where(adj[1:], w[1:] << 31, 0)
    begins = w & ~((w << 1) | below)
    ends = w & ~((w >> 1) | above)
    word_runs = np.add.reduceat((~adj).astype(np.int64), start)
    nr = np.add.reduceat(np.bitwise_count(begins).astype(np.int64), start)
    n = cnt.astype(np.int64)
    is_run = (word_runs <= RUN_MAX) & (nr <= RUN_MAX) & \
        (2 * nr < np.minimum(2 * n, CONTAINER_WORDS))
    is_arr = ~is_run & (n <= ARRAY_WORDS_MAX)
    is_bmp = ~is_run & ~is_arr
    types = np.where(is_run, TYPE_RUN,
                     np.where(is_arr, TYPE_ARRAY, TYPE_BITMAP)
                     ).astype(np.int32)
    size = np.where(is_run, 2 * nr,
                    np.where(is_arr, 2 * n, CONTAINER_WORDS))
    counts = np.where(is_bmp, CONTAINER_WORDS, size // 2).astype(np.int32)
    off = np.cumsum(size) - size
    offsets = off.astype(np.int32)
    # the JAX module concatenates the array containers' raw word values
    # into the payload, so their dtype promotes it
    dtype = np.result_type(np.uint32, val.dtype) if is_arr.any() \
        else np.uint32
    payload = np.zeros(int(off[-1] + size[-1]), dtype=dtype)
    base = off[seg]
    m = is_bmp[seg]
    payload[base[m] + slot[m]] = w[m]
    m = is_arr[seg]
    rank = np.arange(idx.size) - start[seg]
    payload[base[m] + rank[m]] = slot[m]
    payload[(base + n[seg] + rank)[m]] = val[m]
    m = is_run[seg]
    pairs = np.repeat(off[is_run] - 2 * (np.cumsum(nr[is_run]) -
                                         nr[is_run]), nr[is_run])
    pairs += 2 * np.arange(pairs.size)
    payload[pairs] = _bit_positions(begins[m], slot[m])
    payload[pairs + 1] = _bit_positions(ends[m], slot[m]) + 1
    a_max = int(n[is_arr].max()) if is_arr.any() else 0
    r_max = int(nr[is_run].max()) if is_run.any() else 0
    return Packed(keys, types, counts, offsets, payload, a_max, r_max)


def unpack_packed(p: Packed, rows: int,
                  words: int = SHARD_WORDS) -> np.ndarray:
    """Host (numpy) decode oracle: the dense tensor a Packed stream
    represents — the differential reference for the device kernel."""
    out = np.zeros(rows * words, dtype=np.uint32)
    for i in range(p.keys.size):
        base = int(p.keys[i]) * CONTAINER_WORDS
        off = int(p.offsets[i])
        n = int(p.counts[i])
        t = int(p.types[i])
        if t == TYPE_BITMAP:
            out[base: base + CONTAINER_WORDS] = \
                p.payload[off: off + CONTAINER_WORDS]
        elif t == TYPE_ARRAY:
            slots = p.payload[off: off + n].astype(np.int64)
            out[base + slots] = p.payload[off + n: off + 2 * n]
        else:  # TYPE_RUN
            pairs = p.payload[off: off + 2 * n].astype(np.int64)
            for s, e in pairs.reshape(n, 2):
                w0, w1 = s // WORD_BITS, (e - 1) // WORD_BITS
                for w in range(w0, w1 + 1):
                    lo = max(s - w * WORD_BITS, 0)
                    hi = min(e - w * WORD_BITS, WORD_BITS)
                    m = ((1 << hi) - 1) & ~((1 << lo) - 1)
                    out[base + w] |= np.uint32(m & 0xFFFFFFFF)
    return out.reshape(rows, words)




# ---------------------------------------------------------------------------
# The ragged packed stack (the container kernels' input).
# ---------------------------------------------------------------------------

# Payload word alignment of every container in a stack: 4 words = 16
# bytes, so the kernels move bitmap tiles with 16-byte loads.
PAYLOAD_ALIGN = 4


class PackedStack(NamedTuple):
    """S packed streams laid end to end, exact size (no pow2 padding) —
    what both container kernels (ops/kernels.py) and ``decode_block``
    take, so one launch covers shards of any container count.

    ``slots[s, t]`` is the index into the container tables of the
    container that covers tile ``t`` of shard ``s`` (a tile is
    CONTAINER_WORDS words of the flat ``[rows, words]`` fragment), or -1.
    It replaces the sorted key table: the JAX package's ``_tile_slots``
    map, built once per stack instead of per launch.  ``offsets`` are
    absolute word offsets into ``payload``, multiples of PAYLOAD_ALIGN,
    int64 so a stack's payload may pass 2^31 words."""
    slots: torch.Tensor    # int32[S, tiles]
    types: torch.Tensor    # int32[N] TYPE_*
    counts: torch.Tensor   # int32[N] entries / words / runs
    offsets: torch.Tensor  # int64[N]
    payload: torch.Tensor  # int32[M] uint32 bit patterns

    def to(self, device) -> "PackedStack":
        return PackedStack(*(a.to(device) for a in self))


def tiles_of(rows: int, words: int) -> int:
    """Container tiles of a ``[rows, words]`` fragment."""
    return -(-rows * words // CONTAINER_WORDS)


def stack_packed(packs, tiles: int, device) -> PackedStack:
    """Lay packed streams (``Packed``, or any object with its five table
    fields, padded or not) end to end into one PackedStack of
    ``len(packs)`` shards on ``device``, built on the host.

    Padding entries (key -1), unknown types and keys at or beyond
    ``tiles`` (a write that raced the caller's row capacity) are dropped.
    Each kept container's payload is copied to a PAYLOAD_ALIGN-aligned
    offset at its full size — CONTAINER_WORDS words for a bitmap, 2 x
    count for an array or run — with words past its pack's buffer read
    as zero, so no kernel read leaves the stack's payload."""
    cw = CONTAINER_WORDS
    slots = np.full((len(packs), tiles), -1, dtype=np.int32)
    types, counts, offsets, pays = ([np.zeros(0, dt)] for dt in (
        np.int32, np.int32, np.int64, np.uint32))
    n_live = base = 0
    for s, p in enumerate(packs):
        k = np.asarray(p.keys, dtype=np.int64)
        t = np.asarray(p.types, dtype=np.int32)
        live = (k >= 0) & (k < tiles) & (t >= TYPE_ARRAY) & (t <= TYPE_RUN)
        k, t = k[live], t[live]
        n = np.asarray(p.counts, dtype=np.int32)[live]
        src = np.asarray(p.offsets, dtype=np.int64)[live]
        size = np.where(t == TYPE_BITMAP, cw,
                        2 * np.maximum(n.astype(np.int64), 0))
        asize = -(-size // PAYLOAD_ALIGN) * PAYLOAD_ALIGN
        dst = np.cumsum(asize) - asize
        out = np.zeros(int(asize.sum()), dtype=np.uint32)
        if size.size:
            owner = np.repeat(np.arange(size.size), size)
            j = np.arange(owner.size) - np.repeat(np.cumsum(size) - size,
                                                  size)
            at = src[owner] + j
            pay = np.asarray(p.payload, dtype=np.uint32)
            ok = (at >= 0) & (at < pay.size)
            out[(dst[owner] + j)[ok]] = pay[at[ok]]
        slots[s, k] = np.arange(n_live, n_live + k.size)
        n_live += k.size
        types.append(t)
        counts.append(n)
        offsets.append(dst + base)
        pays.append(out)
        base += out.size
    return PackedStack(
        torch.from_numpy(slots), torch.from_numpy(np.concatenate(types)),
        torch.from_numpy(np.concatenate(counts)),
        torch.from_numpy(np.concatenate(offsets)),
        torch.from_numpy(np.concatenate(pays).view(np.int32))).to(device)


def stack_tables(keys, types, counts, offsets, payload,
                 tiles: int) -> PackedStack:
    """One fragment's (padded) container tables as tensors -> a one-shard
    PackedStack on the same device (built on the host, as every stack
    is)."""
    arrs = [a.detach().cpu().numpy() for a in
            (keys, types, counts, offsets, payload)]
    p = Packed(*arrs[:4], arrs[4].view(np.uint32), 0, 0)
    return stack_packed([p], tiles, keys.device)


# ---------------------------------------------------------------------------
# Device decode (plain PyTorch).
# ---------------------------------------------------------------------------

def _gather(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """payload[idx], reading 0 where idx is outside the buffer (the JAX
    decode's fill mode)."""
    M = payload.numel()
    ok = (idx >= 0) & (idx < M)
    vals = payload[idx.clamp(0, max(M - 1, 0))]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _expand(n: torch.Tensor):
    """(owner, j) for ``n[i]`` items per owner i: owner repeats each i
    n[i] times, j counts 0..n[i]-1 within it."""
    owner = torch.repeat_interleave(
        torch.arange(n.numel(), device=n.device), n)
    start = torch.cumsum(n, 0) - n
    return owner, torch.arange(owner.numel(), device=n.device) - start[owner]


def decode_block(slots, types, counts, offsets, payload, *, rows: int,
                 words: int = SHARD_WORDS) -> torch.Tensor:
    """Decode a PackedStack to dense int32 words ``[S, rows, words]`` on
    its device — the plain version of the CUDA decode kernel.  It relies
    on ``pack_words``' invariants, as the JAX decode's scatter-set does:
    unique slots within an array container, disjoint runs within a run
    container, so every output word receives disjoint bits and one
    scatter-add is their OR."""
    S, tiles = slots.shape
    if tiles != tiles_of(rows, words):
        raise ValueError(f"slot map has {tiles} tiles, a [{rows}, {words}] "
                         f"fragment {tiles_of(rows, words)}")
    total = rows * words
    dev = slots.device
    out = torch.zeros(S * total, dtype=torch.int32, device=dev)
    cw = CONTAINER_WORDS
    flat = slots.reshape(-1)
    tile = torch.nonzero(flat >= 0).reshape(-1)          # s * tiles + t
    ci = flat[tile].long()
    t = types[ci]
    n = counts[ci].long()
    o = offsets[ci].long()
    first = (tile % tiles) * cw                          # tile's word in shard
    out_base = (tile // tiles) * total + first
    dst_parts, val_parts = [], []

    sel = t == TYPE_BITMAP
    if bool(sel.any()):
        j = torch.arange(cw, device=dev)
        vals = _gather(payload, o[sel, None] + j)
        ok = first[sel, None] + j < total
        dst_parts.append((out_base[sel, None] + j)[ok])
        val_parts.append(vals[ok])

    sel = (t == TYPE_ARRAY) & (n > 0)
    if bool(sel.any()):
        owner, e = _expand(n[sel])
        ob = o[sel][owner]
        slot = _gather(payload, ob + e).long() & 0xFFFFFFFF
        vals = _gather(payload, ob + n[sel][owner] + e)
        ok = (slot < cw) & (first[sel][owner] + slot < total)
        dst_parts.append((out_base[sel][owner] + slot)[ok])
        val_parts.append(vals[ok])

    sel = (t == TYPE_RUN) & (n > 0)
    if bool(sel.any()):
        owner, r = _expand(n[sel])
        ob = o[sel][owner]
        rs = _gather(payload, ob + 2 * r).long() & 0xFFFFFFFF
        re_ = _gather(payload, ob + 2 * r + 1).long() & 0xFFFFFFFF
        re_ = re_.clamp(max=cw * WORD_BITS)
        nonempty = re_ > rs
        rs, re_ = rs[nonempty], re_[nonempty]
        run_out = out_base[sel][owner][nonempty]
        run_first = first[sel][owner][nonempty]
        w0 = rs // WORD_BITS
        span = (re_ - 1) // WORD_BITS - w0 + 1
        wo, wj = _expand(span)
        w = w0[wo] + wj
        lo = (rs[wo] - w * WORD_BITS).clamp(0, WORD_BITS)
        hi = (re_[wo] - w * WORD_BITS).clamp(0, WORD_BITS)
        one = torch.ones_like(lo)
        mask = ((one << hi) - 1) & ~((one << lo) - 1) & 0xFFFFFFFF
        ok = run_first[wo] + w < total
        dst_parts.append((run_out[wo] + w)[ok])
        val_parts.append(_narrow(mask[ok]))

    if dst_parts:
        out.index_put_((torch.cat(dst_parts),), torch.cat(val_parts),
                       accumulate=True)
    return out.view(S, rows, words)


def pad_packed(p: Packed) -> tuple[np.ndarray, ...]:
    """Pad a Packed stream's arrays to their pow2 buckets (padding
    containers use key/type -1) — the per-fragment staging unit the
    compiled decode buckets expect."""
    cb = pow2_bucket(p.keys.size)
    pb = pow2_bucket(p.payload.size)
    keys = np.full(cb, -1, dtype=np.int32)
    types = np.full(cb, -1, dtype=np.int32)
    counts = np.zeros(cb, dtype=np.int32)
    offsets = np.zeros(cb, dtype=np.int32)
    c = p.keys.size
    keys[:c] = p.keys
    types[:c] = p.types
    counts[:c] = p.counts
    offsets[:c] = p.offsets
    payload = np.zeros(pb, dtype=np.uint32)
    payload[: p.payload.size] = p.payload
    return keys, types, counts, offsets, payload


def upload_decode(p: Packed, rows: int, target,
                  words: int = SHARD_WORDS) -> torch.Tensor:
    """Ship a packed stream to ``target`` and decode it there to the dense
    mirror — Fragment.device()'s compressed upload path.  The transfer
    moves compressed bytes; the sparse->dense expansion happens on the
    device, through the decode kernel on a CUDA device (ops/kernels.py)
    and its plain version on the CPU.  A decode that launched the
    kernel records one launch-ledger entry, as the JAX module records
    its Pallas decodes (utils/devobs.py); it captures nothing, so it
    notes no compile."""
    import time

    from ..utils import devobs
    from . import kernels

    stack = stack_packed([p], tiles_of(rows, words), target)
    t0 = time.perf_counter()
    with kernels.tallying_launches() as tally:
        out = kernels.decode_block(*stack, rows=rows, words=words)[0]
    launched = sum(tally.values())
    if launched:
        devobs.LEDGER.record(
            sig=f"decode:{rows}x{words}:cuda", kind="decode", shards=1,
            shards_padded=1, batch_rows=rows, batch_rows_padded=rows,
            queue_s=0.0, dispatch_s=time.perf_counter() - t0,
            decode_bytes=0, compiled=False,
            kernel_launches=launched, kernel_tiles=stack.slots.numel())
    return out
