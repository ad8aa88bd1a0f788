"""Bit-sliced-index (BSI) ops for integer fields — the port of the JAX
package's ``ops/bsi.py``.

A BSI fragment is ``[2 + depth, SHARD_WORDS]`` words (fragment.go:90-93,
field.go:1564-1647):

* row 0 — existence ("not null") bit per column     (bsiExistsBit)
* row 1 — sign bit (set = negative)                 (bsiSignBit)
* row 2+i — bit i of the magnitude, LSB first       (bsiOffsetBit + i)

Every comparison and aggregation scan is O(depth) vector passes, the
complexity of the reference's per-slice roaring scans (fragment.go:1111
sum, :1147 min, :1189 max, :1288-1538 rangeEQ/LT/GT/Between).

The ops take int32 word tensors (uint32 bit patterns, ops/bitset.py) with
any leading axes: ``[rows, W]`` for one fragment, ``[S, rows, W]`` for a
stacked shard group.  A filter or candidate segment has the fragment's
leading axes, optionally under a batch axis.  In the ``_dyn`` forms the
predicate's magnitude arrives as an int32 tensor of ``MAG_BITS`` bits
(LSB first) on the device: ``[63]`` for one predicate, ``[B, 63]`` for a
batch of B predicates, whose axis leads every result
(``[B, S, W]``) — each bit selects per batch row with ``torch.where``, so
a batch is one chain of launches, not B chains.  The predicate's sign
stays structural, as in the JAX module: it selects the code path.

The device halves return int32 popcounts (each at most 2^20 a shard);
the 2^i weighting that would overflow runs on the host in Python ints
(``weighted_sum``, ``reconstruct_min_max``, copied).  BSI has no Pallas
kernel in the JAX package (XLA fuses these passes), so this module is
plain PyTorch on every device; a fused BSI kernel is later performance
work.  Copied as they are: the row constants, ``MAG_BITS``,
``weighted_sum``, ``reconstruct_min_max`` and the numpy ``pack_values``
/ ``unpack_values``.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitset import popcount_words, word_bit_np

EXISTS_ROW = 0
SIGN_ROW = 1
OFFSET_ROW = 2

MAG_BITS = 63  # max magnitude bits of an int64 predicate


def depth_of(bsi_frag) -> int:
    return bsi_frag.shape[-2] - OFFSET_ROW


def _row(bsi_frag, r: int) -> torch.Tensor:
    return bsi_frag[..., r, :]


def _total(seg) -> torch.Tensor:
    """Set bits per leading row (int32, summed over the word axis)."""
    return popcount_words(seg).sum(dim=-1, dtype=torch.int32)


def not_null(bsi_frag, filter_seg=None):
    """Columns with a value set (fragment.go:1269 notNull)."""
    seg = _row(bsi_frag, EXISTS_ROW)
    if filter_seg is not None:
        seg = seg & filter_seg
    return seg


def _magnitude_compare(bsi_frag, pred_mag: int, candidates):
    """Classic bit-sliced comparison of per-column magnitudes against a
    constant, MSB->LSB (the loop structure of fragment.go:1349 rangeLT /
    :1436 rangeGT collapsed into one pass).

    Returns (lt, eq, gt) segments partitioning ``candidates`` by
    magnitude <, ==, > ``pred_mag``.
    """
    depth = depth_of(bsi_frag)
    eq = candidates
    lt = torch.zeros_like(candidates)
    gt = torch.zeros_like(candidates)
    for i in range(depth - 1, -1, -1):
        bit = _row(bsi_frag, OFFSET_ROW + i)
        if (pred_mag >> i) & 1:
            lt = lt | (eq & ~bit)
            eq = eq & bit
        else:
            gt = gt | (eq & bit)
            eq = eq & ~bit
    if pred_mag >> depth:
        # Predicate magnitude exceeds representable range: everything is less.
        lt = lt | eq | gt
        eq = torch.zeros_like(eq)
        gt = torch.zeros_like(gt)
    return lt, eq, gt


def _select(op: str, exists, lt, eq, gt):
    if op == "eq":
        return eq
    if op == "neq":
        return exists & ~eq
    if op == "lt":
        return lt
    if op == "le":
        return lt | eq
    if op == "gt":
        return gt
    if op == "ge":
        return gt | eq
    raise ValueError(f"unknown range op {op!r}")


def _zero_split(bsi_frag, pos, neg):
    """(lt, eq, gt) of the zero predicate: magnitude-0 columns with the
    sign bit set still hold value 0."""
    _, peq, pgt = _magnitude_compare(bsi_frag, 0, pos)
    _, neg_zero, _ = _magnitude_compare(bsi_frag, 0, neg)
    return neg & ~neg_zero, peq | neg_zero, pgt


def range_op(bsi_frag, op: str, value: int, filter_seg=None):
    """Signed comparison of every column's value against ``value``.

    op in {"eq","neq","lt","le","gt","ge"} — the executor lowers PQL
    conditions (pql/ast.go Condition) and Between to these plus intersections
    (fragment.go:1273 rangeOp dispatch).
    """
    exists = not_null(bsi_frag, filter_seg)
    sign = _row(bsi_frag, SIGN_ROW)
    pos = exists & ~sign
    neg = exists & sign
    mag = abs(int(value))

    if value > 0:
        plt, peq, pgt = _magnitude_compare(bsi_frag, mag, pos)
        # every negative value is < a positive predicate
        lt, eq, gt = neg | plt, peq, pgt
    elif value == 0:
        lt, eq, gt = _zero_split(bsi_frag, pos, neg)
    else:
        nlt, neq_, ngt = _magnitude_compare(bsi_frag, mag, neg)
        # for negatives: larger magnitude -> smaller value
        lt, eq, gt = ngt, neq_, pos | nlt
    return _select(op, exists, lt, eq, gt)


def range_between(bsi_frag, lo: int, hi: int, filter_seg=None):
    """lo <= value <= hi (fragment.go:1461 rangeBetween)."""
    ge = range_op(bsi_frag, "ge", lo, filter_seg)
    le = range_op(bsi_frag, "le", hi, filter_seg)
    return ge & le


# -- dynamic-predicate variants ---------------------------------------------
# The predicate magnitude arrives as a bit tensor instead of a Python int,
# so a batch of predicates of one shape runs as one chain of launches —
# the per-slice branch on the predicate bit becomes a select.

def _bit_select(bsi_frag, b: torch.Tensor) -> torch.Tensor:
    """A per-predicate flag ``[...]`` shaped to lead the fragment's
    segment axes (``[..., 1, ..., 1]``)."""
    return b.reshape(tuple(b.shape) + (1,) * (bsi_frag.dim() - 1))


def _magnitude_compare_dyn(bsi_frag, mag_bits, candidates):
    """_magnitude_compare with the predicate's bits as an int32
    ``[..., 63]`` tensor (LSB first).  Bits at positions >= depth mean
    the predicate exceeds the representable range: everything is less."""
    depth = depth_of(bsi_frag)
    eq = candidates
    lt = torch.zeros_like(candidates)
    gt = torch.zeros_like(candidates)
    for i in range(depth - 1, -1, -1):
        bit = _row(bsi_frag, OFFSET_ROW + i)
        b = _bit_select(bsi_frag, mag_bits[..., i] > 0)
        new_lt = torch.where(b, lt | (eq & ~bit), lt)
        new_gt = torch.where(b, gt, gt | (eq & bit))
        eq = torch.where(b, eq & bit, eq & ~bit)
        lt, gt = new_lt, new_gt
    if depth < MAG_BITS:
        ovf = _bit_select(bsi_frag,
                          mag_bits[..., depth:MAG_BITS].sum(dim=-1) > 0)
        lt = torch.where(ovf, lt | eq | gt, lt)
        eq = torch.where(ovf, torch.zeros_like(eq), eq)
        gt = torch.where(ovf, torch.zeros_like(gt), gt)
    return lt, eq, gt


def range_op_dyn(bsi_frag, op: str, sign: str, mag_bits, filter_seg=None):
    """range_op with a dynamic predicate: ``sign`` ("pos"|"zero"|"neg") is
    structural (it selects the code path), ``mag_bits`` is the magnitude
    bit tensor."""
    exists = not_null(bsi_frag, filter_seg)
    sgn = _row(bsi_frag, SIGN_ROW)
    pos = exists & ~sgn
    neg = exists & sgn

    if sign == "pos":
        plt, peq, pgt = _magnitude_compare_dyn(bsi_frag, mag_bits, pos)
        lt, eq, gt = neg | plt, peq, pgt
    elif sign == "zero":
        # predicate 0 needs no dynamic bits (the zero compare is static)
        lt, eq, gt = _zero_split(bsi_frag, pos, neg)
    else:
        nlt, neq_, ngt = _magnitude_compare_dyn(bsi_frag, mag_bits, neg)
        lt, eq, gt = ngt, neq_, pos | nlt
    return _select(op, exists, lt, eq, gt)


def range_between_dyn(bsi_frag, lo_sign, lo_bits, hi_sign, hi_bits,
                      filter_seg=None):
    ge = range_op_dyn(bsi_frag, "ge", lo_sign, lo_bits, filter_seg)
    le = range_op_dyn(bsi_frag, "le", hi_sign, hi_bits, filter_seg)
    return ge & le


def sum_counts(bsi_frag, filter_seg=None):
    """Device half of Sum (fragment.go:1111): per-bit-slice popcounts split
    by sign.  Returns int32 ``[..., 2, depth+1]``: row 0 = positive-side
    counts (count of filter&exists&~sign per magnitude bit, last entry =
    total positive count), row 1 = same for the negative side.  The host
    reconstructs the exact int sum via ``weighted_sum``.  One slice at a
    time, so the temporaries stay the size of one segment batch."""
    exists = not_null(bsi_frag, filter_seg)
    sign = _row(bsi_frag, SIGN_ROW)
    pos = exists & ~sign
    neg = exists & sign
    pos_counts, neg_counts = [], []
    for i in range(depth_of(bsi_frag)):
        sl = _row(bsi_frag, OFFSET_ROW + i)
        pos_counts.append(_total(sl & pos))
        neg_counts.append(_total(sl & neg))
    pos_counts.append(_total(pos))
    neg_counts.append(_total(neg))
    return torch.stack([torch.stack(pos_counts, dim=-1),
                        torch.stack(neg_counts, dim=-1)], dim=-2)


def weighted_sum(counts: np.ndarray):
    """Host half of Sum: exact Python-int reconstruction.

    Returns (sum, count) like fragment.go:1111 (sum of values, number of
    non-null columns in the filter)."""
    counts = np.asarray(counts)
    depth = counts.shape[1] - 1
    pos = sum(int(counts[0, i]) << i for i in range(depth))
    neg = sum(int(counts[1, i]) << i for i in range(depth))
    total = int(counts[0, depth]) + int(counts[1, depth])
    return pos - neg, total


def min_max_bits(bsi_frag, filter_seg=None, want_max=False):
    """Device half of Min/Max (fragment.go:1147 min, :1189 max).

    Narrows the candidate set bit-by-bit from the MSB, per leading row,
    on the device.  Returns (value_bits int32[..., depth], negative
    int32[...], count int32[...]): the chosen magnitude bit per slice,
    whether the extremum is negative, and how many columns attain it.
    The host reconstructs the Python int.
    """
    exists = not_null(bsi_frag, filter_seg)
    sign = _row(bsi_frag, SIGN_ROW)
    pos = exists & ~sign
    neg = exists & sign
    pos_count = _total(pos)
    neg_count = _total(neg)

    if want_max:
        # max: prefer positives; among positives maximise magnitude, among
        # negatives (only if no positives) minimise magnitude.
        use_neg = pos_count == 0
        prefer_set = ~use_neg  # maximise magnitude iff positive side
    else:
        use_neg = neg_count > 0
        prefer_set = use_neg  # minimise value = maximise magnitude if negative
    cand = torch.where(use_neg.unsqueeze(-1), neg, pos)

    bits = []
    for i in range(depth_of(bsi_frag) - 1, -1, -1):
        slice_i = _row(bsi_frag, OFFSET_ROW + i)
        with_bit = cand & slice_i
        without_bit = cand & ~slice_i
        n_with = _total(with_bit)
        n_without = _total(without_bit)
        # prefer_set: take the bit=1 branch when non-empty; else bit=0 branch.
        take_set = torch.where(prefer_set, n_with > 0, n_without == 0)
        cand = torch.where(take_set.unsqueeze(-1), with_bit, without_bit)
        bits.append(take_set.to(torch.int32))
    bits.reverse()
    n_att = _total(cand)
    return torch.stack(bits, dim=-1), use_neg.to(torch.int32), n_att


def reconstruct_min_max(bits, negative, count):
    """Host half of Min/Max: (value, count) from min_max_bits output.

    When the candidate set is empty (no non-null columns under the filter)
    the device bit pattern is meaningless; this returns (0, 0) and callers
    must treat count == 0 as "no value" (the reference returns an empty
    ValCount, executor.go:2995)."""
    if int(count) == 0:
        return 0, 0
    bits = np.asarray(bits)
    mag = sum(int(bits[i]) << i for i in range(bits.shape[0]))
    val = -mag if int(negative) else mag
    return val, int(count)


def pack_values(cols: np.ndarray, values: np.ndarray, depth: int,
                words: int) -> np.ndarray:
    """Host-side construction of a BSI fragment tensor from (column, value)
    pairs — the import path's equivalent of fragment.go:977 setValueBase."""
    out = np.zeros((OFFSET_ROW + depth, words), dtype=np.uint32)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    if values.size and int(np.abs(values).max()) >> depth:
        raise ValueError(
            f"value magnitude {int(np.abs(values).max())} does not fit in "
            f"depth={depth} bits; widen the fragment (the storage layer "
            f"auto-sizes depth like the reference's setValueBase grows "
            f"bitDepth, fragment.go:977)"
        )
    w, bit = word_bit_np(cols)
    np.bitwise_or.at(out[EXISTS_ROW], w, bit)
    negmask = values < 0
    if negmask.any():
        np.bitwise_or.at(out[SIGN_ROW], w[negmask], bit[negmask])
    mags = np.abs(values)
    for i in range(depth):
        sel = (mags >> i) & 1 > 0
        if sel.any():
            np.bitwise_or.at(out[OFFSET_ROW + i], w[sel], bit[sel])
    return out


def unpack_values(bsi_frag: np.ndarray):
    """Host-side extraction: (cols int64[], values int64[]) for set columns."""
    from .bitset import unpack_columns

    bsi_frag = np.asarray(bsi_frag)
    cols = unpack_columns(bsi_frag[EXISTS_ROW])
    if cols.size == 0:
        return cols, np.zeros(0, dtype=np.int64)
    depth = bsi_frag.shape[0] - OFFSET_ROW
    w, bit = word_bit_np(cols)
    vals = np.zeros(cols.shape, dtype=np.int64)
    for i in range(depth):
        vals |= ((bsi_frag[OFFSET_ROW + i, w] & bit) > 0).astype(np.int64) << i
    sign = (bsi_frag[SIGN_ROW, w] & bit) > 0
    vals[sign] = -vals[sign]
    return cols, vals
