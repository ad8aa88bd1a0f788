"""Bit-sliced-index (BSI) layout for integer fields — the part of the JAX
package's ``ops/bsi.py`` that the storage layer needs.

A BSI fragment is ``[2 + depth, SHARD_WORDS]`` words (fragment.go:90-93,
field.go:1564-1647):

* row 0 — existence ("not null") bit per column     (bsiExistsBit)
* row 1 — sign bit (set = negative)                 (bsiSignBit)
* row 2+i — bit i of the magnitude, LSB first       (bsiOffsetBit + i)

Copied: the row constants, ``MAG_BITS`` (the width of a slotted BSI
predicate in ``executor/plan.py parametrize``) and the numpy
``pack_values`` / ``unpack_values``.  The device BSI ops (range
predicates, Sum/Min/Max scans) wait for a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from .bitset import word_bit_np

EXISTS_ROW = 0
SIGN_ROW = 1
OFFSET_ROW = 2

MAG_BITS = 63  # max magnitude bits of an int64 predicate

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
