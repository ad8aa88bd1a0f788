"""Device-side delta overlay application — the port of the JAX
package's ``ingest/delta.py``.

An ingest flush leaves its new words in the fragment's journal
(storage/fragment.py ``ingest_apply``); resident device tensors absorb
them as an indexed OR of a few KB instead of a re-upload of the whole
dense tensor.  Two consumers:

* per-fragment mirrors (``Fragment.device``) call ``apply_overlay``;
* stacked ``[S, rows, W]`` blocks (parallel/stacked.py
  ``_refresh_overlays``) call ``apply_stack_overlay``.

Both reuse ``merge_chunks`` (copied) for the host-side dedupe.

Deviations from the JAX module:

* No pow2 padding of the index arrays (``pad_overlay``): it only let one
  compiled XLA scatter serve a bucket of overlay sizes.  Without padding
  lanes there are no dummy-index collisions, so the update is a plain
  gather, OR and indexed store over host-deduplicated indices — equal
  to the JAX package's add-of-missing-bits.
* Indices travel as int64 ``(row, word)`` (``(member, row, word)`` for a
  stack) tensors, torch's index type; the JAX module's int32 pairs
  avoided a flattened offset that would overflow its default index
  width, and the unflattened form is kept.

Both functions return a NEW tensor and leave the old one as it was, as
the JAX ``.at[].add`` does without donation: a request that captured the
old mirror or stack (another server thread may be between two of its
launches) keeps reading one consistent state, on the CPU too, where
torch ops run synchronously in each caller's thread.  The copy costs a
device-to-device pass over the tensor, not a host re-stage.
"""

from __future__ import annotations

import numpy as np
import torch


def merge_chunks(chunks) -> tuple[np.ndarray, np.ndarray]:
    """Combine journal chunks [(epoch, flat idx, val), ...] into unique
    sorted flat indices with OR-merged word values — the host dedupe
    that makes the device scatter collision-free."""
    if not chunks:
        z = np.zeros(0, dtype=np.int64)
        return z, z.astype(np.uint32)
    idx = np.concatenate([c[1] for c in chunks])
    val = np.concatenate([c[2] for c in chunks])
    uniq, inv = np.unique(idx, return_inverse=True)
    out = np.zeros(uniq.size, dtype=np.uint32)
    np.bitwise_or.at(out, inv, val)
    return uniq, out


def _to(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _or_at(t: torch.Tensor, index: tuple, vals: np.ndarray) -> torch.Tensor:
    """A copy of int32 ``t`` with ``vals`` (uint32 bit patterns) OR'd in
    at the unique positions ``index`` (int64 index tensors)."""
    out = t.clone()
    v = _to(vals.view(np.int32), np.int32, t.device)
    out[index] = out[index] | v
    return out


def apply_overlay(mirror: torch.Tensor, flat_idx: np.ndarray,
                  vals: np.ndarray, words: int) -> torch.Tensor:
    """OR deduplicated journal words into a dense int32 ``[rows, words]``
    mirror; returns the updated tensor (the old one stays as it was for
    any in-flight computation that captured it)."""
    dev = mirror.device
    return _or_at(mirror, (_to(flat_idx // words, np.int64, dev),
                           _to(flat_idx % words, np.int64, dev)), vals)


def apply_stack_overlay(stacked: torch.Tensor, member: np.ndarray,
                        flat_idx: np.ndarray, vals: np.ndarray,
                        words: int) -> torch.Tensor:
    """One indexed OR over a dense ``[S, rows, words]`` stack: ``member``
    names each word's stacked shard row, ``flat_idx`` its
    ``row * words + word`` offset within that member (unique per member,
    as ``merge_chunks`` leaves them)."""
    dev = stacked.device
    return _or_at(stacked, (_to(member, np.int64, dev),
                            _to(flat_idx // words, np.int64, dev),
                            _to(flat_idx % words, np.int64, dev)), vals)
