"""Multi-process execution: one engine spanning N processes, one per GPU,
over ``torch.distributed`` — the port of the JAX package's
``parallel/multihost.py``.

Two composition modes cover the reference's multi-node story (its
HTTP+protobuf data plane and gossip membership):

1. **Cluster of single-process nodes** (parallel/cluster.py): each
   process owns a shard subset on its own card; node-to-node traffic is
   the HTTP control plane.  The default deployment.

2. **One multi-process engine**: N processes join one process group.
   Each imports only its own contiguous shard slice
   (``import_process_slice``) and keeps shape-matched empty fragments
   for the others', so every rank sees the same shard set.  An
   ``Executor(holder, device=..., group=...)`` then stacks only this
   rank's shards and every cross-shard reduction is an explicit
   collective (``dist.all_reduce`` for the sums the JAX package's
   ``psum`` does, ``dist.all_gather`` for its per-shard ``all_gather``,
   parallel/stacked.py).  Every rank runs the same requests in lockstep
   and holds the same answers.  Use it when one index's working set
   exceeds a card but the query rate does not need independent
   replicas.

This module wires mode 2: ``init_distributed`` brings up the process
group (the rendezvous the reference's gossip played for membership).
The JAX package's ``global_mesh()`` has no counterpart: the group passed
to the executor takes its role.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import SHARD_WIDTH, VIEW_STANDARD


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int, backend: str | None = None,
                     device=None):
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens on ``coordinator`` ("host:port"); returns (group, device).

    ``backend=None`` picks ``nccl`` with device ``cuda:<local rank>``
    (one rank per GPU; the local rank is ``process_id`` modulo the cards
    this host has), or ``gloo`` when ``device`` is ``"cpu"``.  Ranks that
    share one card must pass ``backend="gloo"``: NCCL refuses two ranks
    on one device.  Nothing falls back from one backend to the other."""
    import torch.distributed as dist

    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range [0, {num_processes})")
    if device is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "ranks on the CPU over gloo")
        device = torch.device("cuda", process_id % n_cards)
    device = torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD, device


def close_distributed():
    """Leave the process group (every rank calls it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_range(n_shards: int, rank: int, world: int) -> tuple[int, int]:
    """The contiguous shard range ``rank`` of ``world`` owns under an
    even split of ``n_shards``."""
    per = (n_shards + world - 1) // world
    return min(rank * per, n_shards), min((rank + 1) * per, n_shards)


def shard_owner(shard: int, n_shards: int, world: int) -> int:
    """The rank whose ``shard_range`` holds ``shard`` (the last rank for
    a shard past ``n_shards``)."""
    per = (n_shards + world - 1) // world
    return min(shard // per, world - 1)


def process_shard_slice(n_shards: int, group=None) -> tuple[int, int]:
    """The contiguous shard range this process owns under an even split
    — the per-process partition for ``import_process_slice``."""
    import torch.distributed as dist

    return shard_range(n_shards, dist.get_rank(group),
                       dist.get_world_size(group))


def import_process_slice(field, rows, cols, n_shards: int,
                         max_row_id: int, group=None) -> tuple[int, int]:
    """Per-process import for mode 2: this process keeps only ITS shard
    slice's bits, and creates empty fragments for the other shards so
    that every rank holds the same shard set (the executor derives shard
    ownership from it, parallel/stacked.py).

    ``max_row_id``: the GLOBAL maximum row id across all processes.
    Every fragment grows to it, so row capacity agrees on every rank, as
    the JAX package requires for its executables' shapes.  Returns the
    local (lo, hi) shard range."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    lo, hi = process_shard_slice(n_shards, group)
    sel = (cols >= lo * SHARD_WIDTH) & (cols < hi * SHARD_WIDTH)
    field.import_bits(rows[sel], cols[sel])
    view = field._create_view_if_not_exists(VIEW_STANDARD)
    for s in range(n_shards):
        fr = view.create_fragment_if_not_exists(s)
        if fr.n_rows <= max_row_id:
            fr.set_row(max_row_id, None)  # grow capacity, no bits
    return lo, hi


def import_process_values(field, cols, values, n_shards: int,
                          bit_depth: int, group=None) -> tuple[int, int]:
    """``import_process_slice`` for an int field: this process imports
    its slice's values and creates empty fragments for the other shards
    in the field's BSI view, each grown to the GLOBAL ``bit_depth``,
    which the field's options take too: a range predicate's plan reads
    it, and its params length sizes the batch chunks every rank must
    agree on.  Returns the local (lo, hi) shard range."""
    from ..ops import bsi

    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    lo, hi = process_shard_slice(n_shards, group)
    sel = (cols >= lo * SHARD_WIDTH) & (cols < hi * SHARD_WIDTH)
    field.import_values(cols[sel], values[sel])
    field.options.bit_depth = max(field.options.bit_depth, bit_depth)
    view = field._create_view_if_not_exists(field.bsi_view_name())
    top = bsi.OFFSET_ROW + bit_depth - 1
    for s in range(n_shards):
        fr = view.create_fragment_if_not_exists(s)
        if fr.n_rows <= top:
            fr.set_row(top, None)  # grow to the global depth, no bits
    return lo, hi
