"""Stacked shard execution over a list of devices — the port of the JAX
package's ``parallel/mesh_exec.py``, whose mesh becomes a list of GPUs.

The reference fans per-shard jobs to a goroutine pool and a star reduce
(executor.go:2455 mapReduce).  Here shards whose input fragments share a
shape signature are STACKED along a leading shard axis and each reducer
runs once over the whole stack: the JAX package's ``vmap`` over shards
becomes the S axis, and its ``psum`` a sum over S.

Per key of a plan, a group's stacked input is either dense —
``[S, rows, W]`` int32 words — or, for compressed-resident fragments
(storage/fragment.py ``device_form``), a ragged ``PackedStack`` of the
members' packed container streams at their exact sizes, with its slot
map (ops/containers.py).  Packed inputs are decoded at op time through
the ``decode_block`` kernel (``_Frags``), and the TopN/Rows row counts of
a packed field go through the ``fused_row_counts`` kernel, which never
writes the decoded words (``_fused_entry``).  On the CPU both wrappers
run their plain PyTorch versions.

Stacks are cached against the fragments' data generations and charged to
the device budget (``_placed_groups``).  A cached dense stack whose
members have journaled ingest flushes since it was staged absorbs them
as one indexed OR over ``(member, row, word)`` (``_refresh_overlays``,
the JAX module's overlay refresh) instead of a re-stage;
``stack_builds`` and ``overlays`` count the two.

Reducers: ``count_async`` (Count), ``segments`` (bitmap calls),
``row_counts_async`` (TopN, Rows, MinRow/MaxRow),
``group_counts_batch_async`` (the GroupBy inner loop), ``bsi_sum_async``
and ``bsi_min_max`` (Sum, Min, Max), and the batched reducers of the
executor's grouped multi-call path and prepared statements —
``count_batch_async``, ``row_counts_batch_async`` and
``bsi_sum_batch_async`` — which evaluate B same-shape calls over one
``[B, P]`` params matrix (the JAX package's ``vmap`` over its rows is
the batched ``eval_plan``).  A packed BSI entry is decoded through
``_Frags`` (the ``decode_block`` kernel).  A filtered batched row count
over a packed field calls ``fused_row_counts`` once per filter row of
the chunk over the whole ragged stack: the same counts as the JAX
module's decode + masked popcount, without a ``[B, S, rows, W]``
temporary.  A filter-less batched group computes once and broadcasts
over B.

The device mesh (the JAX module's ``Mesh`` over ``jax.devices()`` and its
``NamedSharding(mesh, P(SHARD_AXIS))`` placement): ``StackedExecutor``
takes a list of devices, the first of them the *primary*.  Each
signature group's S members are cut along the shard axis into
``n_devices`` contiguous blocks, sizes differing by at most one (a block
is empty, and left out, when S < ``n_devices``), and block k is staged
on ``devices[k]`` (``Block``: the group's ``(shard_list, placed, sig)``
for that block, plus its ``slot`` k and ``device``).  Per-block state is
kept by slot, never keyed by ``torch.device``: ``["cpu"] * 8`` and
``[cuda:0, cuda:0]`` are meshes of 8 and 2 slots.  Every reducer
evaluates each block on its own device, under ``on_device`` (that card
current, the slot on the kernels' launch counts), issuing every block's
launches before it fetches anything, so the cards overlap.  The JAX
module's ``psum`` becomes ``_psum``: the blocks' partials copied to the
primary and added per signature group in slot order, exactly (int64);
its ``all_gather`` becomes ``_gather``: the blocks' per-shard outputs
copied to the primary and concatenated in slot order, which is shard
order.  A one-device list is the single-device path.  Under a process
group (multi-process mode below) each rank holds such a list, its own
mesh.

Deviations from the JAX module, by design:

* No pow2 shard bucketing (``_bucket`` / ``_pad_and_place``), and no
  container, payload, array-entry or run-count buckets in a compressed
  fragment's signature (``('z', rows, backend)``, storage/fragment.py):
  both exist for XLA's static shapes.  The kernels take a ragged stack,
  so every compressed shard of one row capacity joins one group and one
  launch.  The row capacity stays in the signature: merging capacities
  would pad rows, which every reducer would then have to treat as
  empty.
* Every compressed entry takes the fused kernel: the TPU's ``fits_vmem``
  rule does not apply on the card (ops/kernels.py).
* ``stacked_per_device(n)`` is ``ceil(n / n_devices)``, the JAX
  module's ``_bucket(n) // n_devices`` without the pow2 padding (under a
  process group, the largest slot block of any rank: below), and the
  shard schedule keeps the JAX rule that no slice is cut below
  ``n_devices`` shards.  The executor reaches the reducers through the
  cross-query dispatch batcher (parallel/batcher.py), which serialises
  their launches, every device's of one call under one lock.
* The decode-workspace ceiling sums, as the JAX module does, the dense
  bytes of every compressed key a dispatch decodes — a program's
  ``_Frags`` holds them together — but leaves out a row-count primary
  that only ``fused_row_counts`` reads (``fused_only``): that kernel
  never writes its decoded words, while the JAX estimate counts it.
  The smallest input where the cuts differ: one compressed row-count
  primary with no filter, whose decoded bytes alone exceed the
  workspace — the JAX module slices it, the port keeps one slice.
* The over-budget shard schedule (``shard_schedule``, ``_ShardSchedule``)
  stages slice k+1 on one background uploader thread while slice k
  computes, as the JAX module does.  The uploader issues each block's
  copies on its own device's default CUDA stream, the stream the compute
  thread launches that block's kernels on, so every stack it makes is
  stream-ordered before any kernel that reads it, and a stack the budget
  evicts after its slice's pins are released returns each block's
  memory to that device's caching allocator on that same stream, after
  the queued kernels that read it: no event fence or ``record_stream``
  is needed.  (A partial's copy to the primary runs on its source
  device's stream, and the primary's stream waits for it.)  The price is that the host-to-device copy does not overlap
  device compute; the host densify and the pageable-memory transfer
  overlap the consumer's host work.  Each yielded slice sets the
  launch ledger's slice position (``devobs.set_slice``), as the JAX
  module does.
* The whole-query program's cache (``_graphs``, the JAX module's
  executable cache keyed with ``_exec_seq``) holds captured CUDA graphs.
  A graph bakes in the addresses of the stacked tensors it read, so each
  entry keeps its stack alive, and a stack dropped from the stack cache
  — evicted, trimmed, re-staged or replaced by an overlay refresh —
  drops every graph captured over it (``_drop_graphs``).
* The overlay refresh returns new stacked tensors (ingest/delta.py
  ``apply_stack_overlay``), as the JAX module's un-donated scatter does,
  so a request that captured the old stack reads one consistent state.
  It is serialized under ``_ov_lock`` (the JAX module takes its executor
  lock).

Multi-process mode (``StackedExecutor(devices, group=...)``, the JAX
module's multi-process mesh over ``global_mesh()``, parallel/multihost.py):
W ranks hold the same shard set, each rank the data of its contiguous
slice of the index's shards (``multihost.shard_range``; the other shards
are empty placeholders), and each rank a device list of its own — one
card, several, or slots of a card it shares over gloo — as each JAX
process holds its local devices.  Ranks may hold different slot counts.
Every reducer stacks only this rank's shards of the requested set, cut
into one block a slot of its list (``split_blocks``), so the engine's
shard axis is rank-major, then slot-major, as the JAX global mesh lays
it out.  Each reducer first reduces the rank's slots onto its primary
(``_psum`` / ``_gather``, as one process does), then runs one fixed
collective sequence from the primary, the same on every rank whatever
its data, slot count or block count: the JAX module's ``psum`` becomes
``dist.all_reduce(SUM)`` of the reduced partials, padded to one length
agreed by an ``all_reduce(MAX)`` of the ranks' lengths (``_all_sum``);
its ``all_gather`` of per-shard outputs becomes ``dist.all_gather`` of
fixed-shape per-rank blocks (``segments``) or ``all_gather_object`` of
the ragged per-shard extrema (``bsi_min_max``).  A rank that holds none
of a group's shards, or fewer than its slots, joins the collectives
with zeros.  Afterwards every rank holds the same answer.  A grouped
request's batch chunks each end in collectives, so every rank must cut
them alike: ``stacked_per_device`` takes, given the request's shards,
the largest slot block of any rank (``ceil(owned / slots)`` of each
rank, from the ranks' slot counts gathered once, at the first such
request).  As in the JAX module, the overlay refresh re-stages instead
(a dense stack whose members journaled ingest since it was staged is
rebuilt), and the over-budget shard schedule is off: one slice.  One
deliberate deviation: the JAX module pins the dense form on a
multi-process mesh, because one global SPMD array needs placeholder
fragments of one shape.  Here there is no global array: each slot's
stacks, ragged ``PackedStack`` ones included, hold only its rank's own
shards, so compressed-resident fragments stay compressed and
``decode_block`` and ``fused_row_counts`` run in every slot of every
rank.  The answers are the same.
"""

from __future__ import annotations

import itertools
import time
import weakref
from collections import OrderedDict
from concurrent import futures
from contextlib import contextmanager

import numpy as np
import torch

from ..core import SHARD_WORDS
from . import multihost
from ..executor.plan import eval_plan, parametrize, plan_inputs
from ..ops import bitset, bsi, containers, kernels
from ..storage.membudget import DEFAULT_BUDGET
from ..utils import devobs
from ..utils import profile as qprof
from ..utils.deadline import check_current
from ..utils.faults import FAULTS
from ..utils.locks import make_lock
from ..utils.tracing import GLOBAL_TRACER

# Per-launch dense decode workspace ceiling: a shard slice whose
# compressed stacks decode to more dense bytes than this is cut into
# smaller slices, bounding the transient dense tiles one launch
# materialises.  Process-wide, set from the server config
# (decode-workspace-mb) like DEFAULT_BUDGET (the JAX module's
# ``DECODE_WORKSPACE_BYTES``).
DECODE_WORKSPACE_BYTES = 1 << 30


class _Frags:
    """The decode-at-op-time step (mesh_exec.py ``_unpack_frags``): a lazy
    (field, view) -> dense ``[S, rows, W]`` map over one group's present
    entries.  A packed entry is decoded (``decode_block`` kernel) on first
    access only, so a plan decodes just the fragments it reads — the eager
    counterpart of XLA dropping unused decodes."""

    def __init__(self, present):
        self._entries = {k: (a, s) for k, a, s in present}
        self._dense: dict = {}

    def get(self, key):
        if key in self._dense:
            return self._dense[key]
        entry = self._entries.get(key)
        if entry is None:
            return None
        a, s = entry
        if isinstance(a, containers.PackedStack):
            a = kernels.decode_block(*a, rows=s[1], words=SHARD_WORDS)
        self._dense[key] = a
        return a


def _fused_entry(present, key):
    """(packed arrays, sig) of ``key`` when its entry is compressed — the
    condition under which row counts route decode + filter-AND + popcount
    through one ``fused_row_counts`` launch — else None."""
    for k, a, s in present:
        if k == key:
            return (a, s) if isinstance(a, containers.PackedStack) \
                else None
    return None


def _sig_rows(shape) -> int:
    """Row count of a group-signature entry: dense entries are (rows,
    words), compressed ones ('z', rows, backend)."""
    return shape[1] if shape[0] == "z" else shape[0]


def _flatten_present(present):
    """Flatten present (key, placed, sig) entries into the tensor list a
    whole-query program reads: a compressed entry contributes its five
    ``PackedStack`` tensors, a dense one its stack.  Returns
    (flat, layout); ``layout`` — (key, n tensors, sig) per entry — is
    determined by the sigs and rebuilds the entries (``_unpack_frags``)."""
    flat, layout = [], []
    for k, a, s in present:
        if isinstance(a, containers.PackedStack):
            flat.extend(a)
            layout.append((k, len(a), s))
        else:
            flat.append(a)
            layout.append((k, 1, s))
    return flat, tuple(layout)


def _unpack_frags(layout, arrays):
    """The present entries rebuilt from ``layout`` and the flat tensors;
    wrap them in ``_Frags`` to decode packed ones on first access."""
    out, i = [], 0
    for k, n, s in layout:
        a = arrays[i] if n == 1 else containers.PackedStack(*arrays[i:i + n])
        out.append((k, a, s))
        i += n
    return out


class Block(tuple):
    """One device block of a signature group, as ``_placed_groups``
    returns it: the tuple ``(shard_list, placed, sig)`` — the block's
    shards, its stacked input per key, the group's signature — with
    ``slot``, its index in the executor's device list, ``device``
    (``devices[slot]``) and ``gid``, the first shard of its signature
    group, under which the mesh reductions join the group's blocks."""

    def __new__(cls, shard_list, placed, sig, slot, device, gid):
        b = super().__new__(cls, (shard_list, placed, sig))
        b.slot, b.device, b.gid = slot, device, gid
        return b


@contextmanager
def on_device(device, slot: int):
    """Run a block's work with ``device`` current (a CUDA card; nothing
    to switch on the CPU) and its launches counted under mesh ``slot``."""
    with kernels.on_slot(slot):
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def split_blocks(n: int, n_devices: int):
    """(slot, lo, hi) of the contiguous blocks ``n`` members are cut
    into over ``n_devices`` slots: sizes differ by at most one, the
    larger first; a slot whose block would be empty is left out."""
    q, r = divmod(n, n_devices)
    lo = 0
    for k in range(n_devices):
        hi = lo + q + (k < r)
        if hi > lo:
            yield k, lo, hi
        lo = hi


# Monotonic executor ids for program-cache keys: a collected executor's
# id() can be reused by the next one.
_EXEC_SEQ = itertools.count()


def field_rows(holder, index: str, field: str, view: str) -> int:
    """Max fragment row count for (field, view) — the ``rows`` axis of a
    batched row count's ``[B, S, rows, W]`` masked temporary, which the
    batch-chunk sizing must see (executor.batch_chunk_size).  0 when the
    view holds no fragments."""
    idx = holder.index(index)
    f = idx.field(field) if idx is not None else None
    v = f.view(view) if f is not None else None
    if v is None:
        return 0
    return max((fr.n_rows for fr in v.fragments.values()), default=0)


class StackedExecutor:
    """Executes resolved plans over stacked shard groups on a list of
    devices (module docstring)."""

    # Max combos per GroupBy dispatch (mesh_exec.GROUP_CHUNK).
    GROUP_CHUNK = 256
    # Slice target as a fraction of the budget: half, so the next slice
    # can stage (double-buffered) while the current one computes without
    # the pair exceeding the limit.
    STREAM_SLICE_FRACTION = 0.5

    def __init__(self, device, budget=None, group=None):
        """``device``: one device or a list of them (the mesh; the first
        is the primary)."""
        devices = device if isinstance(device, (list, tuple)) \
            else [device]
        self.devices = tuple(torch.device(d) for d in devices)
        # the primary: reductions land here and the host fetches here
        self.device = self.devices[0]
        # the mesh width: blocks a group is cut into, and the shard
        # schedule's minimum slice length
        self.n_devices = len(self.devices)
        # multi-process mode (module docstring): this rank's place in
        # the process group; one rank is the single-process path
        self.group = group
        self.rank, self.world = 0, 1
        if group is not None:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.multiprocess = self.world > 1
        # every rank's slot count, gathered at the first grouped request
        # that sizes batch chunks (stacked_per_device)
        self._rank_slots = None
        # (index, keys, shards) -> (gen token, groups): the stacked input
        # blocks, rebuilt only when a member fragment's data changes.
        # LRU-bounded, each entry charged to the device budget.
        self._stack_cache: OrderedDict = OrderedDict()
        self.stack_cache_max = 64
        self._budget = budget if budget is not None else DEFAULT_BUDGET
        # Leaf lock for _stack_cache dict ops only: budget eviction
        # callbacks race query threads on the dict.
        self._sc_lock = make_lock("stack-cache")
        # Serializes overlay refreshes of cached stacks (the JAX module
        # takes its executor lock there).
        self._ov_lock = make_lock("stack-overlay")
        # stacks staged from fragments, and ingest overlays OR'd into
        # cached stacks instead of a re-stage
        self.stack_builds = 0
        self.overlays = 0
        # row-count groups answered through the fused_row_counts entry
        self.fused_calls = 0
        # batched chunks dispatched (executor._run_batched_groups)
        self.batch_chunks = 0
        # whole-query programs (parallel/wholequery.py): key -> entry,
        # LRU-bounded; entries hold their stacks' tensors and die with
        # them (_drop_graphs)
        self._exec_seq = next(_EXEC_SEQ)
        self._graphs: OrderedDict = OrderedDict()
        self.graphs_max = 32
        # the shard schedule's background prefetch thread (lazy)
        self._uploader = None
        self._up_lock = make_lock("stack-uploader")
        self._finalizer = weakref.finalize(
            self, StackedExecutor._cleanup_budget, self._budget, id(self),
            self._stack_cache, self._graphs)

    @staticmethod
    def _cleanup_budget(budget, exec_id, stack_cache, graphs):
        for ck in list(stack_cache):
            budget.unregister(("stack", exec_id, ck))
        stack_cache.clear()
        graphs.clear()

    def stacked_per_device(self, n_shards: int, holder=None, index=None,
                           shards=None) -> int:
        """Stacked shards one slot's launch covers for ``n_shards``: its
        block of the shard axis, ``ceil(n / n_devices)``.  Under a
        process group, given the request's ``shards`` of ``index``, the
        largest block of any rank: ``ceil(owned / slots)`` of each rank's
        own shards and slot count.  Every rank computes it alike, so
        every rank cuts a batched group into the same chunks and issues
        the same collectives; the first call is a collective itself (the
        ranks' slot counts)."""
        if self.multiprocess and shards is not None:
            if self._rank_slots is None:
                self._rank_slots = self.gather_objects(self.n_devices)
            owned = [0] * self.world
            for r in self._owners(holder, index, shards):
                owned[r] += 1
            return max(1, max(-(-o // k) for o, k
                              in zip(owned, self._rank_slots)))
        return max(1, -(-n_shards // self.n_devices))

    def slot_bytes(self) -> list[int]:
        """Bytes of the cached stacks' blocks on each slot of the device
        list, dense and packed."""
        with self._sc_lock:
            groups = [v[1] for v in self._stack_cache.values()]
        out = [0] * self.n_devices
        for blocks in groups:
            for b in blocks:
                for p in b[1]:
                    if isinstance(p, torch.Tensor):
                        out[b.slot] += p.numel() * p.element_size()
                    elif p is not None:
                        out[b.slot] += sum(a.numel() * a.element_size()
                                           for a in p)
        return out

    def stacked_bytes(self, index: str) -> dict:
        """(field, view) -> {"bytes", "rows", "packed_bytes"} of the
        device stacks this executor holds for ``index``, summed over
        signature groups: ``bytes`` of every block, dense and packed,
        ``rows`` the widest dense ``[S, rows, W]`` block's rows (0 when
        only packed), ``packed_bytes`` the packed stacks' share.  A key
        held in several cached stacks (other key lists or shard sets)
        counts at its largest."""
        with self._sc_lock:
            entries = [(ck[1], v[1]) for ck, v in self._stack_cache.items()
                       if ck[0] == index]
        out: dict = {}
        for keys, groups in entries:
            per: dict = {}
            for _shards, placed, _sig in groups:
                for key, p in zip(keys, placed):
                    if p is None:
                        continue
                    acc = per.setdefault(
                        key, {"bytes": 0, "rows": 0, "packed_bytes": 0})
                    if isinstance(p, torch.Tensor):
                        acc["bytes"] += p.numel() * p.element_size()
                        acc["rows"] = max(acc["rows"], p.shape[1])
                    else:
                        nb = sum(a.numel() * a.element_size() for a in p)
                        acc["bytes"] += nb
                        acc["packed_bytes"] += nb
            for key, acc in per.items():
                if acc["bytes"] > out.get(key, {"bytes": -1})["bytes"]:
                    out[key] = acc
        return out

    def _drop_graphs(self, ckey):
        """Drop the whole-query programs captured over stack ``ckey``."""
        with self._sc_lock:
            for k in [k for k, e in self._graphs.items() if e.ckey == ckey]:
                del self._graphs[k]

    def close(self):
        """Stop the prefetch thread, unregister budget entries and drop
        cached stacks (the last two also run when an un-closed executor
        is garbage-collected)."""
        with self._up_lock:
            if self._uploader is not None:
                self._uploader.shutdown(wait=True, cancel_futures=True)
                self._uploader = None
        self._finalizer()

    def _uploader_pool(self):
        with self._up_lock:
            if self._uploader is None:
                self._uploader = futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ptpu-prefetch")
            return self._uploader

    # -- the device mesh's reductions ----------------------------------------

    def _psum(self, parts) -> list:
        """The mesh's ``psum``: ``[(block, partial)]`` of one slice ->
        one partial per signature group on the primary, the group's
        blocks copied there and added in slot order (the blocks of a
        group share its shapes)."""
        out: dict = {}
        for b, p in parts:
            p = p.to(self.device, non_blocking=True)
            out[b.gid] = p if b.gid not in out else out[b.gid] + p
        return list(out.values())

    def _gather(self, parts, dim: int = 0) -> list:
        """The mesh's ``all_gather``: ``[(block, output)]`` of one slice,
        an output a tensor or a tuple of tensors with the block's shards
        along ``dim`` -> ``(shard_list, output)`` per signature group on
        the primary, its blocks' outputs concatenated in slot order,
        which is shard order."""
        groups: dict = {}
        for b, t in parts:
            shards, outs = groups.setdefault(b.gid, ([], []))
            shards.extend(b[0])
            outs.append(tuple(x.to(self.device, non_blocking=True)
                              for x in (t if isinstance(t, tuple)
                                        else (t,))))
        res = []
        for shards, outs in groups.values():
            cat = tuple(c[0] if len(c) == 1 else torch.cat(c, dim)
                        for c in zip(*outs))
            res.append((shards, cat if isinstance(parts[0][1], tuple)
                        else cat[0]))
        return res

    # -- multi-process ownership and collectives ----------------------------

    def _owners(self, holder, index, shards) -> list[int]:
        """The rank owning each of ``shards``: the contiguous split of the
        index's shard count that ``multihost.import_process_slice``
        imports by (every rank holds the same shard set)."""
        idx = holder.index(index)
        n = max(idx.available_shards()) + 1 if idx is not None else 1
        return [multihost.shard_owner(s, n, self.world) for s in shards]

    def owned(self, holder, index, shards) -> list:
        """This rank's shards of ``shards`` (all of them on one rank)."""
        if not self.multiprocess:
            return list(shards)
        return [s for s, r in zip(shards, self._owners(holder, index,
                                                       shards))
                if r == self.rank]

    def agree_max(self, values) -> list[int]:
        """Element-wise maximum of an int vector over the ranks (the
        vector itself on one rank)."""
        values = [int(v) for v in values]
        if not self.multiprocess or not values:
            return values
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return [int(v) for v in t.cpu()]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order (``[obj]`` on one rank)."""
        if not self.multiprocess:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _all_sum(self, parts, lead: tuple, ragged: bool = True,
                 keep_last: bool = False) -> list:
        """The multi-process end of an additive reducer: this rank's
        parts (``lead`` + a last axis of per-part length when ``ragged``),
        each already reduced over the rank's slots onto its primary
        (``_psum``), summed into one block on the primary, zero-padded to
        the longest last axis of any rank, and ``all_reduce``-summed from
        the primary (the collective waits on the primary's current
        stream, which waits on each slot's copy).  ``keep_last``: the last
        entry of the last axis stays last (a BSI sum's not-null count
        after its magnitude bits).  Returns the reduced block as the
        reducer's one part; no part when every rank's last axis is
        empty, as one rank returns none when no group takes part."""
        import torch.distributed as dist
        n = None
        if ragged:
            (n,) = self.agree_max([max((p.shape[-1] for p in parts),
                                       default=0)])
            if n == 0:
                return []
        acc = torch.zeros(lead + ((n,) if ragged else ()),
                          dtype=torch.int64, device=self.device)
        for p in parts:
            if keep_last:
                acc[..., :p.shape[-1] - 1] += p[..., :-1]
                acc[..., -1] += p[..., -1]
            elif ragged:
                acc[..., :p.shape[-1]] += p
            else:
                acc += p
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self.group)
        return [acc]

    def _gather_shards(self, out: dict, holder, index, shards,
                       tail: tuple) -> dict:
        """The multi-process end of a per-shard reducer: this rank's
        ``{shard: host uint32 [*tail]}`` rows (its slots' outputs
        already gathered in slot order, ``_gather``), gathered as one fixed
        ``[K, *tail]`` block a rank (K: the most shards any rank owns of
        ``shards``, which every rank computes alike) and spread back to
        ``{shard: rows}`` over every requested shard."""
        import torch.distributed as dist
        owners = self._owners(holder, index, shards)
        per_rank = [[s for s, r in zip(shards, owners) if r == rank]
                    for rank in range(self.world)]
        k = max(len(p) for p in per_rank)
        block = np.zeros((k,) + tail, dtype=np.uint32)
        for i, s in enumerate(per_rank[self.rank]):
            block[i] = out[s]
        local = bitset.from_numpy(block, self.device)
        got = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(got, local, group=self.group)
        res = {}
        for rank, mine in enumerate(per_rank):
            host = bitset.to_numpy(got[rank])
            for i, s in enumerate(mine):
                res[s] = host[i]
        return res

    # -- shard grouping ----------------------------------------------------

    def _frag_sig(self, fr) -> tuple:
        return fr.device_sig(self.device)

    def _stack_token(self, keys, holder, index, shards):
        """(per-shard fragment rows, token, epochs).  The token holds
        every member's (device_gen, signature): a mutation, a budget
        change that flips a fragment between dense and compressed
        residency, or another backend all mint a new token and rebuild
        the stack.  ``epochs`` are the members' ingest epochs: a cached
        stack at the current token but older epochs takes the journal's
        overlay instead."""
        frags = [[holder.fragment(index, field, view, shard)
                  for field, view in keys] for shard in shards]
        token = tuple(
            -1 if fr is None else (fr.device_gen, self._frag_sig(fr))
            for row in frags for fr in row)
        epochs = tuple(
            0 if fr is None else fr.ingest_epoch
            for row in frags for fr in row)
        return frags, token, epochs

    def _is_resident(self, keys, holder, index, shards) -> bool:
        """Whether this (keys, shards) stack is cached AND current — the
        residency signal the shard schedule orders slices by."""
        _, token, _epochs = self._stack_token(keys, holder, index, shards)
        with self._sc_lock:
            cached = self._stack_cache.get(
                (index, tuple(keys), tuple(shards)))
        # an epoch lag still counts as resident: the overlay OR is a few
        # KB of device work, not a re-stage
        return cached is not None and cached[0] == token

    # -- over-budget shard streaming -----------------------------------------

    def fused_only(self, primary, filter_plan) -> frozenset:
        """The keys of a row-count dispatch (``batch_keys(primary,
        filter_plan)``) that only ``fused_row_counts`` reads: the
        primary, unless the filter reads it too and so decodes it."""
        if primary in self._filter_keys(filter_plan):
            return frozenset()
        return frozenset([primary])

    def _estimate_shard_bytes(self, keys, decoded, holder, index, shards):
        """Per-shard byte estimates over ``keys``: (resident, decode).
        Resident counts each fragment's device-resident form —
        compressed bytes for compressed-form fragments, the dense tensor
        otherwise — which is what occupies the budget between launches;
        decode counts the dense words the ``decode_block`` launches of
        one dispatch materialise from compressed fragments of the keys
        whose ``decoded`` flag is set (bounded together by
        DECODE_WORKSPACE_BYTES)."""
        res, dec = [], []
        for shard in shards:
            b = d = 0
            for (field, view), dk in zip(keys, decoded):
                fr = holder.fragment(index, field, view, shard)
                if fr is not None:
                    dense = fr.n_rows * SHARD_WORDS * 4
                    nb = fr.device_nbytes()
                    b += nb
                    if nb < dense and dk:
                        d += dense
            res.append(b)
            dec.append(d)
        return res, dec

    def shard_schedule(self, holder, index, key_lists, shards,
                       fused_only=None):
        """Residency-aware shard-slice schedule for a dispatch that will
        stack ``key_lists`` (one key list per distinct stacked block)
        over ``shards``.  ``fused_only``, when given, holds per key list
        the keys that only ``fused_row_counts`` reads (``fused_only()``):
        they occupy the budget but are never decoded.

        A working set that fits the budget (or an unlimited budget) gets
        ONE slice — the whole shard list, with cache keys identical to
        the unsliced path.  An over-budget set is carved into contiguous
        slices of at most STREAM_SLICE_FRACTION of the budget; slices
        already resident are ordered FIRST so a batch drains all work
        against staged data before rotating the budget, and iteration
        prefetches slice k+1 while slice k dispatches."""
        shards = list(shards)
        # bytes are estimated per key LIST occurrence, not the union:
        # each list stages its own stacked block, so a key shared by two
        # lists occupies device memory twice
        if fused_only is None:
            fused_only = [()] * len(key_lists)
        all_keys, decoded = [], []
        for kl, fo in zip(key_lists, fused_only):
            all_keys.extend(kl)
            decoded.extend(k not in fo for k in kl)
        limit = self._budget.limit_bytes
        slices = [shards]
        # multi-process: one slice (every rank must run one collective
        # sequence, and a rank's slicing depends on its own data)
        if limit and len(shards) > self.n_devices \
                and not self.multiprocess:
            per, dec = self._estimate_shard_bytes(all_keys, decoded, holder,
                                                  index, shards)
            ws = max(1, DECODE_WORKSPACE_BYTES)
            if sum(per) > limit or sum(dec) > ws:
                target = max(1, int(limit * self.STREAM_SLICE_FRACTION))
                # contiguous cuts, deterministic for a given (shards,
                # limit) so repeat queries hit the same slice cache keys;
                # never below n_devices shards a slice (1 here).  Two
                # ceilings: resident bytes against the streaming target
                # and decoded dense bytes against the workspace — a
                # fully-resident compressed working set still slices by
                # the latter.
                slices, cur, cur_b, cur_d = [], [], 0, 0
                for s, b, d in zip(shards, per, dec):
                    if (cur_b + b > target or cur_d + d > ws) and \
                            len(cur) >= self.n_devices:
                        slices.append(cur)
                        cur, cur_b, cur_d = [], 0, 0
                    cur.append(s)
                    cur_b += b
                    cur_d += d
                if slices and len(cur) < self.n_devices:
                    slices[-1].extend(cur)
                elif cur:
                    slices.append(cur)
                if len(slices) > 1:
                    # drain resident slices first (stable within each
                    # class so rotation order stays deterministic)
                    res = [all(self._is_resident(kl, holder, index, sl)
                               for kl in key_lists) for sl in slices]
                    slices = [sl for sl, r in zip(slices, res) if r] + \
                        [sl for sl, r in zip(slices, res) if not r]
        return _ShardSchedule(self, holder, index, key_lists, slices)

    def _pin_stack(self, keys, index, shard_slice) -> tuple | None:
        skey = ("stack", id(self), (index, tuple(keys), tuple(shard_slice)))
        return skey if self._budget.pin(skey) else None

    def _stream_slices(self, keys, holder, index, shards, fused_only=()):
        """``_placed_groups`` over the shard schedule, one block list a
        slice: the iteration surface of every un-batched reducer.  A
        single-slice schedule (the fits-in-budget case) is exactly one
        ``_placed_groups``."""
        for sl in self.shard_schedule(holder, index, [keys], shards,
                                      [fused_only]):
            yield self._placed_groups(keys, holder, index, sl)

    def _placed_groups(self, keys, holder, index, shards):
        """Group shards by input-shape signature over fragment keys
        [(field, view), ...], cut each group into one contiguous block a
        device (module docstring) and stack each block's fragments on
        its device.  Returns ``Block`` s ``(shard_list, placed_per_key,
        sig)``, group by group and, within a group, in slot order;
        ``placed_per_key[i]`` is None when key i's fragment is absent in
        the whole group, a ``PackedStack`` for a compressed entry, else
        the dense ``[S, rows, W]`` stack.  In multi-process mode only
        this rank's shards of ``shards`` are stacked, cut over this
        rank's slots."""
        shards = self.owned(holder, index, shards)
        frags, token, epochs = self._stack_token(keys, holder, index, shards)
        ckey = (index, tuple(keys), tuple(shards))
        skey = ("stack", id(self), ckey)
        with self._sc_lock:
            cached = self._stack_cache.get(ckey)
            if cached is not None and cached[0] == token:
                self._stack_cache.move_to_end(ckey)
        if cached is not None and cached[0] == token and \
                cached[2] != epochs and self.multiprocess:
            cached = None   # multi-process: re-stage, as the JAX module does
        if cached is not None and cached[0] == token:
            if cached[2] != epochs:
                # the stack is current at its device_gen token, but
                # member fragments have journaled ingest flushes since:
                # OR the missing chunks into the resident stacked blocks
                # instead of re-staging them
                out = self._refresh_overlays(ckey, token, frags, shards,
                                             keys, epochs, cached)
                if out is not None:
                    return out
                # a member folded its journal meanwhile: stage afresh
                return self._placed_groups(keys, holder, index, shards)
            self._budget.touch(skey)
            return cached[1]

        self.stack_builds += 1

        groups: dict[tuple, list[tuple[int, list]]] = {}
        for shard, row in zip(shards, frags):
            sig = tuple(None if fr is None
                        else self._frag_sig(fr) for fr in row)
            groups.setdefault(sig, []).append((shard, row))
        out = []
        nbytes = 0
        comp_bytes = 0
        for sig, group in groups.items():
            for slot, lo, hi in split_blocks(len(group), self.n_devices):
                dev = self.devices[slot]
                members = group[lo:hi]
                placed = []
                for i, shape in enumerate(sig):
                    if shape is None:
                        placed.append(None)
                        continue
                    frs = [m[1][i] for m in members]
                    if shape[0] == "z":
                        pk = self._place_packed_block(frs, shape, dev)
                        pb = sum(a.numel() * a.element_size() for a in pk)
                        nbytes += pb
                        comp_bytes += pb
                        placed.append(pk)
                        continue
                    # Warm (mirrors already resident on the device):
                    # stack there, no host transfer.  Cold: one host
                    # block, one transfer.
                    resident = sum(
                        1 for fr in frs
                        if not fr._device_dirty
                        and fr._mirrors.get(dev) is not None)
                    if 5 * resident >= 4 * len(frs):
                        arrs = [fr.device(dev) for fr in frs]
                        if all(tuple(a.shape) == shape for a in arrs):
                            p = torch.stack(arrs)
                        else:
                            # a concurrent write grew a fragment's
                            # capacity after the signature was read
                            p = self._place_host_block(frs, shape, dev)
                    else:
                        p = self._place_host_block(frs, shape, dev)
                    nbytes += p.numel() * p.element_size()
                    placed.append(p)
                out.append(Block([m[0] for m in members], placed, sig,
                                 slot, dev, group[0][0]))

        wself = weakref.ref(self)  # entries must not pin the executor

        def _evict(ck=ckey, tok=token):
            # guard on the registration's token VALUE: a deferred callback
            # that lost a race with a rebuild must not drop the fresh entry
            s = wself()
            if s is not None:
                with s._sc_lock:
                    cur = s._stack_cache.get(ck)
                    dropped = cur is not None and cur[0] == tok
                    if dropped:
                        del s._stack_cache[ck]
                if dropped:
                    s._drop_graphs(ck)

        with self._sc_lock:
            self._stack_cache[ckey] = (token, out, epochs)
            trimmed = []
            while len(self._stack_cache) > self.stack_cache_max:
                trimmed.append(self._stack_cache.popitem(last=False)[0])
        self._drop_graphs(ckey)           # programs over a replaced stack
        self._budget.register(skey, nbytes, _evict,
                              compressed_bytes=comp_bytes)
        for old_key in trimmed:
            self._budget.unregister(("stack", id(self), old_key))
            self._drop_graphs(old_key)
        return out

    def _refresh_overlays(self, ckey, token, frags, shards, keys,
                          new_epochs, cached):
        """OR journaled ingest flushes into the resident stacked blocks
        of a token-valid cache entry and return its groups.  Per dense
        group and key: gather every member fragment's unseen journal
        chunks, dedupe them on the host, and run one indexed OR over the
        ``[S, rows, W]`` stack — KBs of overlay transfer instead of a
        re-stage.  Compressed entries never appear here (their fragments
        fold instead of journaling).  A racing duplicate application is
        harmless: an OR of bits already present changes nothing.  Returns
        None when a member folded its journal after the token was read
        (the chunks it held are gone from the journal, so only a re-stage
        can reach them)."""
        from ..ingest.delta import apply_stack_overlay, merge_chunks
        nk = len(keys)
        row_of = {s: i for i, s in enumerate(shards)}
        with self._ov_lock:
            with self._sc_lock:
                cur = self._stack_cache.get(ckey)
            if cur is None or cur[0] != token:
                cur = cached   # evicted meanwhile: refresh the caller's copy
            if cur[2] == new_epochs:
                return cur[1]
            groups, old_epochs = cur[1], cur[2]
            out = []
            for b in groups:
                shard_list, placed, sig = b
                placed = list(placed)
                for ki in range(nk):
                    s_k = sig[ki]
                    if s_k is None or s_k[0] == "z":
                        continue
                    members, idxs, vals = [], [], []
                    for j, shard in enumerate(shard_list):
                        fr = frags[row_of[shard]][ki]
                        if fr is None:
                            continue
                        at = row_of[shard] * nk + ki
                        di, dv = merge_chunks(fr.delta_chunks(old_epochs[at]))
                        if fr.device_gen != token[at][0]:
                            return None
                        if di.size:
                            members.append(
                                np.full(di.size, j, dtype=np.int64))
                            idxs.append(di)
                            vals.append(dv)
                    if not members:
                        continue
                    placed[ki] = apply_stack_overlay(
                        placed[ki], np.concatenate(members),
                        np.concatenate(idxs), np.concatenate(vals),
                        SHARD_WORDS)
                    self.overlays += 1
                out.append(Block(shard_list, placed, sig, b.slot, b.device,
                                 b.gid))
            with self._sc_lock:
                cur2 = self._stack_cache.get(ckey)
                if cur2 is not None and cur2[0] == token:
                    self._stack_cache[ckey] = (token, out, new_epochs)
                    self._stack_cache.move_to_end(ckey)
            self._drop_graphs(ckey)       # they read the old tensors
            self._budget.touch(("stack", id(self), ckey))
            return out

    def _place_host_block(self, frs, shape, device) -> torch.Tensor:
        """Cold staging: densify a block's fragments into one host block
        and ship it to ``device`` in a single transfer."""
        block = np.zeros((len(frs),) + tuple(shape), np.uint32)
        for i, fr in enumerate(frs):
            dense = fr.staged_dense()
            r = min(dense.shape[0], shape[0])  # cap may race a grow
            block[i, :r] = dense[:r]
        return bitset.from_numpy(block, device)

    def _place_packed_block(self, frs, sig,
                            device) -> containers.PackedStack:
        """Compressed staging: lay the members' packed streams end to end
        (one ``packed_host()`` read each, sized from that read) with the
        slot map built on the host, and ship the stack to ``device``.
        Keys beyond the signature's row capacity, which a write that
        raced the signature can leave, are dropped, as the dense path
        slices to shape."""
        return containers.stack_packed(
            [fr.packed_host() for fr in frs],
            containers.tiles_of(sig[1], SHARD_WORDS), device)

    @staticmethod
    def _present(keys, placed, sig):
        return [(k, a, s) for k, a, s in zip(keys, placed, sig)
                if s is not None]

    def _filter_keys(self, filter_plan) -> list[tuple[str, str]]:
        return plan_inputs(filter_plan) if filter_plan is not None else []

    def batch_keys(self, primary: tuple[str, str],
                   filter_plan) -> list[tuple[str, str]]:
        """The stacked key list for a primary-fragment dispatch with an
        optional (slotted) filter plan."""
        return [primary] + [k for k in self._filter_keys(filter_plan)
                            if k != primary]

    @staticmethod
    def _slotted(filter_plan):
        if filter_plan is None:
            return None, np.zeros(0, dtype=np.int32)
        return parametrize(filter_plan)

    # -- reducers ------------------------------------------------------------
    # Each evaluates every block of a slice on its own device (``on_device``)
    # before it reduces the slice onto the primary (``_psum`` /
    # ``_gather``), so a mesh's cards run together.

    def count_async(self, plan, holder, index, shards) -> list:
        """Count: one popcount-sum per shape group; returns unfetched
        device scalars (int64)."""
        keys = plan_inputs(plan)
        slotted, params = parametrize(plan)
        parts = []
        for blocks in self._stream_slices(keys, holder, index, shards):
            sl = []
            for b in blocks:
                shard_list, placed, sig = b
                if all(s is None for s in sig):
                    continue  # no fragments -> plan evaluates to empty
                with on_device(b.device, b.slot):
                    frags = _Frags(self._present(keys, placed, sig))
                    seg = eval_plan(slotted, frags, params,
                                    lead=(len(shard_list),),
                                    device=b.device)
                    sl.append((b, bitset.count(seg)))
            parts.extend(self._psum(sl))
        if self.multiprocess:
            return self._all_sum(parts, (), ragged=False)
        return parts

    def count(self, plan, holder, index, shards) -> int:
        return sum(int(x) for x in self.count_async(
            plan, holder, index, shards))

    def _segments_slice(self, slotted, params, keys, blocks, zero,
                        out: dict):
        """Per-shard plan results of one slice's blocks into ``out``:
        host uint32 words, ``zero`` for a fragment-less group's shards.
        With a ``[B, P]`` params matrix the shard axis is axis 1."""
        segs = []
        for b in blocks:
            shard_list, placed, sig = b
            if all(s is None for s in sig):
                for shard in shard_list:
                    out[shard] = zero
                continue
            with on_device(b.device, b.slot):
                frags = _Frags(self._present(keys, placed, sig))
                segs.append((b, eval_plan(slotted, frags, params,
                                          lead=(len(shard_list),),
                                          device=b.device)))
        axis = 1 if params.ndim == 2 else 0
        for shard_list, seg in self._gather(segs, axis):
            host = bitset.to_numpy(seg)
            for i, shard in enumerate(shard_list):
                out[shard] = host[:, i] if axis else host[i]

    def segments(self, plan, holder, index, shards) -> dict[int, np.ndarray]:
        """Per-shard plan results as host uint32 words."""
        keys = plan_inputs(plan)
        slotted, params = parametrize(plan)
        out: dict[int, np.ndarray] = {}
        zero = np.zeros(SHARD_WORDS, dtype=np.uint32)
        for blocks in self._stream_slices(keys, holder, index, shards):
            self._segments_slice(slotted, params, keys, blocks, zero, out)
        if self.multiprocess:
            return self._gather_shards(out, holder, index, shards,
                                       (SHARD_WORDS,))
        return out

    def segments_batch(self, slotted, params_mat, holder, index,
                       shards) -> dict[int, np.ndarray]:
        """B same-shape bitmap calls over one ``[B, P]`` params matrix
        (the dispatch batcher's fused ``segments``): {shard: [B, W] host
        uint32 words}."""
        keys = plan_inputs(slotted)
        B = params_mat.shape[0]
        out: dict[int, np.ndarray] = {}
        self._segments_slice(
            slotted, params_mat, keys,
            self._placed_groups(keys, holder, index, shards),
            np.zeros((B, SHARD_WORDS), dtype=np.uint32), out)
        if self.multiprocess:
            return self._gather_shards(out, holder, index, shards,
                                       (B, SHARD_WORDS))
        return out

    @staticmethod
    def merge_counts(parts) -> np.ndarray:
        """Sum per-group count vectors of differing lengths (shape groups
        have different row capacities)."""
        from ..executor.results import acc_counts
        acc = np.zeros(0, dtype=np.int64)
        for p in parts:
            acc = acc_counts(acc, np.asarray(p, dtype=np.int64))
        return acc

    def row_counts_async(self, field: str, view: str, filter_plan, holder,
                         index, shards) -> list:
        """Per-row popcounts of (field, view) fragments over all shards,
        masked by ``filter_plan``'s result when given.  Returns unfetched
        per-group device vectors; combine with ``merge_counts``."""
        keys = self.batch_keys((field, view), filter_plan)
        fplan, params = self._slotted(filter_plan)
        parts = []
        for blocks in self._stream_slices(
                keys, holder, index, shards,
                self.fused_only((field, view), filter_plan)):
            sl = []
            for b in blocks:
                shard_list, placed, sig = b
                if sig[0] is None:
                    continue  # field fragment absent in this group
                with on_device(b.device, b.slot):
                    sl.append((b, self._block_row_counts(
                        b, keys, fplan, params)))
            parts.extend(self._psum(sl))
        if self.multiprocess:
            return self._all_sum(parts, ())
        return parts

    def _block_row_counts(self, b, keys, fplan, params):
        """One block's per-row popcounts of ``keys[0]`` under the
        filter plan (int64 ``[rows]``)."""
        shard_list, placed, sig = b
        present = self._present(keys, placed, sig)
        frags = _Frags(present)
        filt = None
        if fplan is not None:
            filt = eval_plan(fplan, frags, params, lead=(len(shard_list),),
                             device=b.device)
        fused = _fused_entry(present, keys[0])
        if fused is not None:
            # decode + filter-AND + per-row popcount in ONE launch; the
            # field's dense words never reach device memory
            packed, fs = fused
            self.fused_calls += 1
            counts = kernels.fused_row_counts(
                *packed, None if filt is None else filt.contiguous(),
                rows=fs[1], words=SHARD_WORDS)               # [S, rows]
        else:
            frag = frags.get(keys[0])                        # [S, rows, W]
            masked = frag if filt is None else frag & filt[:, None, :]
            counts = bitset.row_counts(masked)               # [S, rows]
        return counts.sum(dim=0, dtype=torch.int64)

    def row_counts(self, field: str, view: str, filter_plan, holder,
                   index, shards) -> np.ndarray:
        return self.merge_counts(
            p.cpu().numpy() for p in self.row_counts_async(
                field, view, filter_plan, holder, index, shards))

    # -- GroupBy inner loop (executor.go:1068 executeGroupBy) --------------

    def group_counts_batch_async(self, last_key: tuple[str, str],
                                 prefix_keys: list[tuple[str, str]],
                                 combos: np.ndarray, filter_plan, holder,
                                 index, shards) -> list:
        """All prefix combos of a GroupBy: ``combos`` is a [C, P] matrix
        of prefix row ids.  Returns [(lo, hi, parts)] where ``parts`` are
        [hi - lo, rows] count matrices (device, int64) covering
        combos[lo:hi], chunked to GROUP_CHUNK combos."""
        combos = np.asarray(combos, dtype=np.int64)
        out = []
        for lo in range(0, combos.shape[0], self.GROUP_CHUNK):
            sub = combos[lo: lo + self.GROUP_CHUNK]
            parts = self._group_counts_chunk(
                last_key, prefix_keys, sub, filter_plan, holder, index,
                shards)
            if self.multiprocess:
                parts = self._all_sum(parts, (sub.shape[0],))
            out.append((lo, lo + sub.shape[0], parts))
        return out

    def _group_counts_chunk(self, last_key, prefix_keys, combos,
                            filter_plan, holder, index, shards) -> list:
        keys = [last_key]
        for k in list(prefix_keys) + self._filter_keys(filter_plan):
            if k not in keys:
                keys.append(k)
        fplan, params = self._slotted(filter_plan)
        parts = []
        for blocks in self._stream_slices(keys, holder, index, shards):
            sl = []
            for b in blocks:
                shard_list, placed, sig = b
                if sig[0] is None:
                    continue
                key_to_sig = dict(zip(keys, sig))
                if any(key_to_sig[k] is None for k in prefix_keys):
                    continue
                with on_device(b.device, b.slot):
                    sl.append((b, self._block_group_counts(
                        b, keys, last_key, prefix_keys, combos, fplan,
                        params)))
            parts.extend(self._psum(sl))
        return parts

    def _block_group_counts(self, b, keys, last_key, prefix_keys, combos,
                            fplan, params):
        """One block's GroupBy counts ``[C, rows]`` (int64)."""
        shard_list, placed, sig = b
        dev = b.device
        frags = _Frags(self._present(keys, placed, sig))
        frag = frags.get(last_key)                           # [S, rows, W]
        fseg = None
        if fplan is not None:
            fseg = eval_plan(fplan, frags, params, lead=(len(shard_list),),
                             device=dev)
        counts = torch.empty((combos.shape[0], frag.shape[1]),
                             dtype=torch.int64, device=dev)
        for ci, rids in enumerate(combos):
            mask = fseg
            for pk, rid in zip(prefix_keys, rids):
                pfrag = frags.get(pk)
                if rid < pfrag.shape[1]:
                    seg = pfrag[:, int(rid), :]
                else:
                    seg = torch.zeros((pfrag.shape[0], SHARD_WORDS),
                                      dtype=torch.int32, device=dev)
                mask = seg if mask is None else mask & seg
            masked = frag if mask is None else frag & mask[:, None, :]
            counts[ci] = bitset.row_counts(masked).sum(
                dim=0, dtype=torch.int64)
        return counts

    # -- BSI aggregations (fragment.go:1111 sum, :1147 min/max) ------------

    def _bsi_slices(self, field: str, view: str, filter_plan, params,
                    holder, index, shards, fn, stream: bool = True):
        """Per slice, ``[(block, fn(bsi stack [S, rows, W], filter))]``
        over the blocks holding the BSI fragment at full BSI depth, each
        evaluated on its own device; the filter is the plan's result
        (``[S, W]``, or ``[B, S, W]`` for a ``[B, P]`` params matrix) or
        None.  ``stream=False``: the caller passes a pre-scheduled shard
        slice (the batched reducers)."""
        keys = self.batch_keys((field, view), filter_plan)
        slices = self._stream_slices(keys, holder, index, shards) \
            if stream else [self._placed_groups(keys, holder, index, shards)]
        for blocks in slices:
            sl = []
            for b in blocks:
                shard_list, placed, sig = b
                if sig[0] is None or \
                        _sig_rows(sig[0]) < bsi.OFFSET_ROW + 1:
                    continue
                with on_device(b.device, b.slot):
                    frags = _Frags(self._present(keys, placed, sig))
                    filt = None
                    if filter_plan is not None:
                        filt = eval_plan(filter_plan, frags, params,
                                         lead=(len(shard_list),),
                                         device=b.device)
                    sl.append((b, fn(frags.get(keys[0]), filt)))
            yield sl

    def bsi_sum_async(self, field: str, view: str, filter_plan, holder,
                      index, shards) -> list:
        """The per-slice popcounts of Sum: unfetched int64 ``[2, depth+1]``
        device matrices, one per signature group; combine with
        ``bsi.weighted_sum`` per part and add."""
        fplan, params = self._slotted(filter_plan)
        parts = []
        for sl in self._bsi_slices(
                field, view, fplan, params, holder, index, shards,
                lambda frag, filt: bsi.sum_counts(frag, filt).sum(
                    dim=0, dtype=torch.int64)):
            parts.extend(self._psum(sl))
        if self.multiprocess:
            return self._all_sum(parts, (2,), keep_last=True)
        return parts

    def bsi_min_max(self, field: str, view: str, filter_plan, holder,
                    index, shards, want_max: bool) -> list:
        """Per-shard extremum bits narrowed on the device and fetched to
        the host: a list of (value, count) per shard."""
        fplan, params = self._slotted(filter_plan)
        out = []
        for sl in self._bsi_slices(
                field, view, fplan, params, holder, index, shards,
                lambda frag, filt: bsi.min_max_bits(frag, filt,
                                                    want_max=want_max)):
            for shard_list, got in self._gather(sl):
                bits, neg, cnt = (x.cpu().numpy() for x in got)
                out.extend(bsi.reconstruct_min_max(bits[i], int(neg[i]),
                                                   int(cnt[i]))
                           for i in range(len(shard_list)))
        if self.multiprocess:
            return [x for part in self.gather_objects(out) for x in part]
        return out

    # -- batched variants: B same-shape calls over one [B, P] params -------
    # A multi-call request's same-shape calls (64 distinct Sums, say)
    # evaluate as one chain of launches over the matrix's B rows.

    def count_batch_async(self, slotted, params_mat, holder, index,
                          shards) -> list:
        """B counts that share one plan shape; parts are int64 [B]."""
        keys = plan_inputs(slotted)
        sl = []
        # no _stream_slices in the batched reducers: their callers
        # (_run_batched_groups and the dispatch batcher) own the slice
        # schedule and pass pre-scheduled shard slices
        for b in self._placed_groups(keys, holder, index, shards):
            shard_list, placed, sig = b
            if all(s is None for s in sig):
                continue
            with on_device(b.device, b.slot):
                frags = _Frags(self._present(keys, placed, sig))
                segs = eval_plan(slotted, frags, params_mat,
                                 lead=(len(shard_list),), device=b.device)
                sl.append((b, bitset.popcount_words(segs).sum(
                    dim=(-2, -1), dtype=torch.int64)))         # [B]
        parts = self._psum(sl)
        if self.multiprocess:
            return self._all_sum(parts, (params_mat.shape[0],),
                                 ragged=False)
        return parts

    def row_counts_batch_async(self, field: str, view: str, slotted_filter,
                               params_mat, holder, index, shards) -> list:
        """B row-count passes sharing one filter shape; parts are int64
        [B, rows]."""
        keys = self.batch_keys((field, view), slotted_filter)
        B = params_mat.shape[0]
        sl = []
        for b in self._placed_groups(keys, holder, index, shards):
            shard_list, placed, sig = b
            if sig[0] is None:
                continue
            with on_device(b.device, b.slot):
                present = self._present(keys, placed, sig)
                frags = _Frags(present)
                fused = _fused_entry(present, keys[0])
                masks = None
                if slotted_filter is not None:
                    masks = eval_plan(slotted_filter, frags, params_mat,
                                      lead=(len(shard_list),),
                                      device=b.device)       # [B, S, W]
                if fused is not None:
                    packed, fs = fused
                    self.fused_calls += 1
                    filts = [None] if masks is None else \
                        [masks[i].contiguous() for i in range(B)]
                    counts = torch.stack([kernels.fused_row_counts(
                        *packed, f, rows=fs[1], words=SHARD_WORDS).sum(
                            dim=0, dtype=torch.int64) for f in filts])
                else:
                    frag = frags.get(keys[0])                # [S, rows, W]
                    masked = frag[None] if masks is None \
                        else frag[None] & masks[:, :, None, :]
                    counts = bitset.row_counts(masked).sum(
                        dim=1, dtype=torch.int64)            # [B|1, rows]
                # a filter-less group computes once and broadcasts over B
                sl.append((b, counts.expand(B, -1)))
        parts = self._psum(sl)
        if self.multiprocess:
            return self._all_sum(parts, (B,))
        return parts

    def bsi_sum_batch_async(self, field: str, view: str, slotted_filter,
                            params_mat, holder, index, shards) -> list:
        """B BSI sums sharing one filter shape; parts are int64
        [B, 2, depth+1]."""
        B = params_mat.shape[0]

        def fn(frag, filt):
            counts = bsi.sum_counts(frag, filt)      # [B|-, S, 2, depth+1]
            if filt is None:
                return counts.sum(dim=0, dtype=torch.int64).expand(
                    (B,) + tuple(counts.shape[1:]))
            return counts.sum(dim=1, dtype=torch.int64)

        (sl,) = self._bsi_slices(field, view, slotted_filter, params_mat,
                                 holder, index, shards, fn, stream=False)
        parts = self._psum(sl)
        if self.multiprocess:
            return self._all_sum(parts, (B, 2), keep_last=True)
        return parts


class _ShardSchedule:
    """Iterable of shard slices with prefetch and pinning (the JAX
    module's ``_ShardSchedule``).

    While the consumer stages and dispatches against slice k, one
    background uploader stages slice k+1 (host densify and device
    placement off the critical path).  Both the in-use and the
    prefetched slices' budget entries are pinned so concurrent staging
    cannot evict them mid-use; pins release once each slice's launches
    are enqueued (the module docstring says why that is safe on one
    stream)."""

    def __init__(self, stacked, holder, index, key_lists, slices):
        self.stacked = stacked
        self.holder = holder
        self.index = index
        self.key_lists = key_lists
        self.slices = slices

    @property
    def max_slice_len(self) -> int:
        return max((len(s) for s in self.slices), default=0)

    def _stage(self, shard_slice) -> list[tuple]:
        """Stage every key list's stack for one slice and pin the
        entries; returns the pinned budget keys.  On a mid-stage failure
        every pin taken so far is released before re-raising — a leaked
        pin would shrink the budget for the process lifetime."""
        pinned = []
        try:
            for kl in self.key_lists:
                self.stacked._placed_groups(kl, self.holder, self.index,
                                            shard_slice)
                skey = self.stacked._pin_stack(kl, self.index, shard_slice)
                if skey is not None:
                    pinned.append(skey)
        except BaseException:
            for k in pinned:
                self.stacked._budget.unpin(k)
            raise
        return pinned

    def _slice_event(self, prof, i, sl, t0, up0, ev0):
        """One per-slice profile stage: wall time plus the budget's
        upload / evict deltas the slice drove."""
        budget = self.stacked._budget
        prof.event("device.slice", time.perf_counter() - t0,
                   slice=i, shards=len(sl),
                   uploadBytes=budget.upload_bytes - up0,
                   evictions=budget.evictions - ev0)

    def __iter__(self):
        # deadline + failpoint gate per slice: an expired query aborts
        # BETWEEN shard slices, and the finally below releases its pins
        prof = qprof.current()
        budget = self.stacked._budget
        if len(self.slices) <= 1:
            try:
                for sl in self.slices:
                    FAULTS.hit("mesh.slice", key=self.index)
                    check_current("mesh shard slice")
                    devobs.set_slice(0, 1)
                    if prof is None:
                        yield sl
                    else:
                        t0, up0, ev0 = (time.perf_counter(),
                                        budget.upload_bytes,
                                        budget.evictions)
                        yield sl
                        self._slice_event(prof, 0, sl, t0, up0, ev0)
            finally:
                devobs.set_slice(None)
            return
        pool = self.stacked._uploader_pool()
        fut = None   # in-flight prefetch of the slice about to be served
        pins: list = []
        try:
            for i, sl in enumerate(self.slices):
                FAULTS.hit("mesh.slice", key=self.index)
                check_current("mesh shard slice")
                t0, up0, ev0 = (time.perf_counter(), budget.upload_bytes,
                                budget.evictions)
                if fut is not None:
                    # a hit means the uploader finished BEFORE the
                    # consumer got here (done() before result(), which
                    # blocks) and the stacks are still token-valid
                    done = fut.done()
                    try:
                        pins.extend(fut.result())
                        budget.note_prefetch(done and all(
                            self.stacked._is_resident(
                                kl, self.holder, self.index, sl)
                            for kl in self.key_lists))
                    except (Exception, futures.CancelledError):
                        # close() cancelling a queued prefetch degrades
                        # to inline staging, counted as a miss
                        budget.note_prefetch(False)
                    fut = None
                # cold slices stage here; prefetched ones hit the cache
                pins.extend(self._stage(sl))
                if i + 1 < len(self.slices):
                    fut = pool.submit(
                        GLOBAL_TRACER.task(self._stage,
                                           name="mesh.prefetch_slice"),
                        self.slices[i + 1])
                # launch-ledger slice position: launches between this
                # yield and the next run against slice i
                devobs.set_slice(i, len(self.slices))
                yield sl
                # the consumer enqueued its launches against this slice
                # between the yield and here: let the budget rotate it
                if prof is not None:
                    self._slice_event(prof, i, sl, t0, up0, ev0)
                for k in pins:
                    budget.unpin(k)
                pins = []
        finally:
            devobs.set_slice(None)
            for k in pins:
                budget.unpin(k)
            if fut is not None:
                try:
                    for k in fut.result():
                        budget.unpin(k)
                # lint: allow(swallowed-exception) — a failed prefetch
                # already shows as a prefetch miss and a re-stage; this
                # finally only releases its pins
                except (Exception, futures.CancelledError):
                    pass
