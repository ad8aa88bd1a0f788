"""Whole-query programs: ONE device program per PQL read request — the
port of the JAX package's ``parallel/wholequery.py``.

The executor lowers a read request to a tuple of ``plan.ReduceNode``s
(Count popcount-sums, TopN/Rows row-count accumulations, BSI slice
counts, Min/Max extremum scans, GroupBy combo grids, raw segments) plus
one params matrix per node.  ``run`` stages the request's inputs with
the stacked executor's own machinery (``_placed_groups``: its stack
cache, device budget, compressed staging and ingest overlays), then
runs the program body: per signature group it decodes packed entries on
first access (the ``decode_block`` kernel; a row count over a packed
field goes through the ``fused_row_counts`` kernel, once per filter row
b), evaluates every node's contribution over the group's leading shard
axis S (the JAX module's ``vmap`` over shards), and reduces in the
program — int32 sums over S and over groups, row-count vectors padded to
the widest group, BSI magnitude columns and totals added apart — where
the JAX module sums locally and ``psum``s over its mesh axis.

Over a device list (parallel/stacked.py: each group cut into one block a
device) the program is one body per device slot over that slot's blocks
(the JAX module's ``shard_map`` body over each device's local block),
run with that device current; the slots' outputs are then reduced onto
the primary outside the bodies (``_merge``): reducing kinds added as the
body adds its groups, ``segments`` and ``bsi_minmax`` outputs gathered in
group order.  One device is one body and no merge.

The body reads its params only as device tensors (``plan.eval_plan``'s
device form), so on a CUDA device it is captured ONCE per program key
into a CUDA graph (the JAX module's one XLA executable per signature)
and replayed after, one graph per device slot.  The first sighting of a
key runs the body eagerly:
a signature seen once (a one-off mix of calls) never pays a capture.
The second sighting captures it; that and every later sighting copies
its params into the graph's static ``[B_pad, P]`` buffers
(``pad_pow2_rows``: graphs are fixed-shape, which is why the JAX module
pads), replays, and copies the outputs out of the graph's memory before
the next replay may overwrite them.  On a CPU device the body runs
eagerly every time.  The path follows the tensors' device; there is no
knob, and a capture that fails raises.

Graph bookkeeping:

* The key is the JAX module's key (program repr, per-group present keys
  and signatures, padded params shapes, the executor's ``_exec_seq``)
  plus the identity of every staged input tensor.  An entry holds those
  tensors, so no address a graph baked in is freed under it; an entry
  dies with its stack (``StackedExecutor._drop_graphs``), and at most
  ``graphs_max`` entries are kept (LRU).
* All graphs of one device slot capture into ONE memory pool, made on
  that slot's device with its own side stream (``_open_pool``): replays
  are serialised by the dispatch batcher's launch lock and outputs are
  copied out, so the graphs' temporaries may share memory.  Each slot's
  capture runs with its device current, after
  ``torch.cuda.empty_cache()`` there.  A replay replays every slot's
  graph, then merges onto the primary: a graph cannot copy between
  cards.
* Captures run one at a time in the process (``_CAPTURE_LOCK``): the
  allocator aborts the process when a pool is torn down or its cache
  emptied while any thread captures.  So a dropped runner's pools wait
  in ``_RETIRED`` and are released under the lock before a capture;
  the garbage collector may drop a runner in the middle of another's
  capture.
* Kernel launches recorded at each slot's capture are added to
  ``kernels.LAUNCHES`` (and to that card's and slot's counts) on every
  replay (``kernels.count_replay``), so launches per request stay true.

Shapes the program cannot express raise ``WholeQueryUnsupported`` and
the executor reroutes to the grouped per-stage path (executor.py, the
fallback matrix).  Concurrent requests whose programs share a shape
fuse in the dispatch batcher (parallel/batcher.py) by concatenating each
node's params along the batch axis.

Deviations from the JAX module:

* ``precheck`` raises ``multiprocess-mesh`` only for a hand-built
  runner under a process group (the executor builds none there); a mesh
  of devices in one process runs its programs.  It raises
  ``streamed-working-set`` when the program's working set takes more
  than one slice of the shard schedule (parallel/stacked.py), before
  anything is staged or captured, so a streamed request is never
  captured into a CUDA graph.
* ``program_keys`` is sorted, so programs over one key set share one
  staged stack whatever their call order.
* Captures stand where compiles stand (utils/devobs.py).  ``sig`` is
  ``devobs.sig_of`` of the program key without the executor's
  ``_exec_seq`` (stable across restarts, so the warm-start corpus can
  name it); ``compiled`` says whether this launch captured its graph.
  ``_capture`` notes each capture in the process-wide registry
  (``devobs.COMPILES``) with its seconds and the fingerprint of the
  padded params and staged inputs, flagging a capture that replaces a
  graph the LRU evicted over the same inputs (the retrace rule is in
  the devobs docstring).  Every run — eager or replay — records one
  launch-ledger entry (``devobs.LEDGER``): the real rows against the
  ``pad_pow2_rows`` rows, the kernel launches it made, the dense bytes
  its decodes write, and the queue wait and ticket count the batcher
  set (``devobs.set_launch_ctx``).  ``dispatch_s`` is host time around
  the eager body or the replay, with no device synchronisation.  The
  runner also keeps its own counters (``snapshot``).
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..core import SHARD_WORDS
from ..executor.plan import _gather_rows_dev, eval_plan, params_to, \
    plan_inputs
from ..ops import bitset, bsi, containers, kernels
from ..utils import devobs
from ..utils import profile as qprof
from ..utils.deadline import check_current
from ..utils.faults import FAULTS
from ..utils.locks import make_rlock
from .stacked import _Frags, _flatten_present, _sig_rows, _unpack_frags, \
    on_device


# Every graph capture of the process, and the release of retired pools
# (module docstring).
_CAPTURE_LOCK = make_rlock("graph-capture")
# The pools of runners that were dropped: {slot: [pool, stream, graph]}
_RETIRED: list = []


def _release_retired():
    """Tear down the retired runners' pools (anchor graph first); the
    caller holds ``_CAPTURE_LOCK``."""
    while _RETIRED:
        pools = _RETIRED.pop()
        for entry in pools.values():
            entry[2] = None
        pools.clear()


class WholeQueryUnsupported(Exception):
    """A request (or runtime shape) the whole-query program cannot
    express.  The executor counts ``wholequery.fallback``, emits a
    structured log event naming the unsupported node, and reroutes to
    the grouped per-stage path — never a silent slow path."""

    def __init__(self, node: str, detail: str = ""):
        super().__init__(f"{node}: {detail}" if detail else node)
        self.node = node
        self.detail = detail


# Node kinds that carry a genuine batch axis: programs made only of
# these can fuse across concurrent requests in the dispatch batcher
# (params concatenate along B).  bsi_minmax has no batch axis and
# group_counts' leading axis is the combo grid, so programs containing
# them launch un-fused.
_BATCH_KINDS = frozenset({"count", "segments", "row_counts", "bsi_sum"})


def node_keys(node, stacked) -> list[tuple[str, str]]:
    """Deterministic (field, view) key list one reducer node reads."""
    if node.kind in ("count", "segments"):
        return plan_inputs(node.plan)
    if node.kind == "group_counts":
        keys = [node.primary]
        for k in node.extra[:-1]:
            if k not in keys:
                keys.append(k)
        for k in (plan_inputs(node.plan) if node.plan is not None else []):
            if k not in keys:
                keys.append(k)
        return keys
    return stacked.batch_keys(node.primary, node.plan)


def program_keys(program, stacked) -> list[tuple[str, str]]:
    """Union of every node's keys, sorted — the single stacked key list
    the whole request stages once."""
    out: set = set()
    for node in program:
        out.update(node_keys(node, stacked))
    return sorted(out)


def program_fused_only(program, stacked) -> frozenset:
    """The program's keys that only ``fused_row_counts`` reads: row-count
    primaries that no node decodes (``_row_counts_masked`` sends a packed
    primary to the fused kernel; every other read goes through
    ``_Frags``)."""
    decoded: set = set()
    for node in program:
        if node.kind == "row_counts":
            decoded.update(stacked._filter_keys(node.plan))
        else:
            decoded.update(node_keys(node, stacked))
    return frozenset(k for node in program if node.kind == "row_counts"
                     for k in [node.primary] if k not in decoded)


def pad_pow2_rows(mat: np.ndarray, repeat: bool = True) -> np.ndarray:
    """Pad a params matrix's row count up to a power of two so arbitrary
    batch sizes reuse a bounded set of captured programs.  ``repeat``
    duplicates the last row (always in-range); otherwise zero rows
    (GroupBy combo grids)."""
    B = mat.shape[0]
    pad = 1 << max(0, B - 1).bit_length()
    if pad == B:
        return mat
    if repeat:
        return np.concatenate([mat, np.repeat(mat[-1:], pad - B, axis=0)])
    return np.concatenate(
        [mat, np.zeros((pad - B,) + mat.shape[1:], mat.dtype)])


def _mat_rows(mat) -> int:
    return mat[0].shape[0] if isinstance(mat, tuple) else mat.shape[0]


class WholeOut:
    """One whole-query launch's unfetched device outputs.

    ``parts[i]`` is node i's device tensors (unfetched, so the executor
    keeps its dispatch-all-then-fetch-once pipeline); ``meta[i]``
    carries the host-assembly facts the finalizers need (per-group
    shard lists, fragment-less shards, actual batch rows)."""

    __slots__ = ("parts", "meta", "sig", "compiled", "rows_padded")

    def __init__(self, parts, meta, sig: str | None = None,
                 compiled: bool = False, rows_padded: int | None = None):
        self.parts = parts
        self.meta = meta
        # digest of the program key; None for the no-live-groups launch
        self.sig = sig
        # True when THIS launch captured its program (a cold signature)
        self.compiled = compiled
        # params rows the launch ran over, every node's (``pad_pow2_rows``
        # for a replay); None where no launch ran or on a per-ticket view
        self.rows_padded = rows_padded

    def slice_batch(self, program, node_lo: list[int], node_b: list[int]):
        """A fused launch's per-ticket view: slice every node's batch
        axis back out (batch-kind nodes only — fusibility is checked
        before tickets coalesce)."""
        parts, meta = [], []
        for ni, node in enumerate(program):
            lo, b = node_lo[ni], node_b[ni]
            m = dict(self.meta[ni])
            m["B"] = b
            if node.kind == "segments":
                parts.append([arr[:, lo:lo + b] for arr in self.parts[ni]])
            else:
                parts.append([arr[lo:lo + b] for arr in self.parts[ni]])
            meta.append(m)
        return WholeOut(parts, meta, self.sig, self.compiled)


def _row_counts_masked(frags, fused, key, mask):
    """Per-row popcounts ``[S, rows]`` (int32) of ``key``'s stack ANDed
    with ``mask`` ``[S, W]`` (None: unmasked).  A packed entry goes
    through the ``fused_row_counts`` kernel, which never writes the
    decoded words; a dense one ANDs and counts."""
    if key in fused:
        packed, sig = fused[key]
        return kernels.fused_row_counts(
            *packed, None if mask is None else mask.contiguous(),
            rows=sig[1], words=SHARD_WORDS)
    frag = frags.get(key)                                    # [S, rows, W]
    return bitset.row_counts(frag if mask is None
                             else frag & mask[:, None, :])


def _node_group(node, mat, frags, fused, S: int, device):
    """One reducer node's contribution from one signature group of S
    shards: summed over S for the reducing kinds, per shard for
    ``segments`` (``[S, B, W]``) and ``bsi_minmax``.  Shapes and the
    int32 accumulation mirror the JAX module's per-shard body, so
    results stay byte-identical."""
    lead = (S,)
    if node.kind in ("count", "segments"):
        segs = eval_plan(node.plan, frags, mat, lead=lead, device=device)
        if node.kind == "segments":
            return segs.transpose(0, 1)                      # [S, B, W]
        return bitset.popcount_words(segs).sum(
            dim=(-2, -1), dtype=torch.int32)                 # [B]
    B = mat.shape[0] if not isinstance(mat, tuple) else mat[0].shape[0]
    if node.kind == "row_counts":
        if node.plan is None:
            counts = _row_counts_masked(frags, fused, node.primary, None)
            return counts.sum(dim=0, dtype=torch.int32).expand(B, -1)
        masks = eval_plan(node.plan, frags, mat, lead=lead,
                          device=device)                     # [B, S, W]
        return torch.stack([
            _row_counts_masked(frags, fused, node.primary, masks[b])
            .sum(dim=0, dtype=torch.int32) for b in range(B)])  # [B, rows]
    frag = frags.get(node.primary)
    if node.kind == "bsi_sum":
        if node.plan is None:
            counts = bsi.sum_counts(frag).sum(dim=0, dtype=torch.int32)
            return counts.expand((B,) + tuple(counts.shape))
        filt = eval_plan(node.plan, frags, mat, lead=lead, device=device)
        return bsi.sum_counts(frag, filt).sum(
            dim=1, dtype=torch.int32)                        # [B, 2, d+1]
    if node.kind == "bsi_minmax":
        filt = None
        if node.plan is not None:
            filt = eval_plan(node.plan, frags, mat[:1], lead=lead,
                             device=device)[0]
        return bsi.min_max_bits(frag, filt,
                                want_max=node.extra[0] == "max")
    # group_counts: combos ride the leading axis of the rids matrix
    rids, params = mat
    fseg = None
    if node.plan is not None:
        fseg = eval_plan(node.plan, frags, params, lead=lead,
                         device=device)[0]                   # [S, W]
    out = []
    for c in range(rids.shape[0]):
        mask = fseg
        for j, pk in enumerate(node.extra[:-1]):
            pfrag = frags.get(pk)                            # [S, rows, W]
            if pfrag.shape[1] == 0:
                seg = torch.zeros((S, SHARD_WORDS), dtype=torch.int32,
                                  device=device)
            else:
                seg = _gather_rows_dev(pfrag, rids[c:c + 1, j])[0]
            mask = seg if mask is None else mask & seg
        out.append(_row_counts_masked(frags, fused, node.primary, mask)
                   .sum(dim=0, dtype=torch.int32))
    return torch.stack(out)                                  # [C, rows]


def _reduce_node(node, parts, info: dict, device, flat_outs: list):
    """Append one node's outputs, from the parts of its contributing
    groups (or device slots) in order, to ``flat_outs``: ``segments``
    and ``bsi_minmax`` parts pass through, the reducing kinds add in
    int32 — count vectors, BSI magnitude columns and totals apart, row
    counts padded to the widest (``info``, ``_combine_info``)."""
    if node.kind == "segments":
        flat_outs.extend(parts)                    # [S, B, W] per group
    elif node.kind == "bsi_minmax":
        for p in parts:                            # (bits, neg, cnt)
            flat_outs.extend(p)
    elif not parts:
        pass                                       # no contributing group
    elif node.kind == "count":
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        flat_outs.append(total)                    # [B]
    elif node.kind == "bsi_sum":
        D = info["depth"]
        acc = torch.zeros((parts[0].shape[0], 2, D + 1), dtype=torch.int32,
                          device=device)
        for s in parts:                            # [B, 2, d+1]
            d = s.shape[-1] - 1
            # magnitude counts and the trailing TOTAL column land
            # separately: groups of different bit depth must not add a
            # total into a magnitude slot
            acc[:, :, :d] += s[:, :, :d]
            acc[:, :, D] += s[:, :, d]
        flat_outs.append(acc)
    else:  # row_counts / group_counts
        acc = torch.zeros((parts[0].shape[0], info["rows"]),
                          dtype=torch.int32, device=device)
        for s in parts:                            # [B, rows_g]
            acc[:, :s.shape[1]] += s
        flat_outs.append(acc)


def _combine_info(program, sched, sig_maps) -> tuple:
    """Per node, the widths its contributing groups reduce to: the
    widest row count, or the deepest BSI depth."""
    def info(ni, node):
        if node.kind in ("row_counts", "group_counts"):
            return {"rows": max(
                (_sig_rows(sig_maps[gi][node.primary])
                 for gi in sched[ni]), default=0)}
        if node.kind == "bsi_sum":
            return {"depth": max(
                (_sig_rows(sig_maps[gi][node.primary]) - bsi.OFFSET_ROW
                 for gi in sched[ni]), default=0)}
        return {}
    return tuple(info(ni, node) for ni, node in enumerate(program))


class _SlotRun:
    """The part of one launch on one device slot: the slot, the indices
    of its live groups, the schedule over them (``sched`` restricted
    to them, renumbered) and the body over them."""

    __slots__ = ("slot", "gis", "sched", "body")

    def __init__(self, slot, gis, sched, body):
        self.slot = slot
        self.gis = gis
        self.sched = sched
        self.body = body


class _SlotGraph:
    """One device slot's captured graph of a program: the graph, its
    static params buffers and outputs, and the kernel launches one
    replay makes."""

    __slots__ = ("slot", "graph", "params", "outputs", "launches")

    def __init__(self, slot, graph, params, outputs, launches):
        self.slot = slot
        self.graph = graph
        self.params = params
        self.outputs = outputs
        self.launches = launches


class _GraphEntry:
    """One captured whole-query program: its graphs, one a device slot
    (``_SlotGraph``), the stacked tensors they read (held so their
    memory stays put), the stack cache key they were captured over, and
    the program's signature."""

    __slots__ = ("graphs", "inputs", "ckey", "sig")

    def __init__(self, graphs, inputs, ckey, sig):
        self.graphs = graphs
        self.inputs = inputs
        self.ckey = ckey
        self.sig = sig

    @property
    def launches(self) -> dict:
        """Kernel launches one replay of every slot's graph makes."""
        out: dict = {}
        for g in self.graphs:
            for k, n in g.launches.items():
                out[k] = out.get(k, 0) + n
        return out


def _mats_to(pad_mats, device):
    """Host params matrices -> int32 tensors on ``device``."""
    return [tuple(params_to(a, device) for a in m) if isinstance(m, tuple)
            else params_to(m, device) for m in pad_mats]


class WholeQueryRunner:
    """Stages and runs whole-query programs over a StackedExecutor,
    reusing its stacked-input staging and keeping its captured
    programs in the executor's ``_graphs`` cache."""

    # program keys seen once (run eagerly), remembered for their second
    # sighting's capture
    SEEN_MAX = 1024

    def __init__(self, stacked):
        self.stacked = stacked
        # device slot -> [memory pool, side stream, anchor graph]; when
        # the runner is dropped they are retired, not torn down
        self._pools: dict = {}
        weakref.finalize(self, _RETIRED.append, self._pools)
        self._seen: OrderedDict = OrderedDict()
        # graph keys the LRU evicted (the retrace rule, utils/devobs.py)
        self._evicted: OrderedDict = OrderedDict()
        # counters (chip_smoke.py and /debug/vars read ``snapshot``)
        self.runs = 0
        self.eager_runs = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    # -- shape probes ------------------------------------------------------

    def program_keys(self, program):
        return program_keys(program, self.stacked)

    def fusible(self, program) -> bool:
        return all(n.kind in _BATCH_KINDS for n in program)

    def precheck(self, program, holder, index, shards):
        """Raise WholeQueryUnsupported for shapes the single-program
        path cannot take; returns the program's stacked key list."""
        if self.stacked.multiprocess:
            # the executor builds no runner under a process group; this
            # guards a hand-built one: a captured graph cannot hold the
            # ranks' collectives
            raise WholeQueryUnsupported(
                "multiprocess-mesh",
                "collectives run eagerly on the grouped path")
        keys = self.program_keys(program)
        if keys and shards:
            sched = self.stacked.shard_schedule(
                holder, index, [keys], shards,
                [program_fused_only(program, self.stacked)])
            if len(sched.slices) > 1:
                raise WholeQueryUnsupported(
                    "streamed-working-set",
                    f"{len(sched.slices)} shard slices")
        return keys

    @staticmethod
    def _participates(node, sig_map) -> bool:
        """Whether a shape group contributes to a node (mirrors the
        grouped path's per-stage skip conditions exactly)."""
        if node.kind in ("count", "segments"):
            return True
        s0 = sig_map.get(node.primary)
        if s0 is None:
            return False
        if node.kind in ("bsi_sum", "bsi_minmax") and \
                _sig_rows(s0) < bsi.OFFSET_ROW + 1:
            return False
        if node.kind == "group_counts":
            return all(sig_map.get(pk) is not None
                       for pk in node.extra[:-1])
        return True

    # -- execution ---------------------------------------------------------

    def run(self, program, mats, holder, index, shards) -> WholeOut:
        """Stage the request's inputs and run the whole program as one
        device computation.  ``mats`` is one int32 params matrix per
        node ([B, P]; group_counts nodes carry (rids[C, Pk],
        params[Pf])).  Returns unfetched device parts per node."""
        st = self.stacked
        keys = self.precheck(program, holder, index, shards)
        FAULTS.hit("mesh.slice", key=index)
        check_current("whole-query dispatch")
        shards = list(shards)
        groups = st._placed_groups(keys, holder, index, shards) \
            if keys and shards else []

        # (shard_list, sig_map, flat, layout, pk, ps, slot) per block
        live = []
        empty_shards: list[int] = []
        for b in groups:
            shard_list, placed, sig = b
            if all(s is None for s in sig):
                empty_shards.extend(shard_list)
                continue
            present = st._present(keys, placed, sig)
            flat_g, layout_g = _flatten_present(present)
            live.append((shard_list, dict(zip(keys, sig)), flat_g,
                         layout_g, tuple(k for k, _, _ in present),
                         tuple(s for _, _, s in present), b.slot))

        exact_mats, pad_mats = [], []
        actual_b = []
        for node, mat in zip(program, mats):
            if node.kind == "group_counts":
                rids, params = mat
                rids = np.ascontiguousarray(rids, dtype=np.int32)
                params = np.asarray(params, dtype=np.int32).reshape(1, -1)
                actual_b.append(rids.shape[0])
                exact_mats.append((rids, params))
                pad_mats.append((pad_pow2_rows(rids, repeat=False),
                                 params))
            else:
                m = np.ascontiguousarray(mat, dtype=np.int32)
                actual_b.append(m.shape[0])
                exact_mats.append(m)
                pad_mats.append(pad_pow2_rows(m))

        # per-node schedule: which live groups contribute (static)
        sched = tuple(
            tuple(gi for gi, g in enumerate(live)
                  if self._participates(node, g[1]))
            for node in program)
        meta = self._node_meta(program, actual_b, live, sched,
                               empty_shards)
        if not live:
            return WholeOut([[] for _ in program], meta)  # no launch

        key = ("wholequery", repr(program),
               tuple((g[4], g[5]) for g in live),
               tuple(tuple(a.shape for a in m) if isinstance(m, tuple)
                     else m.shape for m in pad_mats),
               st._exec_seq)
        sig = devobs.sig_of(key[:-1])
        runs = self._slot_runs(program, live, sched)
        flats = [g[2] for g in live]
        self.runs += 1
        # row-count groups answered through the fused_row_counts entry
        # (the stacked executor's counter, one per node and group)
        st.fused_calls += sum(
            1 for ni, node in enumerate(program)
            if node.kind in ("row_counts", "group_counts")
            for gi in sched[ni] if live[gi][1][node.primary][0] == "z")
        t0 = time.perf_counter()
        if not self._use_graphs():
            with kernels.tallying_launches() as tally:
                outs = self._eager(runs, exact_mats, flats)
            compiled, launches, padded = False, sum(tally.values()), False
        else:
            outs, compiled, launches, padded = self._run_graph(
                key + (tuple(id(t) for f in flats for t in f),),
                (index, tuple(keys), tuple(shards)), runs, exact_mats,
                pad_mats, flats, sig, lambda: self._fingerprint(
                    pad_mats, live))
        outs = self._merge(program, live, sched, runs, outs)
        dt = time.perf_counter() - t0
        rows_padded = sum(_mat_rows(m)
                          for m in (pad_mats if padded else exact_mats))
        self._record(program, sig, live, actual_b, rows_padded, dt,
                     compiled, launches)
        parts = [[outs[j] for j in idxs]
                 for idxs in self._out_index(program, sched)]
        return WholeOut(parts, meta, sig, compiled, rows_padded)

    @staticmethod
    def _fingerprint(pad_mats, live) -> str:
        """Shape fingerprint of a capture: the padded params, then each
        group's staged inputs — a packed stack by its slot map only
        (its table and payload lengths are data; utils/devobs.py)."""
        args = [a for m in pad_mats
                for a in (m if isinstance(m, tuple) else (m,))]
        for g in live:
            i = 0
            for _k, n, _s in g[3]:
                args.append(g[2][i])
                i += n
        return devobs.fingerprint(args)

    def _record(self, program, sig, live, actual_b, rows_padded, dt,
                compiled, launches):
        """One launch-ledger entry and one profile event for this run:
        ``rows_padded`` the params rows it ran over (padded for a
        replay)."""
        st = self.stacked
        fused = program_fused_only(program, st)
        decode_bytes = tiles = 0
        for shard_list, _sig_map, flat, layout, _pk, _ps, _slot in live:
            i = 0
            for k, n, s in layout:
                if n > 1:
                    tiles += flat[i].numel()   # the slot map [S, tiles]
                    if k not in fused:
                        decode_bytes += (len(shard_list) * _sig_rows(s)
                                         * SHARD_WORDS * 4)
                i += n
        shards = sum(len(g[0]) for g in live)
        ctx = devobs.launch_ctx() or {}
        rows = ctx.get("rows")
        if rows is None:
            rows = sum(actual_b)
        devobs.LEDGER.record(
            sig=sig, kind="wholequery", shards=shards,
            shards_padded=shards, batch_rows=rows,
            batch_rows_padded=rows_padded,
            queue_s=ctx.get("queue_s", 0.0),
            tickets=ctx.get("tickets", 1), dispatch_s=dt,
            compiled=compiled, decode_bytes=decode_bytes,
            slice_pos=devobs.current_slice(),
            kernel_launches=launches,
            kernel_tiles=tiles if launches else 0)
        prof = qprof.current()
        if prof is not None:
            prof.event("device.launch", dt, kind="wholequery", sig=sig,
                       shards=shards, shardsPadded=shards,
                       batchRows=rows, batchRowsPadded=rows_padded,
                       decodeBytes=decode_bytes, compiled=compiled)

    def _node_meta(self, program, actual_b, live, sched, empty_shards):
        meta = []
        for ni, node in enumerate(program):
            m = {"B": actual_b[ni]}
            if node.kind == "segments":
                m["groups"] = [live[gi][0] for gi in sched[ni]]
                m["empty"] = list(empty_shards)
            elif node.kind == "bsi_minmax":
                m["groups"] = [live[gi][0] for gi in sched[ni]]
            meta.append(m)
        return meta

    @staticmethod
    def _out_index(program, sched) -> list[list[int]]:
        """Node -> indices into the body's flat outputs (mirrors the
        body's append order)."""
        out_index, n_out = [], 0
        for ni, node in enumerate(program):
            if node.kind in ("segments", "bsi_minmax"):
                n_here = len(sched[ni]) * (3 if node.kind == "bsi_minmax"
                                           else 1)
            else:
                n_here = 1 if sched[ni] else 0
            out_index.append(list(range(n_out, n_out + n_here)))
            n_out += n_here
        return out_index

    # -- the program body --------------------------------------------------

    def _slot_runs(self, program, live, sched) -> list:
        """One ``_SlotRun`` a device slot holding live groups, in slot
        order (one for a single device, over every group)."""
        runs = []
        for slot in sorted({g[6] for g in live}):
            gis = [gi for gi, g in enumerate(live) if g[6] == slot]
            pos = {gi: j for j, gi in enumerate(gis)}
            sub = tuple(tuple(pos[gi] for gi in s if gi in pos)
                        for s in sched)
            runs.append(_SlotRun(slot, gis, sub, self._body(
                program, [live[gi] for gi in gis], sub,
                self.stacked.devices[slot])))
        return runs

    def _eager(self, runs, mats, flats) -> list:
        """Every slot's body run eagerly over ``mats``, each with its
        device current; their outputs, one list a slot."""
        outs = []
        for r in runs:
            dev = self.stacked.devices[r.slot]
            with on_device(dev, r.slot):
                outs.append(r.body(_mats_to(mats, dev),
                                   [flats[gi] for gi in r.gis]))
        return outs

    def _merge(self, program, live, sched, runs, slot_outs) -> list:
        """The slots' outputs reduced onto the primary as one body over
        every live group would have returned them (the JAX module's
        ``psum`` and ``all_gather`` over its mesh axis)."""
        if len(runs) == 1 and runs[0].slot == 0:
            return slot_outs[0]
        dev = self.stacked.device
        combine = _combine_info(program, sched, [g[1] for g in live])
        slot_of = {gi: k for k, r in enumerate(runs) for gi in r.gis}
        per_slot = [[[slot_outs[k][j] for j in idxs]
                     for idxs in self._out_index(program, r.sched)]
                    for k, r in enumerate(runs)]
        flat_outs: list = []
        for ni, node in enumerate(program):
            if node.kind in ("segments", "bsi_minmax"):
                n = 3 if node.kind == "bsi_minmax" else 1
                taken = [0] * len(runs)
                parts = []
                for gi in sched[ni]:
                    k = slot_of[gi]
                    got = per_slot[k][ni][taken[k]:taken[k] + n]
                    taken[k] += n
                    got = [t.to(dev, non_blocking=True) for t in got]
                    parts.append(tuple(got) if n == 3 else got[0])
            else:
                parts = [t.to(dev, non_blocking=True)
                         for k in range(len(runs)) for t in per_slot[k][ni]]
            _reduce_node(node, parts, combine[ni], dev, flat_outs)
        return flat_outs

    def _body(self, program, live, sched, device):
        """The program body over (device params, per-group flat stacked
        tensors) on ``device``.  Everything it consults besides those
        two arguments is frozen static structure (nodes, layouts,
        schedule, combine shapes), so a captured graph replays it
        exactly."""
        groups_static = tuple((g[3], len(g[0])) for g in live)
        combine = _combine_info(program, sched, tuple(g[1] for g in live))

        def body(mats, flats):
            per_group: list[dict] = [dict() for _ in groups_static]
            for gi, (layout_g, S) in enumerate(groups_static):
                node_ids = [ni for ni in range(len(program))
                            if gi in sched[ni]]
                if not node_ids:
                    continue
                present = _unpack_frags(layout_g, flats[gi])
                frags = _Frags(present)
                fused = {k: (a, s) for k, a, s in present
                         if isinstance(a, containers.PackedStack)}
                for ni in node_ids:
                    per_group[gi][ni] = _node_group(
                        program[ni], mats[ni], frags, fused, S, device)

            flat_outs: list = []
            for ni, node in enumerate(program):
                _reduce_node(node, [per_group[gi][ni] for gi in sched[ni]],
                             combine[ni], device, flat_outs)
            return flat_outs

        return body

    # -- CUDA graphs -------------------------------------------------------

    def _use_graphs(self) -> bool:
        """CUDA graphs on a CUDA device; the body runs eagerly elsewhere."""
        return self.stacked.device.type == "cuda"

    def _run_graph(self, gkey, ckey, runs, exact_mats, pad_mats, flats,
                   sig, fp_fn):
        """Run the program for ``gkey``: eagerly on its first sighting
        (over the request's own rows, ``exact_mats``), else replay every
        slot's graph over the padded ``pad_mats``, captured now if this
        is its second.  Returns (outputs outside graph memory, one list
        a slot; captured now; kernel launches; whether the run was
        padded)."""
        st = self.stacked
        with st._sc_lock:
            entry = st._graphs.get(gkey)
            if entry is not None:
                st._graphs.move_to_end(gkey)
            first = entry is None and gkey not in self._seen
            if first:
                self._seen[gkey] = None
                while len(self._seen) > self.SEEN_MAX:
                    self._seen.popitem(last=False)
            evicted = entry is None and \
                self._evicted.pop(gkey, False) is None
        if first:
            self.eager_runs += 1
            with kernels.tallying_launches() as tally:
                outs = self._eager(runs, exact_mats, flats)
            return outs, False, sum(tally.values()), False
        captured = entry is None
        if captured:
            entry = self._capture(gkey, ckey, runs, pad_mats, flats, sig,
                                  fp_fn, evicted)
        # every slot's replay is queued before any output is read
        outs = []
        for g in entry.graphs:
            dev = st.devices[g.slot]
            with on_device(dev, g.slot):
                self._load_params(g, pad_mats)
                g.graph.replay()
                outs.append([o.clone() for o in g.outputs])
            kernels.count_replay(g.launches, dev.index, g.slot)
        self.replays += 1
        return outs, captured, sum(entry.launches.values()), True

    @staticmethod
    def _load_params(entry, pad_mats):
        """Copy this launch's padded params into one slot's graph
        buffers (``entry``: its ``_SlotGraph``)."""
        for buf, m in zip(entry.params, pad_mats):
            for b, a in (zip(buf, m) if isinstance(m, tuple)
                         else ((buf, m),)):
                if a.size:
                    b.copy_(torch.from_numpy(a).pin_memory(),
                            non_blocking=True)

    def _graph(self, fn, slot: int):
        """Capture ``fn()`` into a CUDA graph in slot ``slot``'s pool on
        its side stream, with its device current; returns (graph, fn's
        outputs, the kernel launches it recorded).  Raises if the
        capture fails."""
        dev = self.stacked.devices[slot]
        pool, side = self._pools[slot][:2]
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.device(dev), torch.cuda.stream(side), \
                kernels.recording_launches() as rec:
            graph.capture_begin(pool=pool.id,
                                capture_error_mode="thread_local")
            try:
                outputs = fn()
            except BaseException:
                # end the (now invalid) capture; fn's error is the one
                # reported
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        cur.wait_stream(side)
        return graph, outputs, rec

    def _open_pool(self, slot: int):
        """Slot ``slot``'s graph memory pool and side stream, made on
        its device at the slot's first capture."""
        if slot in self._pools:
            return
        dev = self.stacked.devices[slot]
        with torch.cuda.device(dev):
            self._pools[slot] = [torch.cuda.MemPool(),
                                 torch.cuda.Stream(dev), None]
        # The allocators count the graphs over a pool and free it when
        # the count drops to 0, which happens whenever every program is
        # dropped with its stacks (an ingest overlay); capturing into it
        # again then fails.  A one-op graph held for the runner's
        # lifetime keeps the pool open.
        self._pools[slot][2] = self._graph(
            lambda: torch.zeros(1, dtype=torch.int32, device=dev), slot)

    def _capture(self, gkey, ckey, runs, pad_mats, flats, sig, fp_fn,
                 evicted):
        """Capture every slot's body into a CUDA graph over static
        params buffers on its device, note the program in the capture
        registry and cache the entry, which it returns.  Raises if a
        capture fails."""
        st = self.stacked
        graphs = []
        t0 = time.perf_counter()
        for r in runs:
            dev = st.devices[r.slot]
            with on_device(dev, r.slot), _CAPTURE_LOCK:
                _release_retired()
                self._open_pool(r.slot)
                # A capture cannot release the caching allocator's free
                # cached blocks (the allocator frees them on an
                # out-of-memory only when no capture is underway), so
                # blocks that earlier work left cached can leave the
                # capture no room: release them first.  A capture
                # happens once per program and slot.
                torch.cuda.empty_cache()
                params = _mats_to(pad_mats, dev)
                fl = [flats[gi] for gi in r.gis]
                graph, outputs, rec = self._graph(
                    lambda body=r.body, params=params, fl=fl:
                    body(params, fl), r.slot)
            graphs.append(_SlotGraph(r.slot, graph, params, outputs, rec))
        dt = time.perf_counter() - t0
        self.capture_s += dt
        self.captures += 1
        devobs.COMPILES.note_call(sig, "wholequery", dt, fp_fn(),
                                  evicted=evicted)
        entry = _GraphEntry(graphs, [t for f in flats for t in f], ckey,
                            sig)
        with st._sc_lock:
            st._graphs[gkey] = entry
            while len(st._graphs) > st.graphs_max:
                old, _ = st._graphs.popitem(last=False)
                # a later capture of the same key (same staged inputs)
                # is a retrace: the LRU, not a re-stage, dropped it
                self._evicted[old] = None
                while len(self._evicted) > self.SEEN_MAX:
                    self._evicted.popitem(last=False)
        return entry

    def pool_reserved_bytes(self) -> int | None:
        """Bytes the allocator holds for the graphs' pools, every slot's
        (None before the first capture)."""
        if not self._pools:
            return None
        return sum(s["total_size"] for p in self._pools.values()
                   for s in p[0].snapshot())

    def held_sigs(self) -> set:
        """Signatures of the programs held as captured graphs now."""
        with self.stacked._sc_lock:
            return {e.sig for e in self.stacked._graphs.values()}

    def snapshot(self) -> dict:
        with self.stacked._sc_lock:
            held = len(self.stacked._graphs)
        return {"runs": self.runs, "eagerRuns": self.eager_runs,
                "captures": self.captures, "replays": self.replays,
                "captureS": round(self.capture_s, 6), "graphs": held}
