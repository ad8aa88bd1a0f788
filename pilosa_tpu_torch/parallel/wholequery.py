"""Whole-query programs: ONE device program per PQL read request — the
port of the JAX package's ``parallel/wholequery.py`` for one GPU.

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

The body reads its params only as device tensors (``plan.eval_plan``'s
device form), so on a CUDA device it is captured ONCE per program key
into a CUDA graph (the JAX module's one XLA executable per signature)
and replayed after.  The first sighting of a key runs the body eagerly:
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
* All graphs capture into ONE memory pool: replays are serialised by the
  dispatch batcher's launch lock and outputs are copied out, so the
  graphs' temporaries may share memory.
* Kernel launches recorded at capture are added to ``kernels.LAUNCHES``
  on every replay (``kernels.count_replay``), so launches per request
  stay true.

Shapes the program cannot express raise ``WholeQueryUnsupported`` and
the executor reroutes to the grouped per-stage path (executor.py, the
fallback matrix).  Concurrent requests whose programs share a shape
fuse in the dispatch batcher (parallel/batcher.py) by concatenating each
node's params along the batch axis.

Deviations from the JAX module:

* One device: ``precheck`` never raises ``multiprocess-mesh``.  It
  raises ``streamed-working-set`` when the program's working set takes
  more than one slice of the shard schedule (parallel/stacked.py), before
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
from .stacked import _Frags, _flatten_present, _sig_rows, _unpack_frags


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

    __slots__ = ("parts", "meta", "sig", "compiled")

    def __init__(self, parts, meta, sig: str | None = None,
                 compiled: bool = False):
        self.parts = parts
        self.meta = meta
        # digest of the program key; None for the no-live-groups launch
        self.sig = sig
        # True when THIS launch captured its program (a cold signature)
        self.compiled = compiled

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


class _GraphEntry:
    """One captured whole-query program: the graph, its static params
    buffers and outputs, the stacked tensors it reads (held so their
    memory stays put), the stack cache key it was captured over, and
    the kernel launches one replay makes."""

    __slots__ = ("graph", "params", "outputs", "inputs", "ckey",
                 "launches", "sig")

    def __init__(self, graph, params, outputs, inputs, ckey, launches,
                 sig):
        self.graph = graph
        self.params = params
        self.outputs = outputs
        self.inputs = inputs
        self.ckey = ckey
        self.launches = launches
        self.sig = sig


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
        self._pool = None
        self._side = None
        self._anchor = None
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

        live = []           # (shard_list, sig_map, flat, layout, pk, ps)
        empty_shards: list[int] = []
        for shard_list, placed, sig in groups:
            if all(s is None for s in sig):
                empty_shards.extend(shard_list)
                continue
            present = st._present(keys, placed, sig)
            flat_g, layout_g = _flatten_present(present)
            live.append((shard_list, dict(zip(keys, sig)), flat_g,
                         layout_g, tuple(k for k, _, _ in present),
                         tuple(s for _, _, s in present)))

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
        body = self._body(program, live, sched)
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
                outs = body(_mats_to(exact_mats, st.device), flats)
            compiled, launches, padded = False, sum(tally.values()), False
        else:
            outs, compiled, launches, padded = self._run_graph(
                key + (tuple(id(t) for f in flats for t in f),),
                (index, tuple(keys), tuple(shards)), body, exact_mats,
                pad_mats, flats, sig, lambda: self._fingerprint(
                    pad_mats, live))
        dt = time.perf_counter() - t0
        self._record(program, sig, live, actual_b,
                     pad_mats if padded else exact_mats, dt, compiled,
                     launches)
        parts = [[outs[j] for j in idxs]
                 for idxs in self._out_index(program, sched)]
        return WholeOut(parts, meta, sig, compiled)

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

    def _record(self, program, sig, live, actual_b, run_mats, dt,
                compiled, launches):
        """One launch-ledger entry and one profile event for this run:
        ``run_mats`` are the params it ran over (padded for a replay)."""
        st = self.stacked
        fused = program_fused_only(program, st)
        decode_bytes = tiles = 0
        for shard_list, _sig_map, flat, layout, _pk, _ps in live:
            i = 0
            for k, n, s in layout:
                if n > 1:
                    tiles += flat[i].numel()   # the slot map [S, tiles]
                    if k not in fused:
                        decode_bytes += (len(shard_list) * _sig_rows(s)
                                         * SHARD_WORDS * 4)
                i += n
        shards = sum(len(g[0]) for g in live)
        rows_padded = sum(_mat_rows(m) for m in run_mats)
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

    def _body(self, program, live, sched):
        """The program body over (device params, per-group flat stacked
        tensors).  Everything it consults besides those two arguments is
        frozen static structure (nodes, layouts, schedule, combine
        shapes), so a captured graph replays it exactly."""
        device = self.stacked.device
        groups_static = tuple((g[3], len(g[0])) for g in live)
        sig_maps = tuple(g[1] for g in live)

        def _combine_info(ni, node):
            if node.kind in ("row_counts", "group_counts"):
                return {"rows": max(
                    (_sig_rows(sig_maps[gi][node.primary])
                     for gi in sched[ni]), default=0)}
            if node.kind == "bsi_sum":
                return {"depth": max(
                    (_sig_rows(sig_maps[gi][node.primary])
                     - bsi.OFFSET_ROW for gi in sched[ni]), default=0)}
            return {}

        combine = tuple(_combine_info(ni, node)
                        for ni, node in enumerate(program))

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
                parts = [per_group[gi][ni] for gi in sched[ni]]
                if node.kind == "segments":
                    flat_outs.extend(parts)        # [S, B, W] per group
                elif node.kind == "bsi_minmax":
                    for p in parts:                # (bits, neg, cnt)
                        flat_outs.extend(p)
                elif not parts:
                    pass                           # no contributing group
                elif node.kind == "count":
                    total = parts[0]
                    for p in parts[1:]:
                        total = total + p
                    flat_outs.append(total)                  # [B]
                elif node.kind == "bsi_sum":
                    D = combine[ni]["depth"]
                    acc = torch.zeros((_mat_rows(mats[ni]), 2, D + 1),
                                      dtype=torch.int32, device=device)
                    for s in parts:                # [B, 2, d+1]
                        d = s.shape[-1] - 1
                        # magnitude counts and the trailing TOTAL column
                        # land separately: groups of different bit depth
                        # must not add a total into a magnitude slot
                        acc[:, :, :d] += s[:, :, :d]
                        acc[:, :, D] += s[:, :, d]
                    flat_outs.append(acc)
                else:  # row_counts / group_counts
                    acc = torch.zeros((_mat_rows(mats[ni]),
                                       combine[ni]["rows"]),
                                      dtype=torch.int32, device=device)
                    for s in parts:                # [B, rows_g]
                        acc[:, :s.shape[1]] += s
                    flat_outs.append(acc)
            return flat_outs

        return body

    # -- CUDA graphs -------------------------------------------------------

    def _use_graphs(self) -> bool:
        """CUDA graphs on a CUDA device; the body runs eagerly elsewhere."""
        return self.stacked.device.type == "cuda"

    def _run_graph(self, gkey, ckey, body, exact_mats, pad_mats, flats,
                   sig, fp_fn):
        """Run the program for ``gkey``: eagerly on its first sighting
        (over the request's own rows, ``exact_mats``), else replay its
        graph over the padded ``pad_mats``, captured now if this is its
        second.  Returns (outputs outside graph memory, captured now,
        kernel launches, whether the run was padded)."""
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
                outs = body(_mats_to(exact_mats, st.device), flats)
            return outs, False, sum(tally.values()), False
        captured = entry is None
        if captured:
            entry = self._capture(gkey, ckey, body, pad_mats, flats, sig,
                                  fp_fn, evicted)
        self._load_params(entry, pad_mats)
        entry.graph.replay()
        kernels.count_replay(entry.launches)
        self.replays += 1
        return ([o.clone() for o in entry.outputs], captured,
                sum(entry.launches.values()), True)

    @staticmethod
    def _load_params(entry, pad_mats):
        """Copy this launch's padded params into the graph's buffers."""
        for buf, m in zip(entry.params, pad_mats):
            for b, a in (zip(buf, m) if isinstance(m, tuple)
                         else ((buf, m),)):
                if a.size:
                    b.copy_(torch.from_numpy(a).pin_memory(),
                            non_blocking=True)

    def _graph(self, fn):
        """Capture ``fn()`` into a CUDA graph in the shared pool on the
        side stream; returns (graph, fn's outputs, the kernel launches
        it recorded).  Raises if the capture fails."""
        dev = self.stacked.device
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side), \
                kernels.recording_launches() as rec:
            graph.capture_begin(pool=self._pool.id,
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
        cur.wait_stream(self._side)
        return graph, outputs, rec

    def _open_pool(self):
        """The graphs' shared memory pool and side stream, made at the
        first capture."""
        if self._pool is not None:
            return
        dev = self.stacked.device
        self._pool = torch.cuda.MemPool()
        self._side = torch.cuda.Stream(dev)
        # The allocators count the graphs over a pool and free it when
        # the count drops to 0, which happens whenever every program is
        # dropped with its stacks (an ingest overlay); capturing into it
        # again then fails.  A one-op graph held for the runner's
        # lifetime keeps the pool open.
        self._anchor = self._graph(
            lambda: torch.zeros(1, dtype=torch.int32, device=dev))

    def _capture(self, gkey, ckey, body, pad_mats, flats, sig, fp_fn,
                 evicted):
        """Capture ``body`` into a CUDA graph over static params buffers,
        note it in the capture registry and cache the entry, which it
        returns.  Raises if the capture fails."""
        st = self.stacked
        self._open_pool()
        # A capture cannot release the caching allocator's free cached
        # blocks (the allocator frees them on an out-of-memory only when
        # no capture is underway), so blocks that earlier work left
        # cached can leave the capture no room: release them first.
        # A capture happens once per program.
        torch.cuda.empty_cache()
        params = _mats_to(pad_mats, st.device)
        t0 = time.perf_counter()
        graph, outputs, rec = self._graph(lambda: body(params, flats))
        dt = time.perf_counter() - t0
        self.capture_s += dt
        self.captures += 1
        devobs.COMPILES.note_call(sig, "wholequery", dt, fp_fn(),
                                  evicted=evicted)
        entry = _GraphEntry(graph, params, outputs,
                            [t for f in flats for t in f], ckey, rec, sig)
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
        """Bytes the allocator holds for the graphs' shared pool (None
        before the first capture)."""
        if self._pool is None:
            return None
        return sum(s["total_size"] for s in self._pool.snapshot())

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
