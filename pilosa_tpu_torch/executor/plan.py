"""Bitmap-call plan IR and its evaluation over torch — the port of the
JAX package's ``executor/plan.py``.

A PQL bitmap call tree is first *resolved* against the schema into a
static plan IR — field/view lookup, BSI base-value computation
(field.go:1574 baseValue), time-range view expansion (executor.go:1441
executeRowShard).  The IR, ``Resolver``, ``parametrize`` and
``plan_inputs`` are copied from the JAX module.  ``eval_plan`` and
``PlanCompiler.execute_shard`` are rewritten over torch: PyTorch runs
eagerly, so there is no compile cache — a plan is walked once per call,
with its row ids read from the host params vector.

``eval_plan`` works on any leading batch axes: the per-shard path hands
it ``[rows, W]`` fragments, the stacked executor ``[S, rows, W]`` stacks,
and every node evaluates to ``lead + (W,)``.  BSI predicates
(``BSIPlan``) evaluate through ``ops/bsi.py``: literal ones through
``range_op`` / ``range_between``, slotted ones through the ``_dyn`` forms
with their magnitude bits read from the params.

The batched form replaces the JAX package's ``jax.vmap`` of
``eval_plan`` over the rows of a ``[B, P]`` params matrix
(mesh_exec.py ``count_batch_async``): given that matrix, a row id read
from a param slot gathers ``[B] + lead + (W,)`` rows at once (an id at
or past the fragment's row count reads as an empty row for that b only),
BSI magnitude bits come from ``[B, 63]`` columns, and the result is
``[B] + lead + (W,)``.

The whole-query program (parallel/wholequery.py) hands ``eval_plan`` its
``[B, P]`` matrix as a DEVICE tensor instead.  Then nothing reads a
param on the host: a row id is clamped into range on the device, its
row gathered, and an id past the row count masked to an empty row with
``torch.where`` — what the JAX package's traced body does — so the same
evaluation can be captured once into a CUDA graph and replayed with new
params.  ``ReduceNode`` is the program's reducer node, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Any

import numpy as np
import torch

from ..core import SHARD_WORDS, VIEW_STANDARD
from ..ops import bitset, bsi
from ..pql import BETWEEN, Call, Condition, EQ, GT, GTE, LT, LTE, NEQ
from ..storage.field import FIELD_TYPE_INT, Field
from ..storage import time_quantum as tq


class PlanError(ValueError):
    pass


# -- plan IR ---------------------------------------------------------------

@dataclass(frozen=True)
class RowPlan:
    """Row(field=id) over one or more views (standard or time views)."""
    field: str
    views: tuple[str, ...]
    row_id: int


@dataclass(frozen=True)
class BSIPlan:
    """Row(field <op> value) against a bsig_ view.  op in bsi.range_op's
    vocabulary, plus "notnull" and "empty" specials."""
    field: str
    view: str
    op: str                  # eq|neq|lt|le|gt|ge|between|notnull|empty
    value: int = 0
    value2: int = 0          # between upper bound


@dataclass(frozen=True)
class NotPlan:
    existence: "RowPlan"
    child: Any


@dataclass(frozen=True)
class ShiftPlan:
    child: Any
    n: int


@dataclass(frozen=True)
class NaryPlan:
    op: str                  # intersect|union|difference|xor
    children: tuple[Any, ...]


@dataclass(frozen=True)
class ConstPlan:
    """All-zero segment."""


@dataclass(frozen=True)
class Slot:
    """Dynamic-parameter placeholder inside a plan.

    ``parametrize`` replaces literal row ids and BSI predicate values with
    Slots so the compiled executable is keyed by call-tree SHAPE — every
    ``Count(Row(f=N))`` shares one XLA program with N as a runtime argument
    (SURVEY §7 "one XLA computation per request ... cache keyed by call
    tree shape").  ``idx`` indexes the int32 params vector; ``sign``
    ("pos"/"zero"/"neg", BSI slots only) and ``width`` are structural."""
    idx: int
    sign: str = ""
    width: int = 1

    def __repr__(self):
        return f"${self.idx}:{self.sign}:{self.width}"


@dataclass(frozen=True)
class ReduceNode:
    """Whole-query reducer node (the JAX module's, copied).

    A read request lowers to a tuple of these, one per call or batch of
    same-shape calls, and runs as ONE program (parallel/wholequery.py);
    ``repr`` of the tuple is the program's shape key, and params ride as
    runtime arguments, so distinct literals share one program.

    kind: count | segments | row_counts | bsi_sum | bsi_minmax
          | group_counts
    plan: the slotted bitmap plan (count/segments) or the slotted
          filter plan / None (field reducers)
    primary: (field, view) the reducer reads, () for plan reducers
    extra: structural extras — ("max",)/("min",) for bsi_minmax,
          (prefix_keys..., pad_c) for group_counts
    """
    kind: str
    plan: Any = None
    primary: tuple = ()
    extra: tuple = ()


def parametrize(plan, trace: bool = False):
    """Replace literal row ids / BSI values with Slots; returns
    (slotted_plan, params int32[P]).  repr(slotted_plan) is the shape cache
    key; params ride as a runtime argument.

    With ``trace=True`` returns (slotted, params, prov, guards) for the
    prepared-statement cache: ``prov[j]`` describes how params[j] derives
    from a query-string literal — ``(lit, add, neg, shift, mask)`` meaning
    ``((±(values[lit]+add)) >> shift) & mask`` — or None for a constant;
    ``guards`` are (lit, lo, hi) interval constraints on the raw literal
    values under which this derivation stays valid (sign regions, row-id
    bounds)."""
    from ..pql.ast import LitInt

    params: list[int] = []
    prov: list = []
    guards: list[tuple[int, int, int]] = []
    LO, HI = -(1 << 62), (1 << 62)

    def slot_row(row_id: int) -> Slot:
        s = Slot(len(params))
        params.append(int(row_id))
        if isinstance(row_id, LitInt):
            prov.append((row_id.lit, row_id.add, 0, 0, (1 << 31) - 1))
            # v + add must be a valid non-negative int32 row id
            guards.append((row_id.lit, -row_id.add,
                           (1 << 31) - 1 - row_id.add))
        else:
            prov.append(None)
        return s

    def slot_value(value: int) -> Slot:
        sign = "zero" if value == 0 else ("pos" if value > 0 else "neg")
        s = Slot(len(params), sign, bsi.MAG_BITS)
        mag = abs(int(value))
        tagged = isinstance(value, LitInt)
        if tagged:
            # pin the sign region: it selects the compiled code path
            if sign == "pos":
                guards.append((value.lit, 1 - value.add, HI - value.add))
            elif sign == "neg":
                guards.append((value.lit, LO - value.add, -1 - value.add))
            else:
                guards.append((value.lit, -value.add, -value.add))
        for i in range(bsi.MAG_BITS):
            params.append((mag >> i) & 1)
            # the zero path never reads the magnitude bits (and its guard is
            # exact equality), so they stay constant zeros
            prov.append((value.lit, value.add, int(value < 0), i, 1)
                        if tagged and sign != "zero" else None)
        return s

    def walk(p):
        if isinstance(p, RowPlan):
            return RowPlan(p.field, p.views, slot_row(p.row_id))
        if isinstance(p, BSIPlan):
            if p.op in ("notnull", "empty"):
                return p
            if p.op == "between":
                return BSIPlan(p.field, p.view, p.op,
                               slot_value(p.value), slot_value(p.value2))
            return BSIPlan(p.field, p.view, p.op, slot_value(p.value), 0)
        if isinstance(p, NotPlan):
            return NotPlan(walk(p.existence), walk(p.child))
        if isinstance(p, ShiftPlan):
            return ShiftPlan(walk(p.child), p.n)
        if isinstance(p, NaryPlan):
            return NaryPlan(p.op, tuple(walk(ch) for ch in p.children))
        return p  # ConstPlan

    slotted = walk(plan)
    arr = np.asarray(params, dtype=np.int32)
    if trace:
        return slotted, arr, prov, guards
    return slotted, arr


# -- resolution: pql.Call -> plan IR ---------------------------------------

class Resolver:
    """Resolves bitmap calls against a holder's schema (host-side, once per
    query).

    With a ``guard_sink`` list attached, every schema/value-dependent branch
    taken on a tagged literal (pql.ast.LitInt) appends an interval constraint
    (lit, lo, hi) under which the SAME branch would be taken again — the
    prepared-statement cache replays the resolved plan only while all guards
    hold.  ``uncacheable`` is set when the resolution depends on state that
    can change between calls with identical text (e.g. "now" for an omitted
    time-range end)."""

    def __init__(self, holder, index_name: str, guard_sink=None):
        self.holder = holder
        self.index = holder.index(index_name)
        if self.index is None:
            raise PlanError(f"index not found: {index_name}")
        self.index_name = index_name
        self.guard_sink = guard_sink
        self.uncacheable = False

    def _guard(self, value, lo=None, hi=None):
        """Record: the branch just taken holds while lo <= value <= hi."""
        from ..pql.ast import LitInt
        if self.guard_sink is None or not isinstance(value, LitInt):
            return
        lo = -(1 << 62) if lo is None else lo
        hi = (1 << 62) if hi is None else hi
        self.guard_sink.append((value.lit, lo - value.add, hi - value.add))

    def field(self, name: str) -> Field:
        f = self.index.field(name)
        if f is None:
            raise PlanError(f"field not found: {name}")
        return f

    def resolve_bitmap(self, c: Call):
        name = c.name
        if name in ("Row", "Range"):
            return self._resolve_row(c)
        if name == "Intersect":
            if not c.children:
                raise PlanError("empty Intersect query is currently not "
                                "supported")
            return NaryPlan("intersect", tuple(
                self.resolve_bitmap(ch) for ch in c.children))
        if name == "Union":
            return NaryPlan("union", tuple(
                self.resolve_bitmap(ch) for ch in c.children))
        if name == "Difference":
            return NaryPlan("difference", tuple(
                self.resolve_bitmap(ch) for ch in c.children))
        if name == "Xor":
            return NaryPlan("xor", tuple(
                self.resolve_bitmap(ch) for ch in c.children))
        if name == "Not":
            if not self.index.track_existence:
                raise PlanError(
                    "Not() query requires existence tracking to be enabled "
                    "on the index")
            if len(c.children) != 1:
                raise PlanError("Not() requires exactly one input row")
            from ..core import EXISTENCE_FIELD_NAME
            return NotPlan(
                RowPlan(EXISTENCE_FIELD_NAME, (VIEW_STANDARD,), 0),
                self.resolve_bitmap(c.children[0]))
        if name == "Shift":
            # n defaults to 0 = identity (executor.go:1770, row.go:220)
            n, _ = c.uint_arg("n")
            if len(c.children) != 1:
                raise PlanError("Shift() requires exactly one input row")
            child = self.resolve_bitmap(c.children[0])
            return child if n == 0 else ShiftPlan(child, n)
        raise PlanError(f"unknown bitmap call: {name}")

    def _resolve_row(self, c: Call):
        # BSI condition form: Row(field <op> value)
        cond_arg = c.condition_arg()
        if cond_arg is not None:
            if len(c.args) > 1:
                raise PlanError("Row(): too many arguments")
            return self._resolve_bsi(*cond_arg)

        fa = c.field_arg()
        if fa is None:
            raise PlanError("Row() argument required: field")
        field_name, row_id = fa
        f = self.field(field_name)
        if not isinstance(row_id, int) or isinstance(row_id, bool):
            raise PlanError(f"Row() row id must be an integer, got "
                            f"{row_id!r} (key translation requires keys "
                            f"support)")

        from_arg = c.args.get("from") or c.args.get("_start")
        to_arg = c.args.get("to") or c.args.get("_end")
        if c.name == "Row" and from_arg is None and to_arg is None:
            return RowPlan(field_name, (VIEW_STANDARD,), row_id)

        quantum = f.options.time_quantum
        if not quantum:
            return ConstPlan()
        from_time = tq.parse_time(from_arg) if from_arg else datetime(1, 1, 1)
        if to_arg:
            to_time = tq.parse_time(to_arg)
        else:
            # executor.go:1506: now + 1 day when "to" omitted — the view set
            # depends on the wall clock, so the resolution can't be replayed
            self.uncacheable = True
            to_time = (datetime.now(timezone.utc).replace(tzinfo=None)
                       + timedelta(days=1))
        views = tuple(tq.views_by_time_range(
            VIEW_STANDARD, from_time, to_time, quantum))
        if not views:
            return ConstPlan()
        return RowPlan(field_name, views, row_id)

    def _resolve_bsi(self, field_name: str, cond: Condition):
        """(executor.go:1533 executeRowBSIGroupShard + field.go:1574
        baseValue)"""
        f = self.field(field_name)
        if f.options.type != FIELD_TYPE_INT:
            raise PlanError(f"field {field_name!r} is not an int field")
        view = f.bsi_view_name()
        base = f.options.base
        depth = f.options.bit_depth
        vmin = base - (1 << depth) + 1  # bitDepthMin (field.go:1638)
        vmax = base + (1 << depth) - 1  # bitDepthMax

        if cond.op == NEQ and cond.value is None:
            return BSIPlan(field_name, view, "notnull")
        if cond.op == BETWEEN:
            lo, hi = cond.value
            if hi < vmin:
                self._guard(hi, hi=vmin - 1)
                return BSIPlan(field_name, view, "empty")
            if lo > vmax:
                self._guard(hi, lo=vmin)
                self._guard(lo, lo=vmax + 1)
                return BSIPlan(field_name, view, "empty")
            self._guard(hi, lo=vmin)
            self._guard(lo, hi=vmax)
            if lo <= f.options.min and hi >= f.options.max:
                self._guard(lo, hi=f.options.min)
                self._guard(hi, lo=f.options.max)
                return BSIPlan(field_name, view, "notnull")
            # at least one of (lo > min, hi < max) held; pin the observed one
            if lo > f.options.min:
                self._guard(lo, lo=f.options.min + 1)
            else:
                self._guard(hi, hi=f.options.max - 1)
            # pin the clamp branches of max(lo, vmin) / min(hi, vmax)
            if lo >= vmin:
                self._guard(lo, lo=vmin)
            else:
                self._guard(lo, hi=vmin - 1)
            if hi <= vmax:
                self._guard(hi, hi=vmax)
            else:
                self._guard(hi, lo=vmax + 1)
            lo_b = max(lo, vmin) - base
            hi_b = min(hi, vmax) - base
            return BSIPlan(field_name, view, "between", lo_b, hi_b)

        value = cond.value
        if not isinstance(value, int) or isinstance(value, bool):
            raise PlanError("Row(): conditions only support integer values")

        # full-encompass fast paths -> notNull (executor.go:1650)
        if cond.op == LT and value > f.options.max:
            self._guard(value, lo=f.options.max + 1)
            return BSIPlan(field_name, view, "notnull")
        if cond.op == LTE and value >= f.options.max:
            self._guard(value, lo=f.options.max)
            return BSIPlan(field_name, view, "notnull")
        if cond.op == GT and value < f.options.min:
            self._guard(value, hi=f.options.min - 1)
            return BSIPlan(field_name, view, "notnull")
        if cond.op == GTE and value <= f.options.min:
            self._guard(value, hi=f.options.min)
            return BSIPlan(field_name, view, "notnull")
        # fast paths not taken: pin their complements
        if cond.op == LT:
            self._guard(value, hi=f.options.max)
        elif cond.op == LTE:
            self._guard(value, hi=f.options.max - 1)
        elif cond.op == GT:
            self._guard(value, lo=f.options.min)
        elif cond.op == GTE:
            self._guard(value, lo=f.options.min + 1)

        # baseValue with out-of-range handling (field.go:1574)
        out_of_range = False
        base_value = 0
        if cond.op in (GT, GTE):
            if value > vmax:
                self._guard(value, lo=vmax + 1)
                out_of_range = True
            elif value > vmin:
                self._guard(value, lo=vmin + 1, hi=vmax)
                base_value = value - base
            else:
                self._guard(value, hi=vmin)
                base_value = vmin - base
        elif cond.op in (LT, LTE):
            if value < vmin:
                self._guard(value, hi=vmin - 1)
                out_of_range = True
            elif value > vmax:
                self._guard(value, lo=vmax + 1)
                base_value = vmax - base
            else:
                self._guard(value, lo=vmin, hi=vmax)
                base_value = value - base
        else:  # EQ / NEQ
            if value < vmin:
                self._guard(value, hi=vmin - 1)
                out_of_range = True
            elif value > vmax:
                self._guard(value, lo=vmax + 1)
                out_of_range = True
            else:
                self._guard(value, lo=vmin, hi=vmax)
                base_value = value - base

        if out_of_range:
            if cond.op == NEQ:
                return BSIPlan(field_name, view, "notnull")
            return BSIPlan(field_name, view, "empty")

        op_map = {EQ: "eq", NEQ: "neq", LT: "lt", LTE: "le", GT: "gt",
                  GTE: "ge"}
        return BSIPlan(field_name, view, op_map[cond.op], base_value)


# -- compilation: plan IR -> jitted per-shard function ---------------------

def plan_inputs(plan) -> list[tuple[str, str]]:
    """Deterministic list of (field, view) fragment references of a plan."""
    out: list[tuple[str, str]] = []

    def walk(p):
        if isinstance(p, RowPlan):
            for v in p.views:
                key = (p.field, v)
                if key not in out:
                    out.append(key)
        elif isinstance(p, BSIPlan):
            if (p.field, p.view) not in out:
                out.append((p.field, p.view))
        elif isinstance(p, NotPlan):
            walk(p.existence)
            walk(p.child)
        elif isinstance(p, ShiftPlan):
            walk(p.child)
        elif isinstance(p, NaryPlan):
            for ch in p.children:
                walk(ch)

    walk(plan)
    return out


def params_to(params: np.ndarray, device) -> torch.Tensor:
    """Host params (row ids, predicate bits) -> int32 tensor on
    ``device``.  On a CUDA device the copy goes from pinned memory without
    blocking the host, so reading params never waits for the card's
    queue to drain."""
    t = torch.from_numpy(np.ascontiguousarray(params, dtype=np.int32))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _gather_rows(frag: torch.Tensor, rids: np.ndarray):
    """Rows ``rids`` ``[B]`` of ``frag`` (``lead + (rows, W)``) as
    ``[B] + lead + (W,)``; an id outside ``[0, rows)`` reads as an empty
    row for its b only.  None when every id is outside."""
    ok = (rids >= 0) & (rids < frag.shape[-2])
    if not ok.any():
        return None
    g = frag.movedim(-2, 0)[params_to(np.where(ok, rids, 0), frag.device)
                            .long()]
    if not ok.all():
        g[params_to(np.flatnonzero(~ok), frag.device).long()] = 0
    return g


def _gather_rows_dev(frag: torch.Tensor, rids: torch.Tensor):
    """``_gather_rows`` with the ids ``[B]`` on the device: each id is
    clamped into range, its row gathered, and an id at or past the row
    count masked to an empty row — no value is read on the host."""
    rows = frag.shape[-2]
    g = frag.movedim(-2, 0)[rids.clamp(0, rows - 1).long()]
    ok = (rids < rows).reshape((-1,) + (1,) * (g.dim() - 1))
    return torch.where(ok, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device))


def eval_plan(plan, frags: dict[tuple[str, str], Any], params=None, *,
              lead: tuple = (), device=None) -> torch.Tensor:
    """Evaluate a plan over fragment tensors.  ``frags`` maps (field, view)
    to an int32 ``lead + (n_rows, W)`` tensor, or None (missing fragment);
    it may be a lazy mapping that decodes on first access.  Returns int32
    ``lead + (W,)``; ``lead`` and ``device`` size the all-zero results.

    Literal plans carry their row ids; slotted plans (``parametrize``)
    read them from the host ``params`` vector.  A row id at or past a
    fragment's row count reads as an empty row, as in the JAX module.
    With a ``[B, P]`` params matrix the plan is evaluated for each of its
    B rows at once and the result is ``[B] + lead + (W,)``.  A ``[B, P]``
    int32 tensor on the fragments' device is read only there (the
    whole-query program's form)."""
    on_dev = isinstance(params, torch.Tensor)
    batched = params is not None and np.ndim(params) == 2
    dev_params: dict = {}

    def zero():
        return torch.zeros(lead + (SHARD_WORDS,), dtype=torch.int32,
                           device=device)

    def get_row(field, view, row_id):
        frag = frags.get((field, view))
        if frag is None:
            return None
        if isinstance(row_id, Slot) and on_dev:
            if frag.shape[-2] == 0:
                return None
            return _gather_rows_dev(frag, params[:, row_id.idx])
        if isinstance(row_id, Slot) and batched:
            return _gather_rows(frag, params[:, row_id.idx])
        rid = int(params[row_id.idx]) if isinstance(row_id, Slot) \
            else int(row_id)
        if rid < 0 or rid >= frag.shape[-2]:
            return None
        return frag[..., rid, :]

    def mag_bits(slot: Slot, dev):
        if on_dev:
            return params[..., slot.idx:slot.idx + slot.width]
        # the params go to the device once per evaluation
        if dev not in dev_params:
            dev_params[dev] = params_to(params, dev)
        return dev_params[dev][..., slot.idx:slot.idx + slot.width]

    def ev(p):
        if isinstance(p, ConstPlan):
            return zero()
        if isinstance(p, RowPlan):
            segs = [s for v in p.views
                    if (s := get_row(p.field, v, p.row_id)) is not None]
            if not segs:
                return zero()
            if len(segs) == 1:
                return segs[0]
            return bitset.union_many(torch.stack(segs))
        if isinstance(p, BSIPlan):
            frag = frags.get((p.field, p.view))
            if frag is None or p.op == "empty":
                return zero()
            if p.op == "notnull":
                return bsi.not_null(frag)
            if isinstance(p.value, Slot):
                if p.op == "between":
                    return bsi.range_between_dyn(
                        frag, p.value.sign, mag_bits(p.value, frag.device),
                        p.value2.sign, mag_bits(p.value2, frag.device))
                return bsi.range_op_dyn(frag, p.op, p.value.sign,
                                        mag_bits(p.value, frag.device))
            if p.op == "between":
                return bsi.range_between(frag, p.value, p.value2)
            return bsi.range_op(frag, p.op, p.value)
        if isinstance(p, NotPlan):
            ex = ev(p.existence)
            return bitset.difference(ex, ev(p.child))
        if isinstance(p, ShiftPlan):
            return bitset.shift(ev(p.child), p.n)
        if isinstance(p, NaryPlan):
            segs = [ev(ch) for ch in p.children]
            if not segs:
                return zero()
            acc = segs[0]
            for s in segs[1:]:
                if p.op == "intersect":
                    acc = bitset.intersect(acc, s)
                elif p.op == "union":
                    acc = bitset.union(acc, s)
                elif p.op == "difference":
                    acc = bitset.difference(acc, s)
                else:
                    acc = bitset.xor(acc, s)
            return acc
        raise PlanError(f"unknown plan node: {p!r}")

    out = ev(plan)
    if batched and out.dim() == len(lead) + 1:
        # no node read a param slot: one result serves every b
        out = out.expand((params.shape[0],) + tuple(out.shape))
    return out


class PlanCompiler:
    """Per-shard plan execution (the JAX module's compiled-executable
    cache; eager here, so it only gathers inputs and evaluates)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def execute_shard(self, plan, holder, index_name: str, shard: int,
                      reducer=None):
        """Gather one shard's device mirrors and evaluate the plan:
        int32[W] words, or the int popcount with ``reducer="count"``."""
        slotted, params = parametrize(plan)
        frags = {}
        for field, view in plan_inputs(plan):
            frag = holder.fragment(index_name, field, view, shard)
            if frag is not None:
                frags[(field, view)] = frag.device(self.device)
        seg = eval_plan(slotted, frags, params, device=self.device)
        if reducer == "count":
            return int(bitset.count(seg))
        return seg
