"""Prepared-statement cache: skip parse/resolve/parametrize for repeat
query shapes — the port of the JAX package's ``executor/prepared.py``.

Real databases cache statements keyed by the query text with literals
stripped (Postgres fingerprinting, Oracle cursor sharing); this module is
that, adapted to the plan IR:

1. ``fingerprint`` replaces every integer literal in the PQL text with
   ``?`` (quoted strings and timestamps are preserved) and extracts the
   literal values.  The template string is the cache key.
2. On first sight of a template the query is parsed with literal tagging
   (pql.parser ``mkint`` -> pql.ast.LitInt), resolved and parametrized with
   provenance tracing (plan.parametrize(trace=True)), and the resulting
   slotted plans + batched dispatch structure are stored as a
   ``PreparedEntry``.
3. On a hit, the entry rebuilds each group's ``[B, P]`` params matrix from
   the new literal values with vectorized numpy and replays the whole
   template as ONE whole-query program (executor ``_wq_run_batched``),
   or, with whole-query off or for a shape it cannot take, through the
   grouped path (executor ``_run_batched_groups``) — no parsing, no
   resolution, no per-call Python.  Either way the dispatch rides the
   cross-query batcher, so concurrent requests replaying one template
   fuse into one launch.

Safety: replaying a resolved plan with new values is only sound when the
new values would have taken the same structural branches during
resolution.  Every value-dependent branch records an interval *guard*
(plan.Resolver._guard); sign regions and row-id bounds are guarded by
``parametrize``; literals that never reached a dynamic param slot are
pinned to exact equality.  Any guard failure falls back to the classic
path (slower, always correct).  Entries are invalidated by the global
schema epoch (core.bump_schema_epoch) on DDL or BSI bit-depth growth.

The fingerprint runs the C scanner (native/fingerprint.c) when it is
built and the text is ASCII with no literal beyond int64, else the
Python regex; both give the same template and values.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np

from ..core import schema_epoch
from ..native import fingerprint_native
from ..pql import parse
from ..pql.ast import LitInt, Query
from ..utils.devobs import sig_of
from ..utils.locks import make_lock
from .plan import Resolver, parametrize

# Integer literals only: quoted strings and bare timestamps pass through
# unchanged (they stay part of the template).  The lookaround classes keep
# digits inside identifiers/barewords/floats (``field1``, ``1a2b``, ``1.5``,
# ``2017-01-01``) out of the value list.  The whole pattern is one capture
# group (with the int literal as an inner group) so ``split`` can rebuild
# the template at C speed — a Python callback per match costs ~30 µs/query
# on the serving hot path.
_FP = re.compile(
    r"('(?:[^'\\]|\\.)*'"
    r'|"(?:[^"\\]|\\.)*"'
    r"|\d{4}-[01]\d-[0-3]\dT\d\d:\d\d"
    r"|(?<![\w.:-])(-?\d+)(?![\w.:-]))")


def fingerprint(query: str):
    """(template, values list): the query text with int literals replaced
    by '?' and the literal values in source order."""
    template, values = _fingerprint_fast(query)
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return template, values


def _fingerprint_fast(query: str):
    """Hot-path variant: values may come back as an int64 ndarray (C
    scanner, native/fingerprint.c) or a list of Python ints (regex
    fallback: non-ASCII text, int64 overflow, missing toolchain).
    Internal because ndarray values break ``==`` users."""
    native = fingerprint_native(query)
    if native is not None:
        return native
    return _fingerprint_py(query)


def _fingerprint_py(query: str):
    """Pure-Python fingerprint: one regex split, list slicing, one join —
    no per-match Python callback."""
    parts = _FP.split(query)
    if len(parts) == 1:
        return query, []
    texts = parts[0::3]
    fulls = parts[1::3]
    ints = parts[2::3]
    values = [int(x) for x in ints if x is not None]
    out = []
    for t, fl, iv in zip(texts, fulls, ints):
        out.append(t)
        out.append("?" if iv is not None else fl)
    out.append(texts[-1])
    return "".join(out), values


def template_sig(index: str, template: str) -> str:
    """Short stable id of an index's template, the ``template`` tag of
    the ``prepared.attempt`` span."""
    return sig_of(("prepared", index, template))


def fingerprint_spans(query: str) -> dict[int, int]:
    """token-start -> literal index for the parser's mkint hook (build
    path only — hits never need spans)."""
    spans: dict[int, int] = {}
    i = 0
    for m in _FP.finditer(query):
        if m.group(2) is not None:
            spans[m.start(2)] = i
            i += 1
    return spans


_BATCHABLE = {"Count", "Sum", "TopN"}
_EMPTY_PARAMS = np.zeros(0, dtype=np.int32)


class _Group:
    """One batched dispatch: B same-shape calls -> one executable invocation.

    ``build_params(values)`` reconstructs the [B, P] int32 params matrix:
    params[b, j] = (sgn*(values[lit]+add) >> shift) & mask for dynamic
    slots, the prepared constant for the rest — all vectorized.
    """

    __slots__ = ("kind", "slotted", "call_idxs", "const", "lit", "add",
                 "sgn", "shift", "mask", "extra")

    def __init__(self, kind, slotted, call_idxs, params_rows, prov_rows,
                 extra):
        self.kind = kind
        self.slotted = slotted
        self.call_idxs = call_idxs
        self.extra = extra
        B = len(call_idxs)
        P = params_rows[0].size if params_rows else 0
        self.const = (np.stack(params_rows).astype(np.int64) if P
                      else np.zeros((B, 0), dtype=np.int64))
        lit = np.full((B, P), -1, dtype=np.int64)
        add = np.zeros((B, P), dtype=np.int64)
        sgn = np.ones((B, P), dtype=np.int64)
        shift = np.zeros((B, P), dtype=np.int64)
        mask = np.zeros((B, P), dtype=np.int64)
        for b, prov in enumerate(prov_rows):
            for j, p in enumerate(prov):
                if p is None:
                    continue
                l, a, neg, sh, mk = p
                lit[b, j] = l
                add[b, j] = a
                sgn[b, j] = -1 if neg else 1
                shift[b, j] = sh
                mask[b, j] = mk
        self.lit = lit
        self.add = add
        self.sgn = sgn
        self.shift = shift
        self.mask = mask

    def build_params(self, values: np.ndarray) -> np.ndarray:
        if self.lit.size == 0:
            return self.const.astype(np.int32)
        dyn = self.lit >= 0
        vals = values[np.where(dyn, self.lit, 0)]
        computed = ((self.sgn * (vals + self.add)) >> self.shift) & self.mask
        return np.where(dyn, computed, self.const).astype(np.int32)


class PreparedEntry:
    __slots__ = ("epoch", "n_calls", "groups", "g_lit", "g_lo", "g_hi")

    def __init__(self, epoch, n_calls, groups, guards):
        self.epoch = epoch
        self.n_calls = n_calls
        self.groups = groups
        if guards:
            self.g_lit = np.asarray([g[0] for g in guards], dtype=np.int64)
            self.g_lo = np.asarray([g[1] for g in guards], dtype=np.int64)
            self.g_hi = np.asarray([g[2] for g in guards], dtype=np.int64)
        else:
            self.g_lit = np.zeros(0, dtype=np.int64)
            self.g_lo = self.g_hi = self.g_lit

    def guards_ok(self, values: np.ndarray) -> bool:
        if self.g_lit.size == 0:
            return True
        v = values[self.g_lit]
        return bool(np.all((v >= self.g_lo) & (v <= self.g_hi)))

    def run(self, ex, index: str, values: np.ndarray, shards):
        """Dispatch all groups, then resolve with one device fetch.
        Returns the results list, in call order.  With whole-query on the
        WHOLE template replays as one program launch; otherwise (or on an
        unsupported shape) the groups ride the grouped path."""
        from .executor import _resolve_pendings, _run_batched_groups

        holder = ex.holder
        if shards is None:
            idx = holder.index(index)
            shards = sorted(idx.available_shards())
        results: list = [None] * self.n_calls
        groups = [(g.kind, g.slotted, g.build_params(values),
                   g.call_idxs, g.extra) for g in self.groups]
        if ex.wholequery is not None and ex.whole_query:
            from ..parallel.wholequery import WholeQueryUnsupported
            try:
                ex._wq_run_batched(index, shards, groups, results)
                ex.wq_requests += 1
                ex.stats.count("wholequery.requests")
                return _resolve_pendings(results)
            except WholeQueryUnsupported as e:
                ex._note_wq_fallback(index, e)
                results = [None] * self.n_calls
        _run_batched_groups(ex.batcher, holder, index, shards, groups,
                            results)
        return _resolve_pendings(results)


_UNCACHEABLE = "uncacheable"


class PreparedCache:
    """Template -> PreparedEntry, LRU-bounded; thread-safe."""

    def __init__(self, executor, max_entries: int = 256):
        self.executor = executor
        self.max_entries = max_entries
        self._lock = make_lock("prepared")
        self._entries: OrderedDict = OrderedDict()
        # observability (surfaced at /debug/vars via utils.stats)
        self.hits = 0
        self.misses = 0
        self.guard_misses = 0

    # -- lookup/execute ----------------------------------------------------

    def attempt(self, index: str, query: str, shards):
        """Try to serve ``query`` from the cache.  Returns
        (True, results, sig) on a hit; (False, parsed_query_or_None, sig)
        on a miss — the parsed AST (literal-tagged, tags invisible to the
        classic path) is handed back so the caller never parses twice.
        ``sig`` is the query's ``template_sig``."""
        template, values = _fingerprint_fast(query)
        key = (index, template)
        sig = template_sig(index, template)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if isinstance(values, np.ndarray):
            vals = values
        else:
            try:
                vals = np.asarray(values, dtype=np.int64) if values else \
                    np.zeros(0, dtype=np.int64)
            except OverflowError:
                # a literal beyond int64 can't ride the params machinery;
                # the classic path (arbitrary-precision ints) owns it
                self.misses += 1
                return False, None, sig

        if entry is _UNCACHEABLE:
            self.misses += 1
            return False, None, sig
        if isinstance(entry, PreparedEntry):
            if entry.epoch == schema_epoch() and entry.guards_ok(vals):
                self.hits += 1
                return True, entry.run(self.executor, index, vals,
                                       shards), sig
            if entry.epoch != schema_epoch():
                with self._lock:
                    self._entries.pop(key, None)
            else:
                self.guard_misses += 1
                # entry stays; these values take another branch ->
                # classic path
                return False, None, sig

        # build: tagged parse + prepare; on ineligibility remember that
        self.misses += 1
        spans = fingerprint_spans(query)
        q = parse(query, mkint=lambda v, s: (
            LitInt(v, spans[s], v - int(values[spans[s]]))
            if s in spans else v))
        entry = self._prepare(index, q, values)
        with self._lock:
            self._entries[key] = entry if entry is not None else _UNCACHEABLE
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        if entry is not None:
            return True, entry.run(self.executor, index, vals, shards), sig
        return False, q, sig

    # -- preparation -------------------------------------------------------

    def _prepare(self, index: str, q: Query, values) -> PreparedEntry | None:
        """Resolve + parametrize every call with provenance; None when the
        template can't be soundly cached (non-batchable calls, key
        translation, wall-clock-dependent time ranges)."""
        ex = self.executor
        if ex.stacked is None:
            return None
        if ex.translator.needs_translation(index):
            return None
        if ex.holder.index(index) is None:
            return None  # classic path raises the proper error
        epoch = schema_epoch()
        guards: list = []
        descs: list = []
        for c in q.calls:
            if c.name not in _BATCHABLE:
                return None
            d = self._desc(index, c, guards)
            if d is None:
                return None
            descs.append(d)

        # literals that never reached a dynamic param slot are structural:
        # pin them to exact equality
        dyn_lits = set()
        for d in descs:
            for p in d["prov"]:
                if p is not None:
                    dyn_lits.add(p[0])
        for i, v in enumerate(values):
            if i not in dyn_lits:
                guards.append((i, v, v))

        groups: dict[tuple, list[int]] = {}
        for i, d in enumerate(descs):
            groups.setdefault(d["key"], []).append(i)
        built = []
        for key, idxs in groups.items():
            ds = [descs[i] for i in idxs]
            extra = ds[0]["extra"]
            if ds[0]["kind"] == "topn":
                # the group key omits n/ids, so calls in one group may
                # carry different ones — keep them per call, matching the
                # classic grouped path
                extra = {"field": extra["field"], "view": extra["view"],
                         "ids_n": [(d["extra"]["ids"], d["extra"]["n"])
                                   for d in ds]}
            built.append(_Group(ds[0]["kind"], ds[0]["slotted"], idxs,
                                [d["params"] for d in ds],
                                [d["prov"] for d in ds], extra))
        return PreparedEntry(epoch, len(q.calls), built, guards)

    def _desc(self, index: str, c, guards: list):
        """Traced analog of Executor._batch_desc.  Appends guards; returns
        None for anything the batched executables can't express."""
        ex = self.executor
        sink: list = []
        resolver = Resolver(ex.holder, index, guard_sink=sink)

        def slot_plan(call):
            plan = resolver.resolve_bitmap(call)
            return parametrize(plan, trace=True)

        if c.name == "Count":
            if len(c.children) != 1:
                return None
            slotted, params, prov, pg = slot_plan(c.children[0])
            if resolver.uncacheable:
                return None
            guards.extend(sink)
            guards.extend(pg)
            return {"kind": "count", "key": ("count", repr(slotted)),
                    "slotted": slotted, "params": params, "prov": prov,
                    "extra": None}
        if c.name == "Sum":
            f = ex._bsi_field(index, c)
            if c.children:
                slotted, params, prov, pg = slot_plan(c.children[0])
            else:
                slotted, params, prov, pg = None, _EMPTY_PARAMS, [], []
            if resolver.uncacheable:
                return None
            guards.extend(sink)
            guards.extend(pg)
            return {"kind": "sum", "key": ("sum", f.name, repr(slotted)),
                    "slotted": slotted, "params": params, "prov": prov,
                    "extra": {"field": f.name, "view": f.bsi_view_name(),
                              "base": f.options.base}}
        # TopN
        from .executor import TOPN_EXTRAS
        if any(k in c.args for k in TOPN_EXTRAS):
            return None  # extras need extra device passes + attr reads
        field_name, ok = c.string_arg("_field")
        if not ok or ex.holder.field(index, field_name) is None:
            return None
        if not c.children and "ids" not in c.args and \
                ex.holder.field(index, field_name).options.cache_type \
                in ("ranked", "lru"):
            # unfiltered TopN on a rank-cached field belongs to the rank
            # cache's exact candidate path (executor._execute_topn ->
            # cache/rank.topn_from_rank) — host-side, no device dispatch;
            # a prepared replay would re-route it to a full device scan
            return None
        if c.children:
            slotted, params, prov, pg = slot_plan(c.children[0])
        else:
            slotted, params, prov, pg = None, _EMPTY_PARAMS, [], []
        if resolver.uncacheable:
            return None
        guards.extend(sink)
        guards.extend(pg)
        n, _ = c.uint_arg("n")
        ids = c.args.get("ids")
        if ids is not None:
            ids = [int(x) for x in ids]
        from ..core import VIEW_STANDARD
        return {"kind": "topn", "key": ("topn", field_name, repr(slotted)),
                "slotted": slotted, "params": params, "prov": prov,
                "extra": {"field": field_name, "view": VIEW_STANDARD,
                          "ids": ids, "n": n}}
