"""Query-time key translation + result back-translation
(executor.go:2610 translateCalls / :2781 translateResults).

Before execution, string keys in the call tree are rewritten to uint64 ids
(creating ids for unknown keys, like the reference's TranslateKey); after
execution, ids in results are mapped back to keys.  In a cluster this runs
once at the coordinating node — fanned-out internal calls carry ids only.

Port copy of the JAX package's ``executor/translator.py``: the PyTorch
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from ..pql import Call
from ..storage.field import FIELD_TYPE_BOOL
from .results import (
    GroupCount, Pair, RowIdentifiers, RowResult, ValCount,
)


class TranslationError(ValueError):
    pass


class Translator:
    def __init__(self, holder):
        self.holder = holder

    # -- call rewrite (executor.go:2622 translateCall) ---------------------

    def needs_translation(self, index: str) -> bool:
        idx = self.holder.index(index)
        if idx is None:
            return False
        return idx.keys or any(f.options.keys
                               for f in idx.fields.values())

    def translate_query(self, index: str, query):
        idx = self.holder.index(index)
        if idx is None:
            return query
        for c in query.calls:
            self._translate_call(idx, c)
        return query

    def _translate_call(self, idx, c: Call):
        # arg-name switch (executor.go:2624-2644)
        col_key = row_key = field_name = None
        if c.name in ("Set", "Clear", "Row", "Range", "SetColumnAttrs",
                      "ClearRow", "Store"):
            col_key = "_col"
            fa = c.field_arg()
            if fa is not None:
                field_name = row_key = fa[0]
        elif c.name == "SetRowAttrs":
            row_key = "_row"
            field_name, _ = c.string_arg("_field")
        elif c.name == "Rows":
            field_name, _ = c.string_arg("_field")
            row_key = "previous"
            col_key = "column"
        elif c.name == "GroupBy":
            self._translate_group_by(idx, c)
            return
        else:
            col_key = "col"
            field_name, _ = c.string_arg("field")
            row_key = "row"

        # column key (index-level store)
        if col_key is not None and col_key in c.args:
            v = c.args[col_key]
            if idx.keys:
                if v is not None and not isinstance(v, str):
                    raise TranslationError(
                        "column value must be a string when index 'keys' "
                        "option enabled")
                if isinstance(v, str) and v:
                    c.args[col_key] = idx.translate_store().translate_key(v)
            elif isinstance(v, str):
                raise TranslationError(
                    "string 'col' value not allowed unless index 'keys' "
                    "option enabled")

        # row key (field-level store); bool fields translate directly
        # (executor.go:2669-2680)
        if field_name and row_key is not None and row_key in c.args:
            f = idx.field(field_name)
            if f is not None:
                v = c.args[row_key]
                if f.options.type == FIELD_TYPE_BOOL:
                    if isinstance(v, bool):
                        c.args[row_key] = int(v)
                elif f.options.keys:
                    if v is not None and not isinstance(v, str):
                        raise TranslationError(
                            "row value must be a string when field 'keys' "
                            "option enabled")
                    if isinstance(v, str) and v:
                        c.args[row_key] = \
                            f.translate_store().translate_key(v)
                elif isinstance(v, str):
                    raise TranslationError(
                        "string 'row' value not allowed unless field "
                        "'keys' option enabled")

        for child in c.children:
            self._translate_call(idx, child)

    def _translate_group_by(self, idx, c: Call):
        """(executor.go:2716 translateGroupByCall)"""
        for child in c.children:
            self._translate_call(idx, child)
        prev = c.args.get("previous")
        if prev is None:
            return
        if not isinstance(prev, list):
            raise TranslationError("'previous' argument must be a list")
        rows_children = [ch for ch in c.children if ch.name == "Rows"]
        if len(rows_children) != len(prev):
            raise TranslationError(
                f"mismatched lengths for previous: {len(prev)} and "
                f"children: {len(rows_children)}")
        for i, child in enumerate(rows_children):
            fname, _ = child.string_arg("_field")
            f = idx.field(fname)
            if f is None:
                raise TranslationError(f"field not found: {fname}")
            if f.options.keys:
                if not isinstance(prev[i], str):
                    raise TranslationError(
                        "prev value must be a string when field 'keys' "
                        "option enabled")
                prev[i] = f.translate_store().translate_key(prev[i])
            elif isinstance(prev[i], str):
                raise TranslationError(
                    f"got string row val {prev[i]!r} in 'previous' for "
                    f"field {fname} which doesn't use string keys")

    # -- result back-translation (executor.go:2781 translateResults) -------

    def translate_results(self, index: str, calls, results):
        idx = self.holder.index(index)
        if idx is None:
            return results
        return [self._translate_result(idx, c, r)
                for c, r in zip(calls, results)]

    def _field_of(self, idx, c: Call):
        fname, ok = c.string_arg("_field")
        if not ok:
            fa = c.field_arg()
            fname = fa[0] if fa else ""
        return idx.field(fname) if fname else None

    def _translate_result(self, idx, c: Call, r):
        if isinstance(r, RowResult):
            if idx.keys:
                store = idx.translate_store()
                r.keys = [store.translate_id(int(col)) or ""
                          for col in r.columns()]
            return r
        if isinstance(r, RowIdentifiers):
            f = self._field_of(idx, c)
            if f is not None and f.options.keys:
                store = f.translate_store()
                r.keys = [store.translate_id(i) or "" for i in r.rows]
            return r
        if isinstance(r, list) and r and isinstance(r[0], Pair):
            f = self._field_of(idx, c)
            if f is not None and f.options.keys:
                store = f.translate_store()
                for p in r:
                    p.key = store.translate_id(p.id) or ""
            return r
        if isinstance(r, list) and r and isinstance(r[0], GroupCount):
            for g in r:
                for fr in g.group:
                    f = idx.field(fr.field)
                    if f is not None and f.options.keys:
                        fr.row_key = \
                            f.translate_store().translate_id(fr.row_id) or ""
            return r
        if isinstance(r, ValCount):
            return r
        return r
