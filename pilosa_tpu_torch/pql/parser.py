"""Recursive-descent PQL parser — behavioral port of the 83-line PEG grammar
(reference pql/pql.peg; generated parser pql/pql.peg.go).

The grammar is small enough that a hand-written descent is clearer and easier
to keep in sync than a generated PEG machine.  Semantics preserved:

* special call forms: Set, SetRowAttrs, SetColumnAttrs, Clear, ClearRow,
  Store, TopN, Rows, Range (legacy), generic `IDENT(children..., args...)`
* positional args stored under reserved keys: _col, _row, _field, _timestamp
* conditions: `field <op> value` and the double-bound conditional
  `4 <= field < 9` which collapses to a BETWEEN with strict bounds adjusted
  (ast.go:81-100 endConditional)
* value forms: null/true/false, timestamps (bare or quoted), ints, floats,
  bare words, single/double-quoted strings (escapes), lists, nested calls

Port copy of the JAX package's ``pql/parser.py``: the PyTorch port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import re

from .ast import (
    BETWEEN, Call, Condition, EQ, GT, GTE, LT, LTE, NEQ, Query,
)


class ParseError(ValueError):
    def __init__(self, msg: str, pos: int, text: str):
        line = text.count("\n", 0, pos) + 1
        col = pos - (text.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"parse error at line {line}:{col}: {msg}")
        self.pos = pos


_TIMESTAMP = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d")
_IDENT = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")
_UINT = re.compile(r"0|[1-9]\d*")
_NUMBER = re.compile(r"-?(\d+(\.\d*)?|\.\d+)")
_INT = re.compile(r"-?(0|[1-9]\d*)")
_BAREWORD = re.compile(r"[A-Za-z0-9_:-]+")
_COND_OPS = ("><", "<=", ">=", "==", "!=", "<", ">")  # longest-first


class _Parser:
    def __init__(self, text: str, mkint=None):
        self.text = text
        self.pos = 0
        # mkint(value, token_start) -> int: literal-construction hook used
        # by the prepared-statement cache to tag integer literals with their
        # source position (executor/prepared.py).  Default: identity.
        self.mkint = mkint or (lambda v, start: v)

    # -- low-level ---------------------------------------------------------

    def err(self, msg: str) -> ParseError:
        return ParseError(msg, self.pos, self.text)

    def sp(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def eof(self) -> bool:
        return self.pos >= len(self.text)

    def peek(self, s: str) -> bool:
        return self.text.startswith(s, self.pos)

    def accept(self, s: str) -> bool:
        if self.peek(s):
            self.pos += len(s)
            return True
        return False

    def expect(self, s: str):
        if not self.accept(s):
            raise self.err(f"expected {s!r}")

    def match(self, rx: re.Pattern) -> str | None:
        m = rx.match(self.text, self.pos)
        if m is None:
            return None
        self.pos = m.end()
        return m.group()

    def comma(self):
        self.sp()
        self.expect(",")
        self.sp()

    def try_comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.accept(","):
            self.sp()
            return True
        self.pos = save
        return False

    # -- grammar -----------------------------------------------------------

    def parse(self) -> Query:
        q = Query()
        self.sp()
        while not self.eof():
            q.calls.append(self.call())
            self.sp()
        return q

    def call(self) -> Call:
        for name in ("SetRowAttrs", "SetColumnAttrs", "Set", "ClearRow",
                     "Clear", "Store", "TopN", "Rows", "Range"):
            save = self.pos
            if self.accept(name):
                # must be followed by '(' (else it's a generic ident prefix
                # like "SetFoo")
                save2 = self.pos
                self.sp()
                if self.peek("("):
                    self.pos = save2
                    return getattr(self, "_call_" + name.lower())()
            self.pos = save
        ident = self.match(_IDENT)
        if ident is None:
            raise self.err("expected call name")
        return self._generic_call(ident)

    def _open(self):
        self.sp()
        self.expect("(")
        self.sp()

    def _close(self):
        self.sp()
        self.expect(")")

    # Set(col, field=row[, timestamp])   (pql.peg Call/Set)
    def _call_set(self) -> Call:
        call = Call("Set")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args(call)
        save = self.pos
        if self.try_comma():
            ts = self._timestampfmt()
            if ts is None:
                self.pos = save
            else:
                call.args["_timestamp"] = ts
        self._close()
        return call

    def _call_setrowattrs(self) -> Call:
        call = Call("SetRowAttrs")
        self._open()
        f = self.match(_FIELD)
        if f is None:
            raise self.err("expected field name")
        call.args["_field"] = f
        self.comma()
        call.args["_row"] = self._col_or_key()
        self.comma()
        self._args(call)
        self._close()
        return call

    def _call_setcolumnattrs(self) -> Call:
        call = Call("SetColumnAttrs")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args(call)
        self._close()
        return call

    def _call_clear(self) -> Call:
        call = Call("Clear")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args(call)
        self._close()
        return call

    def _call_clearrow(self) -> Call:
        call = Call("ClearRow")
        self._open()
        self._arg(call)
        self._close()
        return call

    # Store(Call, field=row)
    def _call_store(self) -> Call:
        call = Call("Store")
        self._open()
        call.children.append(self.call())
        self.comma()
        self._arg(call)
        self._close()
        return call

    def _call_topn(self) -> Call:
        return self._posfield_call("TopN")

    def _call_rows(self) -> Call:
        return self._posfield_call("Rows")

    def _posfield_call(self, name: str) -> Call:
        call = Call(name)
        self._open()
        f = self.match(_FIELD)
        if f is None:
            raise self.err("expected field name")
        call.args["_field"] = f
        if self.try_comma():
            self._allargs(call)
        self._close()
        return call

    # Range(field=value, from, to) — legacy time range (pql.peg Range)
    def _call_range(self) -> Call:
        call = Call("Range")
        self._open()
        f = self._field_name()
        self.sp()
        self.expect("=")
        self.sp()
        call.args[f] = self._value()
        self.comma()
        self.accept("from=")
        call.args["from"] = self._require_timestamp()
        self.comma()
        self.accept("to=")
        self.sp()
        call.args["to"] = self._require_timestamp()
        self._close()
        return call

    def _generic_call(self, name: str) -> Call:
        call = Call(name)
        self._open()
        self._allargs(call)
        self.try_comma()
        self._close()
        return call

    # allargs <- Call (comma Call)* (comma args)? / args / sp
    def _allargs(self, call: Call):
        self.sp()
        if self.peek(")"):
            return
        save = self.pos
        try:
            child = self.call()
        except ParseError:
            self.pos = save
            self._args(call)
            return
        call.children.append(child)
        while True:
            save = self.pos
            if not self.try_comma():
                break
            if self.peek(")"):
                self.pos = save
                break
            save2 = self.pos
            try:
                call.children.append(self.call())
            except ParseError:
                self.pos = save2
                self._args(call)
                break

    # args <- arg (comma args)? sp
    def _args(self, call: Call):
        self._arg(call)
        while True:
            save = self.pos
            if not self.try_comma():
                break
            if self.peek(")"):
                self.pos = save
                break
            save2 = self.pos
            try:
                self._arg(call)
            except ParseError:
                # could be the trailing timestamp of Set; rewind the comma
                self.pos = save
                break

    def _arg(self, call: Call):
        self.sp()
        # conditional: int <[=] field <[=] int
        save = self.pos
        cond = self._try_conditional()
        if cond is not None:
            f, c = cond
            call.args[f] = c
            return
        self.pos = save
        f = self._field_name()
        self.sp()
        if self.accept("="):
            # '==' is a condition, '=' alone an assignment
            if self.peek("="):
                self.pos -= 1
            else:
                self.sp()
                if f in call.args:
                    raise self.err(f"duplicate argument: {f}")
                call.args[f] = self._value()
                return
        for op in _COND_OPS:
            if self.accept(op):
                self.sp()
                if f in call.args:
                    raise self.err(f"duplicate argument: {f}")
                call.args[f] = Condition(op, self._value())
                return
        raise self.err("expected '=' or condition operator after field")

    def _try_conditional(self):
        """conditional <- condint condLT condfield condLT condint
        e.g. `4 <= x < 9` (ast.go:81 endConditional)."""
        lo_start = self.pos
        lo_s = self.match(_INT)
        if lo_s is None:
            return None
        self.sp()
        op1 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op1 is None:
            return None
        self.sp()
        f = self.match(_FIELD)
        if f is None:
            return None
        self.sp()
        op2 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op2 is None:
            return None
        self.sp()
        hi_start = self.pos
        hi_s = self.match(_INT)
        if hi_s is None:
            return None
        lo = self.mkint(int(lo_s), lo_start)
        hi = self.mkint(int(hi_s), hi_start)
        if op1 == "<":
            lo = lo + 1
        if op2 == "<":
            hi = hi - 1
        return f, Condition(BETWEEN, [lo, hi])

    def _field_name(self) -> str:
        for r in _RESERVED_FIELDS:
            if self.accept(r):
                return r
        f = self.match(_FIELD)
        if f is None:
            raise self.err("expected field name")
        return f

    def _col_or_key(self):
        """col/row: uint or quoted key (pql.peg col/row)."""
        self.sp()
        if self.peek("'") or self.peek('"'):
            return self._quoted_string()
        start = self.pos
        u = self.match(_UINT)
        if u is None:
            raise self.err("expected column/row id or quoted key")
        return self.mkint(int(u), start)

    def _quoted_string(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.eof():
                raise self.err("unterminated string")
            ch = self.text[self.pos]
            if ch == "\\" and self.pos + 1 < len(self.text) and \
                    self.text[self.pos + 1] in (quote, "\\"):
                out.append(self.text[self.pos + 1])
                self.pos += 2
                continue
            if ch == quote:
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1

    def _timestampfmt(self) -> str | None:
        self.sp()
        for quote in ("'", '"'):
            if self.peek(quote):
                save = self.pos
                self.pos += 1
                ts = self.match(_TIMESTAMP)
                if ts is not None and self.accept(quote):
                    return ts
                self.pos = save
                return None
        return self.match(_TIMESTAMP)

    def _require_timestamp(self) -> str:
        self.sp()
        ts = self._timestampfmt()
        if ts is None:
            raise self.err("expected timestamp (YYYY-MM-DDTHH:MM)")
        return ts

    # value <- item / [list]
    def _value(self):
        self.sp()
        if self.accept("["):
            items = []
            self.sp()
            if not self.peek("]"):
                items.append(self._item())
                while self.try_comma():
                    items.append(self._item())
            self.sp()
            self.expect("]")
            return items
        return self._item()

    def _item(self):
        self.sp()
        # null/true/false need a boundary lookahead (pql.peg item)
        for lit, v in (("null", None), ("true", True), ("false", False)):
            if self.peek(lit):
                after = self.pos + len(lit)
                rest = self.text[after:after + 1]
                if rest in ("", ",", ")", " ", "\t", "\n", "]"):
                    self.pos = after
                    return v
        ts = self._timestampfmt()
        if ts is not None:
            return ts
        if self.peek('"') or self.peek("'"):
            return self._quoted_string()
        start = self.pos
        m = self.match(_NUMBER)
        if m is not None:
            # bareword that starts with digits (e.g. 1a2b) must win over a
            # partial number parse
            nxt = self.text[self.pos:self.pos + 1]
            if nxt and (nxt.isalnum() or nxt in "_:-") and "." not in m:
                self.pos -= len(m)
            elif "." in m:
                return float(m)
            else:
                v = int(m)
                if not (-(1 << 63) <= v < (1 << 63)):
                    # int64 range, like the reference's strconv.ParseInt
                    # failure (ast.go addNumVal)
                    raise self.err(f"integer out of int64 range: {m}")
                return self.mkint(v, start)
        save = self.pos
        ident = self.match(_IDENT)
        if ident is not None:
            self.sp()
            if self.peek("("):
                return self._generic_call(ident)
            self.pos = save
        w = self.match(_BAREWORD)
        if w is not None:
            return w
        raise self.err("expected a value")


def parse(text: str, mkint=None) -> Query:
    """(pql/parser.go:48 ParseString).  ``mkint`` tags integer literals with
    source positions for the prepared-statement cache."""
    return _Parser(text, mkint).parse()
