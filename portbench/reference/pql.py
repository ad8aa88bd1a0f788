"""A small PQL reader and its evaluation over a ``Histogram``.

Reads the calls the traffic mixes send: ``Count``, ``Intersect``,
``Union``, ``Row(f=v)``, ``Rows(f)``, ``TopN(f, [filter], n=k)``,
``GroupBy(Rows(a), Rows(b), ..., [filter])`` and ``Sum([filter],
field=v)``.  A bitmap is a boolean mask over the histogram's cells;
answers take the forms of the port's ``to_dict`` results:

* Count: an int;
* TopN: ``[{"id", "count"}]``, the ``n`` rows of most facts under the
  filter, ties by row id, rows of no fact left out;
* GroupBy: ``[{"group": [{"field", "rowID"}, ...], "count"}]`` over the
  combinations in row order of the first field, then the next, empty
  combinations left out;
* Sum: ``{"value", "count"}``, the sum of the field's values under the
  filter and how many facts there hold one.

Integer arithmetic stays in the histogram's dtype: int64 for the
reference, float32 for the control, whose answers are rounded to ints.
"""

from __future__ import annotations

import re

import numpy as np

_TOKEN = re.compile(r"\s*(?:([A-Za-z_][A-Za-z0-9_]*)|(-?\d+)|(.))")


class Call:
    __slots__ = ("name", "args", "kwargs")

    def __init__(self, name, args, kwargs):
        self.name, self.args, self.kwargs = name, args, kwargs

    def __repr__(self):
        return f"{self.name}({self.args!r}, {self.kwargs!r})"


def _tokens(text: str):
    out = []
    for m in _TOKEN.finditer(text):
        ident, num, sym = m.groups()
        if ident is not None:
            out.append(("id", ident))
        elif num is not None:
            out.append(("num", int(num)))
        elif sym is not None and sym.strip():
            out.append(("sym", sym))
    return out


def parse(text: str) -> list[Call]:
    """The calls of one request."""
    toks = _tokens(text)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else (None, None)

    def take(kind=None, value=None):
        nonlocal pos
        tok = peek()
        if (kind and tok[0] != kind) or (value and tok[1] != value):
            raise ValueError(f"PQL: expected {value or kind} at {tok} in "
                             f"{text!r}")
        pos += 1
        return tok[1]

    def call():
        name = take("id")
        take("sym", "(")
        args, kwargs = [], {}
        while peek() != ("sym", ")"):
            if peek()[0] == "id" and pos + 1 < len(toks) and \
                    toks[pos + 1][0] == "sym" and toks[pos + 1][1] == "=":
                key = take("id")
                take("sym", "=")
                kwargs[key] = take("num") if peek()[0] == "num" \
                    else take("id")
            elif peek()[0] == "id" and pos + 1 < len(toks) and \
                    toks[pos + 1] == ("sym", "("):
                args.append(call())
            elif peek()[0] == "id":
                args.append(take("id"))
            else:
                args.append(take("num"))
            if peek() == ("sym", ","):
                take("sym", ",")
        take("sym", ")")
        return Call(name, args, kwargs)

    calls = []
    while pos < len(toks):
        calls.append(call())
    return calls


class Evaluator:
    def __init__(self, hist):
        self.h = hist

    def _mask(self, c: Call) -> np.ndarray:
        h = self.h
        if c.name == "Row":
            (field, row), = c.kwargs.items()
            ax = h.axis[field]
            sel = np.zeros(h.shape, dtype=bool)
            idx = [slice(None)] * len(h.shape)
            if 0 <= row < h.shape[ax]:
                idx[ax] = row
                sel[tuple(idx)] = True
            return sel
        if c.name in ("Intersect", "Union"):
            masks = [self._mask(a) for a in c.args]
            op = np.logical_and if c.name == "Intersect" else np.logical_or
            out = masks[0]
            for m in masks[1:]:
                out = op(out, m)
            return out
        raise ValueError(f"reference: no bitmap call {c.name}")

    def _filter(self, args) -> np.ndarray:
        calls = [a for a in args if isinstance(a, Call) and a.name != "Rows"]
        if not calls:
            return np.ones(self.h.shape, dtype=bool)
        (f,) = calls
        return self._mask(f)

    def _total(self, arr, mask):
        return int(np.rint(arr[mask].sum(dtype=arr.dtype)))

    def answer(self, c: Call):
        h = self.h
        if c.name == "Count":
            return self._total(h.counts, self._mask(c.args[0]))
        if c.name == "Sum":
            field = c.kwargs["field"]
            mask = self._filter(c.args)
            return {"value": self._total(h.sums[field], mask),
                    "count": self._total(h.valued[field], mask)}
        if c.name == "TopN":
            field = c.args[0]
            n = c.kwargs.get("n")
            ax = h.axis[field]
            mask = self._filter(c.args[1:])
            per = np.where(mask, h.counts, 0)
            other = tuple(i for i in range(per.ndim) if i != ax)
            counts = [int(np.rint(x)) for x in per.sum(axis=other,
                                                       dtype=per.dtype)]
            order = sorted(range(len(counts)), key=lambda r: (-counts[r], r))
            order = [r for r in order if counts[r] > 0]
            if n is not None:
                order = order[:n]
            return [{"id": r, "count": counts[r]} for r in order]
        if c.name == "GroupBy":
            fields = [a.args[0] for a in c.args
                      if isinstance(a, Call) and a.name == "Rows"]
            axes = [h.axis[f] for f in fields]
            mask = self._filter(c.args)
            per = np.where(mask, h.counts, 0)
            other = tuple(i for i in range(per.ndim) if i not in axes)
            grid = per.sum(axis=other, dtype=per.dtype)
            grid = np.transpose(grid, np.argsort(np.argsort(axes)))
            out = []
            for combo in np.ndindex(*grid.shape):
                cnt = int(np.rint(grid[combo]))
                if cnt > 0:
                    out.append({"group": [{"field": f, "rowID": int(r)}
                                          for f, r in zip(fields, combo)],
                                "count": cnt})
            return out
        raise ValueError(f"reference: no call {c.name}")

    def request(self, text: str) -> list:
        return [self.answer(c) for c in parse(text)]
