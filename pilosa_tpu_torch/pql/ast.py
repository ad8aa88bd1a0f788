"""PQL AST: Query, Call, Condition (reference pql/ast.go:27-560).

A query is a list of calls; a call has a name, an args dict (string keys to
int/float/str/bool/None/list/Condition values, with positional args under
reserved keys "_col", "_row", "_field", "_timestamp") and child calls.

Port copy of the JAX package's ``pql/ast.py``: the PyTorch port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Condition operators (pql/token.go / ast.go Condition).
LT, LTE, GT, GTE, EQ, NEQ, BETWEEN = "<", "<=", ">", ">=", "==", "!=", "><"


class LitInt(int):
    """An int carrying the provenance of the query-string literal it came
    from: ``lit`` is the literal's index in the fingerprint's value list and
    ``add`` the affine offset applied since (e.g. the ±1 strict-bound
    adjustment of `4 <= x < 9`, or a BSI base subtraction).  Behaves as a
    plain int everywhere; only the prepared-statement cache
    (executor/prepared.py) looks at the tags.  Affine arithmetic preserves
    provenance; everything else decays to int."""

    def __new__(cls, value, lit: int, add: int = 0):
        x = super().__new__(cls, value)
        x.lit = lit
        x.add = add
        return x

    def __add__(self, other):
        if type(other) is int:
            return LitInt(int(self) + other, self.lit, self.add + other)
        return int(self) + other

    __radd__ = __add__

    def __sub__(self, other):
        if type(other) is int:
            return LitInt(int(self) - other, self.lit, self.add - other)
        return int(self) - other

_COND_STRINGS = {LT: "<", LTE: "<=", GT: ">", GTE: ">=", EQ: "==",
                 NEQ: "!=", BETWEEN: "><"}


@dataclass
class Condition:
    op: str
    value: Any  # int for comparisons, [lo, hi] for BETWEEN

    def string_with_subj(self, subj: str) -> str:
        if self.op == BETWEEN:
            lo, hi = self.value
            return f"{lo} <= {subj} <= {hi}"
        return f"{subj} {self.op} {_value_string(self.value)}"

    def __repr__(self):
        return f"Condition({self.op!r}, {self.value!r})"


def _value_string(v) -> str:
    if isinstance(v, str):
        return f'"{v}"'
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, list):
        return "[" + ",".join(_value_string(x) for x in v) + "]"
    return str(v)


@dataclass
class Call:
    name: str
    args: dict[str, Any] = field(default_factory=dict)
    children: list["Call"] = field(default_factory=list)

    # -- typed arg accessors (pql/ast.go:220-360) --------------------------

    def arg(self, key: str, default=None):
        return self.args.get(key, default)

    def uint_arg(self, key: str) -> tuple[int, bool]:
        """(value, found); raises on non-integer (ast.go UintArg)."""
        v = self.args.get(key)
        if v is None:
            return 0, False
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(
                f"arg {key!r} of call {self.name!r} must be an integer, "
                f"got {v!r}")
        if v < 0:
            raise ValueError(f"arg {key!r} must be non-negative, got {v}")
        return v, True

    def int_arg(self, key: str) -> tuple[int, bool]:
        v = self.args.get(key)
        if v is None:
            return 0, False
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(
                f"arg {key!r} of call {self.name!r} must be an integer, "
                f"got {v!r}")
        return v, True

    def string_arg(self, key: str) -> tuple[str, bool]:
        v = self.args.get(key)
        if v is None:
            return "", False
        if not isinstance(v, str):
            raise TypeError(f"arg {key!r} must be a string, got {v!r}")
        return v, True

    def bool_arg(self, key: str) -> tuple[bool, bool]:
        v = self.args.get(key)
        if v is None:
            return False, False
        if not isinstance(v, bool):
            raise TypeError(f"arg {key!r} must be a bool, got {v!r}")
        return v, True

    def condition_arg(self) -> tuple[str, "Condition"] | None:
        """First (field, Condition) arg if present — used by Row(a < 4) BSI
        dispatch (executor.go:1452)."""
        for k, v in self.args.items():
            if isinstance(v, Condition):
                return k, v
        return None

    def field_arg(self) -> tuple[str, Any] | None:
        """First non-reserved scalar arg: the (field, row) pair of Row/Set
        (ast.go:430)."""
        for k, v in self.args.items():
            if k.startswith("_") or isinstance(v, Condition):
                continue
            return k, v
        return None

    def has_conditions(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def clone(self) -> "Call":
        return Call(
            self.name,
            dict(self.args),
            [c.clone() for c in self.children],
        )

    def __repr__(self):
        parts = [repr(c) for c in self.children]
        parts += [
            (v.string_with_subj(k) if isinstance(v, Condition)
             else f"{k}={_value_string(v)}")
            for k, v in sorted(self.args.items())
        ]
        return f"{self.name}({', '.join(parts)})"


@dataclass
class Query:
    calls: list[Call] = field(default_factory=list)

    def write_calls(self) -> list[Call]:
        return [c for c in self.calls if c.name in WRITE_CALLS]

    def __repr__(self):
        return "".join(repr(c) for c in self.calls)


WRITE_CALLS = {"Set", "Clear", "ClearRow", "Store", "SetRowAttrs",
               "SetColumnAttrs"}
