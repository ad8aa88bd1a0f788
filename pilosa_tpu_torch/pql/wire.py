"""AST <-> JSON wire codec for node-to-node query forwarding.

The reference re-sends the original PQL string with a protobuf QueryRequest
carrying Remote=true + pinned shards (http/client.go:268 QueryNode,
internal/private.proto QueryRequest).  Here the coordinator fans out
*individual calls*, so the call tree is shipped as JSON — no re-parse on
the remote side, and write-call fan-out can pin exactly one call.

Port copy of the JAX package's ``pql/wire.py``: the PyTorch port keeps
its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any

from .ast import Call, Condition


def _enc_val(v) -> Any:
    if isinstance(v, Condition):
        return {"$cond": [v.op, v.value]}
    return v


def _dec_val(v) -> Any:
    if isinstance(v, dict) and "$cond" in v:
        op, value = v["$cond"]
        return Condition(op, value)
    return v


def call_to_wire(c: Call) -> dict:
    return {
        "name": c.name,
        "args": {k: _enc_val(v) for k, v in c.args.items()},
        "children": [call_to_wire(ch) for ch in c.children],
    }


def call_from_wire(d: dict) -> Call:
    return Call(
        d["name"],
        {k: _dec_val(v) for k, v in d.get("args", {}).items()},
        [call_from_wire(ch) for ch in d.get("children", [])],
    )
