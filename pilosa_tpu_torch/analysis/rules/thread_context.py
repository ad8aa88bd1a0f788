"""thread-context: contextvar reads across an unprotected thread hop
(the orphan-span/profile bug class).

The tracing and profile contexts ride contextvars (utils/tracing.py,
utils/profile.py).  A function handed to ``pool.submit`` or
``Thread(target=...)`` runs with EMPTY contextvars: spans parent as
orphan roots and profile events vanish, silently — the fix threads
``capture()``/``attach()``/``task()`` through every pool boundary
(cluster fan-out, dispatch batcher, shard-slice prefetch).

The rule flags a submit/Thread callsite whose resolvable target touches
tracing/profile context (``qprof.stage``, ``tracer.span``,
``GLOBAL_TRACER``...) without re-attaching a captured context (no
``attach``/``task``/``activate`` in its body).  Background monitors that
intentionally start fresh root traces carry an inline allow.
"""

from __future__ import annotations

import ast

from ..astlint import rule

_CTX_ATTRS = {"stage", "event", "span", "current", "capture", "inject",
              "current_trace_id"}
_CTX_FRAGMENTS = ("prof", "trac")
_REATTACH = {"attach", "task", "activate"}


def _chain(node) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _touches_context(fn_node) -> tuple[bool, bool]:
    """(touches tracing/profile contextvars, re-attaches a context)."""
    touches = reattaches = False
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else None)
        if name in _REATTACH:
            reattaches = True
        if name in _CTX_ATTRS and isinstance(node.func, ast.Attribute):
            recv = "".join(_chain(node.func.value)).lower()
            if any(f in recv for f in _CTX_FRAGMENTS):
                touches = True
    return touches, reattaches


def _resolve_target(arg, call_scope):
    """The submitted callable's function scope, when statically
    resolvable: a local def/lambda by name, or a self-method."""
    if isinstance(arg, ast.Lambda):
        return arg._ptpu_fscope
    if isinstance(arg, ast.Name):
        return call_scope.lookup_func(arg.id)
    if isinstance(arg, ast.Attribute) and \
            isinstance(arg.value, ast.Name) and arg.value.id == "self":
        s = call_scope
        while s is not None and s.kind != "class":
            s = s.parent
        if s is not None:
            return s.funcs.get(arg.attr)
    return None


@rule("thread-context", scope="src")
def check(mod):
    """submit/Thread target touches tracing/profile contextvars without
    re-attaching captured context."""
    mod.scopes  # annotate nodes with their scopes
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        target = None
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else None)
        if fname == "submit" and node.args:
            target = node.args[0]
        elif fname == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
        if target is None:
            continue
        fscope = _resolve_target(target, node._ptpu_scope)
        if fscope is None:
            continue  # wrapped (tracer.task(fn)) or non-local: fine
        touches, reattaches = _touches_context(fscope.node)
        if touches and not reattaches:
            yield node.lineno, (
                "thread-hop target touches tracing/profile contextvars "
                "without re-attaching captured context — wrap it with "
                "tracer.task()/attach() (or profile.activate) so spans "
                "and profile events land in the submitting request")
