"""wall-clock: ``time.time()`` in timing code (the wall-clock duration class).

Durations must come from ``time.perf_counter()`` pairs — wall clock
steps (NTP slew, manual set) mid-measurement produce negative/garbage
durations in traces, histograms, and pacing loops.  Wall-clock reads
are legitimate only as display-only stamps, and those sites annotate
themselves: a ``_wall_stamp`` helper, or an inline
``# lint: allow(wall-clock) — <reason>``.

A grep misses ``from time import time`` and ``import time as t``
aliases entirely — this pass tracks the import bindings, so every
spelling of a wall-clock read is caught.
"""

from __future__ import annotations

import ast

from ..astlint import rule


@rule("wall-clock", scope="src")
def check(mod):
    """time.time() outside an annotated _wall_stamp/display-only site."""
    mod_aliases: set[str] = set()    # names bound to the time MODULE
    fn_aliases: set[str] = set()     # names bound to the time FUNCTION
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mod_aliases.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name == "time":
                        fn_aliases.add(a.asname or "time")
    if not mod_aliases and not fn_aliases:
        return
    mod.scopes  # ensure every node carries its _ptpu_scope backlink
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = (isinstance(f, ast.Attribute) and f.attr == "time"
               and isinstance(f.value, ast.Name)
               and f.value.id in mod_aliases) \
            or (isinstance(f, ast.Name) and f.id in fn_aliases)
        if not hit:
            continue
        # annotated wall-stamp helpers are the sanctioned sites
        s = node._ptpu_scope
        allowed = False
        while s is not None:
            fn = s.node
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.name == "_wall_stamp":
                allowed = True
                break
            s = s.parent
        if not allowed:
            yield node.lineno, (
                "wall-clock time.time() in timing code — durations come "
                "from perf_counter pairs; display-only stamps go through "
                "a _wall_stamp helper or carry an inline allow")
