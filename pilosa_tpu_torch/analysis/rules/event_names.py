"""event-names: two-way events.emit <-> catalog check.

The event catalog (the ``events-catalog`` markers) is the operator's
contract for the /debug/events journal and the /debug/cluster fleet
timeline, exactly like the metrics catalog is for /metrics: an
uncataloged ``events.emit("...")`` site produces timeline entries no
runbook explains, and a dangling catalog row documents an event that
can never fire (the failpoint-names lesson — a name nothing emits reads
as "this never happened" when it actually CAN'T happen).  The catalog
is ``docs/observability.md`` plus the port's supplement
(rules/catalogs.py).
"""

from __future__ import annotations

import ast

from ..astlint import Finding, project_rule
from .catalogs import NAMED, rows, sections


def _recv(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _emit_sites(mod):
    """(name, line) for every literal ``events.emit("...")`` /
    ``EVENTS.emit("...")`` call in a module."""
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"):
            continue
        recv = _recv(node.func.value)
        if not (recv.endswith("events") or recv.endswith("EVENTS")
                or recv.endswith("self")):
            continue
        # self.emit(...) only counts inside utils/events.py itself
        if recv.endswith("self") and not mod.rel.endswith(
                "utils/events.py"):
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value, node.lineno


@project_rule("event-names")
def check(modules, root):
    """events.emit name missing from the catalogs / row no site emits."""
    code: dict[str, tuple[str, int]] = {}
    for rel, mod in modules.items():
        if not rel.startswith("pilosa_tpu_torch/"):
            continue
        if rel.startswith("pilosa_tpu_torch/analysis/"):
            continue  # the analyzer's own docs show names on purpose
        for name, line in _emit_sites(mod):
            code.setdefault(name, (rel, line))
    if not code:
        return  # journal absent: nothing to check against

    secs, problems = sections(root, "event-names", "events")
    if problems:
        yield from problems
        return
    docs = {(n, rel, line) for rel, line, body in secs
            for n, _ in rows(body)}

    for name in sorted(code):
        if not any(d == name for d, _, _ in docs):
            rel, line = code[name]
            yield Finding("event-names", rel, line,
                          f"event '{name}' is emitted but missing from "
                          f"the events catalogs ({NAMED})")
    for d, rel, line in sorted(docs):
        if d not in code:
            yield Finding("event-names", rel, line,
                          f"events-catalog row '{d}' matches no "
                          f"events.emit site")
