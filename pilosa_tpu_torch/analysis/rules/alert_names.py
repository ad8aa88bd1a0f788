"""alert-names: two-way alert_rule <-> catalog check.

Alert-rule ids are the paging contract: an operator woken by
``ALERT fire [page] slo-latency-burn`` must find a catalog row that
says what the alert means and — crucially — WHERE TO LOOK, so every
row's runbook line must name a ``/debug`` surface.  The lint is
two-way like event-names: a registered rule with no catalog row is an
unexplained page; a catalog row matching no ``alert_rule("...")``
registration documents an alert that can never fire.  The catalog is
``docs/observability.md`` plus the port's supplement
(rules/catalogs.py).
"""

from __future__ import annotations

import ast

from ..astlint import Finding, project_rule
from .catalogs import NAMED, rows, sections


def _rule_sites(mod):
    """(id, line) for every literal ``alert_rule("...")`` decorator or
    call in a module (utils/slo.py today, but the lint is site-agnostic
    so subsystem-local rules stay covered)."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else \
            f.attr if isinstance(f, ast.Attribute) else None
        if name != "alert_rule":
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value, node.lineno


@project_rule("alert-names")
def check(modules, root):
    """alert_rule id missing a catalog row / row with no registration /
    row whose runbook names no /debug surface."""
    code: dict[str, tuple[str, int]] = {}
    for rel, mod in modules.items():
        if not rel.startswith("pilosa_tpu_torch/"):
            continue
        if rel.startswith("pilosa_tpu_torch/analysis/"):
            continue  # the analyzer's own docs show ids on purpose
        for rid, line in _rule_sites(mod):
            code.setdefault(rid, (rel, line))
    if not code:
        return  # SLO engine absent: nothing to check against

    secs, problems = sections(root, "alert-names", "alerts")
    if problems:
        yield from problems
        return
    docs = sorted((n, rest, rel, line) for rel, line, body in secs
                  for n, rest in rows(body))

    for rid in sorted(code):
        if not any(n == rid for n, _, _, _ in docs):
            rel, line = code[rid]
            yield Finding("alert-names", rel, line,
                          f"alert rule '{rid}' is registered but missing "
                          f"from the alerts catalogs ({NAMED})")
    for rid, rest, rel, line in docs:
        if rid not in code:
            yield Finding("alert-names", rel, line,
                          f"alerts-catalog row '{rid}' matches no "
                          f"alert_rule registration")
        elif "/debug" not in rest:
            yield Finding("alert-names", rel, line,
                          f"alerts-catalog row '{rid}' has no runbook "
                          f"surface — the row must name a /debug "
                          f"endpoint to look at")
