"""metrics-docs: two-way stats-name <-> catalog check.

The metrics catalog is the operator's contract: every stats series the
code can emit must have a catalog row, and every row must still match a
call site.  An undocumented series is invisible to dashboards; a
dangling row documents a lie.  Dynamic f-string segments in code and
``<...>`` placeholders in docs both normalize to ``*`` and match by
glob.  The catalog is ``docs/observability.md`` plus the port's
supplement (rules/catalogs.py).
"""

from __future__ import annotations

import fnmatch
import re

from ..astlint import Finding, project_rule
from .catalogs import NAMED, rows, sections

CALL = re.compile(
    r'[a-z_]*stats\.(?:count|gauge|timing|timer|histogram)\(\s*(f?)"([^"]+)"',
    re.S)
HELPER = re.compile(r"\b_count\(")  # dotted-name prefix helpers
NAME = re.compile(r'"([a-z0-9_]+(?:\.[a-z0-9_{}.]+)+)"')


@project_rule("metrics-docs")
def check(modules, root):
    """Stats series missing from the catalogs / rows matching no site."""
    code: dict[str, tuple[str, int]] = {}  # name -> first (rel, line)
    for rel, mod in modules.items():
        if not rel.startswith("pilosa_tpu_torch/"):
            continue
        for m in CALL.finditer(mod.source):
            is_f, name = m.groups()
            if is_f:
                name = re.sub(r"\{[^}]*\}", "*", name)
            code.setdefault(name,
                            (rel, mod.source.count("\n", 0, m.start()) + 1))
        for m in HELPER.finditer(mod.source):
            # every dotted literal near the helper call (covers
            # conditional names like "a.hit" if ... else "a.miss")
            line = mod.source.count("\n", 0, m.start()) + 1
            for name in NAME.findall(mod.source[m.end():m.end() + 160]):
                code.setdefault(re.sub(r"\{[^}]*\}", "*", name),
                                (rel, line))

    secs, problems = sections(root, "metrics-docs", "metrics")
    if problems:
        yield from problems
        return
    docs = [(re.sub(r"<[^>]*>", "*", n), rel, line)
            for rel, line, body in secs for n, _ in rows(body)]

    for name in sorted(code):
        if not any(fnmatch.fnmatch(name, d) for d, _, _ in docs):
            rel, line = code[name]
            yield Finding("metrics-docs", rel, line,
                          f"stats series '{name}' missing from the "
                          f"catalogs ({NAMED})")
    for d, rel, line in sorted(set(docs)):
        if not any(fnmatch.fnmatch(c, d) for c in code):
            yield Finding("metrics-docs", rel, line,
                          f"catalog row '{d}' matches no stats call site")
