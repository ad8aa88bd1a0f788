"""failpoint-names: armed failpoints must name a real trigger site.

``FAULTS.hit("fragment.wal")`` callsites define the failpoint namespace;
tests and game-day specs arm names from it.  A typo'd arm
(``fragment.waal=kill:25``) silently never fires — the crash harness
soaks against NOTHING and reports green.  This rule collects every
literal ``FAULTS.hit`` name in pilosa_tpu_torch/ and checks every armed
reference against it: ``FAULTS.arm("...")`` first arguments, literal
``FAULTS.configure`` specs, and any ``name=error|delay|kill`` spec
string literal (env specs, crash-harness specs, f-string prefixes).
"""

from __future__ import annotations

import ast
import re

from ..astlint import Finding, project_rule

SPEC_NAME = re.compile(r"([a-z0-9_.]+)=(?:error|delay|kill)\b")


def _recv(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _literal_parts(node):
    """String content visible in a Constant or an f-string's constant
    segments (the crash harness builds specs like
    f"fragment.wal=kill:{n}")."""
    s = _str_const(node)
    if s is not None:
        yield s
    elif isinstance(node, ast.JoinedStr):
        for part in node.values:
            s = _str_const(part)
            if s is not None:
                yield s


@project_rule("failpoint-names")
def check(modules, root):
    """Armed failpoint name with no FAULTS.hit trigger site."""
    hits: set[str] = set()
    for rel, mod in modules.items():
        if not rel.startswith("pilosa_tpu_torch/"):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "hit" \
                    and _recv(node.func.value).endswith("FAULTS") \
                    and node.args:
                name = _str_const(node.args[0])
                if name:
                    hits.add(name)
    if not hits:
        return  # registry absent: nothing to check against

    def armed_names(mod):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and "FAULTS" in _recv(node.func.value):
                if node.func.attr == "arm" and node.args:
                    name = _str_const(node.args[0])
                    if name:
                        yield name, node.lineno
                    continue
                if node.func.attr == "configure" and node.args:
                    spec = _str_const(node.args[0])
                    for part in (spec or "").split(";"):
                        name = part.strip().partition("=")[0]
                        if name:
                            yield name, node.lineno
                    continue
            # bare spec literals: env specs, crash-harness kill specs
            for text in _literal_parts(node):
                for name in SPEC_NAME.findall(text):
                    yield name, node.lineno

    for rel, mod in modules.items():
        if rel.startswith("pilosa_tpu_torch/analysis/"):
            continue  # the analyzer's own docs show BAD specs on purpose
        seen: set[tuple[str, int]] = set()
        for name, line in armed_names(mod):
            if name in hits or (name, line) in seen:
                continue
            seen.add((name, line))
            yield Finding(
                "failpoint-names", rel, line,
                f"failpoint '{name}' is armed but has no FAULTS.hit "
                f"trigger site — a typo'd arm never fires and the "
                f"harness soaks against nothing")
