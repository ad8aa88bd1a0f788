"""AST lint framework: scope-aware rules over the port's tree.

Each rule encodes an invariant a real bug taught (docs/static-analysis.md
has the catalog with the motivating bug per rule).  Rules are AST
passes, not greps: they see aliased imports, nested scopes, and call
shapes a regex misses.

Suppressions are inline comments on the finding line (or the line
directly above, for lines with no room):

    # lint: allow(<rule>[, <rule>...]) — <reason>

and every suppression MUST carry a reason — a reasonless allow is itself
a finding (``suppression-reason``), and an allow that no longer matches
any finding is too (``suppression-unused``), so the allow list can only
shrink as bugs are fixed.

Two rule kinds register here:

* per-module rules (``@rule``) — run once per parsed file, scoped to
  ``src`` (pilosa_tpu_torch/, chip_smoke.py) or ``all`` (src + the
  port's tests, ``tests/test_torch_*.py``);
* project rules (``@project_rule``) — run once over the whole tree
  (cross-file catalogs: metrics docs, failpoint names).

``run()`` is the ``python -m pilosa_tpu_torch.analysis`` entry;
``lint_source`` lints a source string for the golden-fixture tests.

Port copy of the JAX package's ``analysis/astlint.py``, repointed at the
port: the JAX package's own analyzer lints the JAX package, scripts/
and every test file; this one lints the port, its smoke run and its
tests.
"""

from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path

SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*([a-z0-9_*,\- ]+?)\s*\)\s*(?:[—–:-]+\s*)?(.*)")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Suppressions:
    """Inline ``# lint: allow(rule) — reason`` comments of one file.
    Parsed from real COMMENT tokens — text inside a docstring that
    merely looks like a suppression (this framework's own docs, say)
    suppresses nothing."""

    def __init__(self, source: str):
        import io
        import tokenize
        self.by_line: dict[int, set[str]] = {}
        self.missing_reason: list[tuple[int, set[str]]] = []
        self.comment_lines: set[int] = set()
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except (tokenize.TokenError, SyntaxError):
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            # only comment-ONLY lines extend a suppression block upward;
            # a trailing comment on a code line must not leak its allow
            # onto the next line's findings
            if tok.line.lstrip().startswith("#"):
                self.comment_lines.add(tok.start[0])
            m = SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            i = tok.start[0]
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            self.by_line[i] = rules
            if not m.group(2).strip():
                self.missing_reason.append((i, rules))
        self._used: set[tuple[int, str]] = set()

    def _match(self, rule_id: str, ln: int) -> bool:
        rules = self.by_line.get(ln)
        if rules and (rule_id in rules or "*" in rules):
            self._used.add((ln, rule_id if rule_id in rules else "*"))
            return True
        return False

    def allows(self, rule_id: str, line: int) -> bool:
        # the comment rides the finding line itself, or anywhere in the
        # contiguous comment block directly above it (reasons wrap)
        if self._match(rule_id, line):
            return True
        ln = line - 1
        while ln in self.comment_lines:
            if self._match(rule_id, ln):
                return True
            ln -= 1
        return False

    def unused(self, active_rules: set[str]):
        """(line, rule) allows that matched no finding — stale allows
        must be deleted, not accumulate.  Only rules that actually ran
        count (a partial run must not read scoped-out allows as stale)."""
        for ln, rules in self.by_line.items():
            for r in rules:
                if r == "*" or r not in active_rules:
                    continue
                if (ln, r) not in self._used:
                    yield ln, r


# -- scope analysis ---------------------------------------------------------


class Scope:
    """One lexical scope and the functions defined directly in it — the
    map from a call site to its lexical context that the thread-context
    and wall-clock rules read.  (The JAX package's copy also records
    bindings and loads for its traced-closure rule, which the port does
    not have.)"""

    __slots__ = ("node", "kind", "parent", "funcs")

    def __init__(self, node, kind: str, parent: "Scope | None"):
        self.node = node
        self.kind = kind            # "module" | "function" | "class"
        self.parent = parent
        self.funcs: dict[str, Scope] = {}   # name -> immediate child def

    def lookup_func(self, name: str) -> "Scope | None":
        """Resolve ``name`` to a function scope visible from here (the
        Name-passed-to-wrapper case)."""
        s: Scope | None = self
        while s is not None:
            if name in s.funcs:
                return s.funcs[name]
            s = s.parent
        return None


class _ScopeWalker(ast.NodeVisitor):
    def __init__(self, tree):
        self.root = Scope(tree, "module", None)
        self._cur = self.root
        self.generic_visit(tree)

    # every visited node gets a backlink to its scope so rules can map a
    # call site to its lexical context
    def visit(self, node):
        node._ptpu_scope = self._cur
        super().visit(node)

    def generic_visit(self, node):
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _visit_body(self, node, kind: str, body):
        parent = self._cur
        self._cur = Scope(node, kind, parent)
        node._ptpu_scope = parent            # the def site's scope
        for stmt in body:
            self.visit(stmt)
        inner, self._cur = self._cur, parent
        return inner

    def _visit_funclike(self, node, name: str | None):
        # decorators/defaults/annotations evaluate in the DEFINING scope
        for dec in getattr(node, "decorator_list", []):
            self.visit(dec)
        for d in node.args.defaults + [d for d in node.args.kw_defaults
                                       if d is not None]:
            self.visit(d)
        body = node.body if isinstance(node.body, list) else [node.body]
        fscope = self._visit_body(node, "function", body)
        node._ptpu_fscope = fscope           # the function's own scope
        if name is not None:
            self._cur.funcs[name] = fscope

    def visit_FunctionDef(self, node):
        self._visit_funclike(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_funclike(node, None)

    def visit_ClassDef(self, node):
        for dec in node.decorator_list:
            self.visit(dec)
        for base in node.bases + node.keywords:
            self.visit(base)
        self._visit_body(node, "class", node.body)


# -- parsed module ----------------------------------------------------------


class Module:
    def __init__(self, rel: str, source: str, is_test: bool = False):
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.is_test = is_test
        self.tree = ast.parse(source, filename=rel)
        self.suppressions = Suppressions(source)
        self._scopes: Scope | None = None

    @property
    def scopes(self) -> Scope:
        if self._scopes is None:
            self._scopes = _ScopeWalker(self.tree).root
        return self._scopes


# -- registry ---------------------------------------------------------------


@dataclass
class Rule:
    id: str
    scope: str          # "src" | "all"
    fn: object
    doc: str


RULES: dict[str, Rule] = {}
PROJECT_RULES: dict[str, Rule] = {}


def rule(rule_id: str, scope: str = "src", doc: str = ""):
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, scope, fn, doc or fn.__doc__ or "")
        fn.rule_id = rule_id
        return fn
    return deco


def project_rule(rule_id: str, doc: str = ""):
    def deco(fn):
        PROJECT_RULES[rule_id] = Rule(rule_id, "all", fn,
                                      doc or fn.__doc__ or "")
        fn.rule_id = rule_id
        return fn
    return deco


def _load_rules():
    from . import rules  # noqa: F401  (registers on import)


# -- runner -----------------------------------------------------------------

SRC_DIRS = ("pilosa_tpu_torch",)
SRC_FILES = ("chip_smoke.py",)
# The port's tests; the JAX package's analyzer lints the others.
TEST_GLOB = "test_torch_*.py"


def iter_modules(root: Path):
    """Yield (rel, path, is_test) for every lintable python file."""
    seen = []
    for d in SRC_DIRS:
        base = root / d
        if base.is_dir():
            seen += [(p, False) for p in sorted(base.rglob("*.py"))]
    for f in SRC_FILES:
        p = root / f
        if p.is_file():
            seen.append((p, False))
    tests = root / "tests"
    if tests.is_dir():
        seen += [(p, True) for p in sorted(tests.glob(TEST_GLOB))]
    for path, is_test in seen:
        yield str(path.relative_to(root)), path, is_test


def _run_module_rules(mod: Module, rule_ids) -> list[Finding]:
    out = []
    for r in (RULES[i] for i in rule_ids):
        if r.scope == "src" and mod.is_test:
            continue
        for line, msg in r.fn(mod):
            if not mod.suppressions.allows(r.id, line):
                out.append(Finding(r.id, mod.rel, line, msg))
    return out


def run(root: Path, rule_ids: list[str] | None = None) -> list[Finding]:
    """Lint the whole tree; returns every unsuppressed finding.
    Unknown rule ids raise — a typo'd ``--rule`` must not silently
    analyze nothing and report success (the failpoint-names bug class,
    turned on ourselves)."""
    _load_rules()
    if rule_ids is not None:
        unknown = [i for i in rule_ids
                   if i not in RULES and i not in PROJECT_RULES]
        if unknown:
            known = ", ".join(sorted({**RULES, **PROJECT_RULES}))
            raise ValueError(
                f"unknown rule id(s): {', '.join(unknown)} "
                f"(known: {known})")
    mod_ids = [i for i in (rule_ids or RULES) if i in RULES]
    proj_ids = [i for i in (rule_ids or PROJECT_RULES) if i in PROJECT_RULES]
    modules: dict[str, Module] = {}
    findings: list[Finding] = []
    for rel, path, is_test in iter_modules(root):
        try:
            modules[rel] = Module(rel, path.read_text(), is_test)
        except SyntaxError as e:
            findings.append(Finding("syntax", rel, e.lineno or 0, str(e)))
    for mod in modules.values():
        findings += _run_module_rules(mod, mod_ids)
    for r in (PROJECT_RULES[i] for i in proj_ids):
        for f in r.fn(modules, root):
            mod = modules.get(f.path)
            if mod is None or not mod.suppressions.allows(r.id, f.line):
                findings.append(f)
    # suppression hygiene runs only on a FULL-rule pass: a scoped run
    # hasn't exercised the other rules' allows
    if rule_ids is None:
        active = set(RULES) | set(PROJECT_RULES)
        for mod in modules.values():
            for ln, rules_ in mod.suppressions.missing_reason:
                findings.append(Finding(
                    "suppression-reason", mod.rel, ln,
                    f"allow({', '.join(sorted(rules_))}) carries no "
                    f"reason — every suppression must say why"))
            for ln, rid in mod.suppressions.unused(active):
                findings.append(Finding(
                    "suppression-unused", mod.rel, ln,
                    f"allow({rid}) matches no finding — delete the "
                    f"stale suppression"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_source(source: str, rule_ids: list[str] | None = None,
                rel: str = "snippet.py",
                is_test: bool = False) -> list[Finding]:
    """Lint one source string (the golden-fixture test entry)."""
    _load_rules()
    mod = Module(rel, source, is_test)
    ids = [i for i in (rule_ids or RULES) if i in RULES]
    return sorted(_run_module_rules(mod, ids),
                  key=lambda f: (f.line, f.rule))


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m pilosa_tpu_torch.analysis",
        description="the port's invariant analyzer "
                    "(docs/static-analysis.md)")
    p.add_argument("--root", default=".",
                   help="repo checkout to analyze (default: cwd)")
    p.add_argument("--rule", action="append", dest="rules", default=None,
                   help="run only this rule id (repeatable)")
    p.add_argument("--list-rules", action="store_true")
    args = p.parse_args(argv)
    _load_rules()
    if args.list_rules:
        for r in sorted({**RULES, **PROJECT_RULES}.values(),
                        key=lambda r: r.id):
            first = (r.doc or "").strip().splitlines()
            print(f"{r.id:24s} {first[0] if first else ''}")
        return 0
    root = Path(args.root).resolve()
    if not (root / "pilosa_tpu_torch").is_dir():
        print(f"analysis: no pilosa_tpu_torch/ package under {root}",
              file=sys.stderr)
        return 2
    try:
        findings = run(root, args.rules)
    except ValueError as e:
        print(f"analysis: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f)
    n_rules = len(RULES) + len(PROJECT_RULES)
    if findings:
        print(f"analysis: FAIL — {len(findings)} finding(s) "
              f"across {n_rules} rules")
        return 1
    print(f"analysis: OK ({n_rules} rules)")
    return 0
