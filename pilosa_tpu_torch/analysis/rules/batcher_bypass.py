"""batcher-bypass: direct stacked-reducer dispatch outside parallel/.

Device dispatch must flow through the dispatch batcher
(parallel/batcher.py): a direct call of a ``StackedExecutor`` reducer
bypasses cross-query fusion, the queued-deadline drop-out, the dispatch
stats and the launch lock that serialises every launch on the card.
Only ``parallel/`` touches the reducers; everything else goes through
``executor.batcher``'s same-named wrappers.

The pass is receiver-aware: besides literal ``self.stacked.segments(
...)`` shapes it tracks simple local aliases (``st = ex.stacked;
st.segments(...)`` and ``st = StackedExecutor(...)``).  The executor
holds its reducers as ``self.stacked``, so a call chain naming
``stacked`` is the taint.
"""

from __future__ import annotations

import ast

from ..astlint import rule

# The reducers of parallel/stacked.py (its module docstring), and their
# fetched forms.
REDUCERS = {
    "count_async", "count", "segments", "segments_batch",
    "row_counts_async", "row_counts", "group_counts_batch_async",
    "bsi_sum_async", "bsi_min_max", "count_batch_async",
    "row_counts_batch_async", "bsi_sum_batch_async",
}


def _chain_names(node) -> list[str]:
    """Attribute chain as name parts: self.executor.stacked -> [self,
    executor, stacked]."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _is_stacked_expr(node, aliases: set[str]) -> bool:
    if isinstance(node, ast.Call):  # st = StackedExecutor(...)
        inner = _chain_names(node.func)
        return bool(inner) and inner[-1] == "StackedExecutor"
    parts = _chain_names(node)
    if not parts:
        return False
    if parts[0] in aliases:
        return True
    return any("stacked" in p for p in parts)


@rule("batcher-bypass", scope="src")
def check(mod):
    """Stacked reducer call outside parallel/ (route through the
    batcher)."""
    rel = mod.rel.replace("\\", "/")
    if rel.startswith(("pilosa_tpu_torch/parallel/",
                       "pilosa_tpu_torch/analysis/")):
        return
    # a Name assigned from a stacked-looking expression taints that name
    # for the rest of the module (over-approximate, which is the safe
    # direction for a bypass check)
    aliases: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_stacked_expr(node.value, aliases):
            aliases.add(node.targets[0].id)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in REDUCERS:
            continue
        if _is_stacked_expr(node.func.value, aliases):
            yield node.lineno, (
                f"direct stacked dispatch '{node.func.attr}' outside "
                f"parallel/ — route through executor.batcher "
                f"(parallel/batcher.py) so fusion, deadline drop-out, "
                f"dispatch stats and the launch lock apply")
