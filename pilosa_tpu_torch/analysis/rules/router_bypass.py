"""router-bypass: read fan-out grouping outside the routing layer.

The read fan-out's shard->node decision belongs to the read router
(parallel/routing.py): it owns replica scoring, residency preference,
breaker pre-skip, and the placement-overlay view.  A call site that
groups shards by jump-hash primary itself — ``shards_by_node`` (the
primary-pinned grouping helper) or the cluster's internal grouping
methods — dispatches reads the router never saw: no load spreading, no
breaker skip, no overlay consistency, and the per-shard balancer
counters go blind.

Scope: everything outside ``pilosa_tpu_torch/parallel/`` (the routing
layer itself and the cluster module that delegates to it).  Placement's
``shards_by_node`` stays available for unit tests of the hash ring.
"""

from __future__ import annotations

import ast

from ..astlint import rule

GROUPERS = {"shards_by_node", "_group_shards", "_ready_owner_order"}


@rule("router-bypass", scope="src")
def check(mod):
    """Read fan-out grouping outside parallel/ (route through
    cluster.router / ReadRouter.group_shards)."""
    rel = mod.rel.replace("\\", "/")
    if rel.startswith(("pilosa_tpu_torch/parallel/",
                       "pilosa_tpu_torch/analysis/")):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in GROUPERS:
            continue
        yield node.lineno, (
            f"read fan-out grouping '{node.func.attr}' outside "
            f"parallel/ — route through the read router "
            f"(parallel/routing.py group_shards) so replica scoring, "
            f"breaker pre-skip, the placement overlay, and the "
            f"hot-shard counters all apply")
