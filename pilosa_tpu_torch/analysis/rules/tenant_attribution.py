"""tenant-attribution: admission acquires and cache fills must carry a
tenant label.

The tenant isolation plane (docs/robustness.md "Tenant isolation") only
works when every enforcement point knows WHO the work belongs to: an
``admission.acquire()`` without a tenant admits under the shared default
bucket (weighted fairness degrades to FIFO for that caller), and a
result-cache ``fill()`` without one charges the bytes to nobody (the
per-tenant quota cannot see them, so a flood refills past its cap).
This rule keeps new call sites honest: every acquire on an admission
pool and every fill on a result cache must pass an explicit ``tenant=``
keyword — even when the value is ``qtenant.current_or_none()``, the
explicitness is the point (the call site shows the attribution decision).
``tenant.*`` journal events must name their tenant the same way.

Scope: src, excluding the isolation plane's own modules (the admission
controller, the caches, and utils/ implement the mechanism; they are
the ones being attributed TO) — and tests, which exercise bare pools
deliberately.
"""

from __future__ import annotations

import ast

from ..astlint import rule

# the mechanism itself: these define/own the tenant plumbing
EXEMPT_PREFIXES = (
    "pilosa_tpu_torch/server/admission.py",
    "pilosa_tpu_torch/cache/",
    "pilosa_tpu_torch/storage/membudget.py",
    "pilosa_tpu_torch/utils/",
    "pilosa_tpu_torch/analysis/",
)

# receiver-name fragments that identify an admission pool or a result
# cache at a call site (adm.acquire(...), self.admission.acquire(...),
# cache.fill(...), self.result_cache.fill(...))
ADMISSION_RECV = ("admission", "adm")
CACHE_RECV = ("cache",)


def _recv_name(func: ast.Attribute) -> str:
    """Dotted receiver of an attribute call, e.g.
    ``self.result_cache.fill`` -> "self.result_cache"."""
    parts = []
    node = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords) \
        or any(kw.arg is None for kw in call.keywords)  # **kwargs


@rule("tenant-attribution", scope="src")
def check(mod):
    """Admission acquire / cache fill sites must pass tenant=."""
    rel = mod.rel.replace("\\", "/")
    if rel.startswith(EXEMPT_PREFIXES):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # tenant.* journal events must carry tenant=
        if isinstance(func, ast.Attribute) and func.attr == "emit" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and node.args[0].value.startswith("tenant.") \
                and not _has_kw(node, "tenant"):
            yield node.lineno, (
                f"journal event {node.args[0].value!r} emitted without "
                f"a tenant= field — a tenant-plane event that cannot "
                f"say whose it is defeats shed/quota attribution")
            continue
        if not isinstance(func, ast.Attribute):
            continue
        recv = _recv_name(func).lower()
        last = recv.rsplit(".", 1)[-1]
        if func.attr == "acquire" \
                and (last in ADMISSION_RECV
                     or any(f in last for f in ADMISSION_RECV)) \
                and not _has_kw(node, "tenant"):
            yield node.lineno, (
                f"admission acquire on '{_recv_name(func)}' without "
                f"tenant= — untagged admission rides the shared "
                f"default bucket, so weighted fairness and "
                f"tenant-first shedding cannot see this caller "
                f"(pass tenant=qtenant.current() or an explicit name)")
        elif func.attr == "fill" \
                and any(f in last for f in CACHE_RECV) \
                and not _has_kw(node, "tenant"):
            yield node.lineno, (
                f"result-cache fill on '{_recv_name(func)}' without "
                f"tenant= — unattributed bytes are invisible to the "
                f"per-tenant quota (pass "
                f"tenant=qtenant.current_or_none())")
