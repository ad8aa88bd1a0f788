"""Rule modules — importing this package registers every rule with the
astlint registry (one module per rule, docs/static-analysis.md)."""

from . import (  # noqa: F401
    alert_names,
    batcher_bypass,
    event_names,
    except_swallow,
    failpoints,
    metrics_docs,
    router_bypass,
    tenant_attribution,
    thread_context,
    wallclock,
)
