"""``wq_fallback_share``: the share of the window's requests that the
whole-query program (``parallel/wholequery.py``) handed back to the
grouped path, from the executor's ``wq_fallbacks`` / ``wq_requests``."""

from __future__ import annotations


def snapshot(run):
    ex = run.api.executor
    return ex.wq_requests, ex.wq_fallbacks


def read(run, before, after):
    n = after[0] - before[0]
    return 100.0 * (after[1] - before[1]) / n if n > 0 else None
