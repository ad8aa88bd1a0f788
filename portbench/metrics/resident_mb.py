"""``resident_mb``: device bytes the port holds resident at the window's
end (``storage/membudget.py``'s default budget, where the stacked
executor registers every cached stack and fragment mirror), in MB."""

from __future__ import annotations


def snapshot(run):
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    return DEFAULT_BUDGET.resident_bytes


def read(run, before, after):
    return after / 1e6 if after else None
