"""``device_idle_share``: the share of the traced window in which the
cards ran nothing, the mean over the cards the run uses."""

from __future__ import annotations


def read(run, before, after):
    tr = run.trace
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
