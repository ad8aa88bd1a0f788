"""``kernel_roofline_share``: the least device time the traced window's
requests need (``cost.least_seconds``: the bytes of their input rows over
the peak bandwidth, or their operations over the peak rate, spread over
the cards) against the time the cards were busy in that window."""

from __future__ import annotations

from portbench import cost


def read(run, before, after):
    tr = run.trace
    pk = cost.peaks(run.device_name)
    if not tr or not pk or tr["busy_s"] <= 0 or not run.requests:
        return None
    need = sum(cost.least_seconds(r.pql, run.cfg, pk)
               for r in run.requests)
    return 100.0 * need / run.n_cards / tr["busy_s"]
