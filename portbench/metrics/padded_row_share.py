"""``padded_row_share``: the share of the params rows the window's device
launches ran that no request asked for, over every ``batcher.launch``
span: (rows run - rows asked) / rows run.  A whole-query replay runs
``pad_pow2_rows`` rows (``parallel/wholequery.py``), the last row
repeated: a fused batch of 3 runs 4."""

from __future__ import annotations

from portbench import spans


def snapshot(run):
    return spans.window(run, "padded_row_share")


def read(run, before, after):
    if after is None:
        return None
    launches = [s["tags"] for s in after if s["name"] == "batcher.launch"]
    run_rows = sum(t["paddedRows"] for t in launches)
    if not run_rows:
        return None
    return 100.0 * (run_rows - sum(t["batchRows"] for t in launches)) \
        / run_rows
