"""Holding the container kernels (ops/kernels.py) against their plain
versions on the card and timing both: the measurement that
``chip_smoke.py`` and the bench (``python -m pilosa_tpu_torch.bench``)
report beside each kernel's bound.

The bound of a measured record is the larger of its bytes over the
H100's memory rate and its 32-bit operations over the rate outside the
tensor cores (NVIDIA's data sheet, SXM part): each input read once and
each output written once, from the run's own inputs.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 67e12        # 32-bit ops outside the tensor cores
SLEEP_CYCLES = 50_000_000      # ~25 ms at the H100's boost clock


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events around ``iters`` calls after ``warmup``.  The calls
    are queued behind a sleep on the card (SLEEP_CYCLES), so that a
    kernel whose host-side launch takes longer than its run on the card
    is timed by the card and not by the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the uint32 (words) or int32 (counts) values."""
    from .bitset import to_numpy
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    x, y = to_numpy(a).astype(np.int64), to_numpy(b).astype(np.int64)
    return int(np.abs(x - y).max()) if x.size else 0


def stack_bytes(st) -> int:
    """Bytes of a ragged packed stack — its slot map, tables and payload,
    each read once (the payload holds each container's words exactly,
    plus at most 3 alignment words)."""
    return sum(a.numel() * a.element_size() for a in st)


def new_rec() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0}


def bound(rec) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of a measured record."""
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = rec["ops"] / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_filtered(placed, sig, S: int, dec: dict, fus: dict, filters,
                     iters: int = 20, plain_iters: int = 3):
    """Add one stacked group's kernel launches for a filtered TopN to
    ``dec`` / ``fus``: ``decode_block`` over every filter stack
    ``placed[i]`` named in ``filters`` ([(i, row), ...]), then
    ``fused_row_counts`` over the primary stack ``placed[0]`` under the
    AND of those rows.  Each kernel is compared with its plain version on
    the same inputs and timed ``iters`` times (its plain version
    ``plain_iters`` times)."""
    from ..core import SHARD_WORDS
    from . import containers, kernels
    for st in placed:
        if not isinstance(st, containers.PackedStack):
            raise AssertionError("a field of the group is not "
                                 "compressed-resident")
    dense = {}
    for i in dict.fromkeys(i for i, _row in filters):
        st, rows = placed[i], sig[i][1]

        def run(st=st, rows=rows):
            return kernels.decode_block(*st, rows=rows, words=SHARD_WORDS)

        def plain(st=st, rows=rows):
            return kernels.decode_block_plain(*st, rows=rows,
                                              words=SHARD_WORDS)

        got, want = run(), plain()
        torch.cuda.synchronize()
        dec["err"] = max(dec["err"], max_abs_err(got, want))
        dec["ms"] += time_ms(run, iters=iters)
        dec["plain_ms"] += time_ms(plain, iters=plain_iters, warmup=1)
        dec["bytes"] += stack_bytes(st) + S * rows * SHARD_WORDS * 4
        dense[i] = got
    filt = None
    for i, row in filters:
        filt = dense[i][:, row] if filt is None else filt & dense[i][:, row]
    filt = filt.contiguous()
    st, rows = placed[0], sig[0][1]

    def frun():
        return kernels.fused_row_counts(*st, filt, rows=rows,
                                        words=SHARD_WORDS)

    def fplain():
        return kernels.fused_row_counts_plain(*st, filt, rows=rows,
                                              words=SHARD_WORDS)

    got, want = frun(), fplain()
    torch.cuda.synchronize()
    fus["err"] = max(fus["err"], max_abs_err(got, want))
    fus["ms"] += time_ms(frun, iters=iters)
    fus["plain_ms"] += time_ms(fplain, iters=plain_iters, warmup=1)
    fus["bytes"] += stack_bytes(st) + S * SHARD_WORDS * 4 + S * rows * 4
    fus["ops"] += 2 * st.payload.numel()  # AND + popcount a payload word
