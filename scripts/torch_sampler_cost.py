"""What the observed server's background passes cost under load.

    python3 scripts/torch_sampler_cost.py [--device cuda] [--runs 4]

Opens one port Server in this process with the observability leg's
observed configuration (``pilosa_tpu_torch.bench``: a time-series
sample every 50 ms over a 1 s window, the SLO engine evaluating after
each sample, every trace sampled, a 0.5 s slow-query threshold), loads
the leg's data and drives ``--runs`` of the leg's closed loop (16
client processes, 64 ``Count(Row)`` requests a client) while timing,
on the sampler thread itself, each pass's parts: the whole
``Server.sample_timeseries``, the allocator reads inside it
(``torch.cuda.memory_reserved`` or ``memory_stats_as_nested_dict``,
whichever the checkout calls) and ``SLOEngine.evaluate``, each in
wall and thread-CPU milliseconds.  Prints one JSON line: passes, the
mean and p90 of each part, the share of wall time the passes held
(passes x mean wall over the load's seconds) and each run's median
request.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from pilosa_tpu_torch import bench
    from pilosa_tpu_torch.core import SHARD_WIDTH
    from pilosa_tpu_torch.server.server import Config, Server
    from pilosa_tpu_torch.utils.slo import SLOEngine

    parts: dict = {"sample": [], "reserved": [], "evaluate": []}

    def timed(name, fn):
        def run(*a, **k):
            w, c = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **k)
            finally:
                parts[name].append((time.perf_counter() - w,
                                    time.thread_time() - c))
        return run

    Server.sample_timeseries = timed("sample", Server.sample_timeseries)
    SLOEngine.evaluate = timed("evaluate", SLOEngine.evaluate)
    # the allocator's reserved bytes, read either way
    for name in ("memory_reserved", "memory_stats_as_nested_dict"):
        setattr(torch.cuda, name, timed("reserved",
                                        getattr(torch.cuda, name)))
    rng = np.random.default_rng(5)
    cols = rng.integers(0, SHARD_WIDTH, size=20_000)
    rws = rng.integers(0, 64, size=20_000)
    with tempfile.TemporaryDirectory(prefix="ptt_sampler_") as tmp:
        s = Server(Config(data_dir=tmp, bind="localhost:0",
                          device=args.device, anti_entropy_interval=0,
                          metric_poll_interval=0,
                          dispatch_batch_window_us=1000,
                          slow_query_threshold=0.5, trace_sample_rate=1.0,
                          timeseries_interval=0.05, timeseries_window=1.0))
        s.open()
        try:
            bench.load_set(s.port, "obs", "f", rws, cols)

            def run():
                rows = rng.integers(0, 64, size=bench.OBS_CLIENTS
                                    * bench.OBS_PER_CLIENT)
                qs = [f"Count(Row(f={r}))" for r in rows]
                per = [qs[k::bench.OBS_CLIENTS]
                       for k in range(bench.OBS_CLIENTS)]
                return bench.process_load("sampler", s.port, "obs", per)

            for _ in range(2):                  # warm: captures settle
                run()
            for v in parts.values():
                v.clear()
            t0 = time.perf_counter()
            p50 = [statistics.median(run()[1]) * 1e3
                   for _ in range(args.runs)]
            load_s = time.perf_counter() - t0
            got = {k: list(v) for k, v in parts.items()}
        finally:
            s.close()

    def summary(xs):
        if not xs:
            return None
        walls = sorted(w * 1e3 for w, _ in xs)
        return {"n": len(xs), "wall_ms_mean": statistics.mean(walls),
                "wall_ms_p90": walls[int(0.9 * (len(walls) - 1))],
                "cpu_ms_mean": statistics.mean(c * 1e3 for _, c in xs)}

    out = {"device": args.device, "load_s": load_s, "run_p50_ms": p50,
           **{k: summary(v) for k, v in got.items()}}
    out["held_share"] = {k: len(v) * statistics.mean(w for w, _ in v)
                         / load_s for k, v in got.items() if v}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
