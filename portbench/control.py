"""The control of ``correct``: the reference put in the program's place,
counted in float32, the precision below the configuration's exact
integers, must come out as not correct.

    python3 portbench/control.py --workload NAME --seeds 1 2 3 [--requests N]

For each seed it draws the cell's table at its full size on the card,
builds the reference's histogram in int64 and the control's in float32
from the same columns, sends the control ``N`` requests of the cell's
deck in the order a run's clients send them (``N`` defaults to what a
run of ``run_seconds`` sends, as measured: ``--requests``), judges the
control's answers as ``run.py`` judges the port's, and prints one JSON
line a seed with the readings of the numbers ``correct`` compares.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def requests_of(cards, offsets, n: int):
    """The first ``n`` requests of the clients, taken in turn."""
    out, i = [], 0
    while len(out) < n:
        k = i % len(offsets)
        out.append(cards[(offsets[k] + i // len(offsets)) % len(cards)][1])
        i += 1
    return out


def readings(cfg, mix, gen, seed: int, device, n: int, facts=None) -> dict:
    import torch

    from portbench import mix as mixmod
    from portbench.reference.histogram import Histogram
    from portbench.reference.pql import Evaluator

    exact = Histogram(cfg, torch.int64)
    low = Histogram(cfg, torch.float32)
    for b in gen.blocks(cfg, seed, device, facts):
        exact.add(b.columns)
        low.add(b.columns)
    ref, control = Evaluator(exact.finish()), Evaluator(low.finish())
    cards = mixmod.deck(mix, cfg, seed)
    reqs = requests_of(cards, mixmod.offsets(mix, len(cards), seed), n)
    want, got = {}, {}
    wrong = 0
    for q in reqs:
        if q not in want:
            want[q] = ref.request(q)
            got[q] = control.request(q)
        wrong += got[q] != want[q]
    return {"seed": seed, "requests": len(reqs), "distinct": len(want),
            "wrong_answers": wrong, "failed_requests": 0,
            "wrong_distinct": sum(got[q] != want[q] for q in want)}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=1000)
    a = p.parse_args(argv)
    sys.path[:] = [x for x in sys.path
                   if Path(x or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _bench, cell, cfg, mix = run.load_cell(a.workload)
    gen = run._load("gen", cfg["name"])
    for seed in a.seeds:
        t0 = time.perf_counter()
        rec = readings(cfg, mix, gen, seed, torch.device("cuda:0"),
                       a.requests)
        rec["workload"] = cell["name"]
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
