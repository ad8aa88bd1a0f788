"""Time the port's host container pack on the SSB corpus.

    python3 scripts/torch_pack_time.py [--root DIR] [--shards N] [--seed S]

Builds the SSB fact index of ``pilosa_tpu_torch/ssb.py`` (four fields of
7, 5, 12 and 8 rows; the sparse corpus of ``chip_smoke.py``) at
``--shards`` shards (256) in a port Holder on the host, then packs every
fragment's sparse word store with ``ops/containers.pack_words`` — what
``Fragment.packed_host`` does once per fragment and data generation for
a compressed stack or a binary-wire frame — and prints one JSON line:
fragments, containers, the pack's total seconds, and its seconds per
fragment (median, mean, max) and per container.

``--root`` imports the port from another checkout (an unpacked parent
commit, say), so that two versions of the pack are timed on one host
with one script; the corpus is made by that checkout's ``ssb.py``.
Runs on the CPU alone and needs no card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                            .parent.parent))
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.ops import containers
    from pilosa_tpu_torch.storage import Holder

    t0 = time.perf_counter()
    holder = Holder(None)
    ssb.build_ssb(holder, np.random.default_rng(args.seed),
                  n_shards=args.shards)
    build_s = time.perf_counter() - t0
    index = holder.index(ssb.SSB_INDEX)
    stores = [(fr._idx, fr._val) for name, _rows in ssb.SSB_FIELDS
              for fr in index.field(name).view("standard")
              .fragments.values()]
    secs, conts = [], 0
    for idx, val in stores:
        t = time.perf_counter()
        p = containers.pack_words(idx, val)
        secs.append(time.perf_counter() - t)
        conts += p.keys.size
    print(json.dumps({
        "root": args.root, "shards": args.shards, "fragments": len(stores),
        "containers": conts, "corpus_build_s": build_s,
        "pack_s": sum(secs), "per_fragment_median_s": statistics.median(secs),
        "per_fragment_mean_s": statistics.fmean(secs),
        "per_fragment_max_s": max(secs),
        "per_container_us": 1e6 * sum(secs) / max(conts, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
