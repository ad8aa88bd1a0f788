"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

(``python3 -m portbench.run`` from the checkout's root is the same.)

A cell of ``BENCHMARK.json`` names a deployment (``configs/<config>.json``,
drawn by ``gen/<config>.py``, answered by ``reference/<config>.py``) and a
traffic mix (``traffic/<mix>.json``); the per-layer metrics are read by
``metrics/<metric>.py``.  Set-up draws the table on the card from the seed,
loads it into an in-memory ``pilosa_tpu_torch`` holder, stages the cell's
stacks and warms its whole-query programs for every fused batch size; then
the clients of the mix send requests through ``API.query`` for ``--seconds``
in a closed loop.  After the window the port is freed and the reference
answers every request of the window again from the same columns; one
wrong or failed answer makes ``correct`` false.  ``--trace 1`` runs the
same window with ``torch.profiler`` over all of it, and reports the
per-layer metrics instead of the end-to-end ones.  A cell of one chip
runs on ``cuda:0``; a cell of more spans every card it asks for.

Exits 2 without a result when the card or the port is missing, 3 when a
JAX module is loaded after the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), or since
    this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def _rss_peak_mb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _bytes_written() -> int | None:
    """Bytes this process has written to storage (Linux ``/proc``)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def _load(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, found by name."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    from portbench import mix as mixmod
    return bench, cell, cfg, mixmod.load(cell["traffic"])


def schema_of(cfg: dict) -> dict:
    from portbench import encode
    fields = {}
    for f in cfg["fields"]:
        if f["type"] == "set":
            fields[f["name"]] = {"type": "set"}
        else:
            fields[f["name"]] = {"type": "int", "min": f["min"],
                                 "max": f["max"],
                                 "bitDepth": encode.bit_depth(f["max"])}
    return {cfg["index"]: {"keys": False,
                           "trackExistence": cfg["track_existence"],
                           "fields": fields}}


def normalize(results) -> list:
    """The port's results in the reference's plain forms."""
    out = []
    for r in results:
        if isinstance(r, list):
            out.append([x.to_dict() for x in r])
        elif hasattr(r, "to_dict"):
            out.append(r.to_dict())
        else:
            out.append(r)
    return out


class Run:
    """What one run knows, handed to the metric readers."""

    def __init__(self, cfg, cell, device_name, n_cards):
        self.cfg, self.cell = cfg, cell
        self.device_name, self.n_cards = device_name, n_cards
        self.api = None
        self.trace = None      # devtrace.summarize of the traced window
        self.requests: list = []


def _sync(devices):
    import torch
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _burst(api, index, cards, n):
    """``n`` requests sent at once from ``n`` threads."""
    gate = threading.Barrier(n)

    def one(k):
        gate.wait()
        api.query(index, cards[k % len(cards)][1])

    ts = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def warm_up(api, index, cards, offsets, clients, devices, rounds_max=8,
            round_s=1.5):
    """Stage and warm: one request of every template alone (stages its
    stacks); then bursts of every template at each power of two up to
    the client count, twice each (a whole-query program is captured at
    the second sighting of its padded batch size), with the batcher's
    window held open meanwhile so that a burst fuses into one launch;
    then rounds of the mix itself until two in a row capture nothing.
    Returns (stage s, warm s, rounds)."""
    from pilosa_tpu_torch.utils import devobs
    from portbench import loop

    by_name: dict = {}
    for name, pql in cards:
        by_name.setdefault(name, []).append((name, pql))
    t0 = time.perf_counter()
    for group in by_name.values():
        api.query(index, group[0][1])
    _sync(devices)
    t1 = time.perf_counter()
    batcher = api.executor.batcher
    window = batcher.window_s
    batcher.window_s = 0.05
    try:
        n = 1
        while n <= clients:
            for group in by_name.values():
                for _ in range(2):
                    _burst(api, index, group, n)
            n *= 2
    finally:
        batcher.window_s = window
    rounds = quiet = 0
    while rounds < rounds_max and quiet < 2:
        rounds += 1
        c0 = devobs.COMPILES.totals()["compiles"]
        loop.closed_loop(lambda q: api.query(index, q), cards, offsets,
                         round_s)
        quiet = quiet + 1 if devobs.COMPILES.totals()["compiles"] == c0 \
            else 0
    _sync(devices)
    return t1 - t0, time.perf_counter() - t1, rounds


def run_cell(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device=None, facts=None, metric_names=None,
             log=None) -> dict:
    """One run of ``cell``; returns the result record.  ``device`` and
    ``facts`` are for tests on the CPU (a device list and a table cut to
    a few shards); the benchmark runs the config's device layout at its
    full size."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    phases = {}
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.convert import holder_from_arrays
    from pilosa_tpu_torch.utils import devobs
    from portbench import encode, loop
    from portbench import mix as mixmod

    if device is None:
        device = "cuda:0" if cell["chips"] == 1 else \
            [f"cuda:{k}" for k in range(cell["chips"])]
    devs = [torch.device(d) for d in
            (device if isinstance(device, list) else [device])]
    gen_dev = devs[0]
    phases["import_s"] = _process_age_s()   # interpreter, torch, the port

    gen = _load("gen", cfg["name"])
    t1 = time.perf_counter()
    stream = encode.FragmentStream(cfg, gen.blocks(cfg, seed, gen_dev, facts))
    holder = holder_from_arrays(schema_of(cfg), stream)
    _sync([gen_dev])
    t2 = time.perf_counter()
    phases["generate_s"] = stream.gen_s
    phases["load_s"] = (t2 - t1) - stream.gen_s
    log(f"[portbench] table: {stream.words} non-zero words in "
        f"{len(cfg['fields'])} fields")

    api = API(holder, device=device)
    index = cfg["index"]
    cards = mixmod.deck(mix, cfg, seed)
    offsets = mixmod.offsets(mix, len(cards), seed)
    stage_s, warm_s, rounds = warm_up(api, index, cards, offsets,
                                      mix["clients"], devs)
    log(f"[portbench] loaded {phases['load_s'] + phases['generate_s']:.1f}"
        f" s, staged {stage_s:.1f} s, warmed {warm_s:.1f} s "
        f"({rounds} rounds)")
    phases["stage_s"] = stage_s
    phases["warm_s"] = warm_s
    phases["warm_rounds"] = rounds
    device_name = torch.cuda.get_device_name(devs[0]) \
        if devs[0].type == "cuda" else "cpu"
    run = Run(cfg, cell, device_name, len(devs))
    run.api = api

    readers = {m: _load("metrics", m) for m in metric_names or ()} \
        if trace else {}
    before = {m: r.snapshot(run) for m, r in readers.items()
              if hasattr(r, "snapshot")}
    caps0 = devobs.COMPILES.totals()["compiles"]
    setup_s = _process_age_s()

    prof = None
    if trace:
        # the whole window under torch.profiler, started before the
        # clients send (a trace started while another thread launches
        # misses that thread's kernels: PERF.md)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if devs[0].type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            from torch._C._profiler import _ExperimentalConfig
            prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except TypeError:   # a torch without the option
            prof = profile(activities=acts)
        prof.__enter__()

    t_start, t_stop, reqs = loop.closed_loop(
        lambda q: api.query(index, q), cards, offsets, seconds)
    _sync(devs)
    if prof is not None:
        prof.__exit__(None, None, None)
    captures = devobs.COMPILES.totals()["compiles"] - caps0
    log(f"[portbench] window {t_stop - t_start:.1f} s, {len(reqs)} "
        f"requests, {captures} captures")
    after = {m: r.snapshot(run) for m, r in readers.items()
             if hasattr(r, "snapshot")}
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs
                if d.type == "cuda"), default=0)
    if prof is not None:
        from portbench import devtrace
        run.trace = devtrace.summarize(prof, t_stop - t_start, len(devs))
        run.requests = reqs
    layer = {}
    for m, r in readers.items():
        v = r.read(run, before.get(m), after.get(m))
        if v is not None:
            layer[m] = v

    # free the port before the reference runs
    run.api = None
    api.executor.close()
    del api, holder, stream
    gc.collect()
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()

    t3 = time.perf_counter()
    ref = _load("reference", cfg["name"])
    evaluator = ref.evaluator(cfg, gen.blocks(cfg, seed, gen_dev, facts))
    want: dict = {}
    wrong = failed = 0
    first_bad = None
    for r in reqs:
        if r.error is not None:
            failed += 1
            first_bad = first_bad or (r.pql, r.error)
            continue
        if r.pql not in want:
            want[r.pql] = evaluator.request(r.pql)
        if normalize(r.result) != want[r.pql]:
            wrong += 1
            first_bad = first_bad or (r.pql, normalize(r.result),
                                      want[r.pql])
    ref_s = time.perf_counter() - t3

    lat = [r.t1 - r.t0 for r in reqs]
    rec = loop.latency_record(lat) if lat else {}
    window = t_stop - t_start
    e2e = {"queries_per_s": len(reqs) / window if window > 0 else 0.0,
           "p50_ms": rec.get("p50_ms", 0.0),
           "p95_ms": loop.percentile(lat, 95) * 1e3 if lat else 0.0,
           "peak_device_mb": peak / 1e6,
           "setup_s": setup_s}
    checks = {"wrong_answers": {"value": wrong, "limit": 0},
              "failed_requests": {"value": failed, "limit": 0}}
    info = {"phases": phases, "setup_s": setup_s, "window_s": window,
            "host_rss_peak_mb": _rss_peak_mb(),
            "bytes_written": _bytes_written(),
            "requests": len(reqs), "distinct": len(want),
            "captures_in_window": captures, "reference_s": ref_s,
            "tail": rec, "first_bad": first_bad,
            "by_template": _by_template(reqs)}
    return {"correct": bool(reqs) and wrong == 0 and failed == 0,
            "attempted": len(reqs), "failed": wrong + failed,
            "e2e": e2e, "layer": layer, "peak": peak, "devices": devs,
            "device_name": device_name, "trace": run.trace,
            "checks": checks, "info": info}


def _by_template(reqs) -> dict:
    """Requests, median and p95 ms of each template of the mix."""
    from portbench import loop
    out = {}
    for name in sorted({r.name for r in reqs}):
        lat = [r.t1 - r.t0 for r in reqs if r.name == name]
        out[name] = [len(lat), loop.percentile(lat, 50) * 1e3,
                     loop.percentile(lat, 95) * 1e3]
    return out


def _units(bench: dict) -> dict:
    return {m["name"]: m["unit"] for m in
            bench["end_to_end"] + bench["per_layer"]}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    def fail(msg, code):
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)
        return code

    # run as a script, the path starts at this folder: the checkout's
    # root takes its place, so only packages resolve from here
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # the run's caches stay inside the checkout, at fixed paths
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    try:
        bench, cell, cfg, mix = load_cell(a.workload)
    except (OSError, StopIteration, KeyError, ValueError) as e:
        return fail(f"no cell {a.workload!r}: {e!r}", 2)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card", 2)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} visible", 2)
    if importlib.util.find_spec("pilosa_tpu_torch") is None:
        return fail("the port (pilosa_tpu_torch) is not in this checkout", 2)

    out = run_cell(cell, cfg, mix, a.seed, a.seconds, bool(a.trace),
                   metric_names=[m["name"] for m in bench["per_layer"]])
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        return fail(f"JAX modules loaded in the run: {loaded}", 3)

    units = _units(bench)
    if a.trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["layer"].items()}
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items()}
    device = {"platform": "gpu", "kind": out["device_name"],
              "count": len(out["devices"]),
              "memory_peak_bytes": out["peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device}
    if a.trace and out["trace"]:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                               "idle_gaps": out["trace"]["idle_gaps"]}
    result["checks"] = out["checks"]
    info = dict(out["info"], e2e=out["e2e"], layer=out["layer"])
    if out["trace"]:
        info["busy_s_by_card"] = out["trace"]["busy_s_by_card"]
    print("[portbench] " + json.dumps(info, default=str), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"[portbench] check {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
