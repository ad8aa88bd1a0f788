"""Spread of the port bench's two timing gates on the card.

    python3 scripts/torch_timing_gates.py [--root DIR ...] [--runs N]
        [--device cuda] [--out FILE]

Runs ``python -m pilosa_tpu_torch.bench --smoke --device DEV --leg
observability --leg slo`` N times a checkout, each run in a process of
its own.  ``--root`` (repeatable; default this checkout) names the
checkouts: an unpacked parent commit beside this one compares the two
in one call, their runs in turns (A, B, then B, A).

Each run's process imports the checkout's bench and watches its two
legs from outside their timed windows:

- observability: every closed-loop call of the leg (``process_loads``,
  which runs a round's two servers at once; ``process_load`` in a
  checkout that still runs them one after the other): each server's
  rate and median request, and both servers' counters from
  ``/debug/vars`` and ``/proc/<pid>/stat`` (read only) before and after
  it — captures and retraces of the capture registry, the whole-query
  runner's eager runs and replays, the launch ledger's launches, alerts
  fired, flight-recorder bundles and the server process's CPU seconds;
- slo (story 2): the same counters of the evaluation on and off servers
  at each round's edge (a round is ``overhead_q`` requests a mode),
  read at the round's first request with the read's seconds taken out
  of the leg's clock, so no timed request pays for them.

From these and the run's own record it prints, a run a line, both
estimators of each gate: the pooled median request (``overhead_pct``)
and the best-run qps ratio (``qps_ratio``) the bench judged before it
paired its rounds,
and the median over paired rounds of ``1 - base_p50 / obs_p50`` and of
``on_rate / off_rate``; then a summary line a checkout (mean, standard
deviation, min and max of each estimator, and the SLO rounds' mean
ratio by round parity) and the card's line; ``--out`` appends each
line to a file as well.  A run whose bench exits non-zero is reported
with its exit code, its error, the loads it ran and stderr's end, and
counted; the script then exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# One bench run in a process of its own, from the checkout in argv[1].
DRIVER = r'''
import json, os, statistics, sys, time, types
sys.path.insert(0, sys.argv[1])
from pilosa_tpu_torch import bench

LIVE = {}          # port -> ServerProcess of the two legs
OBS = []           # observability loads
CALLS = [0]        # closed-loop calls watched (a call may load both servers)
SLO = {"posts": 0, "snaps": []}
ASK = [False]      # inside ask_json: an answer check, not a round
SKEW = [0.0]       # seconds of counter reads taken out of bench's clock
real_time = bench.time
bench.time = types.SimpleNamespace(
    **{k: getattr(real_time, k) for k in dir(real_time)
       if not k.startswith("__")})
bench.time.perf_counter = lambda: real_time.perf_counter() - SKEW[0]
TICK = os.sysconf("SC_CLK_TCK")


def cpu_s(pid):
    with open(f"/proc/{pid}/stat") as f:
        rest = f.read().rsplit(")", 1)[1].split()
    return (int(rest[11]) + int(rest[12])) / TICK


def snap(sp):
    v = json.loads(bench.get(sp.port, "/debug/vars"))
    d = v["device"]
    g = d.get("graphs") or {}
    return {"captures": d["compiles"]["compiles"],
            "retraces": d["compiles"]["retraces"],
            "eager_runs": g.get("eagerRuns", 0),
            "replays": g.get("replays", 0),
            "launches": d["launches"]["launches"],
            "alerts_fired": (v.get("alerts") or {}).get("firedTotal", 0),
            "bundles": (v.get("flightRecorder") or {}).get("captures", 0),
            "cpu_s": cpu_s(sp.proc.pid)}


def mode(sp):
    if sp.leg == "slo":
        return "on" if sp.kw.get("alert_rules") == "all" else "off"
    return "obs" if "timeseries_interval" in sp.kw else "base"


def snap_all(leg):
    t0 = real_time.perf_counter()
    out = {mode(sp): snap(sp) for sp in LIVE.values() if sp.leg == leg}
    SKEW[0] += real_time.perf_counter() - t0
    return out


real_init = bench.ServerProcess.__init__
def init(self, leg, device, **kw):
    real_init(self, leg, device, **kw)
    self.kw = kw
bench.ServerProcess.__init__ = init

real_open = bench.ServerProcess.wait_open
def wait_open(self):
    real_open(self)
    LIVE[self.port] = self
bench.ServerProcess.wait_open = wait_open

real_close = bench.ServerProcess.close
def close(self):
    if self.leg == "slo" and self.port in LIVE:
        slo_edge()
    LIVE.pop(self.port, None)
    real_close(self)
bench.ServerProcess.close = close

def watched(loads, run):
    """Run ``run()`` — closed loops on the servers of ``loads`` (name ->
    (port, index, per-client queries)) — between two reads of every
    server's counters; one OBS entry a load."""
    before = snap_all("observability")
    res = run()
    after = snap_all("observability")
    delta = {m: {k: after[m][k] - before[m][k] for k in after[m]}
             for m in after}
    CALLS[0] += 1
    for name, (port, _index, per_client) in loads.items():
        wall, lat = res[name][:2]
        OBS.append({"call": CALLS[0], "mode": mode(LIVE[port]),
                    "per_client": len(per_client[0]),
                    "rate": len(lat) / wall,
                    "p50_ms": statistics.median(lat) * 1e3,
                    "wall_s": wall, "delta": delta})
    return res


if hasattr(bench, "process_loads"):    # the servers' runs at once
    real_loads = bench.process_loads
    def process_loads(leg, loads):
        if leg != "observability":
            return real_loads(leg, loads)
        return watched(loads, lambda: real_loads(leg, loads))
    bench.process_loads = process_loads
else:                                  # one server's run at a time
    real_load = bench.process_load
    def process_load(leg, port, index, per_client):
        if leg != "observability":
            return real_load(leg, port, index, per_client)
        return watched({0: (port, index, per_client)},
                       lambda: {0: real_load(leg, port, index,
                                             per_client)})[0]
    bench.process_load = process_load


def slo_edge():
    n = 2 * bench.SMOKE.slo["overhead_q"]
    if SLO["posts"] % n == 0 and (not SLO["snaps"]
                                  or SLO["snaps"][-1][0] != SLO["posts"]):
        SLO["snaps"].append((SLO["posts"], snap_all("slo")))


real_ask = bench.ask_json
def ask_json(*a, **k):
    ASK[0] = True
    try:
        return real_ask(*a, **k)
    finally:
        ASK[0] = False
bench.ask_json = ask_json

real_post = bench.post
def post(port, path, body, *a, **k):
    if path == "/index/ov/query" and not ASK[0]:
        slo_edge()
        SLO["posts"] += 1
    return real_post(port, path, body, *a, **k)
bench.post = post

error, out = None, {"configs": {}, "seconds": {}}
try:
    out = bench.run(["--smoke", "--device", sys.argv[2],
                     "--leg", "observability", "--leg", "slo"])
except bench.LegFailed as e:
    error = str(e)
snaps = SLO["snaps"]
windows = [{"posts": b[0] - a[0],
            "delta": {m: {k: b[1][m][k] - a[1][m][k] for k in b[1][m]}
                      for m in b[1]}}
           for a, b in zip(snaps, snaps[1:])]
print(json.dumps({"error": error, "configs": out["configs"],
                  "seconds": out["seconds"], "card": out.get("card"),
                  "cpus": os.cpu_count(), "obs_loads": OBS,
                  "slo_windows": windows}), flush=True)
sys.exit(1 if error else 0)
'''

COUNTERS = ("captures", "retraces", "eager_runs", "replays", "launches",
            "alerts_fired", "bundles", "cpu_s")


def summed(loads: list, mode: str) -> dict:
    """``mode``'s counters over the calls of ``loads``, each call once."""
    calls = {x["call"]: x["delta"] for x in loads}
    return {k: sum(d[mode][k] for d in calls.values()) for k in COUNTERS}


def run_detail(load: dict) -> dict:
    """One load: its server, rate, median request, and the loaded
    server's launches and CPU seconds over the call."""
    d = load["delta"][load["mode"]]
    return {"mode": load["mode"], "rate": load["rate"],
            "p50_ms": load["p50_ms"], "launches": d["launches"],
            "cpu_s": d["cpu_s"]}


def estimators(rec: dict) -> dict:
    """Both estimators of both gates, and the counters over the timed
    windows a server, from one run's driver record."""
    obs = rec["configs"]["observability"]
    slo = rec["configs"]["20_slo_alerting"]
    n_obs = len(obs["observed"]["run_calls_per_s"])
    loads = rec["obs_loads"][-2 * n_obs:]
    warm = rec["obs_loads"][:-2 * n_obs]
    rounds = []
    for a, b in zip(loads[::2], loads[1::2]):
        p50 = {a["mode"]: a["p50_ms"], b["mode"]: b["p50_ms"]}
        rounds.append(100.0 * (1.0 - p50["base"] / p50["obs"]))
    on = slo["overhead_on"]["run_calls_per_s"]
    off = slo["overhead_off"]["run_calls_per_s"]
    ratios = [a / b for a, b in zip(on, off)]
    n_timed = len(on)
    windows = rec["slo_windows"][-n_timed:]
    return {
        "overhead_pct": obs["overhead_pct"],
        "overhead_paired_pct": statistics.median(rounds),
        "overhead_rounds_pct": rounds,
        "qps_ratio": slo["qps_ratio"],
        "qps_ratio_paired": statistics.median(ratios),
        "qps_rounds": ratios,
        "obs_runs": [run_detail(x) for x in loads],
        "cpus": rec.get("cpus"),
        "slo_runs": {"on": on, "off": off},
        "obs_warm": {m: summed(warm, m) for m in ("base", "obs")},
        "obs_warm_loads": len(warm),
        "obs_timed": {m: summed(loads, m) for m in ("base", "obs")},
        "slo_timed": {m: summed([dict(w, call=i) for i, w in
                                 enumerate(windows)], m)
                      for m in ("on", "off")},
        "obs_record_paired": obs.get("overhead_paired_pct"),
        "slo_record_paired": slo.get("qps_ratio_paired"),
        "captures_timed": {"observability": obs.get("captures_timed"),
                           "slo": slo.get("captures_timed")},
        "legs_s": rec["seconds"]}


def spread(xs: list) -> dict:
    return {"n": len(xs), "mean": statistics.mean(xs),
            "sd": statistics.stdev(xs) if len(xs) > 1 else 0.0,
            "min": min(xs), "max": max(xs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    roots = [str(Path(r).resolve()) for r in args.root or [HERE]]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    runs: dict = {r: [] for r in roots}
    failed: dict = {r: 0 for r in roots}
    card = None
    for i in range(args.runs):
        for root in roots if i % 2 == 0 else roots[::-1]:
            env = dict(os.environ)
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", DRIVER, root, args.device],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=900)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0:
                failed[root] += 1
                rec = json.loads(lines[-1]) if lines and \
                    lines[-1].startswith("{") else {}
                emit({"root": root, "run": i, "rc": proc.returncode,
                      "wall_s": wall, "error": rec.get("error"),
                      "obs_loads": [run_detail(x) for x in
                                    rec.get("obs_loads", [])],
                      "stderr": proc.stderr[-3000:]})
                continue
            rec = json.loads(lines[-1])
            card = rec["card"] or card
            est = estimators(rec)
            runs[root].append(est)
            emit({"root": root, "run": i, "rc": 0, "wall_s": wall, **est})
    for root in roots:
        ests = runs[root]
        rounds = [e["qps_rounds"] for e in ests]
        emit({"root": root, "summary": True, "runs_ok": len(ests),
              "runs_failed": failed[root],
              # the SLO rounds by parity: the order of a round's pairs
              # depends on it
              "qps_rounds_even_odd": [
                  statistics.mean(x for r in rounds for x in r[p::2])
                  for p in (0, 1)] if ests else None,
              **{k: spread([e[k] for e in ests]) for k in (
                  "overhead_pct", "overhead_paired_pct", "qps_ratio",
                  "qps_ratio_paired") if ests}})
    print(card, flush=True)
    if out is not None:
        out.close()
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
