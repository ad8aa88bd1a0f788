"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main path — PQL read requests over the SSB star-schema
corpus at its full 256 shards, dense-resident and compressed-resident —
through the user entry point ``pilosa_tpu_torch.executor.Executor``, and
holds every CUDA kernel of that path against its plain PyTorch version.
Phases, each printing its own lines:

1. card   — the device name and power limit; fails without CUDA.
2. build  — compiles ``pilosa_tpu_torch/csrc`` with nvcc (timed).
3. corpus — builds the SSB corpus from a seed (pilosa_tpu_torch/ssb.py).
4. kernels against plain — each kernel's wrapper on card tensors, on the
   boundary container packs and at the stacked SSB shapes, bit-exact
   against its plain version; times (CUDA events) beside the bound.
5. ssb    — the ``_ssb_batch`` mix, dense-resident (no budget) and
   compressed-resident (96 MB budget); every answer equals the numpy
   oracle, both forms agree, and the compressed run must launch both
   kernels (counts reset just before it, read just after).
   With ``--profile`` each run ends with one request under
   torch.profiler: the card's busy and idle share and its top kernels.
6. the ``kernels`` JSON line, the nvidia-smi line, and last the result
   line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the result line.  It imports
nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
N_SHARDS = 256
BUDGET_MB = 96
BATCH = 24            # calls per request, as bench.bench_ssb
N_BATCHES = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (guide table)
INT32_OPS_PER_S = 67e12        # 32-bit ops outside the tensor cores
# Where the replaced Pallas kernels live: the JAX package's directory,
# named here only as a path for the report, never imported.
JAX_KERNELS = "pilosa" + "_tpu/ops/kernels.py"


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, timed
    with CUDA events around ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
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
    from pilosa_tpu_torch.ops.bitset import to_numpy
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    x, y = to_numpy(a).astype(np.int64), to_numpy(b).astype(np.int64)
    return int(np.abs(x - y).max()) if x.size else 0


def stream_bytes(arrs) -> int:
    """Bytes one pass must read of a stacked packed group: the four
    tables plus the payload words its containers reference."""
    keys, types, counts, _offsets, _payload = arrs
    t, n = types.long(), counts.long()
    need = torch.where(t == 1, torch.full_like(n, 2048),
                       torch.where(t >= 0, 2 * n, torch.zeros_like(n)))
    return int(4 * keys.numel() * 4 + 4 * need.sum().item())


# -- phase 4a: boundary packs ----------------------------------------------

def boundary_packs():
    """name -> (idx, val) packs at the container-form boundaries (the
    cases of tests/test_torch_containers.py at the full shard width)."""
    from pilosa_tpu_torch.core import CONTAINER_WORDS as CW, SHARD_WORDS
    from pilosa_tpu_torch.ops.containers import ARRAY_WORDS_MAX, RUN_MAX
    rng = np.random.default_rng(SEED)
    rows = 8
    last = rows * SHARD_WORDS // CW - 1

    def array(tile, n):
        slots = np.sort(rng.choice(CW, n, replace=False))
        v = rng.integers(1, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[0] = 0x80000000
        return (tile * CW + slots).astype(np.int64), v

    def runs(tile, n_runs):
        w = (np.arange(n_runs)[:, None] * 4 + np.arange(3)[None, :])
        idx = (tile * CW + w.reshape(-1)).astype(np.int64)
        return idx, np.full(idx.size, 0xFFFFFFFF, np.uint32)

    parts = [array(0, ARRAY_WORDS_MAX), array(3, ARRAY_WORDS_MAX + 1),
             runs(5, RUN_MAX), runs(9, RUN_MAX + 1),
             (np.arange(CW, dtype=np.int64) + 20 * CW,
              np.full(CW, 0xFFFFFFFF, np.uint32)),
             array(last, 17)]
    idx = np.concatenate([p[0] for p in parts])
    val = np.concatenate([p[1] for p in parts])
    order = np.argsort(idx)
    return rows, {"mixed": (idx[order], val[order]),
                  "emptied": (np.zeros(0, np.int64), np.zeros(0, np.uint32))}


def check_boundary_packs(device):
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import containers, kernels
    from pilosa_tpu_torch.ops.bitset import from_numpy
    rows, packs = boundary_packs()
    for name, (idx, val) in packs.items():
        p = containers.pack_words(idx, val)
        arrs = [from_numpy(a, device) if a.dtype == np.uint32
                else torch.from_numpy(a).to(device)
                for a in containers.pad_packed(p)]
        got = kernels.decode_block(*arrs, rows=rows, words=SHARD_WORDS)
        plain = kernels.decode_block_plain(*arrs, rows=rows,
                                           words=SHARD_WORDS)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        oracle = containers.unpack_packed(p, rows, SHARD_WORDS)
        from pilosa_tpu_torch.ops.bitset import to_numpy
        if err or not np.array_equal(to_numpy(got), oracle):
            raise AssertionError(f"decode_block differs on pack {name}")
        filt = from_numpy(np.random.default_rng(1).integers(
            0, 1 << 32, SHARD_WORDS, dtype=np.uint64).astype(np.uint32),
            device)
        for f in (None, filt):
            k = kernels.fused_row_counts(*arrs, f, rows=rows,
                                         words=SHARD_WORDS)
            q = kernels.fused_row_counts_plain(*arrs, f, rows=rows,
                                               words=SHARD_WORDS)
            torch.cuda.synchronize()
            if max_abs_err(k, q):
                raise AssertionError(
                    f"fused_row_counts differs on pack {name} "
                    f"(filtered={f is not None})")
        say("kernels", pack=name, types=p.type_histogram(), exact=True)


# -- phase 4b: the stacked SSB shapes --------------------------------------

def _new_rec() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0}


def measure_group(placed, sig, S: int, dec: dict, fus: dict,
                  rg: int, c: int, plain_iters: int = 3):
    """Add one stacked group's kernel launches for the TopN filter to
    ``dec`` / ``fus``: decode the region and category stacks, then the
    fused count over the rev stack under region[rg] & category[c].  Each
    kernel is compared with its plain version on the same inputs."""
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import kernels
    for arrs in placed:
        if not isinstance(arrs, tuple):
            raise AssertionError("an SSB field is not compressed-resident")
    dense = {}
    for name, arrs, s in zip(("region", "category"), placed[1:], sig[1:]):
        rows = s[1]

        def run(arrs=arrs, rows=rows):
            return kernels.decode_block(*arrs, rows=rows, words=SHARD_WORDS)

        def plain(arrs=arrs, rows=rows):
            return kernels.decode_block_plain(*arrs, rows=rows,
                                              words=SHARD_WORDS)

        got, want = run(), plain()
        torch.cuda.synchronize()
        dec["err"] = max(dec["err"], max_abs_err(got, want))
        dec["ms"] += time_ms(run, iters=20)
        dec["plain_ms"] += time_ms(plain, iters=plain_iters, warmup=1)
        dec["bytes"] += stream_bytes(arrs) + S * rows * SHARD_WORDS * 4
        dense[name] = got
    filt = (dense["region"][:, rg] & dense["category"][:, c]).contiguous()
    arrs, rows = placed[0], sig[0][1]

    def frun():
        return kernels.fused_row_counts(*arrs, filt, rows=rows,
                                        words=SHARD_WORDS)

    def fplain():
        return kernels.fused_row_counts_plain(*arrs, filt, rows=rows,
                                              words=SHARD_WORDS)

    got, want = frun(), fplain()
    torch.cuda.synchronize()
    fus["err"] = max(fus["err"], max_abs_err(got, want))
    fus["ms"] += time_ms(frun, iters=20)
    fus["plain_ms"] += time_ms(fplain, iters=plain_iters, warmup=1)
    fus["bytes"] += stream_bytes(arrs) + S * SHARD_WORDS * 4 + S * rows * 4
    fus["ops"] += 2 * S * rows * SHARD_WORDS   # AND + popcount a word


def check_ssb_shapes(holder, device, rg: int = 1, c: int = 3):
    """Each kernel at the shapes the main path gives it for
    ``TopN(rev, Intersect(Row(region=rg), Row(category=c)))`` over every
    shard: decode_block over the region and category stacks (the filter's
    operands), fused_row_counts over the rev stacks under that filter, for
    every signature group the stacked executor forms.  Then the same work
    as ONE group of all shards (each field padded to its largest container
    and payload bucket), which shows the kernels' own rate apart from the
    per-group launches; that measurement is printed, not reported as the
    main path's."""
    from pilosa_tpu_torch.ops.containers import pow2_bucket
    from pilosa_tpu_torch.parallel.stacked import StackedExecutor
    from pilosa_tpu_torch import ssb
    st = StackedExecutor(device)
    keys = [("rev", "standard"), ("region", "standard"),
            ("category", "standard")]
    shards = list(range(N_SHARDS))
    groups = st._placed_groups(keys, holder, ssb.SSB_INDEX, shards)
    dec, fus = _new_rec(), _new_rec()
    for shard_list, placed, sig in groups:
        measure_group(placed, sig, len(shard_list), dec, fus, rg, c)
    say("kernels", ssb_groups=len(groups),
        group_shards=[len(g[0]) for g in groups],
        rev_sig=groups[0][2][0])

    placed, sig = [], []
    for field, view in keys:
        frs = [holder.fragment(ssb.SSB_INDEX, field, view, s) for s in shards]
        packs = [fr.packed_host() for fr in frs]
        one = ("z", max(fr.n_rows for fr in frs),
               max(pow2_bucket(p.keys.size) for p in packs),
               max(pow2_bucket(p.payload.size) for p in packs))
        placed.append(st._place_packed_block(frs, one))
        sig.append(one)
    one_dec, one_fus = _new_rec(), _new_rec()
    measure_group(placed, sig, N_SHARDS, one_dec, one_fus, rg, c,
                  plain_iters=1)
    for name, rec in (("decode_block", one_dec),
                      ("fused_row_counts", one_fus)):
        if rec["err"]:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on one group of all shards")
        b_ms, b_by = bound(rec)
        say("kernels", one_group=name, shards=N_SHARDS, ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            bytes=rec["bytes"], exact=True)
    st.close()
    return dec, fus


def bound(rec) -> tuple[float, str]:
    t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = rec["ops"] / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 5: the SSB request mix ------------------------------------------

def profile_request(ex, query: str, label: str):
    """One request under torch.profiler: the card's busy time (the sum of
    its kernel and copy durations) against the request's wall time, and
    the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pilosa_tpu_torch import ssb
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.execute(ssb.SSB_INDEX, query)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kern.append((us, e.count, e.key))
    busy_ms = sum(k[0] for k in kern) / 1e3
    top = [(name[:48], round(us / 1e3, 3), n)
           for us, n, name in sorted(kern, reverse=True)[:8]]
    say("profile", run=label, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / (wall * 1e3),
        kernels=sum(k[1] for k in kern), top=json.dumps(top))


def run_ssb(holder, hist, device, label: str, profile: bool = False):
    """Warm, then time N_BATCHES requests of BATCH mixed SSB calls over
    all shards; every answer must equal the oracle.  Returns (answers,
    record)."""
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET
    shards = list(range(N_SHARDS))
    rng = np.random.default_rng(SEED + 1)
    batches = [ssb.ssb_calls(rng, BATCH) for _ in range(N_BATCHES + 1)]
    ex = Executor(holder, device=device)
    kernels.reset_launches()
    answers, lat = [], []
    for i, calls in enumerate(batches):
        t0 = time.perf_counter()
        got = ssb.normalize(ex.execute(ssb.SSB_INDEX, ssb.ssb_batch(calls)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:                      # batch 0 warms: stacks staged, cached
            lat.append(dt)
        want = [ssb.oracle(hist, shards, c) for c in calls]
        if got != want:
            bad = next(j for j, (a, b) in enumerate(zip(got, want))
                       if a != b)
            raise AssertionError(
                f"{label}: {ssb.ssb_query(calls[bad])} -> {got[bad]}, "
                f"oracle {want[bad]}")
        answers.append(got)
    if profile:
        profile_request(ex, ssb.ssb_batch(batches[-1]), label)
    launches = dict(kernels.LAUNCHES)
    stats = DEFAULT_BUDGET.stats()
    ex.close()
    rec = {"qps": BATCH * len(lat) / sum(lat),
           "resident_mb": stats["residentBytes"] / 2**20,
           "compressed_mb": stats["compressedBytes"] / 2**20,
           "batch_p50_ms": statistics.median(lat) * 1e3,
           "batch_ms": [round(x * 1e3, 3) for x in lat],
           "launches": launches}
    say("ssb", run=label, shards=N_SHARDS, calls_per_batch=BATCH,
        batches=len(lat), qps=rec["qps"], batch_p50_ms=rec["batch_p50_ms"],
        resident_mb=rec["resident_mb"], compressed_mb=rec["compressed_mb"],
        launches=json.dumps(launches))
    return answers, rec


def main(argv) -> int:
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from pilosa_tpu_torch import ssb
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage import Holder
    from pilosa_tpu_torch.storage import fragment as port_fragment
    from pilosa_tpu_torch.storage.membudget import DEFAULT_BUDGET

    device = torch.device("cuda", 0)
    card = card_line()
    say("card", name=torch.cuda.get_device_name(0), nvidia_smi=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = kernels.build()
    say("build", seconds=time.perf_counter() - t0, library=lib.name)
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "bytes smem" in line or "Compiling" in line:
            say("build", ptxas=line.strip())

    t0 = time.perf_counter()
    holder = Holder(None)
    hist = ssb.build_ssb(holder, np.random.default_rng(SEED),
                         n_shards=N_SHARDS)
    say("corpus", shards=N_SHARDS, columns=N_SHARDS << 20,
        fields=dict(ssb.SSB_FIELDS), seconds=time.perf_counter() - t0)

    check_boundary_packs(device)
    port_fragment.COMPRESSED_RESIDENT = True
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    dec, fus = check_ssb_shapes(holder, device)
    for name, rec in (("decode_block", dec), ("fused_row_counts", fus)):
        if rec["err"]:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at the SSB shapes: {rec['err']}")

    # dense-resident: no budget, so every fragment stays dense
    DEFAULT_BUDGET.limit_bytes = None
    dense_ans, dense_rec = run_ssb(holder, hist, device, "dense", profile)
    # compressed-resident: the 96 MB budget packs the sparse fragments
    DEFAULT_BUDGET.limit_bytes = BUDGET_MB << 20
    DEFAULT_BUDGET.shrink_to_limit()
    comp_ans, comp_rec = run_ssb(holder, hist, device, "compressed",
                                 profile)
    if comp_ans != dense_ans:
        raise AssertionError("dense and compressed answers differ")
    for name, n in comp_rec["launches"].items():
        if n <= 0:
            raise AssertionError(f"the compressed SSB run never launched "
                                 f"{name}")

    src = "pilosa_tpu_torch/csrc/container_kernels.cu"
    lines = []
    for name, rec, replaces in (
            ("decode_block", dec, f"{JAX_KERNELS}:245"),
            ("fused_row_counts", fus, f"{JAX_KERNELS}:326")):
        b_ms, b_by = bound(rec)
        lines.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces,
                      "launches": comp_rec["launches"][name],
                      "max_abs_err": rec["err"], "ms": rec["ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ssb": {"dense": dense_rec, "compressed": comp_rec,
                              "budget_mb": BUDGET_MB}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
