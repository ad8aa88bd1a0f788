"""Time the port's two container kernels on one NVIDIA GPU, one container
form at a time.

    python3 scripts/torch_kernel_forms.py [--source A.cu [B.cu ...]]

Builds synthetic ragged packed stacks (pilosa_tpu_torch/ops/containers.py
PackedStack) on the card at the SSB category shape — 256 shards x 16 rows
x 16 tiles, a container on every tile — in which every container has one
form: bitmap, array of 8 entries, array of 1023 entries, run of 40 short
runs, run of one full-tile run; and "empty", with no container on any
tile but one.  For each form it
times ``decode_block`` and ``fused_row_counts`` (under a random filter)
with CUDA events, the calls queued behind a sleep on the card so that the
events time the card and not the host's launch rate, and prints each time
beside its bytes bound (decode: the dense bytes written; fused: the filter
and the stack read once) at 3.35 TB/s.  Each form is first checked
bit-exact against the plain versions on its first 4 shards.

With ``--source``, each given CUDA source is built and timed in turn
(A, B, ..., then again in reverse order), so that variants of the kernel
file can be compared in one process on one card.  Prints one JSON line
per (source, form, kernel) and the card's nvidia-smi line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import HBM_BYTES_PER_S, max_abs_err, time_ms  # noqa: E402

S, ROWS = 256, 16
FORMS = ("empty", "bitmap", "array_8", "array_1023", "run_40", "run_full")


def form_stack(form: str, device):
    """A PackedStack of S shards whose every tile holds one container of
    ``form``, made on ``device`` from a seed.  "empty" holds a single
    bitmap container (tile 0 of shard 0) and leaves every other tile
    without one."""
    from pilosa_tpu_torch.core import CONTAINER_WORDS as CW, SHARD_WORDS
    from pilosa_tpu_torch.ops import containers
    tiles = containers.tiles_of(ROWS, SHARD_WORDS)
    n = 1 if form == "empty" else S * tiles
    g = torch.Generator(device=device).manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    if form in ("empty", "bitmap"):
        typ, cnt, size = containers.TYPE_BITMAP, CW, CW
        body = ints(-2**31, 2**31, (n, CW))
    elif form.startswith("array"):
        typ = containers.TYPE_ARRAY
        cnt = int(form.split("_")[1])
        size, gap = 2 * cnt, CW // cnt
        slots = torch.arange(cnt, device=device) * gap + ints(0, gap,
                                                              (n, cnt))
        body = torch.cat([slots, ints(1, 2**31, (n, cnt))], dim=1)
    elif form == "run_full":
        typ, cnt, size = containers.TYPE_RUN, 1, 2
        body = torch.tensor([[0, CW * 32]], device=device).repeat(n, 1)
    else:
        typ, cnt, size = containers.TYPE_RUN, 40, 80
        start = torch.arange(cnt, device=device) * 1600 + ints(0, 400,
                                                               (n, cnt))
        end = start + ints(1, 1200, (n, cnt))
        body = torch.stack([start, end], dim=2).reshape(n, size)
    asize = -(-size // containers.PAYLOAD_ALIGN) * containers.PAYLOAD_ALIGN
    payload = torch.zeros(n, asize, dtype=torch.int32, device=device)
    payload[:, :size] = body.to(torch.int32)
    slots = torch.full((S * tiles,), -1, dtype=torch.int32, device=device)
    slots[:n] = torch.arange(n, dtype=torch.int32, device=device)
    return containers.PackedStack(
        slots.reshape(S, tiles),
        torch.full((n,), typ, dtype=torch.int32, device=device),
        torch.full((n,), cnt, dtype=torch.int32, device=device),
        torch.arange(n, dtype=torch.int64, device=device) * asize,
        payload.reshape(-1))


def head(st, k: int):
    """The first ``k`` shards of a stack built by ``form_stack`` (its
    containers are in shard order)."""
    from pilosa_tpu_torch.ops import containers
    n = int((st.slots[:k] >= 0).sum())
    return containers.PackedStack(st.slots[:k].contiguous(), st.types[:n],
                                  st.counts[:n], st.offsets[:n],
                                  st.payload)


def measure(form: str, st, filt, device) -> list[dict]:
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import kernels
    small = head(st, 4)
    for k, p in ((kernels.decode_block(*small, rows=ROWS, words=SHARD_WORDS),
                  kernels.decode_block_plain(*small, rows=ROWS,
                                             words=SHARD_WORDS)),
                 (kernels.fused_row_counts(*small, filt[:4], rows=ROWS,
                                           words=SHARD_WORDS),
                  kernels.fused_row_counts_plain(*small, filt[:4], rows=ROWS,
                                                 words=SHARD_WORDS))):
        torch.cuda.synchronize()
        if max_abs_err(k, p):
            raise AssertionError(f"a kernel differs from its plain version "
                                 f"on form {form}")
    stack_bytes = sum(a.numel() * a.element_size() for a in st)
    dense = S * ROWS * SHARD_WORDS * 4
    dec = time_ms(lambda: kernels.decode_block(
        *st, rows=ROWS, words=SHARD_WORDS), iters=20)
    fus = time_ms(lambda: kernels.fused_row_counts(
        *st, filt, rows=ROWS, words=SHARD_WORDS), iters=50)
    out = []
    for name, ms, nbytes in (
            ("decode_block", dec, stack_bytes + dense),
            ("fused_row_counts", fus,
             stack_bytes + filt.numel() * 4 + S * ROWS * 4)):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({"form": form, "kernel": name, "ms": ms,
                    "bound_ms": bound, "share_of_bound": bound / ms,
                    "bytes": nbytes})
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_forms: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.core import SHARD_WORDS
    from pilosa_tpu_torch.ops import kernels
    sources = [Path(a) for a in argv[argv.index("--source") + 1:]] \
        if "--source" in argv else [kernels.SOURCE]
    device = torch.device("cuda", 0)
    filt = torch.randint(-2**31, 2**31, (S, SHARD_WORDS), dtype=torch.int64,
                         device=device).to(torch.int32)
    stacks = {f: form_stack(f, device) for f in FORMS}
    order = sources + sources[::-1] if len(sources) > 1 else sources
    for src in order:
        kernels.SOURCE, kernels._lib = src, None
        kernels.BUILD_INFO.clear()
        kernels.build()
        for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
            if "registers" in line or "Compiling" in line:
                print(json.dumps({"source": src.name,
                                  "ptxas": line.strip()}), flush=True)
        for f in FORMS:
            for rec in measure(f, stacks[f], filt, device):
                print(json.dumps({"source": src.name, **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
