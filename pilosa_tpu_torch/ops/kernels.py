"""Container kernels for Hopper: the port of the JAX package's
``ops/kernels.py`` (its two Pallas kernels), written in CUDA C++ in
``csrc/container_kernels.cu``.

* ``decode_block`` — packed container streams -> dense words.
* ``fused_row_counts`` — decode + optional AND with a dense filter +
  per-row popcount in one launch; the decoded words never reach device
  memory (the TopN/Rows ``row_counts`` hot path, parallel/stacked.py).

Both take a ragged ``containers.PackedStack`` of S shards — a slot map
``[S, tiles]`` and the shards' container tables and payloads laid end to
end — so one launch covers every shard of a stack whatever its
container count or payload size (the JAX package's ``vmap`` over one
pow2 bucket's Pallas call covered only that bucket).  The other call
form, one fragment's 1-D (padded) tables ``keys, types, counts,
offsets, payload``, is a stack of S = 1, built on the host.

Each wrapper checks device, dtype, shape, contiguity and alignment,
allocates its output, launches on the current stream, raises if the
launch reports an error, and counts its launches in ``LAUNCHES`` (and by
card and mesh slot, ``LAUNCHES_BY_DEVICE`` / ``LAUNCHES_BY_SLOT``).  On a
tensor that lies on the CPU it calls its plain PyTorch version
(``decode_block_plain``, ``fused_row_counts_plain``) instead; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
Degenerate inputs (no containers, no tiles, no shards) return zeros
without a launch.

Deviations from the JAX module, by design:

* The backend is resolved from the tensors' device ("cuda" or "torch"),
  not from a process-wide knob; there is no switch that moves the card's
  path off the kernels.
* The TPU's ``fits_vmem`` eligibility rule (a 12 MB VMEM budget) does not
  apply: each block's shared memory is a fixed 8 or 16 KB whatever the
  containers, so every packed entry on the card takes the kernel.
* No ``a_bucket`` / ``r_bucket`` arguments: the kernels loop over a
  container's actual entries and runs.
* ``words`` must be a multiple of 2048 on the card (the plain version
  takes any width, as the JAX jnp decode does).

The shared library is built at first use with ``nvcc`` for ``sm_90a``
from the sources in this checkout, into ``pilosa_tpu_torch/_build/``
(listed in ``.gitignore``), and loaded with ctypes.  Nothing is built or
imported from CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..core import CONTAINER_WORDS, SHARD_WORDS
from . import bitset, containers

# Kernel launches per wrapper — counted only where a CUDA kernel is
# launched (never for the plain version, never for a degenerate shortcut).
# The server launches from many request threads: increments take
# _launches_lock, since ``+=`` on a dict item is not atomic.  A launch
# recorded into a CUDA graph (``recording_launches``) runs on each replay
# of the graph, not at capture: the whole-query runner adds the graph's
# recorded launches to LAUNCHES, and to REPLAYED, per replay
# (``count_replay``).
LAUNCHES = {"decode_block": 0, "fused_row_counts": 0}
REPLAYED = {"decode_block": 0, "fused_row_counts": 0}
# The same launches by (kernel, card index) and by (kernel, mesh slot):
# the stacked executor runs block k of its device list under
# ``on_slot(k)`` (parallel/stacked.py), so two slots of one card count
# apart.  A launch outside any slot (a kernel check, the per-shard path)
# counts by card only.
LAUNCHES_BY_DEVICE: dict = {}
LAUNCHES_BY_SLOT: dict = {}
_launches_lock = threading.Lock()
_capture = threading.local()

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "container_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def reset_launches():
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            REPLAYED[k] = 0
        LAUNCHES_BY_DEVICE.clear()
        LAUNCHES_BY_SLOT.clear()


class on_slot:
    """Context manager: the wrappers' launches on this thread inside it
    also count under mesh slot ``slot`` (``LAUNCHES_BY_SLOT``)."""

    def __init__(self, slot: int):
        self.slot = slot

    def __enter__(self):
        self.prev = getattr(_capture, "slot", None)
        _capture.slot = self.slot

    def __exit__(self, *exc):
        _capture.slot = self.prev


def _count(name: str, n: int, card, slot):
    """Add ``n`` launches of ``name`` on card index ``card`` (and mesh
    slot ``slot`` unless None) to the per-card and per-slot tables;
    the caller holds ``_launches_lock``."""
    key = (name, card)
    LAUNCHES_BY_DEVICE[key] = LAUNCHES_BY_DEVICE.get(key, 0) + n
    if slot is not None:
        key = (name, slot)
        LAUNCHES_BY_SLOT[key] = LAUNCHES_BY_SLOT.get(key, 0) + n


class recording_launches:
    """Context manager for a CUDA graph capture on this thread: the
    wrappers' launches inside it are recorded into the dict it returns
    (kernel -> launches a replay makes) instead of LAUNCHES."""

    def __enter__(self) -> dict:
        self.rec = {k: 0 for k in LAUNCHES}
        self.prev = getattr(_capture, "rec", None)
        _capture.rec = self.rec
        return self.rec

    def __exit__(self, *exc):
        _capture.rec = self.prev


class tallying_launches:
    """Context manager: the wrappers' launches on this thread inside it
    are also added to the dict it returns (kernel -> launches); they
    still count in LAUNCHES.  The whole-query runner tallies an eager
    run's launches for the launch ledger (utils/devobs.py)."""

    def __enter__(self) -> dict:
        self.tally = {k: 0 for k in LAUNCHES}
        self.prev = getattr(_capture, "tally", None)
        _capture.tally = self.tally
        return self.tally

    def __exit__(self, *exc):
        _capture.tally = self.prev


def count_replay(rec: dict, card: int = 0, slot: int | None = None):
    """Count one replay of a graph whose capture recorded ``rec``, on
    card index ``card`` and mesh slot ``slot``."""
    with _launches_lock:
        for k, n in rec.items():
            LAUNCHES[k] += n
            REPLAYED[k] += n
            if n:
                _count(k, n, card, slot)


def resolve(device) -> str:
    """Container-kernel backend for tensors on ``device``: "cuda" (the
    kernels) or "torch" (the plain versions, CPU only) — also the
    kernel-backend axis of compressed ``Fragment.device_sig()`` tuples
    (storage/fragment.py)."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the container kernels")


def build() -> Path:
    """Compile the kernel source to a shared library (once per source
    content) and return its path.  The output name carries a hash of the
    source, so an edited source rebuilds; the compile writes to a
    temporary name and renames, so concurrent builders never load a
    partial file.  ``BUILD_INFO`` records the seconds taken and the
    compiler's register / shared-memory report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libcontainer_kernels-{tag}.so"
    if out.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return out
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=proc.stderr.strip())
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.decode_block_launch.argtypes = [p, p, p, p, p, p, ll, p]
            lib.decode_block_launch.restype = i
            lib.fused_row_counts_launch.argtypes = [p, p, p, p, p, p, p, ll,
                                                    i, i, p]
            lib.fused_row_counts_launch.restype = i
            _lib = lib
        return _lib


def _as_stack(stream, rows: int, words: int):
    """(PackedStack, single) for either call form: a PackedStack's five
    tensors (the 2-D slot map first), or one fragment's 1-D tables (its
    keys first), made a stack of one shard."""
    if stream[0].dim() == 1:
        return containers.stack_tables(
            *stream, tiles=containers.tiles_of(rows, words)), True
    return containers.PackedStack(*stream), False


def _check_stack(st: containers.PackedStack, rows: int, words: int):
    """Validate a stack for the kernels; returns tiles per row."""
    dev = st.slots.device
    if dev.type != "cuda":
        raise ValueError(f"container kernels run on CUDA tensors, got {dev}")
    for name, a, dt, dim in (("slots", st.slots, torch.int32, 2),
                             ("types", st.types, torch.int32, 1),
                             ("counts", st.counts, torch.int32, 1),
                             ("offsets", st.offsets, torch.int64, 1),
                             ("payload", st.payload, torch.int32, 1)):
        if a.dtype != dt or a.device != dev or a.dim() != dim or \
                not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D {dt} "
                             f"tensor on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if not st.types.numel() == st.counts.numel() == st.offsets.numel():
        raise ValueError("container tables disagree in length")
    if st.payload.data_ptr() % 16:
        raise ValueError("payload must be 16-byte aligned")
    if words % CONTAINER_WORDS:
        raise ValueError(f"words={words} is not a multiple of "
                         f"{CONTAINER_WORDS} (one container tile)")
    tpr = words // CONTAINER_WORDS
    if st.slots.shape[1] != rows * tpr:
        raise ValueError(f"slot map has {st.slots.shape[1]} tiles, a "
                         f"[{rows}, {words}] fragment {rows * tpr}")
    if st.slots.shape[0] * tpr >= 1 << 31:
        raise ValueError(f"{st.slots.shape[0]} shards exceed one launch")
    return tpr


def _launch(name: str, st: containers.PackedStack, *args):
    """Launch kernel ``name`` over ``st`` (and ``args``) on the current
    stream of the stack's device, raise on a CUDA error, count it."""
    dev = st.slots.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_load(), f"{name}_launch")(
            *(a.data_ptr() for a in st), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    rec = getattr(_capture, "rec", None)
    if rec is not None:
        rec[name] += 1
        return
    with _launches_lock:
        LAUNCHES[name] += 1
        _count(name, 1, dev.index, getattr(_capture, "slot", None))
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] += 1


# ---------------------------------------------------------------------------
# decode_block
# ---------------------------------------------------------------------------

def decode_block_plain(slots, types, counts, offsets, payload, *,
                       rows: int, words: int = SHARD_WORDS) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel (ops/containers.py
    decode_block), in both call forms."""
    st, single = _as_stack((slots, types, counts, offsets, payload), rows,
                           words)
    out = containers.decode_block(*st, rows=rows, words=words)
    return out[0] if single else out


def decode_block(slots, types, counts, offsets, payload, *, rows: int,
                 words: int = SHARD_WORDS) -> torch.Tensor:
    """Decode a PackedStack (``slots`` its ``[S, tiles]`` slot map) to
    dense int32 words ``[S, rows, words]``, or one fragment's 1-D tables
    (``slots`` then its keys) to ``[rows, words]``.  CPU tensors take the
    plain version; CUDA tensors launch ``decode_block_kernel``."""
    stream = (slots, types, counts, offsets, payload)
    if slots.device.type == "cpu":
        return decode_block_plain(*stream, rows=rows, words=words)
    st, single = _as_stack(stream, rows, words)
    _check_stack(st, rows, words)
    S = st.slots.shape[0]
    dev = st.slots.device
    if st.types.numel() == 0 or st.slots.numel() == 0:
        out = torch.zeros((S, rows, words), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((S, rows, words), dtype=torch.int32, device=dev)
        _launch("decode_block", st, out.data_ptr(), st.slots.numel())
    return out[0] if single else out


# ---------------------------------------------------------------------------
# fused_row_counts
# ---------------------------------------------------------------------------

def fused_row_counts_plain(slots, types, counts, offsets, payload,
                           filt=None, *, rows: int,
                           words: int = SHARD_WORDS) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: decode, AND with the
    filter, per-row popcount -> int32 ``[S, rows]`` (``[rows]`` for 1-D
    tables)."""
    frag = decode_block_plain(slots, types, counts, offsets, payload,
                              rows=rows, words=words)
    if filt is not None:
        frag = frag & filt[..., None, :]
    return bitset.row_counts(frag)


def fused_row_counts(slots, types, counts, offsets, payload, filt=None,
                     *, rows: int, words: int = SHARD_WORDS) -> torch.Tensor:
    """Per-row set-bit counts of a PackedStack, optionally ANDed with a
    dense filter ``[S, words]`` (``[words]`` for 1-D tables), in one
    launch: int32 ``[S, rows]`` (``[rows]``).  Call forms as
    ``decode_block``.  CPU tensors take the plain version; CUDA tensors
    launch ``fused_row_counts_kernel``."""
    stream = (slots, types, counts, offsets, payload)
    if slots.device.type == "cpu":
        return fused_row_counts_plain(*stream, filt, rows=rows, words=words)
    st, single = _as_stack(stream, rows, words)
    tpr = _check_stack(st, rows, words)
    S = st.slots.shape[0]
    dev = st.slots.device
    if filt is not None:
        if single:
            filt = filt[None]
        if filt.dtype != torch.int32 or filt.device != dev or \
                tuple(filt.shape) != (S, words) or \
                not filt.is_contiguous() or filt.data_ptr() % 16:
            raise ValueError(
                f"filter must be contiguous 16-byte aligned int32 "
                f"{(S, words)} on {dev}, got {filt.dtype} "
                f"{tuple(filt.shape)} on {filt.device}")
    # the kernel adds each (shard, tile column)'s count with an atomic
    out = torch.zeros((S, rows), dtype=torch.int32, device=dev)
    if st.types.numel() and st.slots.numel():
        _launch("fused_row_counts", st,
                None if filt is None else filt.data_ptr(), out.data_ptr(),
                S, rows, tpr)
    return out[0] if single else out
