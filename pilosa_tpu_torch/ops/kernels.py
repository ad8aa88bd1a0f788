"""Container kernels for Hopper: the port of the JAX package's
``ops/kernels.py`` (its two Pallas kernels), written in CUDA C++ in
``csrc/container_kernels.cu``.

* ``decode_block`` — packed container streams -> dense words, one
  2048-word tile per thread block.
* ``fused_row_counts`` — decode + optional AND with a dense filter +
  per-row popcount in one launch; the decoded words never reach device
  memory (the TopN/Rows ``row_counts`` hot path, parallel/stacked.py).

Both take the stacked shard axis natively — tables ``[S, C]``, payload
``[S, P]`` — so one launch covers a whole signature group (what ``vmap``
over the Pallas call gave on the TPU).  1-D tables are one fragment.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream, raises if the
launch reports an error, and counts its launches in ``LAUNCHES``.  On a
tensor that lies on the CPU it calls its plain PyTorch version
(``decode_block_plain``, ``fused_row_counts_plain``) instead; on a CUDA
tensor it launches the kernel or raises — there is no fallback.
Degenerate inputs (no containers, no rows, no shards) return zeros
without a launch.

Deviations from the JAX module, by design:

* The backend is resolved from the tensors' device ("cuda" or "torch"),
  not from a process-wide knob; there is no switch that moves the card's
  path off the kernels.
* The TPU's ``fits_vmem`` eligibility rule (a 12 MB VMEM budget) does not
  apply: each block's shared memory is a fixed ~10 KB whatever the
  bucket, so every packed entry on the card takes the kernel.
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
LAUNCHES = {"decode_block": 0, "fused_row_counts": 0}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "container_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_SHARDS = 65535  # grid.y limit of one launch

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
            lib.decode_block_launch.argtypes = [p, p, p, p, p, p, i, i, ll,
                                                i, p]
            lib.decode_block_launch.restype = i
            lib.fused_row_counts_launch.argtypes = [p, p, p, p, p, p, p, i,
                                                    i, ll, i, i, p]
            lib.fused_row_counts_launch.restype = i
            _lib = lib
        return _lib


def _check_stream(keys, types, counts, offsets, payload):
    """Validate one packed stream (1-D) or a stacked group (2-D) and
    return it as 2-D tensors plus whether the caller passed 1-D."""
    single = keys.dim() == 1
    tabs = (keys, types, counts, offsets)
    if single:
        tabs = tuple(a[None] for a in tabs)
        payload = payload[None]
    dev = tabs[0].device
    for name, a in zip(("keys", "types", "counts", "offsets", "payload"),
                       tabs + (payload,)):
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bit patterns), "
                            f"got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, keys on {dev}")
        if a.dim() != 2:
            raise ValueError(f"{name} must be 1-D or 2-D, got {a.shape}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(a.shape != tabs[0].shape for a in tabs) or \
            payload.shape[0] != tabs[0].shape[0]:
        raise ValueError("container tables and payload disagree in shape: "
                         f"{[tuple(a.shape) for a in tabs + (payload,)]}")
    if dev.type != "cuda":
        raise ValueError(f"container kernels run on CUDA tensors, got {dev}")
    return tabs + (payload,), single


def _launch_shape(S: int, rows: int, words: int):
    if words % CONTAINER_WORDS:
        raise ValueError(f"words={words} is not a multiple of "
                         f"{CONTAINER_WORDS} (one container tile)")
    if S > MAX_SHARDS:
        raise ValueError(f"{S} stacked shards exceed one launch's "
                         f"{MAX_SHARDS}")
    return words // CONTAINER_WORDS


# ---------------------------------------------------------------------------
# decode_block
# ---------------------------------------------------------------------------

def decode_block_plain(keys, types, counts, offsets, payload, *, rows: int,
                       words: int = SHARD_WORDS) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel (ops/containers.py
    decode_block)."""
    return containers.decode_block(keys, types, counts, offsets, payload,
                                   rows=rows, words=words)


def decode_block(keys, types, counts, offsets, payload, *, rows: int,
                 words: int = SHARD_WORDS) -> torch.Tensor:
    """Decode packed streams to dense int32 words ``[S, rows, words]``
    (``[rows, words]`` for 1-D tables).  CPU tensors take the plain
    version; CUDA tensors launch ``decode_block_kernel``."""
    if keys.device.type == "cpu":
        return decode_block_plain(keys, types, counts, offsets, payload,
                                  rows=rows, words=words)
    (keys, types, counts, offsets, payload), single = _check_stream(
        keys, types, counts, offsets, payload)
    S, C = keys.shape
    out = torch.empty((S, rows, words), dtype=torch.int32,
                      device=keys.device)
    if C == 0 or rows == 0 or S == 0:
        out.zero_()
    else:
        tpr = _launch_shape(S, rows, words)
        lib = _load()
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            rc = lib.decode_block_launch(
                keys.data_ptr(), types.data_ptr(), counts.data_ptr(),
                offsets.data_ptr(), payload.data_ptr(), out.data_ptr(),
                S, C, payload.shape[1], rows * tpr, stream)
        if rc != 0:
            raise RuntimeError(f"decode_block launch failed: CUDA error {rc}")
        LAUNCHES["decode_block"] += 1
    return out[0] if single else out


# ---------------------------------------------------------------------------
# fused_row_counts
# ---------------------------------------------------------------------------

def fused_row_counts_plain(keys, types, counts, offsets, payload, filt=None,
                           *, rows: int,
                           words: int = SHARD_WORDS) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: decode, AND with the
    filter, per-row popcount -> int32 ``[S, rows]`` (``[rows]`` for 1-D
    tables)."""
    frag = containers.decode_block(keys, types, counts, offsets, payload,
                                   rows=rows, words=words)
    if filt is not None:
        frag = frag & filt[..., None, :]
    return bitset.row_counts(frag)


def fused_row_counts(keys, types, counts, offsets, payload, filt=None, *,
                     rows: int, words: int = SHARD_WORDS) -> torch.Tensor:
    """Per-row set-bit counts of packed fragments, optionally ANDed with a
    dense filter (``[S, words]``, or ``[words]`` for 1-D tables), in one
    launch: int32 ``[S, rows]`` (``[rows]``).  CPU tensors take the plain
    version; CUDA tensors launch ``fused_row_counts_kernel``."""
    if keys.device.type == "cpu":
        return fused_row_counts_plain(keys, types, counts, offsets, payload,
                                      filt, rows=rows, words=words)
    (keys, types, counts, offsets, payload), single = _check_stream(
        keys, types, counts, offsets, payload)
    S, C = keys.shape
    if filt is not None:
        if single:
            filt = filt[None]
        if filt.dtype != torch.int32 or filt.device != keys.device or \
                tuple(filt.shape) != (S, words) or not filt.is_contiguous():
            raise ValueError(
                f"filter must be contiguous int32 {(S, words)} on "
                f"{keys.device}, got {filt.dtype} {tuple(filt.shape)} on "
                f"{filt.device}")
    out = torch.empty((S, rows), dtype=torch.int32, device=keys.device)
    if C == 0 or rows == 0 or S == 0:
        out.zero_()
    else:
        tpr = _launch_shape(S, rows, words)
        lib = _load()
        with torch.cuda.device(keys.device):
            stream = torch.cuda.current_stream(keys.device).cuda_stream
            rc = lib.fused_row_counts_launch(
                keys.data_ptr(), types.data_ptr(), counts.data_ptr(),
                offsets.data_ptr(), payload.data_ptr(),
                None if filt is None else filt.data_ptr(), out.data_ptr(),
                S, C, payload.shape[1], rows, tpr, stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_row_counts launch failed: CUDA error {rc}")
        LAUNCHES["fused_row_counts"] += 1
    return out[0] if single else out
