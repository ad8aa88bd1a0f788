"""Native (C) host helpers — the port of the JAX package's
``native/__init__.py``.

The compute path is PyTorch and CUDA; these are host-side hot spots
where Python-level cost caps serving throughput.  Each helper is
optional: its shared library is built from the checked-in C source with
the system ``cc`` at first use, into ``pilosa_tpu_torch/_build/`` (listed
in ``.gitignore``), and every caller keeps its pure-Python path, so a
missing toolchain degrades to the slow path rather than failing.

Deviation from the JAX module: nothing is built when the module is
imported, and the library goes to the build directory, not beside its
source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent / "_build"

_lock = threading.Lock()
_libs: dict = {}


def _build_and_load(name: str):
    """Compile native/<name>.c to _build/_<name>.so (if stale) and dlopen
    it.  Returns None on any failure — callers must treat the native
    path as an optimization, never a requirement."""
    src = _SRC_DIR / f"{name}.c"
    so = BUILD_DIR / f"_{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        try:
            return ctypes.CDLL(str(so))
        except OSError:
            pass  # corrupt / wrong-arch artifact: rebuild below
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a temp file + atomic rename: concurrent importers
        # (test workers, several servers) must not dlopen a half-written
        # library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, str(src)],
                check=True, capture_output=True, timeout=60)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return ctypes.CDLL(str(so))
    # the native library is an optional accelerator: no cc / no
    # toolchain falls back to the pure-Python path, and callers treat
    # None as exactly that
    except (OSError, subprocess.SubprocessError):
        return None


def _fingerprint_lib():
    with _lock:
        if "fingerprint" not in _libs:
            lib = _build_and_load("fingerprint")
            if lib is not None:
                lib.fingerprint_scan.argtypes = [
                    ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
                ]
                lib.fingerprint_scan.restype = ctypes.c_long
            _libs["fingerprint"] = lib
        return _libs["fingerprint"]


def fingerprint_native(query: str):
    """(template, values int64 ndarray) via the C scanner, or None when
    the native library is unavailable or the query needs the Python path
    (non-ASCII text, int64 overflow)."""
    lib = _fingerprint_lib()
    if lib is None:
        return None
    if not query.isascii():
        # the regex's \w matches Unicode word chars in lookarounds; the C
        # scanner is byte-wise ASCII — non-ASCII queries take the Python
        # path
        return None
    b = query.encode("utf-8")
    n = len(b)
    tmpl = ctypes.create_string_buffer(n + 1)
    vals = np.empty(n // 2 + 1, dtype=np.int64)
    out_len = ctypes.c_long()
    nv = lib.fingerprint_scan(
        b, n, tmpl, ctypes.byref(out_len),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), vals.size)
    if nv < 0:
        return None
    return tmpl.raw[:out_len.value].decode("utf-8"), vals[:nv]
