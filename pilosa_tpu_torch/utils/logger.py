"""Logger (reference logger/logger.go:25-107 Logger iface +
std/verbose/nop impls).

Port copy of the JAX package's ``utils/logger.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import sys
import time


class Logger:
    def __init__(self, verbose: bool = False, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stderr

    def _emit(self, level: str, msg: str):
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.stream.write(f"{ts} {level} {msg}\n")
        self.stream.flush()

    def info(self, msg: str):
        self._emit("INFO", msg)

    def debug(self, msg: str):
        if self.verbose:
            self._emit("DEBUG", msg)

    def error(self, msg: str):
        self._emit("ERROR", msg)

    def event(self, name: str, **fields):
        """Structured log line — ``<ts> INFO <name> k=v k=v ...`` with
        stable key order — so operators can grep/join machine-readably.
        The slow-query log emits these with ``trace=<id>``, correlating
        log lines to /debug/traces (docs/observability.md)."""
        parts = " ".join(
            f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
            for k, v in fields.items())
        self._emit("INFO", f"{name} {parts}" if parts else name)


class NopLogger(Logger):
    def _emit(self, level: str, msg: str):
        pass
