"""Deterministic failpoint registry for chaos/robustness testing.

Production behavior is a no-op: ``FAULTS.hit(name)`` returns after one
empty-dict check when nothing is armed.  Tests (and operators running
game-days) arm failpoints programmatically (``FAULTS.arm``) or via the
``failpoints`` config knob / ``PILOSA_TPU_FAILPOINTS`` env var, using a
compact spec:

    name=mode[:arg][@match][#times][;name=...]

    client.request=error@localhost:10102        every request to that host
                                                fails as a transport error
    mesh.slice=delay:0.25@myindex#3             first three shard slices of
                                                queries over 'myindex' sleep
                                                250 ms before dispatch
    fragment.snapshot=error                     snapshot writes fail

Modes: ``error`` raises ``FaultInjected`` (an OSError subclass, so
transport-level handling — client retries, circuit breakers, fan-out
replica retry — exercises its real error paths), ``delay:<seconds>``
sleeps, and ``kill[:skip]`` SIGKILLs the OWN process after skipping the
first ``skip`` hits — the crash harness's way of dying at an exact
byte-level failpoint (mid snapshot rename, between WAL frame appends)
instead of at a random wall-clock instant.  ``@match`` is a substring
filter on the key the hit site passes (host+path for client requests,
index name for mesh slices, file path for storage); ``#times`` disarms
after that many triggers.

Woven into: ``InternalClient._request`` (client.request), fragment
snapshot/WAL writes (fragment.snapshot / fragment.wal), and the mesh
shard-slice loop (mesh.slice) — every overload/failure path is testable
without real partitions (the failpoints.go idea from the reference's
test suite, env-armed).

Port copy of the JAX package's ``utils/faults.py``: the PyTorch port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import time

from .locks import make_lock


class FaultInjected(OSError):
    """Injected failure.  An OSError so transport/storage error handling
    treats it exactly like the real fault it simulates."""


def parse_spec(spec: str) -> list[tuple[str, str, float, str | None,
                                        int | None]]:
    """Parse a ``name=mode[:arg][@match][#times];...`` spec into
    ``(name, mode, arg, match, times)`` tuples.  Shared grammar between
    the in-process failpoint registry (this module) and the network
    fault layer (utils/netchaos.py ChaosProxy) — one spec syntax for
    every chaos surface; each consumer validates its own mode set."""
    out = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rhs = part.partition("=")
        if not rhs:
            raise ValueError(f"bad failpoint spec {part!r}")
        times = None
        if "#" in rhs:
            rhs, _, t = rhs.rpartition("#")
            times = int(t)
        match = None
        if "@" in rhs:
            rhs, _, match = rhs.partition("@")
        mode, _, arg = rhs.partition(":")
        out.append((name.strip(), mode.strip(),
                    float(arg) if arg else 0.0, match or None, times))
    return out


class _Fault:
    __slots__ = ("mode", "arg", "match", "times", "hits")

    def __init__(self, mode: str, arg: float, match: str | None,
                 times: int | None):
        self.mode = mode
        self.arg = arg
        self.match = match
        self.times = times
        self.hits = 0


class FaultRegistry:
    def __init__(self):
        self._faults: dict[str, _Fault] = {}
        self._lock = make_lock("faults")

    def arm(self, name: str, mode: str = "error", arg: float = 0.0,
            match: str | None = None, times: int | None = None):
        if mode not in ("error", "delay", "kill"):
            raise ValueError(f"unknown failpoint mode {mode!r}")
        with self._lock:
            self._faults[name] = _Fault(mode, arg, match, times)

    def disarm(self, name: str | None = None):
        with self._lock:
            if name is None:
                self._faults.clear()
            else:
                self._faults.pop(name, None)

    def configure(self, spec: str):
        """Parse and arm a ``name=mode[:arg][@match][#times];...`` spec."""
        for name, mode, arg, match, times in parse_spec(spec):
            self.arm(name, mode, arg, match, times)

    def hit(self, name: str, key: str = ""):
        """Trigger point.  MUST stay near-free when nothing is armed —
        it sits on hot paths (WAL appends, slice dispatch)."""
        if not self._faults:          # production fast path, no lock
            return
        with self._lock:
            f = self._faults.get(name)
            if f is None:
                return
            if f.match and f.match not in key:
                return
            f.hits += 1
            if f.mode == "kill" and f.arg > 0:
                # kill:skip — let the first `skip` hits through so the
                # crash harness can die on a RANDOM later occurrence of
                # the same failpoint, not always the first
                f.arg -= 1
                return
            if f.times is not None:
                f.times -= 1
                if f.times <= 0:
                    del self._faults[name]
            mode, arg = f.mode, f.arg
        if mode == "delay":
            time.sleep(arg)
        elif mode == "kill":
            # kill -9 the OWN process at this exact failpoint: no atexit,
            # no flushing, no destructors — the crash the durability
            # contract is written against (docs/robustness.md)
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        else:
            raise FaultInjected(f"failpoint {name!r} injected (key={key!r})")

    def snapshot(self) -> dict:
        with self._lock:
            return {name: {"mode": f.mode, "arg": f.arg, "match": f.match,
                           "timesLeft": f.times, "hits": f.hits}
                    for name, f in self._faults.items()}


FAULTS = FaultRegistry()
