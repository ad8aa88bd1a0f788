"""Process-level kill -9 crash harness for the PyTorch port: the
counterpart of tests/test_crash.py and tests/crash_worker.py.

A child port server (this file run as a script, ``python
tests/test_torch_crash.py DATA_DIR BIND MAX_OP_N [SPEC]``, with
``device="cpu"``) runs under single-bit write load; each cycle it is
SIGKILLed, either by a kill-mode failpoint
(pilosa_tpu_torch/utils/faults.py) armed inside an exact storage
window (mid WAL append, mid snapshot write, between snapshot fsync and
rename, inside the startup torn-tail truncation) or by a manual kill -9
at a random write index, then restarted.  After every restart the
harness asserts:

* zero acknowledged-write loss: every Set that returned HTTP 200
  before the kill is present after replay;
* no invented data: anything extra is exactly the (at most one)
  in-flight write the kill interrupted;
* clean startup: the server reaches serving state and reports
  storage.degraded == false.

The check is behavioural: the two packages' children would see
different kill points under the same load, so there is no differential
form.  The byte-level truncation and bit-flip fuzz is in
tests/test_torch_durability.py.  The short 2-cycle run rides tier-1;
the 20-cycle randomized soak is marked slow, as in the reference.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

WORKER = os.path.abspath(__file__)
MAX_OP_N = 12   # snapshot every ~12 ops so the snapshot windows see traffic
N_ROWS = 6
INDEX = "ci"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(port, method, path, data=None, timeout=15):
    body = None
    if data is not None:
        body = data.encode() if isinstance(data, str) \
            else json.dumps(data).encode()
    r = urllib.request.Request(
        f"http://localhost:{port}{path}", method=method, data=body)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read())


def _pick_spec(rng) -> str:
    """One cycle's failpoint spec.  Empty = manual mid-load SIGKILL."""
    roll = int(rng.integers(0, 5))
    if roll == 0:
        return f"fragment.wal=kill:{int(rng.integers(0, 60))}"
    if roll == 1:
        return f"fragment.snapshot=kill:{int(rng.integers(0, 4))}"
    if roll == 2:
        return f"fragment.snapshot.rename=kill:{int(rng.integers(0, 4))}"
    if roll == 3:
        # fires only when startup actually finds a torn tail to
        # truncate; otherwise the manual fallback kill ends the cycle
        return "fragment.wal.truncate=kill:0"
    return ""


class _Harness:
    def __init__(self, tmp_path):
        self.data_dir = str(tmp_path / "node")
        self.proc = None
        self.port = None
        # acknowledged (row -> cols) and possibly-landed in-flight writes
        self.acked = {r: set() for r in range(N_ROWS)}
        self.maybe = set()
        self.next_col = 0

    # -- child lifecycle ---------------------------------------------------

    def _spawn(self, spec: str) -> bool:
        """Start the worker; True once serving, False if it was SIGKILLed
        during startup (a legitimate outcome for startup-window
        failpoints like fragment.wal.truncate)."""
        self.port = _free_port()
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + [p for p in
                           env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.proc = subprocess.Popen(
            [sys.executable, WORKER, self.data_dir,
             f"localhost:{self.port}", str(MAX_OP_N), spec],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True)
        deadline = time.time() + 120
        while time.time() < deadline:
            ret = self.proc.poll()
            if ret is not None:
                out = self.proc.stdout.read()
                assert ret == -signal.SIGKILL, \
                    f"worker died rc={ret} (not SIGKILL):\n{out[-4000:]}"
                return False
            try:
                _req(self.port, "GET", "/status", timeout=5)
                return True
            except Exception:
                time.sleep(0.1)
        raise AssertionError("worker did not reach serving state in 120s")

    def start(self, spec: str = ""):
        """Start the worker with ``spec`` armed; if a startup-window
        failpoint kills it during replay/recovery, restart bare — the
        recovery itself must be crash-safe (truncation re-runs
        idempotently)."""
        if not self._spawn(spec):
            assert self._spawn(""), "recovery-of-recovery died"

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=30)

    def stop(self):
        try:
            self.kill()
        except Exception:
            pass

    # -- load + verification -----------------------------------------------

    def ensure_schema(self):
        for path in (f"/index/{INDEX}", f"/index/{INDEX}/field/f"):
            try:
                _req(self.port, "POST", path, {})
            except urllib.error.HTTPError as e:
                if e.code not in (400, 409):  # already exists
                    raise

    def write_until_death(self, rng, max_writes=250) -> None:
        """Single-bit write load until the child dies at its failpoint;
        if it survives ``max_writes`` (or the cycle is a manual one),
        kill -9 at a random write index."""
        manual_at = int(rng.integers(20, max_writes))
        for i in range(max_writes):
            row = int(rng.integers(0, N_ROWS))
            col = self.next_col
            self.next_col += 1
            self.maybe.add((row, col))
            try:
                _req(self.port, "POST", f"/index/{INDEX}/query",
                     f"Set({col}, f={row})", timeout=15)
            except Exception:
                # the in-flight write died with the child: confirm the
                # death was the SIGKILL we engineered, not a crash
                ret = self.proc.wait(timeout=30)
                assert ret == -signal.SIGKILL, \
                    f"worker died rc={ret} under write load"
                return
            self.acked[row].add(col)
            self.maybe.discard((row, col))
            if i >= manual_at:
                self.kill()
                return
        self.kill()

    def verify(self):
        """The durability contract, checked after every restart."""
        st = _req(self.port, "GET", "/status")
        # a pure process kill never loses/corrupts synced state: torn
        # tails recover, nothing quarantines
        assert st["storage"]["degraded"] is False, st["storage"]
        for row in range(N_ROWS):
            [res] = _req(self.port, "POST", f"/index/{INDEX}/query",
                         f"Row(f={row})")["results"]
            got = set(res["columns"])
            may = {c for (r, c) in self.maybe if r == row}
            lost = self.acked[row] - got
            assert not lost, \
                f"row {row}: {len(lost)} acknowledged writes lost " \
                f"(e.g. {sorted(lost)[:5]})"
            extra = got - self.acked[row] - may
            assert not extra, \
                f"row {row}: invented columns {sorted(extra)[:5]}"


def _run_cycles(tmp_path, n_cycles: int, seed: int,
                forced_specs: list[str] | None = None):
    """Each cycle: (re)start with that cycle's failpoint spec armed —
    the restart itself replays the previous kill's WAL — verify the
    whole durability contract, then write until the armed window (or
    the manual fallback) SIGKILLs the child.  One final bare restart
    verifies the last kill."""
    rng = np.random.default_rng(seed)
    h = _Harness(tmp_path)
    try:
        for cycle in range(n_cycles):
            spec = forced_specs[cycle] if forced_specs is not None \
                else _pick_spec(rng)
            h.start(spec)
            h.ensure_schema()
            h.verify()
            h.write_until_death(rng)
        h.start()
        h.verify()
    finally:
        h.stop()


def test_crash_harness_short(tmp_path):
    """Two deterministic cycles covering the two highest-value windows
    (WAL append, snapshot rename) — fast enough for tier-1 and the
    scripts/check.sh subset."""
    _run_cycles(tmp_path, 2, seed=7, forced_specs=[
        "fragment.wal=kill:25",
        "fragment.snapshot.rename=kill:0",
    ])


@pytest.mark.slow
def test_crash_harness_soak(tmp_path):
    """The acceptance soak: >= 20 randomized kill -9 cycles across all
    storage failpoint windows, zero acknowledged-write loss."""
    _run_cycles(tmp_path, 20, seed=1234)


def worker_main(argv):
    """The child: one single-node port server on the CPU with the
    failpoint spec armed BEFORE anything touches disk, serving until it
    is killed."""
    import threading

    data_dir, bind, max_op_n = argv[:3]
    spec = argv[3] if len(argv) > 3 else ""
    from pilosa_tpu_torch.utils.faults import FAULTS
    if spec:
        FAULTS.configure(spec)

    from pilosa_tpu_torch.server.server import Config, Server
    cfg = Config(data_dir=data_dir, bind=bind, max_op_n=int(max_op_n),
                 anti_entropy_interval=0, repair_interval=0,
                 failpoints=spec, device="cpu", metric_poll_interval=0)
    srv = Server(cfg)
    srv.open()
    print(f"CRASH WORKER READY port={srv.port}", flush=True)
    threading.Event().wait()  # serve until SIGKILL


if __name__ == "__main__":
    worker_main(sys.argv[1:])
