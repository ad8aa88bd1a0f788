"""ChaosProxy: a TCP forwarder that injects NETWORK-level faults
between cluster nodes (docs/robustness.md "Network chaos").

The in-process failpoint registry (utils/faults.py) exercises error
*handling* paths, but it can't produce what real networks do: bytes
that arrive late, connections that die mid-response with an RST, peers
that accept a request and then go silent (half-open), or partitions
where one direction flows and the other doesn't.  Tests and game-days
park a ChaosProxy between nodes — the cluster's host list points at the
proxy, the proxy forwards to the real port — and arm faults with the
SAME ``name=mode[:arg][@match][#times]`` spec grammar as the failpoint
registry (utils/faults.py parse_spec), over the proxy's trigger sites:

    site      fires on
    -------   -------------------------------------------------------
    connect   every new inbound connection
    up        every chunk flowing client -> upstream (requests)
    down      every chunk flowing upstream -> client (responses)

and the network mode set:

    latency:<s>         sleep before forwarding each chunk (a straggling
                        but alive peer; arm with #times for a one-shot
                        stall)
    throttle:<bytes/s>  bandwidth cap: sleep len(chunk)/rate per chunk
    rst[:after_bytes]   once the site has forwarded >= after_bytes,
                        hard-close BOTH sockets with SO_LINGER(0) — the
                        peer sees a connection reset mid-stream
    blackhole           read and DISCARD chunks (half-open drop: the
                        sender believes the bytes went out, the receiver
                        blocks until its socket timeout); on ``connect``
                        the connection is accepted and never serviced
    partition           on ``connect``: accept and immediately RST (a
                        hard partition — definite, fast failure); on a
                        direction site it behaves like ``rst:0``

``@match`` substring-filters on the site key (``client_ip:port`` of the
inbound connection), ``#times`` disarms after that many triggers.
Asymmetric partitions are one-direction blackholes; full partitions are
``connect=partition`` plus :meth:`sever` to kill live flows.

Threading: one accept loop, two pump threads per connection.  Pure
stdlib, test/game-day infrastructure only — never on a serving path.

Port copy of the JAX package's ``utils/netchaos.py``: the PyTorch port
keeps its own copy (over its own ``utils/faults.py`` ``parse_spec``) so
that the port's cluster tests and ``chip_smoke.py`` import nothing of
the JAX package.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from .faults import parse_spec
from .locks import make_lock

_SITES = ("connect", "up", "down")
_MODES = ("latency", "throttle", "rst", "blackhole", "partition")

# per-recv chunk; small enough that latency/throttle act per-segment,
# big enough that healthy forwarding is not syscall-bound
CHUNK = 64 << 10


class _NetFault:
    __slots__ = ("mode", "arg", "match", "times", "hits")

    def __init__(self, mode: str, arg: float, match: str | None,
                 times: int | None):
        self.mode = mode
        self.arg = arg
        self.match = match
        self.times = times
        self.hits = 0


def _hard_close(sock):
    """Close with SO_LINGER(1, 0): the kernel sends RST, not FIN — the
    peer sees a reset, exactly what a yanked cable / dead middlebox
    produces."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    """TCP forwarder ``listen_port -> target`` with armable faults."""

    def __init__(self, target_host: str, target_port: int,
                 listen_host: str = "localhost", listen_port: int = 0):
        self.target = (target_host, target_port)
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, listen_port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._faults: dict[str, _NetFault] = {}
        self._lock = make_lock("netchaos")
        self._closing = threading.Event()
        self._conns: set[tuple[socket.socket, socket.socket]] = set()
        # counters for assertions/snapshots (all under _lock)
        self.connections = 0
        self.bytes_up = 0
        self.bytes_down = 0
        self.rsts = 0
        self.dropped_bytes = 0
        self.refused = 0
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- arming ------------------------------------------------------------

    def arm(self, site: str, mode: str, arg: float = 0.0,
            match: str | None = None, times: int | None = None):
        if site not in _SITES:
            raise ValueError(f"unknown chaos site {site!r} "
                             f"(one of {_SITES})")
        if mode not in _MODES:
            raise ValueError(f"unknown chaos mode {mode!r} "
                             f"(one of {_MODES})")
        with self._lock:
            self._faults[site] = _NetFault(mode, arg, match, times)

    def configure(self, spec: str):
        """Arm from a ``site=mode[:arg][@match][#times];...`` spec —
        the shared faults.py grammar over the network mode set."""
        for site, mode, arg, match, times in parse_spec(spec):
            self.arm(site, mode, arg, match, times)

    def disarm(self, site: str | None = None):
        with self._lock:
            if site is None:
                self._faults.clear()
            else:
                self._faults.pop(site, None)

    def heal(self):
        """Disarm everything — the partition ends, traffic flows."""
        self.disarm()

    def sever(self):
        """RST every live connection (pair with ``connect=partition``
        for a full partition: existing flows die, new ones are
        refused)."""
        with self._lock:
            conns = list(self._conns)
        for a, b in conns:
            _hard_close(a)
            _hard_close(b)
        # severed pairs are gone — drop them so blackholed (pump-less)
        # connections don't accumulate in the set for the proxy's
        # lifetime (pump threads discard their own pair; this is the
        # only removal path a connect=blackhole entry ever gets)
        with self._lock:
            self._conns.difference_update(conns)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "target": f"{self.target[0]}:{self.target[1]}",
                "listen": self.address,
                "connections": self.connections,
                "bytesUp": self.bytes_up,
                "bytesDown": self.bytes_down,
                "rsts": self.rsts,
                "droppedBytes": self.dropped_bytes,
                "refused": self.refused,
                "armed": {s: {"mode": f.mode, "arg": f.arg,
                              "match": f.match, "timesLeft": f.times,
                              "hits": f.hits}
                          for s, f in self._faults.items()},
            }

    def close(self):
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.sever()

    # -- fault evaluation --------------------------------------------------

    def _fault(self, site: str, key: str,
               forwarded: int = 0) -> tuple[str, float] | None:
        """(mode, arg) if a fault fires for this site/key, else None.
        Consumes #times like the failpoint registry.  ``rst``'s byte
        threshold is checked HERE so an un-reached threshold neither
        counts a hit nor consumes #times."""
        with self._lock:
            f = self._faults.get(site)
            if f is None:
                return None
            if f.match and f.match not in key:
                return None
            if f.mode in ("rst", "partition") and forwarded < f.arg:
                return None
            f.hits += 1
            if f.times is not None:
                f.times -= 1
                if f.times <= 0:
                    del self._faults[site]
            return f.mode, f.arg

    # -- forwarding --------------------------------------------------------

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                client, addr = self._listener.accept()
            except OSError:
                return  # listener closed
            key = f"{addr[0]}:{addr[1]}"
            with self._lock:
                self.connections += 1
            hit = self._fault("connect", key)
            if hit is not None:
                mode, _arg = hit
                if mode in ("partition", "rst"):
                    with self._lock:
                        self.refused += 1
                    _hard_close(client)
                    continue
                if mode == "blackhole":
                    # accepted, never serviced: the client blocks on its
                    # own socket timeout (the half-open peer)
                    with self._lock:
                        self.refused += 1
                        self._conns.add((client, client))
                    continue
                if mode == "latency":
                    time.sleep(_arg)
                # throttle on connect is meaningless: ignore
            try:
                upstream = socket.create_connection(self.target,
                                                    timeout=10)
            except OSError:
                _hard_close(client)
                continue
            pair = (client, upstream)
            with self._lock:
                self._conns.add(pair)
            for site, src, dst in (("up", client, upstream),
                                   ("down", upstream, client)):
                t = threading.Thread(target=self._pump,
                                     args=(site, key, src, dst, pair),
                                     daemon=True)
                t.start()

    def _pump(self, site: str, key: str, src, dst, pair):
        forwarded = 0
        try:
            while not self._closing.is_set():
                try:
                    chunk = src.recv(CHUNK)
                except OSError:
                    break
                if not chunk:
                    break
                hit = self._fault(site, key, forwarded)
                if hit is not None:
                    mode, arg = hit
                    if mode == "latency":
                        time.sleep(arg)
                    elif mode == "throttle" and arg > 0:
                        time.sleep(len(chunk) / arg)
                    elif mode in ("rst", "partition"):
                        with self._lock:
                            self.rsts += 1
                        _hard_close(src)
                        _hard_close(dst)
                        break
                    elif mode == "blackhole":
                        with self._lock:
                            self.dropped_bytes += len(chunk)
                        continue  # swallowed: half-open drop
                try:
                    dst.sendall(chunk)
                except OSError:
                    break
                forwarded += len(chunk)
                with self._lock:
                    if site == "up":
                        self.bytes_up += len(chunk)
                    else:
                        self.bytes_down += len(chunk)
        finally:
            # one direction ending ends the conversation: HTTP keep-alive
            # can't survive a half-dead tunnel, and the cluster client
            # re-dials transparently
            for s in pair:
                try:
                    s.close()
                except OSError:
                    pass
            with self._lock:
                self._conns.discard(pair)
