"""Diagnostics reporting (reference diagnostics.go:42-263).

The reference phones home hourly to a hard-coded vendor endpoint; this
rebuild keeps the subsystem but inverts the default: reporting is OFF
unless the operator configures ``diagnostics_endpoint``, and the payload
goes to THEIR endpoint (fleet monitoring), not a vendor's.  The payload
mirrors the reference's anonymized shape: version, platform, uptime,
schema scale, and runtime gauges.

Port copy of the JAX package's ``utils/diagnostics.py``.  Deviation: the
payload also names the server's primary device (the first of its device
list) and, on a CUDA device, its card (``torch.cuda.get_device_name``).
"""

from __future__ import annotations

import json
import platform
import threading
import time
import urllib.request


class DiagnosticsCollector:
    def __init__(self, server, endpoint: str, interval: float = 3600.0):
        self.server = server
        self.endpoint = endpoint
        self.interval = interval
        # lint: allow(wall-clock) — uptime is operator display on the
        # diagnostics report, never a perf measurement
        self.start_time = time.time()
        self._closing = threading.Event()
        self._thread = None

    def payload(self) -> dict:
        """(diagnostics.go:80-151 CheckVersion/logic, minus identifiers)"""
        from .. import __version__

        holder = self.server.holder
        # schema levels mutate under per-object locks; each list()/len()
        # below is a single GIL-atomic snapshot, so concurrent DDL can
        # skew counts but never break iteration
        indexes = list(holder.indexes.values())
        fields = [f for i in indexes for f in list(i.fields.values())]
        n_fields = len(fields)
        n_frags = sum(len(v.fragments) for f in fields
                      for v in list(f.views.values()))
        out = {
            "version": __version__,
            "platform": platform.platform(),
            "python": platform.python_version(),
            # lint: allow(wall-clock) — uptime display; second-scale
            # NTP slew is irrelevant at hour granularity
            "uptimeSeconds": int(time.time() - self.start_time),
            "numIndexes": len(holder.indexes),
            "numFields": n_fields,
            "numFragments": n_frags,
        }
        devices = getattr(self.server, "devices", None)
        if devices:
            device = devices[0]         # the primary
            out["device"] = str(device)
            if device.type == "cuda":
                import torch
                out["card"] = torch.cuda.get_device_name(device)
        cluster = self.server.cluster
        if cluster is not None:
            out["numNodes"] = len(cluster.nodes)
            out["replicaN"] = cluster.replica_n
            out["clusterState"] = cluster.state
        # SLOs & alerting (docs/observability.md): active-alert count
        # and the newest flight-recorder bundle stamp, so fleet
        # monitoring sees "this node is paging" without scraping it
        slo = getattr(self.server, "slo", None)
        if slo is not None:
            summary = slo.vars_summary()
            out["activeAlerts"] = len(summary["active"])
            out["alertsFired"] = summary["firedTotal"]
        rec = getattr(self.server, "flightrec", None)
        if rec is not None:
            out["lastBundle"] = rec.snapshot()["last"]
        return out

    def report_once(self) -> bool:
        try:
            body = json.dumps(self.payload()).encode()
            req = urllib.request.Request(
                self.endpoint, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()
            return True
        except Exception as e:
            # diagnostics must never take the server down, but a
            # misconfigured endpoint must not fail invisibly either
            self.server.logger.error(f"diagnostics report failed: {e}")
            return False

    def open(self):
        if not self.endpoint or self.interval <= 0:
            return  # interval 0 disables, like the other monitors
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._closing.wait(self.interval):
            self.report_once()

    def close(self):
        self._closing.set()
