"""Mutual TLS between the PyTorch port's cluster nodes: the case of
tests/test_cluster.py ``test_cluster_mutual_tls`` on port nodes
(``device="cpu"``), once over each internal query wire.  Every node
serves HTTPS and requires a client certificate; its ``InternalClient``
presents the node's certificate (``configure_tls``), so the DDL
broadcast, the replica write fan-out and the query fan-out ride HTTPS,
and on ``bin1`` the PTPUQRY1 frames cross TLS unchanged.  A client
without a certificate is refused by the handshake.

The certificates are made by ``openssl``, as in the reference test.
"""

import json
import ssl
import subprocess
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.pql import parse  # noqa: E402
from pilosa_tpu_torch.server.server import Config, Server  # noqa: E402

from test_torch_cluster import (  # noqa: E402, F401
    _free_ports, close_all, restore_knobs)


def _make_certs(tmp_path):
    """Self-signed CA + one server/client certificate for localhost."""
    ca_key, ca_crt = tmp_path / "ca.key", tmp_path / "ca.crt"
    key, csr, crt = tmp_path / "node.key", tmp_path / "node.csr", \
        tmp_path / "node.crt"
    ext = tmp_path / "ext.cnf"
    ext.write_text("subjectAltName=DNS:localhost,IP:127.0.0.1\n")

    def run(*a):
        subprocess.run(a, check=True, capture_output=True)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(ca_key), "-out", str(ca_crt), "-days", "1",
        "-subj", "/CN=test-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(key), "-out", str(csr), "-subj", "/CN=localhost")
    run("openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
        "-CAkey", str(ca_key), "-CAcreateserial", "-days", "1",
        "-extfile", str(ext), "-out", str(crt))
    return str(ca_crt), str(crt), str(key)


@pytest.mark.parametrize("wire", ["json", "bin1"])
def test_cluster_mutual_tls(tmp_path, wire):
    try:
        ca, crt, key = _make_certs(tmp_path)
    except Exception as e:  # pragma: no cover - missing openssl
        pytest.skip(f"openssl unavailable: {e}")
    ports = _free_ports(2)
    hosts = [f"https://localhost:{p}" for p in ports]
    servers = []
    try:
        for i, p in enumerate(ports):
            srv = Server(Config(
                data_dir=str(tmp_path / f"node{i}"), bind=f"localhost:{p}",
                node_id=f"node{i}", cluster_hosts=hosts, replica_n=2,
                device="cpu", anti_entropy_interval=0,
                metric_poll_interval=0, internal_wire=wire,
                tls_certificate=crt, tls_key=key, tls_ca_certificate=ca))
            srv.open()
            servers.append(srv)
        ctx = ssl.create_default_context(cafile=ca)
        ctx.load_cert_chain(crt, key)

        def req(port, method, path, data=None):
            body = json.dumps(data).encode() if isinstance(data, dict) \
                else (data.encode() if isinstance(data, str) else data)
            r = urllib.request.Request(
                f"https://localhost:{port}{path}", method=method, data=body)
            with urllib.request.urlopen(r, context=ctx, timeout=30) as resp:
                return json.loads(resp.read() or b"{}")

        req(ports[0], "POST", "/index/ti", {})
        req(ports[0], "POST", "/index/ti/field/f", {})
        # write through node1: DDL broadcast + replica fan-out ride HTTPS
        out = req(ports[1], "POST", "/index/ti/query",
                  "Set(3, f=1) Set(9, f=1) Set(1048580, f=1)")
        assert out["results"] == [True, True, True]
        for p in ports:
            out = req(p, "POST", "/index/ti/query",
                      "Count(Row(f=1)) Row(f=1)")
            assert out["results"][0] == 3
            assert out["results"][1]["columns"] == [3, 9, 1048580]
        # node0 fans a read out to node1 over HTTPS on the chosen wire:
        # on bin1 the PTPUQRY1 frames crossed TLS and decoded, with no
        # downgrade to JSON
        c0 = servers[0].cluster
        counts0 = dict(servers[0].stats.snapshot()["counts"])
        got = c0.client.query_calls(hosts[1], "ti",
                                    parse("Count(Row(f=1))").calls, [1])
        assert got[0] == [1]
        counts1 = servers[0].stats.snapshot()["counts"]
        frames = counts1.get("cluster.wire_frames", 0) - \
            counts0.get("cluster.wire_frames", 0)
        assert (frames > 0) == (wire == "bin1")
        assert counts1.get("cluster.wire_fallback", 0) == 0
        assert c0.client.peer_wire_mode(hosts[1]) == wire
        # a client without a certificate is refused by the handshake
        nocert = ssl.create_default_context(cafile=ca)
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"https://localhost:{ports[0]}/status", context=nocert,
                timeout=10)
    finally:
        close_all(servers)
